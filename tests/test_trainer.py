"""Optimizer and fit-loop tests."""

import json
import os

import numpy as np
import pytest

from tensor_ops.backend.rng import Rng
from tensor_ops.models import act_logistic, act_softmax, cross_entropy, gen_net
from tensor_ops.models.optim import adam, momentum, sgd
from tensor_ops.models.trainer import fit


def toy_data(n=200, seed=0):
    r = np.random.default_rng(seed)
    X = r.uniform(-1, 1, size=(n, 2))
    labels = (X[:, 0] * X[:, 1] > 0).astype(int)
    Y = np.eye(2)[labels]
    return X, Y, labels


def make_net(be, seed=0):
    rng = Rng(be, seed=seed)
    return gen_net(be, 2, 2, [(16, act_logistic())], act_softmax(), rng)


def test_optimizers_reduce_loss(jb):
    X, Y, _ = toy_data()
    loss = cross_entropy(2)
    for opt in (sgd(), momentum(0.9), adam()):
        net = make_net(jb, seed=1)
        res = fit(net, loss, jb, X, Y, epochs=8, batch_size=32,
                  lr=0.3 if opt.name != "adam" else 0.01,
                  optimizer=opt, verbose=False)
        first = res.history[0]["loss"]
        last = res.history[-1]["loss"]
        assert last < first, (opt.name, first, last)


def test_fit_with_validation_and_metrics(jb, tmp_path):
    X, Y, labels = toy_data(300, seed=2)
    loss = cross_entropy(2)
    net = make_net(jb, seed=3)
    mpath = str(tmp_path / "metrics.jsonl")
    cpath = str(tmp_path / "ckpt.npz")
    from tensor_ops.models.optim import adam

    res = fit(net, loss, jb, X[:250], Y[:250], epochs=40, batch_size=50,
              lr=0.05, optimizer=adam(), val=(X[250:], labels[250:]),
              metrics_path=mpath, checkpoint_path=cpath, checkpoint_every=50,
              log_every=50, verbose=False)
    assert os.path.exists(mpath) and os.path.exists(cpath)
    recs = [json.loads(l) for l in open(mpath)]
    assert all("val_acc" in r for r in recs)
    # learnable task: accuracy should beat chance by the end
    assert recs[-1]["val_acc"] > 0.85
    # checkpoint restores
    from tensor_ops.utils.checkpoint import load_network

    restored = load_network(cpath, net, jb)
    assert len(restored.params) == len(net.params)


def test_fit_numpy_backend(nb):
    X, Y, _ = toy_data(60, seed=4)
    loss = cross_entropy(2)
    net = make_net(nb, seed=5)
    res = fit(net, loss, nb, X, Y, epochs=2, batch_size=20, lr=0.3,
              verbose=False, log_every=1)
    assert res.steps == 6
    assert res.history[-1]["loss"] < res.history[0]["loss"] * 1.5


def test_clip_and_schedules():
    import numpy as np

    from tensor_ops.models.optim import (
        clip_by_global_norm,
        cosine_schedule,
        exponential_schedule,
    )

    g = (np.array([3.0, 4.0]),)  # norm 5
    clipped = clip_by_global_norm(g, 1.0)
    assert np.isclose(np.linalg.norm(clipped[0]), 1.0, atol=1e-6)
    small = (np.array([0.3, 0.4]),)  # norm 0.5 < 1 -> untouched
    same = clip_by_global_norm(small, 1.0)
    np.testing.assert_allclose(same[0], small[0], atol=1e-9)

    lr = cosine_schedule(1.0, 100)
    assert np.isclose(lr(0), 1.0) and lr(100) < 1e-9 and 0.4 < lr(50) < 0.6
    lre = exponential_schedule(1.0, 0.5, every=10)
    assert lre(0) == 1.0 and lre(10) == 0.5 and lre(25) == 0.25


def test_gradient_accumulation_matches_full_batch(jb):
    """accum_steps=4 over a batch == one full-batch step (same mean
    gradient, same update)."""
    from tensor_ops.models.optim import sgd
    from tensor_ops.models.trainer import make_opt_step

    X, Y, _ = toy_data(32, seed=9)
    loss = cross_entropy(2)
    net = make_net(jb, seed=10)
    xb, yb = jb.asarray(X), jb.asarray(Y)

    full = make_opt_step(net, loss, jb, sgd())
    acc = make_opt_step(net, loss, jb, sgd(), accum_steps=4)
    v1, _, p1 = full(0.3, xb, yb, (), net.params)
    v2, _, p2 = acc(0.3, xb, yb, (), net.params)
    assert abs(float(v1) - float(v2)) < 1e-9
    for a, b in zip(p1, p2):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-9)


def test_async_checkpoint(tmp_path, nb):
    from tensor_ops.utils.checkpoint import load_arrays, save_arrays_async

    fut = save_arrays_async(str(tmp_path / "a.npz"),
                            {"x": np.arange(4)}, {"k": 2})
    fut.result()
    arrays, meta = load_arrays(str(tmp_path / "a.npz"))
    assert meta["k"] == 2 and arrays["x"].tolist() == [0, 1, 2, 3]


def test_fit_clip_and_schedule_wiring(jb):
    """clip_norm bounds the effective update; lr_schedule drives the
    per-step lr without recompiling (the lr is a traced argument)."""
    from tensor_ops.models.optim import cosine_schedule
    from tensor_ops.models.trainer import make_opt_step

    X, Y, _ = toy_data(120, seed=5)
    loss = cross_entropy(2)
    net = make_net(jb, seed=6)

    res = fit(net, loss, jb, X, Y, epochs=4, batch_size=30, lr=0.5,
              clip_norm=0.5, lr_schedule=cosine_schedule(0.5, 16),
              verbose=False, log_every=1)
    assert res.history[-1]["loss"] < res.history[0]["loss"]

    # clipping semantics: with a tiny max norm the params barely move
    step_clip = make_opt_step(net, loss, jb, sgd(), clip_norm=1e-9)
    xb, yb = jb.asarray(X[:30]), jb.asarray(Y[:30])
    _, _, p_clip = step_clip(1.0, xb, yb, (), net.params)
    for a, b in zip(p_clip, net.params):
        assert float(np.abs(np.asarray(a) - np.asarray(b)).max()) < 1e-8

    # cache key separates clip settings
    step_free = make_opt_step(net, loss, jb, sgd())
    assert step_free is not step_clip
    _, _, p_free = step_free(1.0, xb, yb, (), net.params)
    moved = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                for a, b in zip(p_free, net.params))
    assert moved > 1e-4


def test_fit_mixed_precision(jb):
    """bf16 compute with f32 masters: converges, masters stay f32, and
    the trajectory tracks the f32 run loosely (bf16 rounding)."""
    import jax.numpy as jnp

    X, Y, labels = toy_data(240, seed=9)
    loss = cross_entropy(2)

    res_mp = fit(make_net(jb, seed=10), loss, jb, X, Y, epochs=6,
                 batch_size=40, lr=0.3, mixed_precision="bf16",
                 verbose=False, log_every=5)
    assert res_mp.history[-1]["loss"] < res_mp.history[0]["loss"]
    for p in res_mp.net.params:
        # masters keep the backend's full precision (f64 in the suite's
        # x64 mode, f32 in production) — never bf16
        assert p.dtype != jnp.bfloat16 and jnp.dtype(p.dtype).itemsize >= 4

    res_fp = fit(make_net(jb, seed=10), loss, jb, X, Y, epochs=6,
                 batch_size=40, lr=0.3, verbose=False, log_every=5)
    assert abs(res_mp.history[-1]["loss"] - res_fp.history[-1]["loss"]) < 0.15

    with pytest.raises(ValueError):
        from tensor_ops.backend.numpy_backend import NumpyBackend

        fit(make_net(jb, seed=10), loss, NumpyBackend(), X, Y,
            mixed_precision=True)


def test_mixed_precision_auto_routes_and_caches(jb, tmp_path, monkeypatch):
    """mixed_precision=True auto-routes on a one-time measurement:
    the verdict obeys the >3% hysteresis (near-ties stay f32), lands
    in the metrics JSONL and the .state checkpoint, is cached
    in-process (second fit of the same config never re-measures), and
    resume adopts the recorded route without measuring at all."""
    import tensor_ops.models.trainer as TR

    X, Y, _ = toy_data(120, seed=11)
    loss = cross_entropy(2)
    calls = []

    def fake_measure(step_f32, step_bf16, args, **kw):
        calls.append(1)
        return 100.0, 98.0  # bf16 only 2% faster: hysteresis keeps f32

    monkeypatch.setattr(TR, "_measure_mp_route", fake_measure)
    mpath = str(tmp_path / "m.jsonl")
    ck = str(tmp_path / "c.npz")
    net = make_net(jb, seed=20)
    fit(net, loss, jb, X, Y, epochs=2, batch_size=40, lr=0.3,
        mixed_precision=True, verbose=False, metrics_path=mpath,
        checkpoint_path=ck, checkpoint_every=2, log_every=2)
    assert len(calls) == 1
    recs = [json.loads(l) for l in open(mpath)]
    assert recs[0]["mp_route"] == "f32"
    assert recs[0]["mp_f32_us"] == 100.0 and recs[0]["mp_bf16_us"] == 98.0
    from tensor_ops.utils.checkpoint import load_meta

    assert load_meta(ck + ".state")["mp_route"] == "f32"

    # same config again on the same graph: in-process cache, no re-measure
    fit(net, loss, jb, X, Y, epochs=1, batch_size=40, lr=0.3,
        mixed_precision=True, verbose=False)
    assert len(calls) == 1

    # resume adopts the checkpoint's route — measuring would be a bug
    # (a flipped route would break the saving run's numerics)
    def boom(*a, **k):
        raise AssertionError("resume must not re-measure the route")

    monkeypatch.setattr(TR, "_decide_mp_route", boom)
    net2 = make_net(jb, seed=20)
    fit(net2, loss, jb, X, Y, epochs=3, batch_size=40, lr=0.3,
        mixed_precision=True, verbose=False, checkpoint_path=ck,
        checkpoint_every=2, resume=True)


def test_mixed_precision_legacy_resume_adopts_bf16(jb, tmp_path,
                                                   monkeypatch):
    """Resuming a checkpoint that records NO mp_route (saved by a
    pre-auto-routing build, where True forced bf16, or by a False run)
    under mixed_precision=True adopts bf16 with a warning instead of
    silently re-measuring into a mid-chain dtype flip."""
    import warnings

    import tensor_ops.models.trainer as TR

    X, Y, _ = toy_data(80, seed=13)
    loss = cross_entropy(2)
    ck = str(tmp_path / "legacy.npz")
    # the saving run used mixed_precision=False -> no mp_route in meta
    fit(make_net(jb, seed=22), loss, jb, X, Y, epochs=2, batch_size=40,
        lr=0.3, verbose=False, checkpoint_path=ck, checkpoint_every=2)
    from tensor_ops.utils.checkpoint import load_meta

    assert "mp_route" not in load_meta(ck + ".state")

    def boom(*a, **k):
        raise AssertionError("legacy resume must not measure")

    monkeypatch.setattr(TR, "_decide_mp_route", boom)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        res = fit(make_net(jb, seed=22), loss, jb, X, Y, epochs=3,
                  batch_size=40, lr=0.3, mixed_precision=True,
                  verbose=False, checkpoint_path=ck, checkpoint_every=2,
                  resume=True)
    assert any("no mp_route" in str(x.message) for x in w)
    # the adopted route is recorded going forward
    assert load_meta(ck + ".state")["mp_route"] == "bf16"
    assert all(np.isfinite(h["loss"]) for h in res.history)


def test_normalize_mp_accepts_truthy_legacy_values():
    """Pre-router callers passed ints / numpy bools; they keep working
    with truthiness semantics, while unknown strings stay rejected."""
    from tensor_ops.models.trainer import _normalize_mp

    assert _normalize_mp(1) == "auto"
    assert _normalize_mp(0) == "off"
    assert _normalize_mp(np.True_) == "auto"
    assert _normalize_mp(np.False_) == "off"
    with pytest.raises(ValueError, match="mixed_precision"):
        _normalize_mp("yes")


def test_mixed_precision_auto_picks_bf16_when_clearly_faster(jb, monkeypatch):
    """A >3% bf16 win routes to bf16 — and the bf16 step actually runs
    (the batched-graph key lands in the compile cache)."""
    import tensor_ops.models.trainer as TR

    X, Y, _ = toy_data(80, seed=12)
    monkeypatch.setattr(TR, "_measure_mp_route",
                        lambda *a, **k: (100.0, 90.0))
    net = make_net(jb, seed=21)
    res = fit(net, cross_entropy(2), jb, X, Y, epochs=2, batch_size=40,
              lr=0.3, mixed_precision=True, verbose=False, log_every=2)
    assert all(np.isfinite(h["loss"]) for h in res.history)
    assert any(isinstance(k, tuple) and k and k[0] == "optstep" and k[5]
               for k in net.op._compiled), "bf16 step was never built"


def test_mixed_precision_rejects_unknown_value(jb):
    X, Y, _ = toy_data(40)
    with pytest.raises(ValueError, match="mixed_precision must be"):
        fit(make_net(jb), cross_entropy(2), jb, X, Y,
            mixed_precision="fp16")


def test_fit_sequences_mixed_precision_auto_routes(jb, monkeypatch):
    """The same measure-once router runs on fit_sequences' dual-rate
    step (different step signature than fit's)."""
    import tensor_ops.models.trainer as TR
    from tensor_ops.models import fit_sequences, squared_error
    from tensor_ops.models.recurrent import gen_net as gen_rnet

    t = np.linspace(0, 2 * np.pi, 9, dtype=np.float64)
    XS = np.stack([np.sin(t[:-1] + p)[:, None]
                   for p in np.linspace(0, 3, 32)])
    TS = np.stack([np.sin(t[1:] + p)[:, None]
                   for p in np.linspace(0, 3, 32)])
    calls = []

    def fake_measure(a, b, args, **kw):
        calls.append(1)
        return 50.0, 10.0  # clear bf16 win

    monkeypatch.setattr(TR, "_measure_mp_route", fake_measure)
    net = gen_rnet(jb, 1, 1, [(6, act_logistic(), act_logistic())],
                   act_logistic(), None, Rng(jb, seed=5))
    master = np.asarray(net.params[0]).dtype
    res = fit_sequences(net, squared_error(1), jb, XS, TS, epochs=2,
                        batch_size=16, rate_state=0.01, rate_param=0.1,
                        mixed_precision=True, log_every=1, verbose=False)
    assert len(calls) == 1
    assert all(np.isfinite(h["loss"]) for h in res.history)
    assert np.asarray(res.net.params[0]).dtype == master


def test_fit_prefetch_identical_to_no_prefetch(jb):
    """DevicePrefetcher only overlaps transfer with compute — the loss
    trajectory is bit-identical to the unprefetched path (same loader
    seed -> same batch order)."""
    X, Y, _ = toy_data()
    loss = cross_entropy(2)
    r1 = fit(make_net(jb, seed=4), loss, jb, X, Y, epochs=3, batch_size=32,
             lr=0.3, verbose=False, log_every=1, prefetch=2)
    r0 = fit(make_net(jb, seed=4), loss, jb, X, Y, epochs=3, batch_size=32,
             lr=0.3, verbose=False, log_every=1, prefetch=0)
    assert len(r1.history) == len(r0.history)
    for a, b in zip(r1.history, r0.history):
        assert a["loss"] == b["loss"]


def test_device_prefetcher_order_and_depth():
    from tensor_ops.utils.native import DevicePrefetcher

    class FakeLoader:
        def __init__(self):
            self.k = 0

        def next(self):
            self.k += 1
            return self.k, -self.k

    calls = []
    pf = DevicePrefetcher(FakeLoader(), lambda x, y: calls.append(x) or (x, y),
                          depth=3)
    assert calls == [1, 2, 3]          # depth batches pre-pulled
    assert pf.next() == (1, -1)        # FIFO order preserved
    assert calls == [1, 2, 3, 4]       # refilled immediately
    assert pf.next() == (2, -2)
    with pytest.raises(ValueError):
        DevicePrefetcher(FakeLoader(), lambda x, y: (x, y), depth=0)


def test_fit_resume_restores_optimizer_state(jb, tmp_path):
    """fit(resume=True) continues from params + Adam moments + step —
    the second run must match an uninterrupted run's final loss closely
    (identical modulo the loader's reshuffle position)."""
    from tensor_ops.utils.checkpoint import load_train_state

    X, Y, _ = toy_data(n=256, seed=5)
    loss = cross_entropy(2)
    ck = str(tmp_path / "run.npz")

    # interrupted run: 1 epoch (8 steps), checkpoint every 4
    r1 = fit(make_net(jb, seed=6), loss, jb, X, Y, epochs=1, batch_size=32,
             lr=0.01, optimizer=adam(), checkpoint_path=ck,
             checkpoint_every=4, verbose=False, log_every=1)
    assert os.path.exists(ck) and os.path.exists(ck + ".state")

    # the .state file restores the exact params and step of run 1's
    # last checkpoint (step 8 == r1.steps since 8 % 4 == 0)
    o = adam()
    tmpl = o.init(r1.net.params)
    p_ck, st_ck, step_ck = load_train_state(ck + ".state", tmpl)
    assert step_ck == r1.steps
    for a, b in zip(p_ck, r1.net.params):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # resume with a LARGER total budget: the fresh seed-999 net is
    # REPLACED by the checkpoint and only the REMAINING steps run
    # (epochs is the total budget, not an increment)
    r2 = fit(make_net(jb, seed=999), loss, jb, X, Y, epochs=2, batch_size=32,
             lr=0.01, optimizer=adam(), checkpoint_path=ck,
             checkpoint_every=4, resume=True, verbose=False, log_every=1)
    assert r2.steps == 16                      # total, not r1.steps + 16
    assert r2.history[0]["step"] == r1.steps + 1

    # resume at an already-met budget (r2 checkpointed at step 16)
    # trains zero further steps and returns the checkpointed params
    r3 = fit(make_net(jb, seed=999), loss, jb, X, Y, epochs=1, batch_size=32,
             lr=0.01, optimizer=adam(), checkpoint_path=ck,
             checkpoint_every=4, resume=True, verbose=False, log_every=1)
    assert r3.steps == r2.steps and r3.history == []
    for a, b in zip(r3.net.params, r2.net.params):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # template-mismatch raises loudly (different optimizer)
    opt = sgd()
    st = opt.init(make_net(jb, seed=6).params)
    with pytest.raises(ValueError, match="optimizer state mismatch"):
        load_train_state(ck + ".state", st)

    # same structure, different hyperparameters: the stored struct_key
    # rejects the resume instead of silently reinterpreting the moments
    with pytest.raises(ValueError, match="optimizer mismatch"):
        fit(make_net(jb, seed=999), loss, jb, X, Y, epochs=2, batch_size=32,
            lr=0.01, optimizer=adam(b1=0.5), checkpoint_path=ck,
            checkpoint_every=4, resume=True, verbose=False, log_every=1)


def test_fit_resume_exact_equivalence(jb, tmp_path):
    """A crash/resume chain reproduces the uninterrupted run BIT-EXACTLY:
    params + Adam moments round-trip through the .state file and the
    loader stream is fast-forwarded to the restored step, so run-A(1
    epoch) -> resume(2 epochs total) equals one straight 2-epoch run."""
    X, Y, _ = toy_data(n=256, seed=11)
    loss = cross_entropy(2)
    ck = str(tmp_path / "chain.npz")

    fit(make_net(jb, seed=7), loss, jb, X, Y, epochs=1, batch_size=32,
        lr=0.01, optimizer=adam(), checkpoint_path=ck,
        checkpoint_every=8, verbose=False)          # saves at step 8
    resumed = fit(make_net(jb, seed=999), loss, jb, X, Y, epochs=2,
                  batch_size=32, lr=0.01, optimizer=adam(),
                  checkpoint_path=ck, checkpoint_every=8, resume=True,
                  verbose=False)

    straight = fit(make_net(jb, seed=7), loss, jb, X, Y, epochs=2,
                   batch_size=32, lr=0.01, optimizer=adam(),
                   verbose=False)
    assert resumed.steps == straight.steps == 16
    for a, b in zip(resumed.net.params, straight.net.params):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_loader_skip_matches_drained_stream():
    """NativeLoader.skip(n) lands the stream exactly where n next()
    calls would (both the native and the fallback path)."""
    from tensor_ops.utils.native import NativeLoader

    r = np.random.default_rng(0)
    X = r.normal(size=(100, 3)).astype(np.float32)
    Y = r.normal(size=(100, 2)).astype(np.float32)

    a = NativeLoader(X, Y, batch=16, seed=42)
    b = NativeLoader(X, Y, batch=16, seed=42)
    try:
        for _ in range(9):      # crosses an epoch boundary (ceil(100/16)=7)
            a.next()
        b.skip(9)
        for _ in range(3):
            xa, ya = a.next()
            xb, yb = b.next()
            np.testing.assert_array_equal(xa, xb)
            np.testing.assert_array_equal(ya, yb)
    finally:
        a.close()
        b.close()


def _sine_sequences(n_seqs=64, T=12, seed=0):
    r = np.random.default_rng(seed)
    phases = r.uniform(0, 2 * np.pi, size=n_seqs)
    t = np.arange(T + 1) * 0.3
    waves = 0.5 + 0.5 * np.sin(phases[:, None] + t[None, :])
    return waves[:, :-1, None], waves[:, 1:, None]


def test_fit_sequences_trains_and_resumes(jb, tmp_path):
    """fit_sequences: the recurrent family gets the production loop —
    loss falls, and a crash/resume chain reproduces the uninterrupted
    run bit-exactly (same shuffle stream, states+params restored)."""
    from tensor_ops.models import act_logistic, fit_sequences, squared_error
    from tensor_ops.models.recurrent import gen_net as gen_rnet
    from tensor_ops.utils.checkpoint import load_recurrent

    XS, TS = _sine_sequences()
    loss = squared_error(1)
    ck = str(tmp_path / "rnn.npz")

    def rnet(seed):
        return gen_rnet(jb, 1, 1, [(8, act_logistic(), act_logistic())],
                        act_logistic(), None, Rng(jb, seed=seed))

    kw = dict(batch_size=16, rate_state=0.01, rate_param=0.1,
              verbose=False, log_every=4)
    r1 = fit_sequences(rnet(3), loss, jb, XS, TS, epochs=4, **kw)
    assert r1.steps == 16
    assert r1.history[-1]["loss"] < r1.history[0]["loss"]

    # crash at epoch 2, resume to the same total budget
    fit_sequences(rnet(3), loss, jb, XS, TS, epochs=2, checkpoint_path=ck,
                  checkpoint_every=4, **kw)
    resumed = fit_sequences(rnet(999), loss, jb, XS, TS, epochs=4,
                            checkpoint_path=ck, checkpoint_every=4,
                            resume=True, **kw)
    assert resumed.steps == 16
    for a, b in zip(resumed.net.params, r1.net.params):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(resumed.net.states, r1.net.states):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # the servable checkpoint round-trips through load_recurrent
    back = load_recurrent(ck, rnet(999), jb)
    assert len(back.states) == 1 and len(back.params) == len(r1.net.params)


@pytest.mark.parametrize("cfg", [
    # (n_rows, batch, epochs, crash_epochs, optimizer)
    (96, 32, 3, 1, "adam"),
    (100, 32, 4, 2, "sgd"),       # ragged dataset (drops 4 rows/epoch)
    (64, 16, 5, 3, "momentum"),
    (80, 40, 2, 1, "adam"),
])
def test_fit_resume_equivalence_property(nb, tmp_path, cfg):
    """Property: for ANY (dataset size, batch, budget, crash point,
    optimizer), the crash/resume chain equals the uninterrupted run
    bit-exactly — on the numpy backend (no jit, pure semantics)."""
    n_rows, batch, epochs, crash, opt_name = cfg
    opts = {"adam": adam, "sgd": sgd, "momentum": momentum}
    X, Y, _ = toy_data(n=n_rows, seed=n_rows)
    loss = cross_entropy(2)
    ck = str(tmp_path / f"p{n_rows}.npz")

    fit(make_net(nb, seed=1), loss, nb, X, Y, epochs=crash,
        batch_size=batch, lr=0.05, optimizer=opts[opt_name](),
        checkpoint_path=ck, checkpoint_every=1, verbose=False)
    resumed = fit(make_net(nb, seed=77), loss, nb, X, Y, epochs=epochs,
                  batch_size=batch, lr=0.05, optimizer=opts[opt_name](),
                  checkpoint_path=ck, checkpoint_every=1, resume=True,
                  verbose=False)
    straight = fit(make_net(nb, seed=1), loss, nb, X, Y, epochs=epochs,
                   batch_size=batch, lr=0.05, optimizer=opts[opt_name](),
                   verbose=False)
    assert resumed.steps == straight.steps
    for a, b in zip(resumed.net.params, straight.net.params):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_fit_sequences_resume_equivalence_property(nb, tmp_path):
    """Same property for the recurrent loop on the numpy backend."""
    from tensor_ops.models import fit_sequences, squared_error
    from tensor_ops.models.recurrent import gen_net as gen_rnet

    XS, TS = _sine_sequences(n_seqs=24, T=5, seed=2)
    loss = squared_error(1)
    ck = str(tmp_path / "r.npz")

    def rnet(seed):
        return gen_rnet(nb, 1, 1, [(4, act_logistic(), act_logistic())],
                        act_logistic(), None, Rng(nb, seed=seed))

    kw = dict(batch_size=8, rate_state=0.02, rate_param=0.1,
              verbose=False, log_every=50)
    fit_sequences(rnet(4), loss, nb, XS, TS, epochs=1, checkpoint_path=ck,
                  checkpoint_every=1, **kw)
    resumed = fit_sequences(rnet(88), loss, nb, XS, TS, epochs=3,
                            checkpoint_path=ck, checkpoint_every=1,
                            resume=True, **kw)
    straight = fit_sequences(rnet(4), loss, nb, XS, TS, epochs=3, **kw)
    assert resumed.steps == straight.steps == 9
    for a, b in zip(resumed.net.params, straight.net.params):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(resumed.net.states, straight.net.states):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_fit_sequences_optimizer_clip_schedule(jb, tmp_path):
    """fit_sequences now carries fit's full surface: adam + clip_norm +
    lr_schedule trains, and the crash/resume chain under adam restores
    the optimizer moments bit-exactly."""
    from tensor_ops.models import fit_sequences, squared_error
    from tensor_ops.models.optim import adam, cosine_schedule
    from tensor_ops.models.recurrent import gen_net as gen_rnet

    XS, TS = _sine_sequences(n_seqs=32, T=6, seed=7)
    loss = squared_error(1)

    def rnet(seed):
        return gen_rnet(jb, 1, 1, [(6, act_logistic(), act_logistic())],
                        act_logistic(), None, Rng(jb, seed=seed))

    kw = dict(batch_size=8, rate_state=0.02, rate_param=0.05,
              optimizer=adam(), clip_norm=1.0,
              lr_schedule=cosine_schedule(0.05, 12),
              verbose=False, log_every=2)
    r1 = fit_sequences(rnet(5), loss, jb, XS, TS, epochs=3, **kw)
    assert r1.steps == 12
    assert r1.history[-1]["loss"] < r1.history[0]["loss"]

    ck = str(tmp_path / "rnn_adam.npz")
    fit_sequences(rnet(5), loss, jb, XS, TS, epochs=1, checkpoint_path=ck,
                  checkpoint_every=2, **kw)
    resumed = fit_sequences(rnet(99), loss, jb, XS, TS, epochs=3,
                            checkpoint_path=ck, checkpoint_every=2,
                            resume=True, **kw)
    assert resumed.steps == 12
    for a, b in zip(resumed.net.params, r1.net.params):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(resumed.net.states, r1.net.states):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_fit_sequences_optimizer_mismatch_rejected(jb, tmp_path):
    from tensor_ops.models import fit_sequences, squared_error
    from tensor_ops.models.optim import adam
    from tensor_ops.models.recurrent import gen_net as gen_rnet

    XS, TS = _sine_sequences(n_seqs=16, T=4, seed=8)
    loss = squared_error(1)
    rnet = gen_rnet(jb, 1, 1, [(4, act_logistic(), act_logistic())],
                    act_logistic(), None, Rng(jb, seed=6))
    ck = str(tmp_path / "rmm.npz")
    fit_sequences(rnet, loss, jb, XS, TS, epochs=1, batch_size=8,
                  optimizer=adam(b1=0.9), checkpoint_path=ck,
                  checkpoint_every=1, verbose=False)
    with pytest.raises(ValueError, match="optimizer mismatch"):
        fit_sequences(rnet, loss, jb, XS, TS, epochs=2, batch_size=8,
                      optimizer=adam(b1=0.5), checkpoint_path=ck,
                      checkpoint_every=1, resume=True, verbose=False)


def test_fit_sequences_remat_matches_plain(nb):
    """remat_every through the production loop: identical trajectory."""
    from tensor_ops.models import fit_sequences, squared_error
    from tensor_ops.models.recurrent import gen_net as gen_rnet

    XS, TS = _sine_sequences(n_seqs=16, T=6, seed=9)
    loss = squared_error(1)

    def rnet(seed):
        return gen_rnet(nb, 1, 1, [(4, act_logistic(), act_logistic())],
                        act_logistic(), None, Rng(nb, seed=seed))

    kw = dict(batch_size=8, rate_state=0.02, rate_param=0.1,
              verbose=False, log_every=1)
    a = fit_sequences(rnet(7), loss, nb, XS, TS, epochs=2, **kw)
    b = fit_sequences(rnet(7), loss, nb, XS, TS, epochs=2,
                      remat_every=3, **kw)
    for ra, rb in zip(a.history, b.history):
        assert abs(ra["loss"] - rb["loss"]) < 1e-12
    for x, y in zip(a.net.params, b.net.params):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), atol=1e-12)


def test_fit_sequences_warmup_schedule_stays_finite(jb):
    """lr_schedule hitting 0 at step 0 (linear warmup) must not
    NaN-poison the optimizer path: the dual-rate ratio is passed as a
    constant, never computed as 0/0 in-step."""
    from tensor_ops.models import fit_sequences, squared_error
    from tensor_ops.models.optim import adam
    from tensor_ops.models.recurrent import gen_net as gen_rnet

    XS, TS = _sine_sequences(n_seqs=16, T=5, seed=12)
    rnet = gen_rnet(jb, 1, 1, [(4, act_logistic(), act_logistic())],
                    act_logistic(), None, Rng(jb, seed=13))
    res = fit_sequences(
        rnet, squared_error(1), jb, XS, TS, epochs=3, batch_size=8,
        optimizer=adam(), lr_schedule=lambda s: 0.05 * min(1.0, s / 4.0),
        verbose=False, log_every=1)
    assert all(np.isfinite(h["loss"]) for h in res.history), res.history
    for p in res.net.params:
        assert np.all(np.isfinite(np.asarray(p)))


def test_compiled_cache_thread_safe():
    import threading

    from tensor_ops.ops.ir import CompiledCache

    c = CompiledCache(maxsize=8)
    errors = []

    def hammer(base):
        try:
            for i in range(3000):
                k = (base + i) % 12
                if c.get(k) is None:
                    c[k] = k
        except Exception as e:  # noqa: BLE001 — recorded for the assert
            errors.append(e)

    threads = [threading.Thread(target=hammer, args=(j,)) for j in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and len(c) <= 8


def test_fit_sequences_accum_matches_plain(jb):
    """accum_steps on fit_sequences: accumulating 4 quarter-batch chunks
    inside the jitted step equals the plain full-batch step at 1e-9
    (the mean of equal-sized chunk means IS the batch mean)."""
    from tensor_ops.models import (act_logistic, adam, fit_sequences,
                                       squared_error)
    from tensor_ops.models.recurrent import gen_net as gen_rnet

    XS, TS = _sine_sequences()
    loss = squared_error(1)

    def rnet(seed=3):
        return gen_rnet(jb, 1, 1, [(8, act_logistic(), act_logistic())],
                        act_logistic(), None, Rng(jb, seed=seed))

    kw = dict(epochs=2, batch_size=16, optimizer=adam(), rate_param=0.05,
              log_every=1, verbose=False)
    r_plain = fit_sequences(rnet(), loss, jb, XS, TS, **kw)
    r_accum = fit_sequences(rnet(), loss, jb, XS, TS, accum_steps=4, **kw)
    assert len(r_plain.history) == len(r_accum.history) > 3
    for ra, rb in zip(r_plain.history, r_accum.history):
        assert abs(ra["loss"] - rb["loss"]) < 1e-9, (ra, rb)
    for a, b in zip(r_plain.net.params, r_accum.net.params):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-9)
    for a, b in zip(r_plain.net.states, r_accum.net.states):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-9)

    with pytest.raises(ValueError, match="divisible by"):
        fit_sequences(rnet(), loss, jb, XS, TS, accum_steps=3,
                      batch_size=16, verbose=False)


def test_accum_steps_zero_rejected_eagerly(jb):
    """accum_steps=0 (or negative) must raise a named error in BOTH fit
    loops — not silently train unaccumulated (fit_sequences' old `> 1`
    gate) or die in a ZeroDivisionError (fit's pipeline chunk math)."""
    from tensor_ops.models import fit_sequences, squared_error
    from tensor_ops.models.recurrent import gen_net as gen_rnet
    from tensor_ops.models.trainer import fit

    X, Y, _ = toy_data(16, seed=9)
    net = make_net(jb, seed=10)
    with pytest.raises(ValueError, match="accum_steps must be >= 1"):
        fit(net, cross_entropy(2), jb, X, Y, accum_steps=0, verbose=False)

    XS, TS = _sine_sequences()
    rnet = gen_rnet(jb, 1, 1, [(8, act_logistic(), act_logistic())],
                    act_logistic(), None, Rng(jb, seed=3))
    with pytest.raises(ValueError, match="accum_steps must be >= 1"):
        fit_sequences(rnet, squared_error(1), jb, XS, TS, accum_steps=0,
                      verbose=False)


def test_fit_sequences_mixed_precision_trains(jb):
    """mixed_precision on fit_sequences: the bf16 scan-BPTT step trains
    (loss falls) while states+params stay full-precision masters."""
    from tensor_ops.models import act_logistic, fit_sequences, squared_error
    from tensor_ops.models.recurrent import gen_net as gen_rnet

    XS, TS = _sine_sequences()
    net = gen_rnet(jb, 1, 1, [(8, act_logistic(), act_logistic())],
                   act_logistic(), None, Rng(jb, seed=3))
    master_dtype = np.asarray(net.params[0]).dtype
    res = fit_sequences(net, squared_error(1), jb, XS, TS, epochs=8,
                        batch_size=16, rate_state=0.01, rate_param=0.1,
                        mixed_precision="bf16", log_every=4, verbose=False)
    assert res.history[-1]["loss"] < res.history[0]["loss"]
    assert np.asarray(res.net.params[0]).dtype == master_dtype
    assert np.asarray(res.net.states[0]).dtype == master_dtype


def test_interrupt_saves_exact_resume_checkpoint(jb, tmp_path):
    """Ctrl-C (KeyboardInterrupt) mid-run leaves an exact-resume
    artifact even with NO periodic checkpointing configured — the
    reference's train-until-Ctrl-C UX (MNIST.hs:297-313) upgraded to
    production semantics: resume + straight run are bit-identical."""
    r = np.random.default_rng(61)
    X = r.uniform(0, 1, size=(64, 8))
    Y = np.eye(4)[r.integers(0, 4, size=64)]
    loss = cross_entropy(4)
    ck = str(tmp_path / "intr.npz")

    def net():
        return gen_net(jb, 8, 4, [(8, act_logistic())], act_softmax(),
                       Rng(jb, seed=62))

    kw = dict(batch_size=16, optimizer=adam(), verbose=False,
              prefetch=0, log_every=1)

    def boom(step):
        if step == 5:
            raise KeyboardInterrupt
        return 0.05

    with pytest.raises(KeyboardInterrupt):
        fit(net(), loss, jb, X, Y, epochs=2, lr_schedule=boom,
            checkpoint_path=ck, checkpoint_every=0, **kw)
    assert os.path.exists(ck) and os.path.exists(ck + ".state")

    flat = lambda s: 0.05  # noqa: E731 — same lr as the interrupted run
    resumed = fit(net(), loss, jb, X, Y, epochs=2, lr_schedule=flat,
                  checkpoint_path=ck, checkpoint_every=0, resume=True,
                  **kw)
    straight = fit(net(), loss, jb, X, Y, epochs=2, lr_schedule=flat,
                   **kw)
    assert resumed.steps == straight.steps == 8
    # 1e-12 (not 0): a device's f64 may wobble 1 ulp between the
    # resumed and straight runs; CPU remains bit-identical
    for a, b in zip(resumed.net.params, straight.net.params):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-12, rtol=0)


def test_interrupt_saves_exact_resume_sequences(jb, tmp_path):
    """The same Ctrl-C semantics on the recurrent loop."""
    from tensor_ops.models import fit_sequences, squared_error
    from tensor_ops.models.recurrent import gen_net as gen_rnet

    XS, TS = _sine_sequences()
    ck = str(tmp_path / "intrs.npz")

    def net():
        return gen_rnet(jb, 1, 1, [(6, act_logistic(), act_logistic())],
                        act_logistic(), None, Rng(jb, seed=63))

    kw = dict(batch_size=16, optimizer=adam(), rate_param=0.05,
              rate_state=0.01, verbose=False, prefetch=0, log_every=1)

    def boom(step):
        if step == 3:
            raise KeyboardInterrupt
        return 0.05

    with pytest.raises(KeyboardInterrupt):
        fit_sequences(net(), squared_error(1), jb, XS, TS, epochs=2,
                      lr_schedule=boom, checkpoint_path=ck,
                      checkpoint_every=0, **kw)
    assert os.path.exists(ck) and os.path.exists(ck + ".state")

    flat = lambda s: 0.05  # noqa: E731
    resumed = fit_sequences(net(), squared_error(1), jb, XS, TS,
                            epochs=2, lr_schedule=flat,
                            checkpoint_path=ck, checkpoint_every=0,
                            resume=True, **kw)
    straight = fit_sequences(net(), squared_error(1), jb, XS, TS,
                             epochs=2, lr_schedule=flat, **kw)
    assert resumed.steps == straight.steps == 8
    for a, b in zip(resumed.net.params, straight.net.params):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-12, rtol=0)
