"""The production-training trio — adamw (decoupled weight decay),
ema_decay (Polyak averaging with exact resume), early_stop_patience —
plus their interplay with the rest of fit's surface."""

import os

import numpy as np
import pytest

from tensor_ops.backend.rng import Rng
from tensor_ops.models import (
    act_logistic,
    act_softmax,
    adam,
    adamw,
    cross_entropy,
    gen_net,
)
from tensor_ops.models.trainer import fit, fit_sequences


def _task(n=256, seed=0):
    r = np.random.default_rng(seed)
    X = r.uniform(-1, 1, size=(n, 2))
    labels = (X[:, 0] * X[:, 1] > 0).astype(int)
    return X, np.eye(2)[labels], labels


def _net(jb, seed=0):
    return gen_net(jb, 2, 2, [(16, act_logistic())], act_softmax(),
                   Rng(jb, seed=seed))


def test_adamw_decoupled_decay(jb):
    """With zero gradients adamw shrinks params by exactly lr*wd per
    step (the decay is DECOUPLED — it never enters the moments), and
    wd=0 reproduces adam bit-for-bit."""
    net = _net(jb)
    params = tuple(net.params)
    zeros = tuple(p * 0 for p in params)
    opt = adamw(weight_decay=0.1)
    st = opt.init(params)
    st, p1 = opt.update(st, params, zeros, 0.5)
    for a, b in zip(p1, params):
        np.testing.assert_allclose(np.asarray(a),
                                   np.asarray(b) * (1 - 0.5 * 0.1),
                                   rtol=1e-12)

    g = tuple(p * 0 + 0.01 for p in params)
    s0 = adamw(weight_decay=0.0).init(params)
    s1 = adam().init(params)
    _, pw = adamw(weight_decay=0.0).update(s0, params, g, 0.1)
    _, pa = adam().update(s1, params, g, 0.1)
    for a, b in zip(pw, pa):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_adamw_regularizes_in_fit(jb):
    """adamw's decay actually shrinks the weight norm vs adam over a
    real fit run (same data/seed/lr)."""
    X, Y, _ = _task()
    kw = dict(epochs=10, batch_size=64, lr=0.05, verbose=False,
              prefetch=0, log_every=5)
    rw = fit(_net(jb, seed=1), cross_entropy(2), jb, X, Y,
             optimizer=adamw(weight_decay=0.05), **kw)
    ra = fit(_net(jb, seed=1), cross_entropy(2), jb, X, Y,
             optimizer=adam(), **kw)
    norm = lambda ps: sum(float((np.asarray(p) ** 2).sum())  # noqa: E731
                          for p in ps)
    assert norm(rw.net.params) < norm(ra.net.params)
    assert rw.history[-1]["loss"] < rw.history[0]["loss"]


def test_ema_matches_manual_recurrence(jb):
    """FitResult.ema_net equals the hand-computed EMA over the exact
    per-step params of an identical run (log_every=1 records them)."""
    X, Y, _ = _task(n=64)
    d = 0.9
    kw = dict(epochs=2, batch_size=32, lr=0.05, optimizer=adam(),
              verbose=False, prefetch=0, log_every=1)
    res = fit(_net(jb, seed=2), cross_entropy(2), jb, X, Y,
              ema_decay=d, **kw)
    assert res.ema_net is not None

    # replay the identical run step by step, folding the EMA by hand
    from tensor_ops.models.trainer import make_opt_step
    from tensor_ops.utils.native import NativeLoader

    net = _net(jb, seed=2)
    opt = adam()
    step_fn = make_opt_step(net, cross_entropy(2), jb, opt)
    params = tuple(net.params)
    ema = tuple(params)
    st = opt.init(params)
    loader = NativeLoader(X, Y, batch=32, seed=0)
    for _ in range(4):
        xb, yb = loader.next()
        _, st, params = step_fn(0.05, jb.asarray(xb), jb.asarray(yb),
                                st, params)
        ema = tuple(d * e + (1 - d) * p for e, p in zip(ema, params))
    for a, b in zip(res.ema_net.params, ema):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-9, rtol=0)
    for a, b in zip(res.net.params, params):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=0, rtol=0)


def test_ema_resume_exact(jb, tmp_path):
    """A crash/resume chain reproduces the uninterrupted EMA exactly.
    The EMA lives INSIDE the .state file — atomic with the params it
    averages, so a crash can never tear the pair."""
    from tensor_ops.utils.checkpoint import load_train_state

    X, Y, _ = _task(n=128)
    ck = str(tmp_path / "ema.npz")
    kw = dict(batch_size=32, lr=0.05, optimizer=adam(), ema_decay=0.95,
              verbose=False, prefetch=0, log_every=1)
    fit(_net(jb, seed=3), cross_entropy(2), jb, X, Y, epochs=1,
        checkpoint_path=ck, checkpoint_every=2, **kw)
    assert not os.path.exists(ck + ".ema")  # no tearable sibling file
    tmpl = adam().init(tuple(_net(jb, seed=3).params))
    _, _, _, ema = load_train_state(ck + ".state", tmpl, with_ema=True)
    assert ema is not None and len(ema) == 4  # w0, b0, w1, b1
    resumed = fit(_net(jb, seed=3), cross_entropy(2), jb, X, Y, epochs=2,
                  checkpoint_path=ck, checkpoint_every=2, resume=True,
                  **kw)
    straight = fit(_net(jb, seed=3), cross_entropy(2), jb, X, Y,
                   epochs=2, **kw)
    for a, b in zip(resumed.ema_net.params, straight.ema_net.params):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-9, rtol=0)


def test_ema_resume_from_non_ema_checkpoint_warns(jb, tmp_path):
    """Resuming a checkpoint saved WITHOUT ema_decay under a run WITH
    it restarts the average from the restored params — loudly, never
    silently."""
    import warnings

    X, Y, _ = _task(n=128)
    ck = str(tmp_path / "noe.npz")
    kw = dict(batch_size=32, lr=0.05, optimizer=adam(),
              verbose=False, prefetch=0, log_every=1)
    fit(_net(jb, seed=8), cross_entropy(2), jb, X, Y, epochs=1,
        checkpoint_path=ck, checkpoint_every=2, **kw)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        res = fit(_net(jb, seed=8), cross_entropy(2), jb, X, Y, epochs=2,
                  checkpoint_path=ck, checkpoint_every=2, resume=True,
                  ema_decay=0.95, **kw)
    assert any("carries no EMA" in str(x.message) for x in w)
    assert res.ema_net is not None


def test_ema_sequences(jb):
    """fit_sequences(ema_decay=...) returns the averaged recurrent net
    (states AND params averaged) and it runs."""
    t = np.linspace(0, 1, 10)
    r = np.random.default_rng(4)
    waves = np.sin(2 * np.pi * t[None, :]
                   + r.uniform(0, np.pi, size=(32, 1)))
    XS, TS = waves[:, :-1, None], waves[:, 1:, None]
    from tensor_ops.models import squared_error
    from tensor_ops.models.recurrent import gen_net as gen_rnet

    net = gen_rnet(jb, 1, 1, [(6, act_logistic(), act_logistic())],
                   act_logistic(), None, Rng(jb, seed=5))
    res = fit_sequences(net, squared_error(1), jb, XS, TS, epochs=2,
                        batch_size=16, rate_param=0.05, rate_state=0.01,
                        ema_decay=0.9, verbose=False, prefetch=0,
                        log_every=1)
    assert res.ema_net is not None
    assert len(res.ema_net.params) == len(res.net.params)
    # the EMA trails the raw params (they moved; the average lags)
    moved = any(
        not np.allclose(np.asarray(a), np.asarray(b))
        for a, b in zip(res.ema_net.params, res.net.params))
    assert moved
    ys, _ = res.ema_net.run_seq(jb, XS[0])
    assert np.all(np.isfinite(np.asarray(ys)))


def test_early_stopping_stops(jb):
    """A net with lr=0 never improves: early_stop_patience halts after
    exactly (1 + patience) evaluations instead of running the budget;
    and the validation requirement is enforced."""
    X, Y, labels = _task(n=128)
    res = fit(_net(jb, seed=6), cross_entropy(2), jb, X, Y, epochs=50,
              batch_size=32, lr=0.0, optimizer=adam(),
              val=(X, labels), early_stop_patience=3,
              verbose=False, prefetch=0, log_every=1)
    # 4 steps/epoch x 50 epochs budget, but eval 1 sets the best and
    # evals 2..4 never improve -> stop at step 4
    assert res.steps == 4, res.steps

    with pytest.raises(ValueError, match="early_stop_patience"):
        fit(_net(jb, seed=6), cross_entropy(2), jb, X, Y, epochs=1,
            early_stop_patience=2, verbose=False, prefetch=0)


def test_early_stopping_keeps_improving_runs(jb):
    """A genuinely learning run with generous patience completes its
    budget."""
    X, Y, labels = _task(n=128)
    res = fit(_net(jb, seed=7), cross_entropy(2), jb, X, Y, epochs=3,
              batch_size=32, lr=0.05, optimizer=adam(),
              val=(X, labels), early_stop_patience=12,
              verbose=False, prefetch=0, log_every=1)
    assert res.steps == 12


def test_val_loss_metric_and_early_stop(jb):
    """val_metric='loss' evaluates the TRAINING loss on (Xv, targets) —
    the regression/reconstruction validation accuracy can't express —
    logs val_loss, and drives early stopping (lr=0 never improves ->
    stop after 1 + patience evaluations)."""
    from tensor_ops.models import squared_error

    r = np.random.default_rng(9)
    X = r.uniform(0, 1, size=(64, 8))
    Y = r.uniform(0, 1, size=(64, 8))
    net = gen_net(jb, 8, 8, [(8, act_logistic())], act_logistic(),
                  Rng(jb, seed=10))
    res = fit(net, squared_error(8), jb, X, Y, epochs=20, batch_size=32,
              lr=0.0, optimizer=adam(), val=(X, Y), val_metric="loss",
              early_stop_patience=2, verbose=False, prefetch=0,
              log_every=1)
    assert res.steps == 3, res.steps  # eval 1 best, evals 2-3 stall
    assert all("val_loss" in h for h in res.history)
    assert np.isfinite(res.history[0]["val_loss"])

    with pytest.raises(ValueError, match="val_metric"):
        fit(net, squared_error(8), jb, X, Y, epochs=1,
            val=(X, Y), val_metric="f1", verbose=False, prefetch=0)


def test_batch_loss_matches_training_loss(jb):
    """training.batch_loss == the mean of per-sample loss_value."""
    from tensor_ops.models import squared_error
    from tensor_ops.models.training import batch_loss

    r = np.random.default_rng(11)
    X = r.uniform(0, 1, size=(8, 4))
    Y = r.uniform(0, 1, size=(8, 4))
    net = gen_net(jb, 4, 4, [(6, act_logistic())], act_logistic(),
                  Rng(jb, seed=12))
    loss = squared_error(4)
    got = batch_loss(net, loss, jb, X, Y)
    want = np.mean([float(np.asarray(net.loss_value(
        loss, jb, jb.asarray(x), jb.asarray(y)))) for x, y in zip(X, Y)])
    assert abs(got - want) < 1e-9


def test_profile_dir_captures_trace(jb, tmp_path):
    """fit(profile_dir=...) writes a jax.profiler trace of steady-state
    steps and training proceeds normally (trace stopped even on short
    runs)."""
    X, Y, _ = _task(n=64)
    pd = str(tmp_path / "trace")
    res = fit(_net(jb, seed=13), cross_entropy(2), jb, X, Y, epochs=2,
              batch_size=32, lr=0.05, optimizer=adam(), profile_dir=pd,
              verbose=False, prefetch=0, log_every=1)
    assert res.steps == 4
    import glob

    assert glob.glob(os.path.join(pd, "**", "*.xplane.pb"),
                     recursive=True), "no trace written"

    # a run SHORTER than the trace window still stops the trace cleanly
    pd2 = str(tmp_path / "trace2")
    res2 = fit(_net(jb, seed=13), cross_entropy(2), jb, X, Y, epochs=1,
               batch_size=64, lr=0.05, profile_dir=pd2,
               verbose=False, prefetch=0, log_every=1)
    assert res2.steps == 1
    # starting a new trace would raise if the previous were left open
    from tensor_ops.utils.profiling import device_trace

    with device_trace(str(tmp_path / "trace3")):
        pass


def test_fit_sequences_val_and_early_stop(jb):
    """fit_sequences(val=(XSv, TSv)) logs the held-out sequence loss
    and early_stop_patience halts a non-improving (lr=0-equivalent)
    run after 1 + patience evaluations — the same surface as fit."""
    from tensor_ops.models import squared_error
    from tensor_ops.models.recurrent import gen_net as gen_rnet

    t = np.linspace(0, 1, 10)
    r = np.random.default_rng(14)
    waves = np.sin(2 * np.pi * t[None, :]
                   + r.uniform(0, np.pi, size=(48, 1)))
    XS, TS = waves[:32, :-1, None], waves[:32, 1:, None]
    XSv, TSv = waves[32:, :-1, None], waves[32:, 1:, None]

    def net():
        return gen_rnet(jb, 1, 1, [(6, act_logistic(), act_logistic())],
                        act_logistic(), None, Rng(jb, seed=15))

    res = fit_sequences(net(), squared_error(1), jb, XS, TS, epochs=2,
                        batch_size=16, rate_param=0.05, rate_state=0.01,
                        val=(XSv, TSv), verbose=False, prefetch=0,
                        log_every=1)
    assert all("val_loss" in h and np.isfinite(h["val_loss"])
               for h in res.history)

    stalled = fit_sequences(net(), squared_error(1), jb, XS, TS,
                            epochs=20, batch_size=16, rate_param=0.0,
                            rate_state=0.0, val=(XSv, TSv),
                            early_stop_patience=2, verbose=False,
                            prefetch=0, log_every=1)
    assert stalled.steps == 3, stalled.steps

    with pytest.raises(ValueError, match="early_stop_patience"):
        fit_sequences(net(), squared_error(1), jb, XS, TS, epochs=1,
                      early_stop_patience=2, verbose=False, prefetch=0)

    # seq_batch_loss == the mean of per-sequence seq_loss
    from tensor_ops.models.training import seq_batch_loss

    n0 = net()
    got = seq_batch_loss(n0, squared_error(1), jb, XSv, TSv)
    want = np.mean([float(np.asarray(n0.seq_loss(
        squared_error(1), jb, jb.asarray(xs), jb.asarray(ts))))
        for xs, ts in zip(XSv, TSv)])
    # 1e-6 (not 1e-9): the vmapped and per-sequence paths are different
    # XLA programs, and a device's f64 may differ between them at
    # ~1e-8 relative; CPU stays ~1e-16
    assert abs(got - want) < 1e-6

def test_profile_dir_rejects_numpy_backend(nb, tmp_path):
    """ADVICE r3: profile_dir is jax-only (there is nothing to trace on
    the numpy oracle) — asking for a trace there raises eagerly instead
    of silently writing an empty directory."""
    X, Y, _ = _task(n=8)
    with pytest.raises(ValueError, match="profile_dir"):
        fit(_net(nb, seed=1), cross_entropy(2), nb, X, Y, epochs=1,
            batch_size=8, lr=0.05, profile_dir=str(tmp_path / "t"),
            verbose=False)
