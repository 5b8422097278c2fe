"""Predictor/serving tests."""

import numpy as np

from tensor_ops.backend.rng import Rng
from tensor_ops.models import act_logistic, act_softmax, gen_net
from tensor_ops.models.fast import FusedMLP
from tensor_ops.models.serve import Predictor


def make(jb):
    rng = Rng(jb, seed=0)
    return gen_net(jb, 6, 3, [(8, act_logistic())], act_softmax(), rng)


def test_predictor_network_path(jb):
    net = make(jb)
    p = Predictor(net, jb, buckets=(4, 16))
    p.warmup()
    x = np.random.default_rng(0).uniform(0, 1, size=(5, 6))
    probs = p.predict(x)
    assert probs.shape == (5, 3)
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, atol=1e-6)
    # single sample squeezes
    one = p.predict(x[0])
    np.testing.assert_allclose(one, probs[0], atol=1e-9)
    assert p.latency()["n"] >= 2


def test_predictor_bucketing_pads_correctly(jb):
    net = make(jb)
    p = Predictor(net, jb, buckets=(8,))
    x = np.random.default_rng(1).uniform(0, 1, size=(3, 6))
    probs = p.predict(x)
    direct = np.asarray([np.asarray(net.run(jb, jb.asarray(xi))) for xi in x])
    np.testing.assert_allclose(probs, direct, atol=1e-9)


def test_predictor_fused_path(jb):
    net = make(jb)
    fm = FusedMLP.from_network(net, precision="highest")
    p = Predictor(fm, buckets=(8,))
    x = np.random.default_rng(2).uniform(0, 1, size=(4, 6))
    probs = p.predict(x)
    assert probs.shape == (4, 3)
    labels = p.predict_class(x)
    assert labels.shape == (4,)


def test_predictor_quantized_mlp(jb):
    """Predictor serves a QuantizedMLP (int8): argmax parity with the
    f32 FusedMLP predictor across bucket boundaries."""
    import jax.numpy as jnp

    from tensor_ops.backend.rng import Rng
    from tensor_ops.models import act_logistic, act_softmax, gen_net
    from tensor_ops.models.fast import FusedMLP, QuantizedMLP
    from tensor_ops.models.serve import Predictor

    rng = Rng(jb, seed=3)
    net = gen_net(jb, 12, 4, [(10, act_logistic())], act_softmax(), rng)
    fm = FusedMLP.from_network(net, precision="highest")
    qm = QuantizedMLP.from_fused(fm)
    pf = Predictor(fm, buckets=(4, 16))
    pq = Predictor(qm, buckets=(4, 16))
    pq.warmup()
    r = np.random.default_rng(0)
    agree, total = 0, 0
    for n in (1, 4, 9, 16, 33):
        x = r.uniform(0, 1, size=(n, 12)).astype(np.float32)
        a = pf.predict_class(x)
        b = pq.predict_class(x)
        assert a.shape == b.shape == (n,)
        # the serving wrapper itself (bucketing/padding) is exact: it
        # must reproduce the bare model's probabilities bit-for-bit
        want = np.asarray(qm.run(jnp.asarray(x, jnp.float32)))
        np.testing.assert_allclose(np.asarray(pq.predict(x)), want,
                                   rtol=1e-6, atol=1e-6)
        agree += int((a == b).sum())
        total += n
    # int8-vs-f32 argmax can differ on near-tie rows of an untrained
    # random net; fidelity bounds live in test_fast — here just sanity
    assert agree / total > 0.8, (agree, total)
    assert pq.latency()["n"] >= 5


def test_predictor_quantized_uniform_uses_megakernel(jb):
    """A uniform int8 stack serves through QuantizedMLP's one jitted
    forward: the Predictor's padded answer equals ``run`` on the rows."""
    import jax.numpy as jnp

    from tensor_ops.models.fast import QuantizedMLP
    from tensor_ops.models.serve import Predictor
    from tensor_ops.ops.int8 import quantize_weights_int8
    from tensor_ops.testing import rand

    N = 128
    ws = [jnp.asarray(rand(70 + k, N, N) * 0.2, jnp.float32) for k in range(2)]
    bs = [jnp.asarray(rand(80 + k, N) * 0.1, jnp.float32) for k in range(2)]
    qs, ss = zip(*(quantize_weights_int8(w) for w in ws))
    qm = QuantizedMLP(tuple(qs), tuple(ss), tuple(bs), ("relu", "identity"))
    p = Predictor(qm, buckets=(8,))
    x = np.random.default_rng(1).uniform(0, 1, size=(5, N)).astype(np.float32)
    out = p.predict(x)
    np.testing.assert_allclose(np.asarray(out),
                               np.asarray(qm.run(x[:5]))[:5], atol=1e-5)


def test_serve_cli_roundtrip(tmp_path, jb):
    """apps/serve.py: save a trained Network checkpoint, serve it back
    (f32 and int8), predictions match the in-process model."""
    import apps.serve as serve_app
    import io
    import contextlib

    from tensor_ops.backend.rng import Rng
    from tensor_ops.models import act_logistic, act_softmax, gen_net
    from tensor_ops.models.training import batched_run
    from tensor_ops.utils.checkpoint import save_network

    import tensor_ops as T

    be = T.JaxBackend()
    rng = Rng(be, seed=1)
    net = gen_net(be, 12, 4, [(8, act_logistic())], act_softmax(), rng)
    ckpt = str(tmp_path / "net.npz")
    save_network(ckpt, net)
    x = np.random.default_rng(2).uniform(0, 1, size=(5, 12)).astype(np.float32)
    xfile = str(tmp_path / "batch.npy")
    np.save(xfile, x)

    want = np.asarray(batched_run(net, be)(be.asarray(x), *net.params))

    for extra in ([], ["--int8"]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            serve_app.main([ckpt, "--layers", "8", "--in-dim", "12",
                            "--out-dim", "4", "-i", xfile, "--buckets", "8",
                            *extra])
        got = [int(l) for l in buf.getvalue().splitlines()
               if l.strip().lstrip("-").isdigit()]
        assert len(got) == 5
        agree = sum(int(g) == int(w) for g, w in zip(got, want.argmax(1)))
        assert agree >= 4, (extra, got, want.argmax(1))

    # --bench prints a latency JSON line
    import json as _json

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve_app.main([ckpt, "--layers", "8", "--in-dim", "12",
                        "--out-dim", "4", "--buckets", "4", "--bench"])
    line = [l for l in buf.getvalue().splitlines() if l.startswith("{")][-1]
    assert _json.loads(line)["latency"]["n"] >= 5


def test_serve_cli_relu_checkpoint_uses_stored_acts(tmp_path, jb):
    """A relu-trained Network checkpoint serves correctly WITHOUT any
    activation flag: the CLI rebuilds the graph from the activation
    names stored by save_network (round-1 gap: it silently assumed
    logistic)."""
    import contextlib
    import io

    import apps.serve as serve_app
    import tensor_ops as T
    from tensor_ops.backend.rng import Rng
    from tensor_ops.models import act_relu, act_softmax, gen_net
    from tensor_ops.models.training import batched_run
    from tensor_ops.utils.checkpoint import save_network

    be = T.JaxBackend()
    net = gen_net(be, 12, 4, [(8, act_relu())], act_softmax(),
                  Rng(be, seed=5))
    ckpt = str(tmp_path / "relu.npz")
    save_network(ckpt, net)
    x = np.random.default_rng(3).uniform(0, 1, size=(6, 12)).astype(np.float32)
    xfile = str(tmp_path / "batch.npy")
    np.save(xfile, x)

    want = np.asarray(batched_run(net, be)(be.asarray(x), *net.params))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve_app.main([ckpt, "--layers", "8", "--in-dim", "12",
                        "--out-dim", "4", "-i", xfile, "--buckets", "8"])
    got = [int(l) for l in buf.getvalue().splitlines()
           if l.strip().lstrip("-").isdigit()]
    assert got == [int(w) for w in want.argmax(1)]


def test_predictor_bf16_storage_parity(jb):
    """Predictor(dtype='bf16') halves weight storage; predictions agree
    with the f32 model (argmax-exact on well-separated outputs)."""
    import jax.numpy as jnp

    net = make(jb)
    fm = FusedMLP.from_network(net)
    p32 = Predictor(fm, buckets=(8,))
    p16 = Predictor(fm, buckets=(8,), dtype="bf16")
    assert p16.model.weights[0].dtype == jnp.bfloat16
    x = np.random.default_rng(4).uniform(0, 1, size=(8, 6)).astype(np.float32)
    a = p32.predict(x)
    b = p16.predict(x)
    np.testing.assert_allclose(a, b, atol=2e-2)
    np.testing.assert_array_equal(a.argmax(1), b.argmax(1))

    import pytest

    with pytest.raises(ValueError, match="FusedMLP"):
        Predictor(net, jb, dtype="bf16")
    with pytest.raises(ValueError, match="dtype"):
        Predictor(fm, dtype="int8")


def test_serve_cli_bf16_rejects_quantized_checkpoint(tmp_path, jb):
    import pytest

    import apps.serve as serve_app
    from tensor_ops.models.fast import QuantizedMLP
    from tensor_ops.utils.checkpoint import save_quantized

    net = make(jb)
    qm = QuantizedMLP.from_fused(FusedMLP.from_network(net))
    ck = str(tmp_path / "q.npz")
    save_quantized(ck, qm)
    with pytest.raises(SystemExit):
        serve_app.main([ck, "--bf16", "--bench", "--buckets", "4"])


def test_sequence_predictor(jb):
    """SequencePredictor: batched whole-sequence serving equals the
    per-sequence run_seq fold; bucketing pads the batch axis."""
    from tensor_ops.backend.rng import Rng
    from tensor_ops.models import act_logistic
    from tensor_ops.models.recurrent import gen_net as gen_rnet
    from tensor_ops.models.serve import SequencePredictor

    rnet = gen_rnet(jb, 2, 1, [(5, act_logistic(), act_logistic())],
                    act_logistic(), None, Rng(jb, seed=1))
    sp = SequencePredictor(rnet, jb, buckets=(4,))
    xs = np.random.default_rng(0).uniform(0, 1, size=(3, 6, 2)) \
        .astype(np.float32)

    out = sp.predict(xs)                       # 3 rides the 4-bucket
    assert out.shape == (3, 6, 1)
    for i in range(3):
        want, _ = rnet.run_seq(jb, jb.asarray(xs[i]))
        np.testing.assert_allclose(out[i], np.asarray(want), atol=1e-6)

    single = sp.predict(xs[0])                 # auto-batch a lone sequence
    np.testing.assert_allclose(single, out[0], atol=1e-6)
    assert sp.latency()["n"] == 2


def test_serve_cli_recurrent_checkpoint(tmp_path, jb):
    """A recurrent checkpoint serves through the CLI with NO
    architecture flags (stored arch metadata rebuilds the graph);
    --probs prints trajectories; wrong flags on old checkpoints die
    cleanly; --bench emits latency JSON."""
    import contextlib
    import io

    import pytest
    import json as _json

    import apps.serve as serve_app
    import tensor_ops as T
    from tensor_ops.backend.rng import Rng
    from tensor_ops.models import act_logistic
    from tensor_ops.models.recurrent import gen_net as gen_rnet
    from tensor_ops.utils.checkpoint import save_recurrent

    be = T.JaxBackend()
    rnet = gen_rnet(be, 2, 1, [(5, act_logistic(), act_logistic())],
                    act_logistic(), act_logistic(), Rng(be, seed=7))
    ck = str(tmp_path / "rnn.npz")
    save_recurrent(ck, rnet)

    xs = np.random.default_rng(0).uniform(0, 1, size=(3, 6, 2)) \
        .astype(np.float32)
    xfile = str(tmp_path / "seqs.npy")
    np.save(xfile, xs)

    # NO architecture flags: the stored arch metadata rebuilds the graph
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve_app.main([ck, "--buckets", "4", "-i", xfile])
    vals = [float(l) for l in buf.getvalue().splitlines()
            if l and l[0].isdigit() or l.startswith("-")]
    want, _ = rnet.run_seq(be, be.asarray(xs[0]))
    assert len(vals) == 3
    np.testing.assert_allclose(vals[0], float(np.asarray(want)[-1, 0]),
                               atol=1e-4)

    # --probs prints the full per-timestep trajectory
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve_app.main([ck, "--buckets", "4", "-i", xfile, "--probs"])
    rows = [l for l in buf.getvalue().splitlines()
            if l and (l[0].isdigit() or l.startswith("-"))]
    assert len(rows) == 3 * 6                  # B x n timesteps

    # a wrong architecture dies cleanly, not with a KeyError
    from tensor_ops.utils.checkpoint import load_arrays, save_arrays
    arrays, meta = load_arrays(ck)
    meta.pop("arch")                           # simulate an old checkpoint
    ck_old = str(tmp_path / "old.npz")
    save_arrays(ck_old, arrays, meta)
    with pytest.raises(SystemExit):
        with contextlib.redirect_stdout(io.StringIO()):
            serve_app.main([ck_old, "--layers", "5,5", "--in-dim", "2",
                            "--out-dim", "1", "--buckets", "4",
                            "-i", xfile])

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve_app.main([ck, "--layers", "5", "--in-dim", "2",
                        "--out-dim", "1", "--buckets", "2", "--bench",
                        "--seq-len", "6"])
    line = [l for l in buf.getvalue().splitlines() if l.startswith("{")][-1]
    assert _json.loads(line)["latency"]["n"] >= 5


def test_predictor_reload_hot_swaps(jb):
    """Predictor.reload: the rolling-update primitive — the replacement
    is warmed for every bucket before the swap, predictions change to
    the new model's, interface changes are rejected, and latency stats
    continue across the swap."""
    import pytest

    from tensor_ops.models.fast import QuantizedMLP

    rng = Rng(jb, seed=0)
    net_a = gen_net(jb, 4, 3, [(8, act_logistic())], act_softmax(), rng)
    net_b = gen_net(jb, 4, 3, [(8, act_logistic())], act_softmax(),
                    Rng(jb, seed=99))
    x = np.random.default_rng(1).uniform(0, 1, size=(5, 4))

    pred = Predictor(FusedMLP.from_network(net_a), buckets=(2, 8))
    pred.warmup()
    out_a = pred.predict(x)
    n_before = pred.latency()["n"]

    pred.reload(FusedMLP.from_network(net_b))
    out_b = pred.predict(x)
    assert not np.allclose(out_a, out_b)
    np.testing.assert_allclose(
        out_b, Predictor(FusedMLP.from_network(net_b),
                         buckets=(2, 8)).predict(x), atol=1e-5)
    assert pred.latency()["n"] == n_before + 1  # stats continue

    # kind may change: swap in the int8 quantization of the same net
    pred.reload(QuantizedMLP.from_fused(FusedMLP.from_network(net_b)))
    out_q = pred.predict(x)
    assert np.argmax(out_q, axis=1).shape == (5,)

    # interface changes are rejected (input AND output width)
    wide = gen_net(jb, 6, 3, [(8, act_logistic())], act_softmax(),
                   Rng(jb, seed=7))
    with pytest.raises(ValueError, match="input width"):
        pred.reload(FusedMLP.from_network(wide))
    tall = gen_net(jb, 4, 5, [(8, act_logistic())], act_softmax(),
                   Rng(jb, seed=8))
    with pytest.raises(ValueError, match="output width"):
        pred.reload(FusedMLP.from_network(tall))

    # kind may change to a Network when a backend is supplied.
    # 5e-3: the Network (staged-IR) and FusedMLP forwards are different
    # XLA programs — at a device's default matmul precision they differ
    # by ~1e-3; the assertion is that the swap took effect, not
    # cross-path bit parity
    pred.reload(net_b, be=jb)
    np.testing.assert_allclose(pred.predict(x), out_b, atol=5e-3)


def test_predictor_reload_keeps_dtype_knob(jb):
    """A bf16-storage deployment STAYS bf16 across reloads (the dtype
    knob is remembered), and the swap is one atomic assignment
    (_serving carries the model and its backend together)."""
    import jax.numpy as jnp

    rng = Rng(jb, seed=1)
    net_a = gen_net(jb, 4, 3, [(8, act_logistic())], act_softmax(), rng)
    net_b = gen_net(jb, 4, 3, [(8, act_logistic())], act_softmax(),
                    Rng(jb, seed=2))
    pred = Predictor(FusedMLP.from_network(net_a), buckets=(4,),
                     dtype="bf16")
    assert pred.model.weights[0].dtype == jnp.bfloat16
    pred.reload(FusedMLP.from_network(net_b))
    assert pred.model.weights[0].dtype == jnp.bfloat16  # knob kept
    pred.reload(FusedMLP.from_network(net_b), dtype=None)
    assert pred.model.weights[0].dtype != jnp.bfloat16  # explicit reset
    # (model, be) travel together — one assignment
    assert pred._serving == (pred.model, pred.be)


def test_sequence_predictor_reload(jb):
    """SequencePredictor.reload: previously-warmed lengths are compiled
    for the replacement before the atomic (rnet, be) swap; predictions
    change; interface changes are rejected."""
    import pytest

    from tensor_ops.backend.rng import Rng as _Rng
    from tensor_ops.models import act_logistic as _log
    from tensor_ops.models.recurrent import gen_net as gen_rnet
    from tensor_ops.models.serve import SequencePredictor

    def rnet(seed):
        return gen_rnet(jb, 1, 1, [(6, _log(), _log())], _log(), None,
                        _Rng(jb, seed=seed))

    pred = SequencePredictor(rnet(0), jb, buckets=(2, 8))
    pred.warmup([5])
    xs = np.random.default_rng(2).uniform(0, 1, size=(3, 5, 1))
    out_a = pred.predict(xs)
    n_before = pred.latency()["n"]

    pred.reload(rnet(1))
    assert 5 in pred._warmed
    out_b = pred.predict(xs)
    assert not np.allclose(out_a, out_b)
    assert pred.latency()["n"] == n_before + 1

    wide = gen_rnet(jb, 2, 1, [(6, _log(), _log())], _log(), None,
                    _Rng(jb, seed=3))
    with pytest.raises(ValueError, match="input shape"):
        pred.reload(wide)

def test_predictor_bf16_reload_quantized_then_back(jb):
    """ADVICE r3: a bf16-storage deployment can hot-swap in a
    QuantizedMLP (the inherited dtype knob must not trip the
    FusedMLP-only validation), and the remembered bf16 preference
    SURVIVES that swap — a later default FusedMLP reload goes back to
    bf16 storage without the operator re-asking."""
    import jax.numpy as jnp

    from tensor_ops.models.fast import QuantizedMLP

    net_a = gen_net(jb, 4, 3, [(8, act_logistic())], act_softmax(),
                    Rng(jb, seed=11))
    net_b = gen_net(jb, 4, 3, [(8, act_logistic())], act_softmax(),
                    Rng(jb, seed=12))
    pred = Predictor(FusedMLP.from_network(net_a), buckets=(4,),
                     dtype="bf16")
    x = np.random.default_rng(3).uniform(0, 1, size=(2, 4))

    # the docstring's own use case: bf16 deployment -> int8 quantization
    pred.reload(QuantizedMLP.from_fused(FusedMLP.from_network(net_b)))
    assert isinstance(pred.model, QuantizedMLP)
    assert pred.predict(x).shape == (2, 3)

    # the bf16 preference survived the non-FusedMLP swap
    pred.reload(FusedMLP.from_network(net_b))
    assert pred.model.weights[0].dtype == jnp.bfloat16

    # an EXPLICIT dtype updates the remembered knob: the next default
    # reload follows the last explicit choice, not construction-time
    pred.reload(FusedMLP.from_network(net_a), dtype=None)
    pred.reload(FusedMLP.from_network(net_b))
    assert pred.model.weights[0].dtype != jnp.bfloat16
    pred.reload(FusedMLP.from_network(net_a), dtype="bf16")
    pred.reload(FusedMLP.from_network(net_b))
    assert pred.model.weights[0].dtype == jnp.bfloat16


def test_sequence_predictor_reload_warms_union(jb):
    """ADVICE r3: reload(warm_lengths=...) warms the UNION of
    previously-warmed lengths and the extras — _warmed never claims a
    length the new rnet was not actually compiled for."""
    from tensor_ops.backend.rng import Rng as _Rng
    from tensor_ops.models import act_logistic as _log
    from tensor_ops.models.recurrent import gen_net as gen_rnet
    from tensor_ops.models.serve import SequencePredictor

    def rnet(seed):
        return gen_rnet(jb, 1, 1, [(6, _log(), _log())], _log(), None,
                        _Rng(jb, seed=seed))

    pred = SequencePredictor(rnet(0), jb, buckets=(2,))
    pred.warmup([3, 5])
    new = rnet(1)
    pred.reload(new, warm_lengths=[7])
    assert pred._warmed == {3, 5, 7}
    # every claimed-warm length is genuinely compiled for the NEW rnet
    for n in (3, 5, 7):
        key = ("serve_seq", n) + jb.cache_key()
        assert key in new.op._compiled, f"length {n} not warm post-swap"

def test_predictor_soak_under_concurrent_reloads(jb):
    """Serving soak (VERDICT r3 item 7): N predict threads race M
    hot-swaps on one Predictor.  Asserts ZERO exceptions, zero torn
    routes (every response equals wholly-old or wholly-new model
    output), and that no request paid a compile inside the timed
    region (max request latency well under one measured warmup)."""
    import threading
    import time as _time

    from tensor_ops.models.fast import QuantizedMLP

    net_a = gen_net(jb, 4, 3, [(8, act_logistic())], act_softmax(),
                    Rng(jb, seed=21))
    net_b = gen_net(jb, 4, 3, [(8, act_logistic())], act_softmax(),
                    Rng(jb, seed=22))
    fa = FusedMLP.from_network(net_a)
    qb = QuantizedMLP.from_fused(FusedMLP.from_network(net_b))
    x = np.random.default_rng(4).uniform(0, 1, size=(3, 4))

    # expected pure outputs of each serving state (computed up front)
    out_a = Predictor(fa, buckets=(4,)).predict(x)
    out_q = Predictor(qb, buckets=(4,)).predict(x)
    assert not np.allclose(out_a, out_q)

    pred = Predictor(fa, buckets=(4,))
    t0 = _time.perf_counter()
    pred.warmup()
    warmup_s = _time.perf_counter() - t0

    errors, torn = [], []
    latencies = []
    stop = threading.Event()

    def client():
        while not stop.is_set():
            t = _time.perf_counter()
            try:
                out = pred.predict(x)
            except Exception as e:  # noqa: BLE001 — collected, asserted
                errors.append(repr(e))
                return
            latencies.append(_time.perf_counter() - t)
            if not (np.allclose(out, out_a, atol=1e-5)
                    or np.allclose(out, out_q, atol=1e-5)):
                torn.append(np.asarray(out))
                return

    threads = [threading.Thread(target=client) for _ in range(4)]
    for t in threads:
        t.start()
    try:
        for k in range(6):  # M=6 alternating hot-swaps under load
            pred.reload(qb if k % 2 == 0 else fa)
            _time.sleep(0.1)  # let clients race the post-swap state too
    finally:
        stop.set()
        for t in threads:
            t.join()

    assert not errors, f"predict raised under reload: {errors[:3]}"
    assert not torn, "a request observed a torn serving state"
    assert len(latencies) > 50, "soak produced too few requests"
    lat = np.sort(latencies)
    p99 = lat[int(0.99 * (len(lat) - 1))]
    # a compile in the request path would cost ~a warmup; warm requests
    # are orders of magnitude cheaper even under thread contention
    assert p99 < max(0.5 * warmup_s, 0.05), \
        f"p99 {p99:.3f}s vs warmup {warmup_s:.3f}s — a request compiled?"
    assert pred.latency()["n"] == len(latencies)  # timer stayed coherent
