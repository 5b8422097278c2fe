"""FusedMLP / QuantizedMLP / FusedRNN: the plain XLA executors and the
int8 layer forms, against the NumPy float64 oracle and independent NumPy
references (float64 on the CPU, so the bounds are tight)."""

import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tensor_ops.ops.int8 import (
    quantize_acts_int8,
    quantize_weights_int8,
    w8_linear,
    w8a8_linear,
)
from tensor_ops.testing import rand as r

DIMS = [(784, 300, 100, 10), (13, 7, 5), (12, 8, 6, 4), (5, 3)]


def _net(be, dims, act="logistic", out="softmax", seed=0):
    from tensor_ops.backend.rng import Rng
    from tensor_ops.models import activation_by_name, gen_net

    hidden = [(h, activation_by_name(act)) for h in dims[1:-1]]
    return gen_net(be, dims[0], dims[-1], hidden, activation_by_name(out),
                   Rng(be, seed=seed))


def _as(net, be):
    """The same network with its params on backend ``be``."""
    from tensor_ops.models import Network

    return Network(net.op, [be.asarray(np.asarray(p)) for p in net.params],
                   net.act_names)


def _np_quantize(a):
    """Independent NumPy form of the per-row symmetric int8 quantizer."""
    a = np.asarray(a, np.float32)
    amax = np.max(np.abs(a), axis=1, keepdims=True)
    scale = np.where(amax > 0, amax / np.float32(127.0), np.float32(1.0))
    q = np.clip(np.round(a / scale), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)


@pytest.mark.parametrize("act", ["logistic", "relu", "tanh"])
@pytest.mark.parametrize("dims", DIMS, ids=lambda d: "x".join(map(str, d)))
def test_fused_mlp_forward_matches_oracle(nb, jb, dims, act):
    from tensor_ops.models.fast import FusedMLP
    from tensor_ops.models.training import batched_run

    net = _net(nb, dims, act)
    fm = FusedMLP.from_network(_as(net, jb), precision="highest")
    assert fm.acts == (act,) * (len(dims) - 2) + ("identity",)
    assert fm.softmax_out
    x = np.random.default_rng(1).uniform(0, 1, size=(3, dims[0]))
    want = batched_run(net, nb)(x, *net.params)
    got = np.asarray(fm.run(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("loss_kind", ["ce", "mse"])
@pytest.mark.parametrize("dims", DIMS, ids=lambda d: "x".join(map(str, d)))
def test_fused_mlp_step_matches_oracle(nb, jb, dims, loss_kind):
    """One FusedMLP SGD step (jax.grad of the plain chain) == the mean of
    the oracle's per-sample transposition-AD gradients."""
    from tensor_ops.models import cross_entropy, squared_error
    from tensor_ops.models.fast import FusedMLP

    o = dims[-1]
    if loss_kind == "ce":
        net, loss = _net(nb, dims), cross_entropy(o)
    else:
        net, loss = _net(nb, dims, out="logistic"), squared_error(o)
    fm = FusedMLP.from_network(_as(net, jb), precision="highest")
    fm = FusedMLP(fm.weights, fm.biases, fm.acts, fm.softmax_out,
                  "highest", loss_kind)
    rr = np.random.default_rng(2)
    X = rr.uniform(0, 1, size=(4, dims[0]))
    Y = np.eye(o)[rr.integers(0, o, size=4)] if loss_kind == "ce" \
        else rr.uniform(0, 1, size=(4, o))
    rate = 0.1

    v, fm2 = fm.train(rate, jnp.asarray(X), jnp.asarray(Y))
    want_v = np.mean([net.loss_value(loss, nb, x, y) for x, y in zip(X, Y)])
    grads = [np.mean(gs, axis=0) for gs in zip(
        *(net.network_gradient(loss, nb, x, y) for x, y in zip(X, Y)))]
    want = [p - rate * g for p, g in zip(net.params, grads)]
    np.testing.assert_allclose(float(v), want_v, rtol=1e-10)
    for a, b in zip(fm2.to_params(), want):
        np.testing.assert_allclose(np.asarray(a), b, rtol=1e-9, atol=1e-12)


def test_fused_mlp_model_roundtrip(jb):
    """FusedMLP.from_network parity with the IR path (highest precision)."""
    from tensor_ops.backend.rng import Rng
    from tensor_ops.models import act_logistic, act_softmax, gen_net
    from tensor_ops.models.fast import FusedMLP
    from tensor_ops.models.training import batched_run

    rng = Rng(jb, seed=0)
    net = gen_net(jb, 12, 4, [(8, act_logistic())], act_softmax(), rng)
    fm = FusedMLP.from_network(net, ["logistic", "identity"], precision="highest")
    xb = jb.asarray(r(14, 6, 12))
    y_ir = np.asarray(batched_run(net, jb)(xb, *net.params))
    y_f = np.asarray(fm.run(xb))
    np.testing.assert_allclose(y_f, y_ir, atol=1e-6)
    v, fm2 = fm.train(0.1, xb, jb.asarray(np.eye(4)[[0, 1, 2, 3, 0, 1]]))
    assert np.isfinite(float(v))


def test_int8_weight_quantization_roundtrip():
    w = jnp.asarray(r(20, 6, 10) * 0.7, jnp.float32)
    q, s = quantize_weights_int8(w)
    assert q.dtype == jnp.int8 and s.shape == (6, 1)
    w2 = q.astype(jnp.float32) * s
    # per-channel max error bounded by half a quantization step
    step = np.asarray(s)[:, 0]
    err = np.abs(np.asarray(w) - np.asarray(w2)).max(axis=1)
    assert (err <= step * 0.5 + 1e-7).all()


@pytest.mark.parametrize("B,K", [(1, 7), (4, 64), (16, 300), (33, 129)])
def test_quantize_acts_int8_matches_numpy(B, K):
    """Per-row activation quantization == the independent NumPy form,
    and dequantizes within half a step; an all-zero row gets scale 1."""
    x = np.asarray(r(300 + B, B, K), np.float32)
    x[0] = 0.0
    q, s = quantize_acts_int8(jnp.asarray(x))
    qn, sn = _np_quantize(x)
    np.testing.assert_array_equal(np.asarray(q), qn)
    np.testing.assert_array_equal(np.asarray(s), sn)
    assert float(s[0, 0]) == 1.0
    err = np.abs(np.asarray(q, np.float32) * np.asarray(s) - x)
    assert (err <= np.asarray(s) * 0.5 + 1e-6).all()


def test_fused_linear_w8_close_to_full_precision():
    x = jnp.asarray(r(21, 8, 16), jnp.float32)
    w = jnp.asarray(r(22, 6, 16) * 0.3, jnp.float32)
    b = jnp.asarray(r(23, 6) * 0.1, jnp.float32)
    q, s = quantize_weights_int8(w)
    y8 = w8_linear(x, q, s, b, jax.nn.sigmoid)
    y32 = jax.nn.sigmoid(x @ w.T + b)
    # int8 weight error propagates mildly through logistic
    np.testing.assert_allclose(np.asarray(y8), np.asarray(y32), atol=0.02)


@pytest.mark.parametrize("B,o,i", [(1, 6, 16), (9, 130, 257)])
def test_w8_layer_matches_bf16_reference(B, o, i):
    """The w8 layer == bf16-rounded operands, float64 products, then the
    per-channel scale and bias."""
    x = jnp.asarray(r(400 + B, B, i), jnp.float32)
    w = jnp.asarray(r(401 + B, o, i) * 0.3, jnp.float32)
    b = jnp.asarray(r(402 + B, o) * 0.1, jnp.float32)
    q, s = quantize_weights_int8(w)
    y = w8_linear(x, q, s, b, lambda z: z)
    xb = np.asarray(x.astype(jnp.bfloat16).astype(jnp.float32), np.float64)
    want = (xb @ np.asarray(q, np.float64).T) * np.asarray(s).T \
        + np.asarray(b)
    assert y.shape == (B, o) and y.dtype == jnp.float32
    np.testing.assert_allclose(np.asarray(y), want, rtol=1e-5, atol=1e-5)


def test_fused_linear_w8a8_close_to_full_precision():
    """int8 x int8 -> int32: per-row activation quantization on top of
    per-channel weight quantization stays within the combined
    quantization error of the f32 result."""
    x = jnp.asarray(r(31, 8, 16), jnp.float32)
    w = jnp.asarray(r(32, 6, 16) * 0.3, jnp.float32)
    b = jnp.asarray(r(33, 6) * 0.1, jnp.float32)
    q, s = quantize_weights_int8(w)
    y8 = w8a8_linear(x, q, s, b, jax.nn.sigmoid)
    y32 = jax.nn.sigmoid(x @ w.T + b)
    np.testing.assert_allclose(np.asarray(y8), np.asarray(y32), atol=0.03)


def test_fused_linear_w8a8_int32_exact():
    """With integer-valued inputs that need no rounding, the int8 path is
    EXACT: the int32 accumulator carries no float error."""
    rr = np.random.default_rng(7)
    x = jnp.asarray(rr.integers(-127, 128, size=(5, 12)), jnp.float32)
    wq = jnp.asarray(rr.integers(-127, 128, size=(9, 12)), jnp.int8)
    sw = jnp.ones((9, 1), jnp.float32)
    b = jnp.zeros((9,), jnp.float32)
    # per-row activation scale is amax/127; integer x in [-127,127]
    # reproduces x / sx exactly only when amax==127, so force that
    x = x.at[:, 0].set(127.0)
    y = w8a8_linear(x, wq, sw, b, lambda z: z)
    want = np.asarray(x) @ np.asarray(wq, np.float32).T
    np.testing.assert_array_equal(np.asarray(y), want)


@pytest.mark.parametrize("B,o,i", [(1, 6, 16), (33, 10, 40), (40, 130, 257),
                                   (5, 128, 128)])
def test_fused_linear_w8a8_odd_shapes(B, o, i):
    """Odd batch and feature dims: the layer's shape and its quantized
    math against plain NumPy."""
    x = jnp.asarray(r(200 + B, B, i), jnp.float32)
    w = jnp.asarray(r(201 + B, o, i) * 0.3, jnp.float32)
    b = jnp.asarray(r(202 + B, o) * 0.1, jnp.float32)
    q, s = quantize_weights_int8(w)
    y = w8a8_linear(x, q, s, b, lambda z: z)
    assert y.shape == (B, o)
    xq, sx = quantize_acts_int8(x)
    want = (np.asarray(xq, np.int32) @ np.asarray(q, np.int32).T
            ).astype(np.float32) * np.asarray(sx) * np.asarray(s).T \
        + np.asarray(b)
    np.testing.assert_allclose(np.asarray(y), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("KN", [(64, 32), (100, 70)], ids=str)
@pytest.mark.parametrize("B", [1, 8, 16, 33])
def test_w8a8_layer_matches_integer_reference(B, KN):
    """The w8a8 layer == an independent NumPy quantize, an exact int64
    product, and the dequant + bias + relu epilogue, at batch sizes and
    widths on and off power-of-two blocks."""
    K, N = KN
    x = np.asarray(r(500 + B, B, K), np.float32)
    w = np.asarray(r(501 + B, N, K) * 0.2, np.float32)
    b = np.asarray(r(502 + B, N) * 0.1, np.float32)
    wq, sw = _np_quantize(w)
    xq, sx = _np_quantize(x)
    acc = xq.astype(np.int64) @ wq.astype(np.int64).T
    want = np.maximum(acc * sx.astype(np.float64) * sw.T + b, 0.0)
    y = w8a8_linear(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(sw),
                    jnp.asarray(b), lambda z: jnp.maximum(z, 0.0))
    np.testing.assert_allclose(np.asarray(y), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["w8", "w8a8"])
def test_quantized_mlp_matches_fused(jb, mode):
    from tensor_ops.backend.rng import Rng
    from tensor_ops.models import act_logistic, act_softmax, gen_net
    from tensor_ops.models.fast import FusedMLP, QuantizedMLP

    rng = Rng(jb, seed=0)
    net = gen_net(jb, 10, 4, [(8, act_logistic())], act_softmax(), rng)
    fm = FusedMLP.from_network(net, precision="highest")
    qm = QuantizedMLP.from_fused(fm, mode=mode)
    x = jnp.asarray(r(24, 5, 10), jnp.float32)
    pf = np.asarray(fm.run(x))
    pq = np.asarray(qm.run(x))
    np.testing.assert_allclose(pq.sum(axis=1), 1.0, atol=1e-5)
    assert (pf.argmax(axis=1) == pq.argmax(axis=1)).all()
    np.testing.assert_allclose(pq, pf, atol=0.05)


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_predictor_serves_model_run(kind):
    """Every FusedMLP/QuantizedMLP request goes through the model's one
    jitted forward; padding to the bucket changes nothing."""
    from tensor_ops.models.fast import FusedMLP, QuantizedMLP
    from tensor_ops.models.serve import Predictor

    rr = np.random.default_rng(4)
    m = FusedMLP(
        weights=[jnp.asarray(rr.normal(size=(6, 4)) * 0.3, jnp.float32),
                 jnp.asarray(rr.normal(size=(3, 6)) * 0.3, jnp.float32)],
        biases=[jnp.zeros((6,), jnp.float32), jnp.zeros((3,), jnp.float32)],
        acts=["logistic", "identity"], softmax_out=True)
    if kind == "int8":
        m = QuantizedMLP.from_fused(m)
    p = Predictor(m, buckets=(8,), dtype="bf16" if kind == "bf16" else None)
    x = rr.uniform(0, 1, size=(5, 4)).astype(np.float32)
    out = p.predict(x)
    assert out.shape == (5, 3)
    np.testing.assert_allclose(out.sum(axis=1), 1.0, atol=1e-5)
    want = np.asarray(p.model.run(jnp.asarray(np.pad(x, ((0, 3), (0, 0))))))
    np.testing.assert_allclose(out, want[:5], rtol=1e-6, atol=1e-7)


def test_fused_rnn_step_matches_recurrent_network(nb):
    """FusedRNN's scan step == the IR fullyConnected step: y is the
    pre-activation, new state is logistic(z) (Recurrent.hs:97-125)."""
    from tensor_ops.backend.rng import Rng
    from tensor_ops.models import act_logistic
    from tensor_ops.models.fast import FusedRNN
    from tensor_ops.models.recurrent import fully_connected

    rng = Rng(nb, seed=31)
    net = fully_connected(act_logistic(), nb, 3, 5, rng)
    frnn = FusedRNN.from_recurrent(net, precision="highest")
    x = r(30, 3)
    y_ref, net2 = net.run(nb, x)
    ys, snew = frnn.seq_forward(x[None])
    np.testing.assert_allclose(np.asarray(ys)[0], np.asarray(y_ref),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(snew), np.asarray(net2.states[0]),
                               atol=1e-5)


def test_fused_rnn_scan_bptt_matches_ir(nb):
    """FusedRNN.train: the summed sequence loss and the updated params
    match the IR ScanOp path's loss and gradients."""
    from tensor_ops.backend.rng import Rng
    from tensor_ops.models import act_logistic, squared_error
    from tensor_ops.models.fast import FusedRNN
    from tensor_ops.models.recurrent import fully_connected

    rng = Rng(nb, seed=32)
    net = fully_connected(act_logistic(), nb, 2, 3, rng)
    frnn = FusedRNN.from_recurrent(net)
    xs = r(33, 4, 2).astype(np.float32)
    tg = r(34, 4, 3).astype(np.float32)
    rS, rP = 0.01, 0.05
    v, m = frnn.train(rS, rP, xs, tg)
    want = float(np.asarray(net.seq_loss(squared_error(3), nb, xs, tg)))
    assert abs(v - want) < 1e-4, (v, want)
    _, gS, gP = net.seq_grad(squared_error(3), nb, xs, tg)
    wS, wX, bb = net.params  # IR params order: (wS, wX, b)
    for got, p, g in ((m.wS, wS, gP[0]), (m.wX, wX, gP[1]), (m.b, bb, gP[2]),
                      (m.s0, net.states[0], gS[0])):
        rate = rS if got is m.s0 else rP
        np.testing.assert_allclose(np.asarray(got), p - rate * np.asarray(g),
                                   atol=1e-5)


def test_fused_rnn_model_trains(nb):
    from tensor_ops.backend.rng import Rng
    from tensor_ops.models import act_logistic
    from tensor_ops.models.fast import FusedRNN
    from tensor_ops.models.recurrent import fully_connected

    rng = Rng(nb, seed=41)
    net = fully_connected(act_logistic(), nb, 1, 4, rng)
    frnn = FusedRNN.from_recurrent(net)
    t = np.linspace(0, 2 * np.pi, 13, dtype=np.float32)
    xs = np.sin(t[:-1]).reshape(-1, 1)
    # target only the first output unit tracks the next sample
    tg = np.zeros((12, 4), np.float32)
    tg[:, 0] = np.sin(t[1:])
    v0, m = frnn.train(0.02, 0.05, xs, tg)
    for _ in range(60):
        v, m = m.train(0.02, 0.05, xs, tg)
    assert v < 0.7 * v0, (v0, v)
    ys, s_final = m.seq_forward(xs)
    assert np.asarray(ys).shape == (12, 4) and np.asarray(s_final).shape == (4,)


def test_fused_autoencoder_style_mse_training(jb):
    """FusedMLP with loss_kind='mse' and no softmax trains an
    encoder-decoder reconstruction (the autoencoder fast path)."""
    from tensor_ops.backend.rng import Rng
    from tensor_ops.models import act_logistic, gen_net
    from tensor_ops.models.fast import FusedMLP

    rng = Rng(jb, seed=51)
    # 8 -> 3 -> 8 bottleneck as one chain
    net = gen_net(jb, 8, 8, [(3, act_logistic())], act_logistic(), rng)
    fm = FusedMLP.from_network(net, softmax_out=False, precision="highest")
    fm = FusedMLP(fm.weights, fm.biases, fm.acts, False, "highest", "mse")
    rr = np.random.default_rng(0)
    # rank-2 data through a logistic squashing -> reconstructable via a
    # 3-unit bottleneck
    z = rr.uniform(-1, 1, size=(16, 2))
    proj = rr.normal(size=(2, 8))
    xb = jnp.asarray(1 / (1 + np.exp(-(z @ proj))), jnp.float32)
    v0, m = fm.train(0.5, xb, xb)
    for _ in range(400):
        v, m = m.train(0.5, xb, xb)
    assert m.loss_kind == "mse"
    assert v < 0.3 * v0, (v0, v)


@pytest.mark.gpu
def test_w8_layer_reads_int8_weights_in_place():
    """On the card XLA folds the int8 -> bf16 weight convert into the GEMM
    fusion: the compiled program holds no bf16 copy of the weights."""
    N = 4096
    x = jnp.zeros((16, N), jnp.float32)
    q = jnp.zeros((N, N), jnp.int8)
    s = jnp.ones((N, 1), jnp.float32)
    b = jnp.zeros((N,), jnp.float32)
    hlo = jax.jit(lambda x, q, s, b: w8_linear(x, q, s, b, lambda z: z)) \
        .lower(x, q, s, b).compile().as_text()
    entry = hlo[hlo.index("\nENTRY"):]
    entry = entry[:entry.index("\n}")]
    sizes = [np.prod([int(d) for d in dims.split(",")])
             for dims in re.findall(r"bf16\[([0-9,]+)\]", entry)]
    assert all(n < N * N for n in sizes), entry
