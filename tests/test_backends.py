"""NumPy-oracle vs JAX/XLA backend parity (<=1e-6 forward and backward;
achieved at ~1e-12 in f64)."""

import numpy as np

import tensor_ops as T
from tensor_ops import prim as P
from tensor_ops.ops import ir
from tensor_ops.models import (
    act_logistic,
    act_softmax,
    cross_entropy,
    gen_net,
    squared_error,
)
from tensor_ops.models.feedforward import Network
from tensor_ops.backend.rng import Rng

TOL = 1e-9


from tensor_ops.testing import rand as r  # noqa: E402


def _to_jax(jb, xs):
    return tuple(jb.asarray(x) for x in xs)


def assert_parity(op, nb, jb, xs, grad=False):
    outs_n = ir.run(op, nb, xs)
    outs_j = ir.run(op, jb, _to_jax(jb, xs))
    for a, b in zip(outs_n, outs_j):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=TOL)
    if grad:
        _, gn = ir.value_and_grad(op, nb, xs)
        _, gj = ir.value_and_grad(op, jb, _to_jax(jb, xs))
        for a, b in zip(gn, gj):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=TOL)


def test_gmul_parity(nb, jb):
    for ms, os, ns in [((2,), (3,), ()), ((2,), (3, 4), (5,)), ((), (3,), ()), ((2, 3), (4,), (5, 2))]:
        x = r(1, *(ms + os))
        y = r(2, *(tuple(reversed(os)) + ns))
        assert_parity(P.gmul(ms, os, ns), nb, jb, (x, y))


def test_pipeline_grad_parity(nb, jb):
    # full softmax + cross-entropy pipeline
    from tensor_ops.models.neuralnet import softmax

    v = r(3, 5)
    t = np.zeros(5)
    t[2] = 1.0
    op = P.first(softmax(5), rest=[(5,)]) >> cross_entropy(5)
    assert_parity(op, nb, jb, (v, t), grad=True)


def test_network_training_parity(nb, jb):
    rng = Rng(nb, seed=7)
    net = gen_net(nb, 6, 3, [(5, act_logistic())], act_softmax(), rng)
    x = r(4, 6)
    y = np.zeros(3)
    y[1] = 1.0
    loss = cross_entropy(3)
    jnet = Network(net.op, _to_jax(jb, net.params))
    # loss values
    assert abs(net.loss_value(loss, nb, x, y) - float(jnet.loss_value(loss, jb, jb.asarray(x), jb.asarray(y)))) < TOL
    # 5 sgd steps
    n1, n2 = net, jnet
    for k in range(5):
        n1 = n1.train(loss, 0.1, nb, x, y)
        n2 = n2.train(loss, 0.1, jb, jb.asarray(x), jb.asarray(y))
    for a, b in zip(n1.params, n2.params):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=TOL)


def test_jit_cache_reuse(jb):
    """Repeated runs reuse the same compiled program (cache keyed on the
    op object)."""
    op = P.mat_vec(3, 2)
    from tensor_ops import engine

    f1 = engine.compile_run(op, jb)
    f2 = engine.compile_run(op, jb)
    assert f1 is f2


def test_loss_curve_parity_across_backends(nb, jb):
    """BASELINE north star: reproducible loss curves — per-sample SGD on
    the dots task tracks between the NumPy-f64 oracle and the JAX-f64
    path to 1e-9 at every step over a 60-step run."""
    from tensor_ops.backend.rng import Rng
    from tensor_ops.models import act_logistic, gen_net, squared_error

    rng = Rng(nb, seed=20)
    net_n = gen_net(nb, 2, 1, [(8, act_logistic())], act_logistic(), rng)
    net_j = Network(net_n.op, _to_jax(jb, net_n.params), net_n.act_names)
    loss = squared_error(1)

    r_ = np.random.default_rng(21)
    X = r_.uniform(-1, 1, size=(60, 2))
    Y = (np.linalg.norm(X, axis=1) < 0.7).astype(np.float64).reshape(-1, 1)

    curve_n, curve_j = [], []
    for k in range(60):
        curve_n.append(float(np.asarray(net_n.loss_value(loss, nb, X[k], Y[k]))))
        curve_j.append(float(np.asarray(net_j.loss_value(
            loss, jb, jb.asarray(X[k]), jb.asarray(Y[k])))))
        net_n = net_n.train(loss, 1.0, nb, X[k], Y[k])
        net_j = net_j.train(loss, 1.0, jb, jb.asarray(X[k]), jb.asarray(Y[k]))
    diffs = np.abs(np.asarray(curve_n) - np.asarray(curve_j))
    # f64 on both backends: the curves agree to 1e-9
    assert diffs.max() < 1e-9, diffs.max()
    assert np.isfinite(curve_n).all()
    # (convergence itself is asserted in test_models/test_apps; this test
    # pins the *bitwise-tracking* property of the two backends' curves)
