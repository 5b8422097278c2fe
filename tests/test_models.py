"""Learn-layer tests: activation/loss values and end-to-end training
convergence (the dots integration gate, SURVEY.md §7.2 step 5)."""

import numpy as np

import tensor_ops as T
from tensor_ops.backend.rng import Rng
from tensor_ops.models import (
    act_logistic,
    act_softmax,
    cross_entropy,
    gen_net,
    squared_error,
)
from tensor_ops.models.neuralnet import logistic, softmax
from tensor_ops.ops import ir

from helpers import check_grads


def test_softmax_values(nb):
    v = np.array([1.0, 2.0, 3.0])
    got = ir.run(softmax(3), nb, (v,))[0]
    e = np.exp(v)
    np.testing.assert_allclose(got, e / e.sum(), atol=1e-12)


def test_softmax_grad(nb):
    v = np.random.default_rng(0).normal(size=4)
    t = np.array([0.0, 1.0, 0.0, 0.0])
    from tensor_ops import prim as P

    op = P.first(softmax(4), rest=[(4,)]) >> cross_entropy(4)
    check_grads(op, nb, (v, t))
    # closed form: d/dz of CE(softmax(z), t) = softmax(z) - t
    _, grads = ir.value_and_grad(op, nb, (v, t))
    sm = np.exp(v) / np.exp(v).sum()
    np.testing.assert_allclose(grads[0], sm - t, atol=1e-8)


def test_squared_error_value_and_grad(nb):
    p = np.array([1.0, 2.0])
    t = np.array([0.5, 1.0])
    v = ir.run(squared_error(2), nb, (p, t))[0]
    assert np.isclose(v, ((t - p) ** 2).sum())
    check_grads(squared_error(2), nb, (p, t))


def test_cross_entropy_value(nb):
    p = np.array([0.2, 0.5, 0.3])
    t = np.array([0.0, 1.0, 0.0])
    v = ir.run(cross_entropy(3), nb, (p, t))[0]
    assert np.isclose(v, -np.log(0.5))


def test_logistic_matches_closed_form():
    assert np.isclose(logistic(np.array(0.0)), 0.5)


def test_training_decreases_loss(nb):
    rng = Rng(nb, seed=3)
    net = gen_net(nb, 2, 1, [(8, act_logistic())], act_logistic(), rng)
    loss = squared_error(1)
    data = [
        (np.array([0.5, 0.5]), np.array([1.0])),
        (np.array([-0.5, -0.5]), np.array([0.0])),
    ]
    before = sum(net.loss_value(loss, nb, x, y) for x, y in data)
    n = net
    for _ in range(100):
        for x, y in data:
            n = n.train(loss, 1.0, nb, x, y)
    after = sum(n.loss_value(loss, nb, x, y) for x, y in data)
    assert after < before * 0.05


def test_induce_moves_input_toward_target(nb):
    rng = Rng(nb, seed=5)
    net = gen_net(nb, 2, 1, [(6, act_logistic())], act_logistic(), rng)
    loss = squared_error(1)
    y = np.array([1.0])
    x = np.array([0.0, 0.0])
    l0 = net.loss_value(loss, nb, x, y)
    for _ in range(50):
        x = net.induce(loss, 0.5, nb, y, x)
    l1 = net.loss_value(loss, nb, x, y)
    assert l1 < l0


def test_network_compose_and_maps(nb):
    rng = Rng(nb, seed=1)
    from tensor_ops.models.feedforward import ff_layer

    a = ff_layer(nb, 2, 3, rng)
    b = ff_layer(nb, 3, 1, rng)
    net = a.then(b)
    x = np.array([1.0, -1.0])
    got = net.run(nb, x)
    wa, ba = a.params
    wb, bb = b.params
    np.testing.assert_allclose(got, wb @ (wa @ x + ba) + bb, atol=1e-12)
    doubled = net.nmap(lambda v: v * 2.0)
    np.testing.assert_allclose(doubled.run(nb, x), 2 * got, atol=1e-12)


def test_train_fold_matches_per_sample_loop(nb, jb):
    """Scanned per-sample SGD == the sequential fold (reference trainAll
    semantics, MNIST.hs:390-396)."""
    from tensor_ops.models.feedforward import Network
    from tensor_ops.models.training import train_fold

    rng = Rng(nb, seed=11)
    net = gen_net(nb, 3, 2, [(4, act_logistic())], act_logistic(), rng)
    loss = squared_error(2)
    r = np.random.default_rng(0)
    X = r.uniform(-1, 1, size=(7, 3))
    Y = r.uniform(0.1, 0.9, size=(7, 2))
    seq = net
    for x, y in zip(X, Y):
        seq = seq.train(loss, 0.3, nb, x, y)
    folded = train_fold(net, loss, nb, 0.3, X, Y)
    for a, b in zip(seq.params, folded.params):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-12)
    jnet = Network(net.op, tuple(jb.asarray(p) for p in net.params))
    jfold = train_fold(jnet, loss, jb, 0.3, jb.asarray(X), jb.asarray(Y))
    for a, b in zip(seq.params, jfold.params):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-9)
