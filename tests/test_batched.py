"""Batched lowering (models/batched.py): the batch-mean loss as a
BATCHED staged-IR graph must produce exactly the vmapped per-sample
mean gradients — while its weight gradients are GEMMs by construction
(the bf16 fix: XLA need not rewrite stacked per-sample outer products
into a GEMM for bf16)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import tensor_ops as T
from tensor_ops.backend.rng import Rng
from tensor_ops.models import (
    act_logistic,
    act_relu,
    act_softmax,
    cross_entropy,
    gen_net,
    squared_error,
)
from tensor_ops.models.batched import (
    batch_network_op,
    batched_loss_graph,
)
from tensor_ops.ops import ir


def _net(be, seed=0):
    return gen_net(be, 7, 4, [(6, act_logistic()), (5, act_relu())],
                   act_softmax(), Rng(be, seed=seed))


@pytest.mark.parametrize("loss_fn", [cross_entropy, squared_error])
def test_batched_grads_equal_vmapped_mean(jb, loss_fn):
    net = _net(jb)
    loss = loss_fn(4)
    B = 9
    r = np.random.default_rng(0)
    xb = jb.asarray(r.uniform(0, 1, size=(B, 7)))
    yb = jb.asarray(np.eye(4)[r.integers(0, 4, size=B)])
    g = batched_loss_graph(net, loss, B)
    assert g is not None
    v, grads = ir.value_and_grad(g, jb, (xb,) + net.params + (yb,))

    comp = net._loss_op(loss)

    def one(x, y, *ps):
        vv, gg = ir.value_and_grad(comp, jb, (x,) + ps + (y,))
        return vv, gg[1:-1]

    vals, pg = jax.vmap(one, in_axes=(0, 0) + (None,) * len(net.params))(
        xb, yb, *net.params)
    assert abs(float(v) - float(jnp.mean(vals))) < 1e-11
    for a, b in zip(grads[1:-1], pg):
        np.testing.assert_allclose(np.asarray(a),
                                   np.asarray(jnp.mean(b, axis=0)),
                                   atol=1e-11, rtol=0)


def test_batched_forward_equals_per_sample(nb, jb):
    """The batched network op == per-sample runs, on BOTH backends (the
    numpy oracle executes BroadcastRows/batched GMul too)."""
    for be in (nb, jb):
        net = _net(be, seed=3)
        B = 5
        bop = batch_network_op(net.op, B)
        assert bop is not None
        r = np.random.default_rng(1)
        xb = be.asarray(r.uniform(0, 1, size=(B, 7)))
        out = np.asarray(ir.run(bop, be, (xb,) + net.params)[0])
        for k in range(B):
            want = np.asarray(net.run(be, be.asarray(np.asarray(xb)[k])))
            np.testing.assert_allclose(out[k], want, atol=1e-12, rtol=0)


def test_batched_graph_caches_and_rejects_unknown(jb):
    from tensor_ops.ops import prim as P
    from tensor_ops.models.feedforward import Network

    net = _net(jb)
    loss = cross_entropy(4)
    g1 = batched_loss_graph(net, loss, 8)
    g2 = batched_loss_graph(net, loss, 8)
    assert g1 is g2  # cached

    # a matrix-input matVec net is outside the supported family -> None
    w = jb.asarray(np.ones((3,)))
    odd = Network(P.first(P.mat_vec(3, 3), rest=[]), (w,))
    assert batch_network_op(odd.op, 4) is None


def test_broadcast_rows_primitive(nb, jb):
    from tensor_ops.ops import prim as P
    from tensor_ops.testing import check_grads

    op = P.broadcast_rows((3,), 4)
    # scalar-output wrapper for the FD check: broadcast, square, sum
    scalar = (op >> P.map_op((4, 3), lambda x: x * x)
              >> P.sum_rows((4, 3)) >> P.sum_rows((3,)))
    for be in (nb, jb):
        v = be.asarray(np.arange(3.0))
        out = np.asarray(ir.run(op, be, (v,))[0])
        assert out.shape == (4, 3)
        np.testing.assert_array_equal(out, np.tile(np.arange(3.0), (4, 1)))
        check_grads(scalar, be, (v,))


def test_fit_mixed_precision_uses_batched_graph(jb):
    """fit(mixed_precision=True) routes through the batched lowering
    (the graph lands in the cache) and still converges."""
    from tensor_ops.models.trainer import fit

    net = _net(jb, seed=5)
    r = np.random.default_rng(2)
    X = r.uniform(0, 1, size=(64, 7))
    proj = r.normal(size=(7, 4))
    Y = np.eye(4)[np.argmax(X @ proj, axis=1)]  # learnable labels
    res = fit(net, cross_entropy(4), jb, X, Y, epochs=8, batch_size=16,
              lr=0.5, mixed_precision="bf16", verbose=False, log_every=1)
    losses = [h["loss"] for h in res.history]
    assert all(np.isfinite(v) for v in losses)
    # bf16 steps are noisy: compare trailing mean against the start
    assert np.mean(losses[-4:]) < losses[0], losses
    keys = [k for k in net.op._compiled
            if isinstance(k, tuple) and k and k[0] == "batched_loss"]
    assert keys, "mixed precision did not build the batched graph"
