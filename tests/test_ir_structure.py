"""Composition-law and structure-combinator tests — the rebuild of the
reference's compile-time guarantees (SURVEY.md §4: composition laws,
``firstOp``/``secondOp`` coherence, ``(&&&)`` gradient-sum semantics per
``Types.hs:258-263``, ``shuffle`` zero-fill/fan-in-sum per
``TOp.hs:106-131``)."""

import numpy as np
import pytest

import tensor_ops as T
from tensor_ops import prim as P
from tensor_ops.ops import ir
from tensor_ops.ops.shapes import ShapeError

from helpers import check_grads


def r(*shape):
    return np.random.default_rng(hash(shape) % 2**32).normal(size=shape)


def test_identity(nb):
    x = r(3)
    op = P.identity([(3,)])
    assert np.allclose(ir.run(op, nb, (x,))[0], x)


def test_compose_mismatch_raises():
    with pytest.raises(ShapeError):
        P.mat_vec(3, 2) >> P.dot(4)


def test_compose_associativity(nb):
    a = P.map_op((3,), lambda x: x * 2, lambda x: 2.0 * (x * 0 + 1))
    b = P.map_op((3,), lambda x: x + 1, lambda x: x * 0 + 1.0)
    c = P.sum_rows((3,))
    x = r(3)
    left = ir.run((a >> b) >> c, nb, (x,))[0]
    right = ir.run(a >> (b >> c), nb, (x,))[0]
    assert np.allclose(left, right)


def test_identity_laws(nb):
    op = P.mat_vec(3, 2)
    x = (r(3, 2), r(2))
    base = ir.run(op, nb, x)[0]
    pre = P.identity([(3, 2), (2,)]) >> op
    post = op >> P.identity([(3,)])
    assert np.allclose(ir.run(pre, nb, x)[0], base)
    assert np.allclose(ir.run(post, nb, x)[0], base)


def test_first_second(nb):
    dbl = P.scale((2,), 2.0)
    x, y = r(2), r(3)
    f = P.first(dbl, rest=[(3,)])
    outs = ir.run(f, nb, (x, y))
    assert np.allclose(outs[0], 2 * x) and np.allclose(outs[1], y)
    s = P.second(dbl, front=[(3,)])
    outs = ir.run(s, nb, (y, x))
    assert np.allclose(outs[0], y) and np.allclose(outs[1], 2 * x)


def test_par(nb):
    f = P.scale((2,), 2.0)
    g = P.scale((3,), -1.0)
    x, y = r(2), r(3)
    outs = ir.run(P.par(f, g), nb, (x, y))
    assert np.allclose(outs[0], 2 * x) and np.allclose(outs[1], -y)


def test_fanout_forward(nb):
    f = P.scale((2,), 2.0)
    g = P.scale((2,), 3.0)
    x = r(2)
    outs = ir.run(P.fanout(f, g), nb, (x,))
    assert np.allclose(outs[0], 2 * x) and np.allclose(outs[1], 3 * x)


def test_fanout_gradient_sums(nb):
    # (&&& gradient = sum of both branches' cotangent pullbacks,
    # Types.hs:258-263): f = 2x, g = 3x, loss = dot(f,g) -> d/dx = 12x
    x = r(2)
    op = P.fanout(P.scale((2,), 2.0), P.scale((2,), 3.0)) >> P.dot(2)
    _, grads = ir.value_and_grad(op, nb, (x,))
    assert np.allclose(grads[0], 12 * x)
    check_grads(op, nb, (x,))


def test_shuffle_forward(nb):
    x, y = r(2), r(3)
    op = P.shuffle([(2,), (3,)], [1, 0, 0])
    outs = ir.run(op, nb, (x, y))
    assert np.allclose(outs[0], y)
    assert np.allclose(outs[1], x) and np.allclose(outs[2], x)


def test_shuffle_grad_fanin_and_zero(nb):
    # input 0 used twice (cotangents sum), input 1 unused (zero grad)
    x, y = r(2), r(2)
    op = P.shuffle([(2,), (2,)], [0, 0]) >> P.dot(2)
    _, grads = ir.value_and_grad(op, nb, (x, y))
    assert np.allclose(grads[0], 2 * x)
    assert np.allclose(grads[1], 0.0)


def test_swap_and_blocks(nb):
    x, y, z = r(2), r(3), r(4)
    sw = P.swap((2,), (3,))
    outs = ir.run(sw, nb, (x, y))
    assert np.allclose(outs[0], y) and np.allclose(outs[1], x)
    sb = P.swap_blocks([(2,), (3,)], [(4,)])
    outs = ir.run(sb, nb, (x, y, z))
    assert np.allclose(outs[0], z)
    assert np.allclose(outs[1], x) and np.allclose(outs[2], y)


def test_drop_take_zero_grads(nb):
    x, y = r(2), r(2)
    op = P.drop([(2,)], [(2,)]) >> P.duplicate((2,)) >> P.dot(2)
    _, grads = ir.value_and_grad(op, nb, (x, y))
    assert np.allclose(grads[0], 0.0)  # dropped slot: zero-filled
    assert np.allclose(grads[1], 2 * y)
    op2 = P.take([(2,)], [(2,)]) >> P.duplicate((2,)) >> P.dot(2)
    _, grads2 = ir.value_and_grad(op2, nb, (x, y))
    assert np.allclose(grads2[0], 2 * x)
    assert np.allclose(grads2[1], 0.0)


def test_lead_infers_passthrough(nb):
    # f *>> g with f: [2]->[2], g: [[2],[2]] -> scalar
    f = P.scale((2,), 2.0)
    g = P.dot(2)
    x, y = r(2), r(2)
    v = ir.run(f.lead(g), nb, (x, y))[0]
    assert np.isclose(v, float((2 * x) @ y))


def test_fanout_requires_same_inputs():
    with pytest.raises(ShapeError):
        P.fanout(P.scale((2,), 1.0), P.scale((3,), 1.0))


def test_mapped_op_multi_output(nb, jb):
    """MappedOp over an op with several outputs (duplicate)."""
    from tensor_ops.ops.loops import MappedOp

    m = MappedOp(P.duplicate((3,)), 4)
    xsb = r(4, 3)
    for be in (nb, jb):
        outs = ir.run(m, be, (be.asarray(xsb),))
        assert len(outs) == 2
        np.testing.assert_allclose(np.asarray(outs[0]), xsb, atol=1e-12)
        np.testing.assert_allclose(np.asarray(outs[1]), xsb, atol=1e-12)
    # transpose: cotangents from both outputs sum
    g = m >> MappedOp(P.dot(3), 4) >> P.sum_rows((4,))
    _, grads = ir.value_and_grad(g, nb, (xsb,))
    np.testing.assert_allclose(grads[0], 2 * xsb, atol=1e-10)


def test_konst_multi_output_in_graph(nb):
    op = P.konst(3.0, (2,), n=2) >> P.dot(2)
    v = ir.run(op, nb, ())[0]
    assert np.isclose(v, 18.0)  # [3,3].[3,3]
    # grad over empty input stack works
    _, grads = ir.value_and_grad(op, nb, ())
    assert grads == ()


def test_deep_composition_stress(nb):
    """200-node chain builds, runs, and differentiates in O(depth)."""
    op = P.identity([(4,)])
    for _ in range(200):
        op = op >> P.scale((4,), 1.001)
    op = op >> P.duplicate((4,)) >> P.dot(4)
    x = r(4)
    v, grads = ir.value_and_grad(op, nb, (x,))
    scale = 1.001 ** 200
    np.testing.assert_allclose(grads[0], 2 * x * scale * scale, rtol=1e-9)


def test_remat_gradients_identical(nb):
    """remat(op) computes the same values and gradients as op, storing
    only inputs as residuals."""
    import jax.numpy as jnp

    chain = P.map_op((3,), lambda a: jnp.tanh(a)) >> P.map_op((3,), lambda a: a * a + a)
    plain = chain >> P.duplicate((3,)) >> P.dot(3)
    ckpt = P.remat(chain) >> P.duplicate((3,)) >> P.dot(3)
    x = r(3)
    v1, g1 = ir.value_and_grad(plain, nb, (x,))
    v2, g2 = ir.value_and_grad(ckpt, nb, (x,))
    assert np.isclose(v1, v2)
    np.testing.assert_allclose(g1[0], g2[0], atol=1e-12)
    # the remat tape is exactly the input tuple
    from tensor_ops.ops.loops import Remat

    node = Remat(chain)
    _, tape = node.apply_tape(nb, (x,))
    assert isinstance(tape, tuple) and len(tape) == 1 and tape[0] is x


def test_runtime_shape_validation(nb):
    """Arrays that do not match the declared stack fail loudly at the
    entry point, not deep inside a backend op."""
    op = P.mat_vec(3, 2)
    with pytest.raises(ShapeError, match="slot 1"):
        ir.run(op, nb, (r(3, 2), r(3)))  # vec should be (2,)
    with pytest.raises(ShapeError, match="slot 0"):
        ir.value_and_grad(P.dot(3), nb, (r(4), r(3)))


def test_describe_and_graph_stats(nb):
    """ops.describe renders every node with its stack signature;
    graph_stats counts nodes/depth/leaf types; max_depth truncates."""
    from tensor_ops.backend.rng import Rng
    from tensor_ops.models import act_logistic, act_softmax, gen_net
    from tensor_ops.ops import describe, graph_stats

    net = gen_net(nb, 4, 2, [(3, act_logistic())], act_softmax(),
                  Rng(nb, seed=0))
    full = describe(net.op)
    assert "Compose" in full and "GMul" in full and "->" in full
    assert full.count("\n") + 1 == graph_stats(net.op)["nodes"]

    short = describe(net.op, max_depth=2)
    assert "more nodes" in short and short.count("\n") < full.count("\n")

    s = graph_stats(net.op)
    assert s["nodes"] == 27 and s["depth"] >= 5
    assert s["leaves"]["GMul"] == 3          # matVec + 2 softmax gmuls
    assert "[4]" in s["signature"]

    # scan/mapped nodes expose their inner step too
    from tensor_ops.ops.loops import ScanOp
    from tensor_ops.ops import prim as P

    scan = ScanOp(P.add((3,)).first(rest=[(3,)]), n=4, n_state=1)
    assert "step: First" in describe(scan) and "SumOp" in describe(scan)


def test_describe_handles_deep_chains(nb):
    """Regression (review): introspection is iterative — a then-chain
    far beyond Python's recursion depth renders and counts fine, and
    max_depth truncation doesn't recurse into the suppressed subtree."""
    from tensor_ops.ops import describe, graph_stats
    from tensor_ops.ops import prim as P

    g = P.map_op((4,), lambda x: x, name="id0")
    for i in range(1200):
        g = g >> P.map_op((4,), lambda x: x, name=f"id{i}")
    s = graph_stats(g)
    assert s["nodes"] == 2401 and s["depth"] >= 1200
    short = describe(g, max_depth=3)
    assert "more nodes" in short and short.count("\n") < 20
