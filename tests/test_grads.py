"""Gradient checks for every primitive op — BASELINE config 2
("gradient-check suite: gradTOp vs finite differences on every TOp
primitive"), with THREE oracles per composition:

1. central finite differences on the numpy backend (``check_grads``),
2. numpy-vs-jax parity (exercised by the shared graphs in
   ``test_backends.py`` / ``test_fuzz.py``),
3. ``jax.grad`` of the composed forward (``check_grads_vs_jax``) — an
   independent whole-graph AD that catches subtly-wrong-but-FD-close
   hand transpositions at ~1e-12 (VERDICT r3 item 3).
"""

import numpy as np
import pytest

from tensor_ops import prim as P
from tensor_ops.ops import ir

from helpers import check_grads, check_grads_vs_jax


from tensor_ops.testing import rand as r  # noqa: E402


def sq(shape):
    """Reduce a tensor to a scalar smoothly: sum of squares, via
    duplicate >> transp-the-copy >> full contraction."""
    sh = tuple(shape)
    return (
        P.duplicate(sh)
        >> P.second(P.transp_op(sh), front=[sh])
        >> P.gmul((), sh, ())
    )


def check_both(op, nb, jb, xs):
    """FD oracle on the numpy backend + jax.grad oracle on jax."""
    check_grads(op, nb, xs)
    check_grads_vs_jax(op, jb, xs)


def test_grad_gmul_cases(nb, jb):
    for ms, os, ns in [((2,), (3,), ()), ((2,), (3,), (4,)), ((2,), (3, 4), (5,)), ((), (3,), ())]:
        x = r(1, *(ms + os))
        y = r(2, *(tuple(reversed(os)) + ns))
        out_shape = ms + ns
        op = P.gmul(ms, os, ns) >> sq(out_shape)
        check_both(op, nb, jb, (x, y))


def test_grad_transp(nb, jb):
    x = r(3, 2, 3)
    op = P.transp_op((2, 3)) >> sq((3, 2))
    check_both(op, nb, jb, (x,))


def test_grad_sum_rows(nb, jb):
    x = r(4, 4, 3)
    op = P.sum_rows((4, 3)) >> sq((3,))
    check_both(op, nb, jb, (x,))


def test_grad_sum_op(nb, jb):
    xs = (r(5, 3), r(6, 3), r(7, 3))
    op = P.sum_op(3, (3,)) >> sq((3,))
    check_both(op, nb, jb, xs)


def test_grad_scale(nb, jb):
    x = r(8, 3)
    op = P.scale((3,), -1.7) >> sq((3,))
    check_both(op, nb, jb, (x,))


def test_grad_replicate(nb, jb):
    x = r(9, 3)
    op = P.replicate_op((3,), 2) >> P.dot(3)
    check_both(op, nb, jb, (x,))


def test_grad_konst_drops(nb, jb):
    x = r(10, 3)
    # konst contributes no gradient; x flows through dot with the constant
    op = P.konst(2.0, (3,), n=1).second(front=[(3,)]) >> P.dot(3)
    _, grads = ir.value_and_grad(op, nb, (x,))
    np.testing.assert_allclose(grads[0], np.full(3, 2.0))
    check_grads_vs_jax(op, jb, (x,))


def test_grad_diag_getdiag(nb, jb):
    v = r(11, 4)
    op = P.diag_op(4, 2) >> sq((4, 4))
    check_both(op, nb, jb, (v,))
    m = r(12, 4, 4)
    op2 = P.get_diag_op(4, 2) >> sq((4,))
    check_both(op2, nb, jb, (m,))


def test_grad_map_with_and_without_closed_form(nb, jb):
    import jax.numpy as jnp

    x = np.abs(r(13, 3)) + 0.5
    op = P.map_op((3,), lambda a: jnp.log(a), lambda a: 1.0 / a) >> sq((3,))
    check_both(op, nb, jb, (x,))
    # derivative derived via jax.grad (the reference's `ad`-package path)
    op2 = P.map_op((3,), lambda a: jnp.tanh(a) * a) >> sq((3,))
    check_both(op2, nb, jb, (np.asarray(x),))


def test_grad_zipn(nb, jb):
    xs = (r(14, 3), r(15, 3), r(16, 3))
    op = P.zip3_op((3,), lambda a, b, c: a * b * c,
                   lambda a, b, c: (b * c, a * c, a * b)) >> sq((3,))
    check_both(op, nb, jb, xs)


def test_grad_inner_outer(nb, jb):
    x, y = r(17, 3), r(18, 4)
    op = P.outer((3,), (4,)) >> sq((3, 4))
    check_both(op, nb, jb, (x, y))
    w, v = r(19, 3, 4), r(20, 4)
    op2 = P.inner((3,), 4, ()) >> sq((3,))
    check_both(op2, nb, jb, (w, v))


def test_grad_deep_chain(nb, jb):
    """Deep composed chain: tape-based transposition stays exact (and
    O(depth), unlike the reference's recompute chain rule)."""
    import jax.numpy as jnp

    op = P.identity([(3,)])
    for _ in range(12):
        op = op >> P.map_op((3,), lambda a: jnp.tanh(a))
    op = op >> sq((3,))
    check_both(op, nb, jb, (r(21, 3),))


def test_jax_oracle_catches_wrong_vjp(nb, jb):
    """The jax.grad oracle is live: a deliberately wrong (but
    FD-plausible at loose tolerance) closed-form map gradient trips it."""
    import jax.numpy as jnp

    x = r(22, 3)
    wrong = P.map_op((3,), lambda a: jnp.tanh(a),
                     lambda a: 1.0 - jnp.tanh(a) ** 2 + 1e-4) >> sq((3,))
    with pytest.raises(AssertionError, match="jax.grad"):
        check_grads_vs_jax(wrong, jb, (x,))
