"""Per-primitive forward semantics, on both backends, against hand
computations and the triple-loop gmul oracle (SURVEY.md §7.3 hard part 1:
exact ``(ms++os) x (Reverse os++ns) -> (ms++ns)`` semantics)."""

import numpy as np
import pytest

from tensor_ops import prim as P
from tensor_ops.ops import ir

from helpers import loop_gmul


from tensor_ops.testing import rand as r  # noqa: E402


GMUL_CASES = [
    # (ms, os, ns)
    ((), (), ()),        # scalar * scalar
    ((), (3,), ()),      # dot
    ((2,), (3,), ()),    # matVec
    ((), (2,), (3,)),    # vecMat
    ((2,), (3,), (4,)),  # matMat
    ((2,), (), (3,)),    # outer
    ((2, 3), (), ()),    # right-scalar scale
    ((2,), (3, 4), (5,)),        # rank-3 contraction over 2 axes
    ((2, 3), (4,), (5, 2)),      # rank-3 x rank-3
    ((), (2, 3, 2), ()),         # full contraction rank 3
]


@pytest.mark.parametrize("ms,os,ns", GMUL_CASES)
def test_gmul_matches_loop_oracle(backends, ms, os, ns):
    x = r(1, *(ms + os))
    y = r(2, *(tuple(reversed(os)) + ns))
    want = loop_gmul(len(ms), len(os), len(ns), x, y)
    for be in backends:
        got = np.asarray(ir.run(P.gmul(ms, os, ns), be, (be.asarray(x), be.asarray(y)))[0])
        np.testing.assert_allclose(got, want, atol=1e-10, err_msg=be.name)


def test_matvec_family(backends):
    w, x = r(3, 3, 2), r(4, 2)
    a, b = r(5, 2, 3), r(6, 3, 4)
    v = r(7, 3)
    for be in backends:
        np.testing.assert_allclose(
            np.asarray(ir.run(P.mat_vec(3, 2), be, (be.asarray(w), be.asarray(x)))[0]),
            w @ x, atol=1e-10)
        np.testing.assert_allclose(
            np.asarray(ir.run(P.mat_mat(2, 3, 4), be, (be.asarray(a), be.asarray(b)))[0]),
            a @ b, atol=1e-10)
        np.testing.assert_allclose(
            np.asarray(ir.run(P.vec_mat(3, 4), be, (be.asarray(v), be.asarray(b)))[0]),
            v @ b, atol=1e-10)
        np.testing.assert_allclose(
            np.asarray(ir.run(P.dot(3), be, (be.asarray(v), be.asarray(v)))[0]),
            v @ v, atol=1e-10)
        np.testing.assert_allclose(
            np.asarray(ir.run(P.outer((3,), (2,)), be, (be.asarray(v), be.asarray(x)))[0]),
            np.outer(v, x), atol=1e-10)


def test_transp_full_reversal(backends):
    x = r(8, 2, 3, 4)
    for be in backends:
        got = np.asarray(ir.run(P.transp_op((2, 3, 4)), be, (be.asarray(x),))[0])
        np.testing.assert_allclose(got, np.transpose(x, (2, 1, 0)))


def test_sum_rows(backends):
    x = r(9, 4, 3)
    for be in backends:
        got = np.asarray(ir.run(P.sum_rows((4, 3)), be, (be.asarray(x),))[0])
        np.testing.assert_allclose(got, x.sum(axis=0))


def test_sum_op_scale_negate(backends):
    x, y, z = r(10, 3), r(11, 3), r(12, 3)
    for be in backends:
        np.testing.assert_allclose(
            np.asarray(ir.run(P.add((3,)), be, (be.asarray(x), be.asarray(y)))[0]), x + y)
        np.testing.assert_allclose(
            np.asarray(ir.run(P.add3((3,)), be, (be.asarray(x), be.asarray(y), be.asarray(z)))[0]),
            x + y + z)
        np.testing.assert_allclose(
            np.asarray(ir.run(P.scale((3,), 2.5), be, (be.asarray(x),))[0]), 2.5 * x)
        np.testing.assert_allclose(
            np.asarray(ir.run(P.negate((3,)), be, (be.asarray(x),))[0]), -x)


def test_konst_replicate_duplicate(backends):
    x = r(13, 3)
    for be in backends:
        outs = ir.run(P.konst(2.0, (2, 2), n=3), be, ())
        assert len(outs) == 3
        np.testing.assert_allclose(np.asarray(outs[1]), np.full((2, 2), 2.0))
        outs = ir.run(P.replicate_op((3,), 4), be, (be.asarray(x),))
        assert len(outs) == 4 and np.allclose(np.asarray(outs[3]), x)
        outs = ir.run(P.duplicate((3,)), be, (be.asarray(x),))
        assert len(outs) == 2


def test_diag_getdiag(backends):
    v = r(14, 4)
    for be in backends:
        d = np.asarray(ir.run(P.diag_op(4, 2), be, (be.asarray(v),))[0])
        np.testing.assert_allclose(d, np.diag(v))
        d3 = np.asarray(ir.run(P.diag_op(4, 3), be, (be.asarray(v),))[0])
        assert d3.shape == (4, 4, 4)
        assert np.isclose(d3[2, 2, 2], v[2]) and d3[0, 1, 2] == 0
        back = np.asarray(ir.run(P.get_diag_op(4, 3), be, (be.asarray(d3),))[0])
        np.testing.assert_allclose(back, v)


def test_map_zip(backends):
    x, y = r(15, 3), r(16, 3)
    for be in backends:
        got = np.asarray(ir.run(
            P.zip_op((3,), lambda a, b: a * b), be, (be.asarray(x), be.asarray(y)))[0])
        np.testing.assert_allclose(got, x * y)
        got = np.asarray(ir.run(
            P.zip3_op((3,), lambda a, b, c: a * b + c), be,
            (be.asarray(x), be.asarray(y), be.asarray(x)))[0])
        np.testing.assert_allclose(got, x * y + x)
