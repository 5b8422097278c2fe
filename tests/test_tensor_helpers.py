"""Value-level Tensor helper API tests (``src/TensorOps/Tensor.hs`` parity)."""

import numpy as np
import pytest

from tensor_ops import tensor as TT
from tensor_ops.ops.shapes import ShapeError


from tensor_ops.testing import rand as r  # noqa: E402


def test_konst_map_zip(backends):
    for be in backends:
        k = TT.konst(be, 2.5, (2, 3))
        assert np.allclose(np.asarray(k), 2.5)
        m = TT.tmap(be, lambda v: v * 2, be.asarray(r(0, 3)), lambda v: 2.0 + 0 * v)
        assert np.allclose(np.asarray(m), 2 * r(0, 3))
        z = TT.tzip(be, lambda a, b: a * b, be.asarray(r(1, 3)), be.asarray(r(2, 3)))
        assert np.allclose(np.asarray(z), r(1, 3) * r(2, 3))


def test_contraction_helpers(backends):
    x, y = r(3, 4), r(4, 4)
    m = r(5, 3, 4)
    for be in backends:
        assert np.isclose(float(np.asarray(TT.dot(be, be.asarray(x), be.asarray(y)))), x @ y)
        np.testing.assert_allclose(
            np.asarray(TT.mat_vec(be, be.asarray(m), be.asarray(x))), m @ x, atol=1e-9)
        np.testing.assert_allclose(
            np.asarray(TT.vec_mat(be, be.asarray(r(6, 3)), be.asarray(m))),
            r(6, 3) @ m, atol=1e-9)
        np.testing.assert_allclose(
            np.asarray(TT.outer_v(be, be.asarray(x), be.asarray(y))),
            np.outer(x, y), atol=1e-9)
        np.testing.assert_allclose(
            np.asarray(TT.outer(be, be.asarray(m), be.asarray(x))),
            np.multiply.outer(m, x), atol=1e-9)


def test_from_list_and_iteration(nb):
    t = TT.from_list(nb, [1, 2, 3, 4, 5, 6], (2, 3))
    assert t.shape == (2, 3) and t[1, 2] == 6
    with pytest.raises(ShapeError):
        TT.from_list(nb, [1, 2], (2, 3))
    assert TT.to_list(nb, t) == [1, 2, 3, 4, 5, 6]
    assert TT.elems(nb, t) == [1, 2, 3, 4, 5, 6]
    assert TT.ito_list(nb, t)[3] == ((1, 0), 4.0)
    assert len(TT.rows(nb, t)) == 2
    assert TT.un_scalar(nb, TT.from_list(nb, [7.0], ())) == 7.0


def test_generate_one_hot_argmax(nb):
    g = TT.generate(nb, (2, 2), lambda idx: idx[0] * 10 + idx[1])
    assert g[1, 1] == 11
    oh = TT.one_hot(nb, 1.0, 0.0, 2, 5)
    assert oh[2] == 1 and oh.sum() == 1
    assert TT.arg_max(nb, np.array([1.0, 5.0, 2.0])) == 1
    assert TT.arg_min(nb, np.array([1.0, 5.0, 2.0])) == 0
    ie = TT.ix_elems(nb, lambda idx, v: v + idx[0], np.zeros((3,)))
    assert np.allclose(np.asarray(ie), [0, 1, 2])
