"""Direct coverage for the Tensor primitives that only had indirect use:
``ix_rows``, ``index`` (the reference's ``(!)``), ``map_rows``, and all
five ``gen_rand`` distribution kinds — the last quarter of the 13-method
backend seam (``/root/reference/src/TensorOps/Types.hs:77-109``).

Each gets semantics checks against hand-computed values plus numpy-vs-jax
parity, and ``gen_rand`` gets moment checks per backend (element-i.i.d.
sampling is the contract, ``Types.hs:93-96``)."""

import numpy as np
import pytest

import jax

from tensor_ops.backend.base import (
    beta,
    exponential,
    gamma,
    normal,
    uniform,
)
from tensor_ops.ops.shapes import ShapeError


# -- ix_rows (Types.hs:100-106) ------------------------------------------


def test_ix_rows_semantics(backends):
    t = np.arange(24, dtype=np.float64).reshape(2, 3, 4)
    want = np.stack(
        [
            np.stack([t[i, j] * (i + 10 * j) for j in range(3)])
            for i in range(2)
        ]
    )
    for be in backends:
        got = be.ix_rows(2, lambda idx, row: row * (idx[0] + 10 * idx[1]),
                         be.asarray(t))
        np.testing.assert_allclose(np.asarray(got), want, atol=1e-12)


def test_ix_rows_changes_slice_shape(backends):
    # the slice function may change the per-slice shape (indexed traversal
    # is shape-polymorphic in the result slice)
    t = np.arange(12, dtype=np.float64).reshape(3, 4)
    for be in backends:
        got = be.ix_rows(1, lambda idx, row: row[:2] + idx[0], be.asarray(t))
        want = np.stack([t[i, :2] + i for i in range(3)])
        np.testing.assert_allclose(np.asarray(got), want, atol=1e-12)


def test_ix_rows_parity(nb, jb):
    t = np.random.default_rng(0).normal(size=(4, 2, 3))
    f = lambda idx, row: row * row + idx[0] - idx[1]  # noqa: E731
    a = nb.ix_rows(2, f, nb.asarray(t))
    b = jb.ix_rows(2, f, jb.asarray(t))
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-12)


def test_ix_rows_empty_axis_raises(backends):
    for be in backends:
        with pytest.raises(ShapeError):
            be.ix_rows(1, lambda idx, row: row, be.asarray(np.zeros((0, 3))))


# -- index / (!) (Types.hs:107-109) ---------------------------------------


def test_index_semantics(backends):
    t = np.arange(24, dtype=np.float64).reshape(2, 3, 4)
    for be in backends:
        arr = be.asarray(t)
        assert float(be.index(arr, (1, 2, 3))) == t[1, 2, 3]
        assert float(be.index(arr, (0, 0, 0))) == t[0, 0, 0]


def test_index_scalar_rank0(backends):
    for be in backends:
        assert float(be.index(be.asarray(7.5), ())) == 7.5


def test_index_parity(nb, jb):
    t = np.random.default_rng(1).normal(size=(3, 5))
    for idx in [(0, 0), (2, 4), (1, 3)]:
        assert float(nb.index(nb.asarray(t), idx)) == pytest.approx(
            float(jb.index(jb.asarray(t), idx)), abs=1e-12
        )


# -- map_rows (Types.hs:77-81) --------------------------------------------


def test_map_rows_semantics(backends):
    t = np.arange(12, dtype=np.float64).reshape(3, 4)
    for be in backends:
        got = be.map_rows(1, lambda row: row.sum() * row, be.asarray(t))
        want = np.stack([r.sum() * r for r in t])
        np.testing.assert_allclose(np.asarray(got), want, atol=1e-12)


def test_map_rows_k0_whole_tensor(backends):
    t = np.arange(6, dtype=np.float64).reshape(2, 3)
    for be in backends:
        got = be.map_rows(0, lambda x: x * 2.0, be.asarray(t))
        np.testing.assert_allclose(np.asarray(got), t * 2, atol=1e-12)


def test_map_rows_shape_change(backends):
    t = np.arange(24, dtype=np.float64).reshape(2, 3, 4)
    for be in backends:
        got = be.map_rows(2, lambda row: row[:2] * 3.0, be.asarray(t))
        want = (t * 3.0)[:, :, :2]
        np.testing.assert_allclose(np.asarray(got), want, atol=1e-12)


def test_map_rows_parity(nb, jb):
    t = np.random.default_rng(2).normal(size=(5, 3))
    f = lambda row: row - row.mean()  # noqa: E731
    a = nb.map_rows(1, f, nb.asarray(t))
    b = jb.map_rows(1, f, jb.asarray(t))
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-12)


def test_map_rows_empty_leading_axis(backends):
    # regression: the numpy oracle used to lose the per-slice output
    # shape for a (0, k) input (returned shape (0,)); both backends must
    # agree on the jax/vmap semantics: lead + f(slice).shape
    for be in backends:
        got = be.map_rows(1, lambda row: row[:2] * 2.0,
                          be.asarray(np.zeros((0, 3))))
        assert tuple(got.shape) == (0, 2)


# -- gen_rand: all five distribution kinds (Types.hs:93-96) ----------------

N = 40_000
DISTS = [
    (normal(1.5, 0.5), 1.5, 0.5**2),
    (uniform(-1.0, 3.0), 1.0, (3.0 - (-1.0)) ** 2 / 12),
    (exponential(2.0), 0.5, 0.25),          # rate 2 -> mean 1/2, var 1/4
    (gamma(3.0, 2.0), 6.0, 12.0),           # shape*scale, shape*scale^2
    (beta(2.0, 5.0), 2 / 7, (2 * 5) / ((7**2) * 8)),
]


@pytest.mark.parametrize("dist,mean,var", DISTS,
                         ids=[d[0].kind for d in DISTS])
def test_gen_rand_moments_numpy(nb, dist, mean, var):
    out = np.asarray(nb.gen_rand(dist, np.random.default_rng(7), (N,)))
    assert out.shape == (N,)
    se = (var / N) ** 0.5
    assert abs(out.mean() - mean) < 6 * se
    assert abs(out.var() - var) < 0.05 * max(var, 1e-3) + 6 * se


@pytest.mark.parametrize("dist,mean,var", DISTS,
                         ids=[d[0].kind for d in DISTS])
def test_gen_rand_moments_jax(jb, dist, mean, var):
    out = np.asarray(jb.gen_rand(dist, jax.random.PRNGKey(7), (N,)))
    assert out.shape == (N,)
    se = (var / N) ** 0.5
    assert abs(out.mean() - mean) < 6 * se
    assert abs(out.var() - var) < 0.05 * max(var, 1e-3) + 6 * se


def test_gen_rand_support_bounds(backends):
    """uniform stays in [lo, hi); exponential/gamma nonnegative; beta in
    [0, 1] — cheap sanity on the sampler wiring (rate/scale mixups would
    break the moment tests above, sign mixups break these)."""
    for be in backends:
        rng = (jax.random.PRNGKey(3) if be.name == "jax"
               else np.random.default_rng(3))

        def draw(dist):
            if be.name == "jax":
                return np.asarray(be.gen_rand(dist, rng, (1000,)))
            return np.asarray(be.gen_rand(dist, rng, (1000,)))

        u = draw(uniform(-2.0, -1.0))
        assert u.min() >= -2.0 and u.max() <= -1.0
        assert draw(exponential(3.0)).min() >= 0.0
        assert draw(gamma(2.0, 1.0)).min() >= 0.0
        b = draw(beta(0.5, 0.5))
        assert b.min() >= 0.0 and b.max() <= 1.0


def test_gen_rand_deterministic_per_key(jb):
    a = np.asarray(jb.gen_rand(normal(0, 1), jax.random.PRNGKey(11), (64,)))
    b = np.asarray(jb.gen_rand(normal(0, 1), jax.random.PRNGKey(11), (64,)))
    np.testing.assert_array_equal(a, b)

# -- gen_rand: custom distributions (the full ContGen parameterization,
#    Types.hs:93-96 — VERDICT r3 item 4) ----------------------------------


def _laplace_icdf():
    import jax.numpy as jnp

    # standard Laplace (mu=0, b=1): mean 0, var 2
    return lambda u: -jnp.sign(u - 0.5) * jnp.log1p(-2 * jnp.abs(u - 0.5))


def test_gen_rand_custom_icdf_moments_numpy(nb):
    from tensor_ops.backend.base import custom

    lap = custom(icdf=_laplace_icdf(), name="laplace")
    out = np.asarray(nb.gen_rand(lap, np.random.default_rng(7), (N,)))
    assert out.shape == (N,) and out.dtype == nb.dtype
    se = (2.0 / N) ** 0.5
    assert abs(out.mean()) < 6 * se
    assert abs(out.var() - 2.0) < 0.1 + 6 * se


def test_gen_rand_custom_icdf_moments_jax(jb):
    from tensor_ops.backend.base import custom

    lap = custom(icdf=_laplace_icdf(), name="laplace")
    out = np.asarray(jb.gen_rand(lap, jax.random.PRNGKey(7), (N,)))
    assert out.shape == (N,)
    se = (2.0 / N) ** 0.5
    assert abs(out.mean()) < 6 * se
    assert abs(out.var() - 2.0) < 0.1 + 6 * se


def test_gen_rand_custom_native_sampler_overrides_icdf(jb, nb):
    """A per-backend native sampler wins over the icdf on its backend;
    the other backend falls back to the icdf."""
    from tensor_ops.backend.base import custom

    def jax_sampler(key, shape):
        return jax.random.laplace(key, shape, dtype=jb.dtype)

    lap = custom(icdf=_laplace_icdf(), samplers={"jax": jax_sampler},
                 name="laplace")
    out_j = np.asarray(jb.gen_rand(lap, jax.random.PRNGKey(3), (N,)))
    out_n = np.asarray(nb.gen_rand(lap, np.random.default_rng(3), (N,)))
    want_j = np.asarray(jax.random.laplace(jax.random.PRNGKey(3), (N,),
                                           dtype=jb.dtype))
    np.testing.assert_array_equal(out_j, want_j)  # native path taken
    se = (2.0 / N) ** 0.5
    for out in (out_j, out_n):
        assert abs(out.mean()) < 6 * se
        assert abs(out.var() - 2.0) < 0.1 + 6 * se


def test_gen_rand_custom_through_rng_draw(backends):
    """Rng.draw accepts a custom distribution on both backends (the
    user-facing path gen_net etc. thread through)."""
    from tensor_ops.backend.base import custom
    from tensor_ops.backend.rng import Rng

    lap = custom(icdf=_laplace_icdf(), name="laplace")
    for be in backends:
        out = np.asarray(Rng(be, seed=5).draw(lap, (8, 4)))
        assert out.shape == (8, 4)
        assert np.isfinite(out).all()


def test_gen_rand_custom_requires_a_spec():
    from tensor_ops.backend.base import custom

    with pytest.raises(ValueError, match="inverse CDF"):
        custom()
