"""JAX/XLA backend — the accelerator compute path.

Plays the role of the reference's BLAS-accelerated ``BTensor`` backend
(``src/TensorOps/Backend/BTensor.hs``), but where that backend needs 971
lines of rank dispatch onto the 8 BLAS cases (``BTensor.hs:141-175,
572-617``), here every ``gmul`` case lowers to one ``lax.dot_general``
(a cuBLAS or XLA-generated GEMM on the GPU) and the whole op graph is traced
into a single jitted XLA program by the engine layer — XLA then fuses the
elementwise ops into the matmuls.

Pointwise-lift VJPs use ``jax.vjp`` of the (elementwise) function at the
array level, which is exactly the per-element gradient the reference
computes via ``TT.gradLift`` (``src/TensorOps/Tensor.hs:119-129``); under
jit XLA CSE dedups any recomputed forward.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ..ops.shapes import Shape
from ..ops.vfunc import VFunc
from .base import Backend, Distribution


class JaxBackend(Backend):
    name = "jax"

    def __init__(self, dtype=jnp.float32, precision: str = "default"):
        """``precision``: "default" lets XLA pick the matmul precision
        (TF32 for float32 on the H100); "highest" forces full f32 for
        parity work.  CPU ignores it (always exact)."""
        self.dtype = jnp.dtype(dtype)
        if precision not in ("default", "highest"):
            raise ValueError(f"unknown precision {precision!r}")
        self.precision = (
            lax.Precision.DEFAULT if precision == "default" else lax.Precision.HIGHEST
        )
        self._precision_name = precision

    def cache_key(self) -> tuple:
        return (self.name, str(self.dtype), self._precision_name)

    # -- construction ---------------------------------------------------
    def asarray(self, x: Any) -> jax.Array:
        return jnp.asarray(x, dtype=self.dtype)

    def zeros(self, shape: Shape) -> jax.Array:
        return jnp.zeros(shape, dtype=self.dtype)

    def ones(self, shape: Shape) -> jax.Array:
        return jnp.ones(shape, dtype=self.dtype)

    def konst(self, value: float, shape: Shape) -> jax.Array:
        return jnp.full(shape, value, dtype=self.dtype)

    # -- primitives -----------------------------------------------------
    def lift(self, vf: VFunc, xs: Sequence[Any]) -> jax.Array:
        return jnp.asarray(vf.f(*xs), dtype=self.dtype)

    def lift_vjp(self, vf: VFunc, xs: Sequence[Any], ct: Any) -> Tuple[jax.Array, ...]:
        if vf.grads is not None:
            gs = vf.grads(*xs)
            return tuple(ct * jnp.asarray(g, dtype=self.dtype) for g in gs)
        # elementwise function => array-level vjp == per-element vjp
        _, pullback = jax.vjp(vf.f, *xs)
        return tuple(pullback(ct))

    def gmul(self, lm: int, lo: int, ln: int, x: jax.Array, y: jax.Array) -> jax.Array:
        x = jnp.asarray(x)
        y = jnp.asarray(y)
        contract_x = tuple(range(lm, lm + lo))
        contract_y = tuple(range(lo - 1, -1, -1))
        return lax.dot_general(
            x,
            y,
            dimension_numbers=((contract_x, contract_y), ((), ())),
            preferred_element_type=self.dtype if self.dtype != jnp.bfloat16 else jnp.float32,
            precision=self.precision,
        ).astype(self.dtype)

    def transp(self, t: jax.Array) -> jax.Array:
        return jnp.transpose(t, axes=tuple(reversed(range(t.ndim))))

    def map_rows(self, k: int, f: Callable, t: jax.Array) -> jax.Array:
        if k == 0:
            return jnp.asarray(f(t), dtype=self.dtype)
        lead = t.shape[:k]
        flat = t.reshape((-1,) + t.shape[k:])
        out = jax.vmap(f)(flat)
        return out.reshape(lead + out.shape[1:])

    def sum_rows(self, t: jax.Array) -> jax.Array:
        return jnp.sum(t, axis=0)

    def diag(self, k: int, v: jax.Array) -> jax.Array:
        if k == 1:
            return v
        n = v.shape[0]
        idx = jnp.arange(n)
        return jnp.zeros((n,) * k, dtype=self.dtype).at[(idx,) * k].set(v)

    def get_diag(self, k: int, t: jax.Array) -> jax.Array:
        n = t.shape[0]
        idx = jnp.arange(n)
        return t[(idx,) * k]

    def gen_rand(self, dist: Distribution, rng: jax.Array, shape: Shape) -> jax.Array:
        if dist.kind == "custom":
            out = dist.sample(
                self.name,
                lambda s: jax.random.uniform(rng, s, dtype=self.dtype),
                rng, tuple(shape))
            return jnp.asarray(out, dtype=self.dtype)
        if dist.kind == "normal":
            return dist.a + dist.b * jax.random.normal(rng, shape, dtype=self.dtype)
        if dist.kind == "uniform":
            return jax.random.uniform(rng, shape, dtype=self.dtype,
                                      minval=dist.a, maxval=dist.b)
        if dist.kind == "exponential":
            return jax.random.exponential(rng, shape, dtype=self.dtype) / dist.a
        if dist.kind == "gamma":
            return dist.b * jax.random.gamma(rng, dist.a, shape, dtype=self.dtype)
        return jax.random.beta(rng, dist.a, dist.b, shape, dtype=self.dtype)

    def generate(self, shape: Shape, f: Callable[[Tuple[int, ...]], float]) -> jax.Array:
        import numpy as np

        out = np.empty(shape, dtype=np.float64)
        for idx in np.ndindex(*shape) if shape else [()]:
            out[idx] = f(idx)
        return jnp.asarray(out, dtype=self.dtype)

    def ix_rows(self, k: int, f: Callable, t: jax.Array) -> jax.Array:
        import numpy as np

        lead = t.shape[:k]
        if 0 in lead:
            from ..ops.shapes import ShapeError

            raise ShapeError("ix_rows over an empty leading axis: the slice "
                             "function's output shape is unknowable")
        rows = []
        for idx in np.ndindex(*lead):
            rows.append(jnp.asarray(f(idx, t[idx]), dtype=self.dtype))
        out = jnp.stack(rows)
        return out.reshape(lead + rows[0].shape)

    def broadcast_to(self, t: jax.Array, shape: Shape) -> jax.Array:
        return jnp.broadcast_to(t, shape)
