"""RNG plumbing: explicit, reproducible random state per backend.

The reference's ``genRand`` is a Tensor primitive parameterized by any
continuous distribution (``src/TensorOps/Types.hs:93-96``) and its apps
seed from the system RNG non-reproducibly (``app/Dots.hs:130``,
``app/MNIST.hs:250-251``).  The rebuild threads explicit state — a NumPy
``Generator`` for the oracle, a split-on-draw JAX PRNG key for the JAX
path — and *adds* the determinism the reference lacks (fixed seeds for the
parity suites)."""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np

from ..ops.shapes import as_shape
from .base import Backend, Distribution


class Rng:
    """Stateful convenience wrapper over backend-specific RNG."""

    def __init__(self, be: Backend, seed: int = 0):
        self.be = be
        if be.name == "jax":
            import jax

            self._key = jax.random.PRNGKey(seed)
        else:
            self._gen = np.random.default_rng(seed)

    def draw(self, dist: Distribution, shape: Sequence[int]) -> Any:
        shape = as_shape(shape)
        if self.be.name == "jax":
            import jax

            self._key, sub = jax.random.split(self._key)
            return self.be.gen_rand(dist, sub, shape)
        return self.be.gen_rand(dist, self._gen, shape)

    def split_key(self) -> Any:
        """Hand out a raw JAX PRNG key (jax backend only)."""
        import jax

        self._key, sub = jax.random.split(self._key)
        return sub

    def shuffle(self, n: int) -> np.ndarray:
        """A permutation of range(n) (epoch shuffling; the reference uses
        mwc ``uniformShuffle``, ``app/MNIST.hs:308``)."""
        if self.be.name == "jax":
            import jax

            self._key, sub = jax.random.split(self._key)
            return np.asarray(jax.random.permutation(sub, n))
        return self._gen.permutation(n)
