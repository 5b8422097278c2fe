"""tensor-ops: a from-scratch rebuild of the capabilities
of mstksg/tensor-ops (shape-indexed, composable tensor-operation graphs
with built-in reverse-mode AD, a neural-net layer, and end-to-end training
apps) on JAX / XLA.

Layering (cf. SURVEY.md §1):

* ``ops.shapes``   — trace-time shape/stack algebra (was: type-level lists)
* ``ops.ir``       — the staged ``TOp`` expression IR + transposition AD
* ``ops.prim``     — the primitive op library (was: src/TensorOps/TOp.hs)
* ``backend``      — the 13-primitive Tensor seam: NumPy oracle + JAX/XLA
* ``engine``       — whole-graph jit staging
* ``tensor``       — value-level helper API (was: src/TensorOps/Tensor.hs)
* ``models``       — activations/losses, feed-forward, recurrent, autoencoder
* ``parallel``     — device meshes and sharded training steps
"""

from .backend.base import (Backend, CustomDistribution, Distribution,
                           beta, custom, exponential, gamma, normal, uniform)
from .backend.jax_backend import JaxBackend
from .backend.numpy_backend import NumpyBackend
from .ops import prim
from .ops.ir import TOp, grad, run, value_and_grad, vjp
from .ops.shapes import Shape, ShapeError, Stack
from .ops.vfunc import VFunc, vfunc1, vfunc2, vfuncN
from . import engine, tensor

__version__ = "0.1.0"

__all__ = [
    "Backend",
    "CustomDistribution",
    "Distribution",
    "JaxBackend",
    "NumpyBackend",
    "Shape",
    "ShapeError",
    "Stack",
    "TOp",
    "VFunc",
    "beta",
    "custom",
    "engine",
    "exponential",
    "gamma",
    "grad",
    "normal",
    "prim",
    "run",
    "tensor",
    "uniform",
    "value_and_grad",
    "vfunc1",
    "vfunc2",
    "vfuncN",
    "vjp",
]
