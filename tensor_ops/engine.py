"""Engine: stage whole op graphs into single jitted XLA programs.

The reference evaluates each ``TOp`` as a chain of Haskell closures with an
FFI crossing into C BLAS per primitive (SURVEY.md §3.1).  Here the entire
graph — forward, gradient, or both — is traced once per (graph, backend,
mode) into one XLA computation; XLA fuses the elementwise ops into the
contractions and the device executes a single program per training step.
Recompilation is avoided by caching the jitted callable on the op object;
``jax.jit`` itself re-specializes per concrete input shapes/dtypes.
"""

from __future__ import annotations

from typing import Callable, Sequence

from .backend.base import Backend
from .ops import ir
from .ops.ir import TOp


def _key(be: Backend, mode: str) -> tuple:
    return be.cache_key() + (mode,)


def compile_run(op: TOp, be: Backend) -> Callable:
    """Jitted forward: ``fn(*xs) -> ys_tuple``."""
    key = _key(be, "run")
    fn = op._compiled.get(key)
    if fn is None:

        def fwd(*xs):
            return op.apply(be, tuple(xs))

        fn = maybe_jit(fwd, be)
        op._compiled[key] = fn
    return fn


def compile_grad(op: TOp, be: Backend) -> Callable:
    """Jitted gradient of a scalar-output graph: ``fn(*xs) -> grads_tuple``
    (the staged ``gradTOp``)."""
    key = _key(be, "grad")
    fn = op._compiled.get(key)
    if fn is None:

        def gradf(*xs):
            return ir.grad(op, be, xs)

        fn = maybe_jit(gradf, be)
        op._compiled[key] = fn
    return fn


def compile_value_and_grad(op: TOp, be: Backend) -> Callable:
    key = _key(be, "vag")
    fn = op._compiled.get(key)
    if fn is None:

        def vag(*xs):
            return ir.value_and_grad(op, be, xs)

        fn = maybe_jit(vag, be)
        op._compiled[key] = fn
    return fn


def compile_vjp(op: TOp, be: Backend) -> Callable:
    """Jitted general VJP: ``fn(xs_tuple, cts_tuple) -> grads_tuple``."""
    key = _key(be, "vjp")
    fn = op._compiled.get(key)
    if fn is None:

        def vjpf(xs, cts):
            return ir.vjp(op, be, xs, cts)

        fn = maybe_jit(vjpf, be)
        op._compiled[key] = fn
    return fn


def maybe_jit(fn: Callable, be: Backend) -> Callable:
    """jit ``fn`` for jax backends; identity for the oracle."""
    if be.name == "jax":
        import jax

        return jax.jit(fn)
    return fn

