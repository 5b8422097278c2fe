"""Batched training: the upgrade over the reference's strictly
per-sample SGD hot loop (``trainAll = foldl' trainNetwork``,
``app/MNIST.hs:390-396`` — SURVEY.md §2.5 notes the reference has *no*
data parallelism of any kind).

The staged per-sample graph is ``jax.vmap``-ed over the batch axis (params
broadcast), gradients are averaged, and gradient + SGD update jit into one
XLA program — so the device runs real ``[B, i] x [o, i]`` matmuls instead of
rank-1 gemv chains.  The AD is still the framework's own graph
transposition (vmap maps over it); ``jax.grad`` is never used on the model.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

import numpy as np

from ..backend.base import Backend
from ..ops import ir
from ..ops.ir import TOp
from .feedforward import Network


def _cache(net: Network, key, build):
    fn = net.op._compiled.get(key)
    if fn is None:
        fn = build()
        net.op._compiled[key] = fn
    return fn


def make_vmapped_grads(net: Network, loss: TOp, be: Backend) -> Callable:
    """The shared core of every batched trainer: the per-sample staged
    graph's value_and_grad (framework transposition AD), vmapped over the
    batch with params broadcast.  Returns
    ``fn(xb, yb, *params) -> (per-sample losses, per-sample param grads)``.
    jax backends only."""
    import jax

    composed = net._loss_op(loss)
    n_params = len(net.params)

    def sample_vag(x, y, *params):
        v, grads = ir.value_and_grad(composed, be, (x,) + params + (y,))
        return v, grads[1:-1]

    return jax.vmap(sample_vag, in_axes=(0, 0) + (None,) * n_params)


def batched_run(net: Network, be: Backend) -> Callable:
    """Jitted batched inference ``fn(xb, *params) -> yb``."""
    key = ("brun",) + be.cache_key()

    def build():
        if be.name == "jax":
            import jax

            def single(x, *params):
                return net.op.apply(be, (x,) + params)[0]

            return jax.jit(
                jax.vmap(single, in_axes=(0,) + (None,) * len(net.params))
            )

        def loop(xb, *params):
            return np.stack([net.op.apply(be, (x,) + tuple(params))[0] for x in xb])

        return loop

    return _cache(net, key, build)


def batched_step(net: Network, loss: TOp, be: Backend) -> Callable:
    """Jitted minibatch SGD step
    ``fn(rate, xb, yb, *params) -> (mean_loss, new_params)`` using the
    framework's transposition AD per sample, vmapped, mean-reduced."""
    composed = net._loss_op(loss)
    key = ("bstep", loss.struct_key()) + be.cache_key()

    def build():
        if be.name == "jax":
            import jax
            import jax.numpy as jnp

            vmapped = make_vmapped_grads(net, loss, be)

            def step(rate, xb, yb, *params):
                vals, grads = vmapped(xb, yb, *params)
                new_params = tuple(
                    p - rate * jnp.mean(g, axis=0) for p, g in zip(params, grads)
                )
                return jnp.mean(vals), new_params

            return jax.jit(step)

        def step(rate, xb, yb, *params):
            vals = []
            gsums = [np.zeros_like(p) for p in params]
            for x, y in zip(xb, yb):
                v, grads = ir.value_and_grad(composed, be, (x,) + tuple(params) + (y,))
                vals.append(v)
                for acc, g in zip(gsums, grads[1:-1]):
                    acc += g
            bsz = len(xb)
            new_params = tuple(p - rate * g / bsz for p, g in zip(params, gsums))
            return float(np.mean(vals)), new_params

        return step

    return _cache(net, key, build)


def train_fold(net: Network, loss: TOp, be: Backend, rate: float, X: Any, Y: Any) -> Network:
    """The reference's per-sample SGD fold (``trainAll = foldl'
    trainNetwork``, ``app/MNIST.hs:390-396``) as ONE jitted program: a
    ``lax.scan`` over the samples carrying the parameters.  Semantics are
    identical to calling :meth:`Network.train` per sample — the scan just
    removes the per-sample dispatch cost."""
    composed = net._loss_op(loss)
    key = ("fold", loss.struct_key()) + be.cache_key()
    fn = _cache(net, key, lambda: _build_fold(net, composed, be))
    new_params = fn(rate, X, Y, *net.params)
    return Network(net.op, tuple(new_params), net.act_names)


def _build_fold(net: Network, composed: TOp, be: Backend):
    if be.name == "jax":
        import jax
        from jax import lax

        def run(rate, X, Y, *params):
            def body(params, xy):
                x, y = xy
                grads = ir.grad(composed, be, (x,) + params + (y,))
                return (
                    tuple(p - rate * g for p, g in zip(params, grads[1:-1])),
                    None,
                )

            params, _ = lax.scan(body, tuple(params), (X, Y))
            return params

        return jax.jit(run)

    def run(rate, X, Y, *params):
        params = tuple(params)
        for x, y in zip(X, Y):
            grads = ir.grad(composed, be, (x,) + params + (y,))
            params = tuple(p - rate * g for p, g in zip(params, grads[1:-1]))
        return params

    return run


def train_minibatch(
    net: Network, loss: TOp, be: Backend, rate: float, xb: Any, yb: Any
) -> Tuple[float, Network]:
    """One minibatch SGD step; returns (mean loss, updated network)."""
    step = batched_step(net, loss, be)
    v, new_params = step(rate, xb, yb, *net.params)
    return v, Network(net.op, new_params, net.act_names)


def accuracy(net: Network, be: Backend, xb: Any, yb_idx: Any) -> float:
    """Fraction of argmax-correct predictions over a batch (the
    ``validate`` fold, ``app/MNIST.hs:369-377``)."""
    run = batched_run(net, be)
    preds = np.asarray(run(xb, *net.params)).argmax(axis=1)
    return float((preds == np.asarray(yb_idx)).mean())


def batch_loss(net: Network, loss: TOp, be: Backend, xb: Any,
               yb: Any) -> float:
    """Mean loss over a batch — the value-only evaluation ``fit`` uses
    for ``val=`` on regression/reconstruction objectives, where argmax
    accuracy is meaningless."""
    key = ("bloss", loss.struct_key()) + be.cache_key()

    def build():
        composed = net._loss_op(loss)
        if be.name == "jax":
            import jax
            import jax.numpy as jnp

            def single(x, y, *params):
                return composed.apply(be, (x,) + params + (y,))[0]

            vm = jax.jit(jax.vmap(
                single, in_axes=(0, 0) + (None,) * len(net.params)))
            return lambda xb, yb, *ps: jnp.mean(vm(xb, yb, *ps))

        def loop(xb, yb, *params):
            return float(np.mean([
                composed.apply(be, (x,) + tuple(params) + (y,))[0]
                for x, y in zip(xb, yb)]))

        return loop

    fn = _cache(net, key, build)
    return float(np.asarray(fn(be.asarray(xb), be.asarray(yb),
                               *net.params)))


def seq_batch_loss(rnet, loss: TOp, be: Backend, XS: Any,
                   TS: Any) -> float:
    """Mean scan-BPTT sequence loss over ``(N, n, *in)`` sequences —
    the value-only evaluation ``fit_sequences`` uses for ``val=``
    (``rnet`` is any RecurrentNetwork-shaped object: ``._seq_graph``,
    ``.states``, ``.params``, ``.op``)."""
    n = int(np.asarray(XS).shape[1])
    key = ("sbloss", loss.struct_key(), n) + be.cache_key()

    def build():
        g = rnet._seq_graph(loss, n)
        nsp = len(rnet.states) + len(rnet.params)
        if be.name == "jax":
            import jax
            import jax.numpy as jnp

            def single(xs, ts, *sp):
                return g.apply(be, (xs,) + sp + (ts,))[0]

            vm = jax.jit(jax.vmap(
                single, in_axes=(0, 0) + (None,) * nsp))
            return lambda X, T, *sp: jnp.mean(vm(X, T, *sp))

        def loop(X, T, *sp):
            return float(np.mean([
                g.apply(be, (xs,) + tuple(sp) + (ts,))[0]
                for xs, ts in zip(X, T)]))

        return loop

    fn = _cache(rnet, key, build)
    return float(np.asarray(fn(be.asarray(XS), be.asarray(TS),
                               *rnet.states, *rnet.params)))


def confusion(net: Network, be: Backend, xb: Any, yb_idx: Any, n_classes: int) -> np.ndarray:
    """Confusion matrix ``count[predicted, actual]`` (the ``confusion``
    fold, ``app/MNIST.hs:379-389``)."""
    run = batched_run(net, be)
    preds = np.asarray(run(xb, *net.params)).argmax(axis=1)
    m = np.zeros((n_classes, n_classes), dtype=np.int64)
    for p, a in zip(preds, np.asarray(yb_idx)):
        m[p, a] += 1
    return m
