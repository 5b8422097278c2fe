#!/usr/bin/env python
"""tensor-ops-dots: train an MLP to classify points inside two circles and
render the learned function as ASCII art — the rebuild of
``/root/reference/app/Dots.hs`` with the same flags, defaults, workload,
and output format (``Dots.hs:103-127`` for the CLI surface,
``Dots.hs:46-100`` for the task).

Backends (the reference's runtime-selectable nl/nv/b triple,
``Dots.hs:139-146,181-186`` — its de-facto cross-backend consistency test):

* ``np``  — NumPy float64 oracle (role of nl/nv)
* ``jax`` — JAX/XLA, jitted (role of b/hmatrix); runs on the GPU when present
* reference aliases ``nl``/``nv`` (-> np) and ``b`` (-> jax) are accepted
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import tensor_ops as T
from tensor_ops.backend.rng import Rng
from tensor_ops.models import act_logistic, gen_net, squared_error
from tensor_ops.models.training import (batched_run, train_fold,
                                            train_minibatch)
from tensor_ops.utils.timing import timed

BACKEND_ALIASES = {
    "np": "np",
    "nl": "np",
    "nv": "np",
    "jax": "jax",
    "b": "jax",
}


def make_backend(name: str):
    if name == "np":
        return T.NumpyBackend()
    import jax.numpy as jnp

    return T.JaxBackend(dtype=jnp.float32)


def in_circle(v: np.ndarray, center: float, radius: float) -> bool:
    """Point inside circle centered at (c, c) (``Dots.hs:93-100``)."""
    d = v - center
    return float(d @ d) <= radius**2


def net_test(backend_name: str, rate: float, n: int, hidden: List[int],
             seed: int, minibatch: int = 0) -> str:
    """Train and render (``netTest``, ``Dots.hs:46-100``)."""
    be = make_backend(backend_name)
    data_rng = np.random.default_rng(seed)

    def gen_points():
        inps = data_rng.uniform(-1.0, 1.0, size=(n, 2))
        outs = np.array(
            [
                1.0 if (in_circle(v, 0.33, 0.33) or in_circle(v, -0.33, 0.33)) else 0.0
                for v in inps
            ]
        ).reshape(n, 1)
        return inps, outs

    (inps, outs), tp = timed(gen_points)
    print(f"Generated test points ({tp:.3f}s)")

    # Draw parameters on the NumPy oracle RNG regardless of backend so the
    # same --seed yields the SAME network everywhere — this makes the
    # reference's cross-backend consistency check (Dots.hs:139-146) a real
    # apples-to-apples comparison here.
    np_rng = Rng(T.NumpyBackend(), seed=seed)
    net = gen_net(T.NumpyBackend(), 2, 1,
                  [(h, act_logistic()) for h in hidden], act_logistic(), np_rng)
    if be.name != "numpy":
        from tensor_ops.models.feedforward import Network

        net = Network(net.op, tuple(be.asarray(p) for p in net.params),
                      net.act_names)
    loss = squared_error(1)

    def train():
        m = net
        if minibatch > 1:
            xb = be.asarray(inps)
            yb = be.asarray(outs)
            for k in range(0, n, minibatch):
                _, m = train_minibatch(m, loss, be, rate, xb[k:k + minibatch], yb[k:k + minibatch])
        elif be.name == "jax":
            # per-sample SGD fold as one scanned program (same semantics
            # as the reference's foldl' trainNetwork)
            m = train_fold(m, loss, be, rate, be.asarray(inps), be.asarray(outs))
        else:
            for x, y in zip(inps, outs):
                m = m.train(loss, rate, be, be.asarray(x), be.asarray(y))
        return tuple(m.params)

    params, tn = timed(train)
    trained = net.__class__(net.op, params, net.act_names)
    print(f"Network trained ({tn:.3f}s)")

    # 51x21 ASCII render of (net output)^2 (``join TT.dot . runNetwork``,
    # ``Dots.hs:83-92``)
    def render(r: float) -> str:
        if r <= 0.2:
            return " "
        if r <= 0.4:
            return "."
        if r <= 0.6:
            return "-"
        if r <= 0.8:
            return "="
        return "#"

    grid_pts = np.array(
        [[x / 25 - 1, y / 10 - 1] for y in range(21) for x in range(51)]
    )
    vals = np.asarray(batched_run(trained, be)(be.asarray(grid_pts), *trained.params))
    vals = (vals.reshape(21, 51) ** 2)
    return "\n".join("".join(render(v) for v in row) for row in vals)


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="tensor-ops-dots",
        description=(
            "tensor-ops-dots - train neural nets with tensor-ops\n\n"
            "Trains a feed-forward neural network on a 2D classifier using "
            "tensor-ops machinery, with the given backends. (If none "
            "provided, backend defaults to 'jax')\n\n"
            "Backends:\n- np: NumPy (oracle)\n- jax: JAX/XLA (GPU when present)\n"
            "- nl, nv, b: reference aliases for np, np, jax"
        ),
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("-r", "--rate", type=float, default=1.0,
                   help="Neural network learning rate (default: 1.0)")
    p.add_argument("-s", "--samps", type=int, default=50000,
                   help="Number of samples to train the network on (default: 50000)")
    p.add_argument("-l", "--layers", type=str, default="12,8",
                   help="Comma-separated hidden layer sizes (default: 12,8)")
    p.add_argument("--seed", type=int, default=0, help="RNG seed (reproducible runs)")
    p.add_argument("--minibatch", type=int, default=0,
                   help="Train with vmapped minibatches of this size instead of "
                        "per-sample SGD (fast path; 0 = per-sample like the reference)")
    p.add_argument("backends", nargs="*", default=["jax"],
                   help="Backends to train with: subset of {np, jax, nl, nv, b}")
    args = p.parse_args(argv)

    hidden = [int(x) for x in args.layers.split(",") if x]
    print(f"rate: {args.rate} | samps: {args.samps} | layers: {hidden}")

    for b in args.backends or ["jax"]:
        if b not in BACKEND_ALIASES:
            p.error(f"Unknown backend: {b}")  # before ANY training runs

    seen = []
    for b in args.backends or ["jax"]:
        resolved = BACKEND_ALIASES[b]
        if resolved in seen:
            continue
        seen.append(resolved)
        label = {"np": "NumPy (oracle)", "jax": "JAX/XLA"}[resolved]
        print(f"Training {label} network ...")
        print(net_test(resolved, args.rate, args.samps, hidden, args.seed,
                       args.minibatch))


if __name__ == "__main__":
    from tensor_ops.utils.compile_cache import use_compile_cache

    use_compile_cache()
    main()
