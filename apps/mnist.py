#!/usr/bin/env python
"""tensor-ops-mnist: train an MLP on MNIST with validation, confusion
matrix, white-noise class, and digit induction — the rebuild of
``/root/reference/app/MNIST.hs`` with the same flags/defaults
(``MNIST.hs:89-133``) and reporting UX (``MNIST.hs:320-367``).

Rebuild extras: ``--minibatch N`` trains with vmapped
minibatches jitted into one XLA program per step (the reference is
strictly per-sample SGD, ``MNIST.hs:390-396``); ``--epochs`` bounds the
reference's run-to-Ctrl-C loop; ``--seed`` makes runs reproducible (the
reference seeds from the system RNG, ``MNIST.hs:250-251``).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import tensor_ops as T
from tensor_ops.backend.rng import Rng
from tensor_ops.models import (
    act_logistic,
    act_softmax,
    cross_entropy,
    gen_net,
)
from tensor_ops.models.training import (
    accuracy,
    batched_run,
    confusion,
    train_fold,
    train_minibatch,
)
from tensor_ops.utils.checkpoint import save_network_async
from tensor_ops.utils.mnist_data import load_mnist
from tensor_ops.utils.timing import timed


def one_hot(i: int, n: int) -> np.ndarray:
    v = np.zeros(n)
    v[i] = 1.0
    return v


def render_digit(x: np.ndarray) -> str:
    """ASCII-render a 784-vector, each pixel doubled horizontally
    (``renderOut``, ``MNIST.hs:423-446``)."""

    def render(r: float) -> str:
        if r <= 0.2:
            return " "
        if r <= 0.4:
            return "."
        if r <= 0.8:
            return "-"
        if r <= 1.9:
            return "="
        return "#"

    rows = np.asarray(x, dtype=np.float64).reshape(28, 28)
    return "\n".join("".join(render(v) * 2 for v in row) for row in rows)


def print_confusion(mat: np.ndarray) -> None:
    """Predicted-by-actual counts with [i] row labels (the boxes render,
    ``MNIST.hs:335-356``)."""
    n = mat.shape[0]
    width = max(5, len(str(mat.max())) + 1)
    header = "     " + "".join(f"{j:>{width}}" for j in range(n))
    print(header)
    for i in range(n):
        print(f"[{i:>2}] " + "".join(f"{mat[i, j]:>{width}}" for j in range(n)))


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="tensor-ops-mnist",
        description="tensor-ops-mnist - train neural nets on MNIST data set\n"
        "Simple test of tensor-ops tensors (JAX/XLA backend) on MNIST "
        "classification challenge",
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("-r", "--rate", type=float, default=0.02,
                   help="Neural network learning rate (default: 0.02)")
    p.add_argument("-l", "--layers", type=str, default="300,100",
                   help="Comma-separated hidden layer sizes (default: 300,100)")
    p.add_argument("-b", "--batch", type=int, default=1000,
                   help="Training batch size (default: 1000)")
    p.add_argument("-d", "--data", type=str, default="data/mnist",
                   help="Directory to store/cache MNIST data files")
    p.add_argument("-c", "--noconfusion", action="store_true",
                   help="Disable confusion matrix validation and only display "
                        "%% error every batch")
    p.add_argument("-w", "--white", action="store_true",
                   help='Train with an eleventh "white noise" class to train '
                        "network on negative results")
    p.add_argument("-i", "--induce", type=int, default=None, metavar="DIGIT",
                   help="Every batch, attempt to induce an image of the given "
                        "digit with the trained network")
    p.add_argument("--epochs", type=int, default=0,
                   help="Number of epochs (0 = run until interrupted, like the reference)")
    p.add_argument("--seed", type=int, default=0, help="RNG seed")
    p.add_argument("--backend", choices=["jax", "np"], default="jax")
    p.add_argument("--minibatch", type=int, default=0,
                   help="Vmapped minibatch size (0 = per-sample SGD like the reference)")
    p.add_argument("--limit", type=int, default=0,
                   help="Subsample the training set to N samples (0 = all)")
    p.add_argument("--metrics", type=str, default=None,
                   help="Append per-batch metrics to this JSONL file")
    p.add_argument("--require-real-data", action="store_true",
                   help="Refuse the synthetic fallback: verify the on-disk "
                        "IDX files are the canonical MNIST distribution "
                        "(md5 of the .gz files or the exact 60000/10000 "
                        "shape signature) and record a pinned-seed accuracy "
                        "trajectory JSONL (default: <data>/accuracy_seed<seed>"
                        ".jsonl unless --metrics is given)")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="Save network parameters to this .npz after every batch")
    args = p.parse_args(argv)

    hi = 10 if args.white else 9   # -w adds the eleventh class
    if args.induce is not None and not (0 <= args.induce <= hi):
        p.error(f"Number {args.induce} out of range ({hi})")

    layers = [int(x) for x in args.layers.split(",") if x]

    train_raw, test_raw = load_mnist(args.data,
                                     require_real=args.require_real_data)
    print("Loaded data.")
    if args.require_real_data and args.metrics is None:
        args.metrics = os.path.join(args.data,
                                    f"accuracy_seed{args.seed}.jsonl")
        print(f"Recording accuracy trajectory to {args.metrics}")

    o = 11 if args.white else 10
    be = T.JaxBackend() if args.backend == "jax" else T.NumpyBackend()
    rng = Rng(be, seed=args.seed)
    shuffle_rng = np.random.default_rng(args.seed + 1)

    if args.limit:
        train_raw = train_raw[: args.limit]

    # processDat: pixels/255, one-hot labels (``MNIST.hs:194-216``)
    tX = np.stack([d / 255.0 for _, d in train_raw]).astype(np.float64)
    tL = np.array([l for l, _ in train_raw])
    vX = np.stack([d / 255.0 for _, d in test_raw]).astype(np.float64)
    vL = np.array([l for l, _ in test_raw])
    tY = np.eye(o)[tL]

    net = gen_net(be, 784, o,
                  [(h, act_logistic()) for h in layers], act_softmax(), rng)
    loss = cross_entropy(o)

    print(f"rate: {args.rate} | batch: {args.batch} | layers: {layers}")
    if args.white:
        print("white noise class enabled")
    if args.induce is not None:
        print(f"inducing: {args.induce}")
    print("Data processed.")

    noise_rng = np.random.default_rng(args.seed + 2)

    from tensor_ops.utils.metrics import MetricsLogger

    metrics = MetricsLogger(args.metrics)
    global_batch = 0
    if args.require_real_data and args.metrics:
        # provenance header: what data this trajectory was measured on
        from tensor_ops.utils.mnist_data import verify_real_mnist

        metrics.log(0, kind="header", seed=args.seed, rate=args.rate,
                    layers=layers, batch=args.batch, white=args.white,
                    limit=args.limit, minibatch=args.minibatch,
                    data=verify_real_mnist(args.data))

    def white_extras(n: int):
        """Scaled uniform-noise samples labeled as class 10
        (``MNIST.hs:299-306``)."""
        xs = noise_rng.uniform(0, 1, size=(n, 784)) * noise_rng.uniform(
            0, 1, size=(n, 1)
        )
        return xs, np.full(n, 10)

    vX_dev = be.asarray(vX)   # validation set: one transfer, not per batch

    def _concat_rows(a, b_rows):
        if be.name == "jax":
            import jax.numpy as jnp

            return jnp.concatenate([a, b_rows])
        return np.concatenate([a, b_rows])

    epoch = 1
    ckpt_future = None
    try:
        while args.epochs == 0 or epoch <= args.epochs:
            print(f"[Epoch {epoch}]")
            X, Y, L = tX, tY, tL
            if args.white:
                nx, nl = white_extras(len(tX) // 10)
                X = np.concatenate([X, nx])
                Y = np.concatenate([Y, np.eye(o)[nl]])
                L = np.concatenate([L, nl])
            perm = shuffle_rng.permutation(len(X))
            X, Y, L = X[perm], Y[perm], L[perm]
            print(f"Training on {len(X)} samples in batches of {args.batch} ...")

            for b0 in range(0, len(X), args.batch):
                bnum = b0 // args.batch + 1
                xs, ys, ls = (
                    X[b0 : b0 + args.batch],
                    Y[b0 : b0 + args.batch],
                    L[b0 : b0 + args.batch],
                )
                print(f"Batch {bnum} ...")

                def train_chunk():
                    nonlocal net
                    if args.minibatch > 1:
                        for k in range(0, len(xs), args.minibatch):
                            _, net = train_minibatch(
                                net, loss, be, args.rate,
                                be.asarray(xs[k : k + args.minibatch]),
                                be.asarray(ys[k : k + args.minibatch]),
                            )
                    elif be.name == "jax":
                        net = train_fold(net, loss, be, args.rate,
                                         be.asarray(xs), be.asarray(ys))
                    else:
                        for x, y in zip(xs, ys):
                            net = net.train(loss, args.rate, be,
                                            be.asarray(x), be.asarray(y))
                    return net.params

                _, t = timed(train_chunk)
                print(f"Trained on {len(xs)} samples in {t:.3f}s")

                if args.white:
                    # only the fresh noise rows transfer each batch; the
                    # 10k real rows sit on device once (vX_dev)
                    nx, nl = white_extras(len(vX) // 10)
                    vXe_dev = _concat_rows(vX_dev, be.asarray(nx))
                    vLe = np.concatenate([vL, nl])
                else:
                    vXe_dev, vLe = vX_dev, vL

                tscore = accuracy(net, be, be.asarray(xs), ls)
                print(f"Training:   {(1 - tscore) * 100:.2f}% error")
                if args.noconfusion:
                    vscore = accuracy(net, be, vXe_dev, vLe)
                    print(f"Validation: {(1 - vscore) * 100:.2f}% error")
                else:
                    conf = confusion(net, be, vXe_dev, vLe, o)
                    vscore = conf.trace() / conf.sum()
                    print(f"Validation: {(1 - vscore) * 100:.2f}% error")
                    print_confusion(conf)
                global_batch += 1
                metrics.log(global_batch, epoch=epoch,
                            train_err=(1 - tscore), val_err=(1 - vscore),
                            batch_seconds=t)
                if args.checkpoint:
                    if ckpt_future is not None:
                        ckpt_future.result()   # surface prior write errors
                    ckpt_future = save_network_async(args.checkpoint, net)

                if args.induce is not None:
                    target = be.asarray(one_hot(args.induce, o))
                    x0 = rng.draw(T.uniform(0, 0.05), (784,))
                    # 5000 induction steps in one jitted program
                    # (induceNum, MNIST.hs:399-411)
                    x1 = net.induce_many(loss, 1.0, be, target, x0, 5000)
                    print(render_digit(np.asarray(x1)))
                    yhat = np.asarray(batched_run(net, be)(
                        be.asarray(np.asarray(x1)[None]), *net.params))[0]
                    print("/".join(f"{v:.2f}" for v in yhat))
            epoch += 1
    except KeyboardInterrupt:
        print("\nInterrupted.")
    finally:
        if ckpt_future is not None:
            ckpt_future.result()   # join the last async checkpoint write
        metrics.close()


if __name__ == "__main__":
    from tensor_ops.utils.compile_cache import use_compile_cache

    use_compile_cache()
    main()
