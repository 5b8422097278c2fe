#!/usr/bin/env python
"""tensor-ops-serve: serve a trained network checkpoint.

A rebuild extra (the reference stops at training loops): load any
checkpoint produced by the framework (`Network` .npz from
``apps/mnist.py --checkpoint`` / ``fit(checkpoint_path=...)``, or a
``FusedMLP``/``QuantizedMLP`` artifact), optionally quantize to int8 at
load, warm the bucketed Predictor, then answer prediction requests from
an .npy/.npz/CSV file or run a latency self-benchmark.

Examples:
    python apps/serve.py ckpt.npz --layers 300,100 --bench
    python apps/serve.py ckpt.npz --layers 300,100 --int8 -i batch.npy
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import tensor_ops as T
from tensor_ops.models import activation_by_name, gen_net
from tensor_ops.models.fast import FusedMLP, QuantizedMLP
from tensor_ops.models.serve import Predictor
from tensor_ops.utils.checkpoint import load_arrays, network_from_arrays


def load_recurrent_model(payload, layers, in_dim: int, out_dim: int,
                         act: str, state_act: str):
    """Rebuild the recurrent template — from the checkpoint's stored
    ``arch`` metadata when present (new checkpoints; no flags needed),
    else from the CLI architecture flags — and load the checkpoint's
    states + params into it (count- and shape-validated)."""
    from tensor_ops.backend.rng import Rng
    from tensor_ops.models.recurrent import gen_net as gen_rnet
    from tensor_ops.utils.checkpoint import recurrent_from_arrays

    be = T.JaxBackend()
    arrays, meta = payload
    arch = meta.get("arch")
    if arch is not None:
        hidden = [
            (h, activation_by_name(a),
             activation_by_name(s) if s is not None else None)
            for h, a, s in zip(arch["sizes"], arch["acts"],
                               arch["state_acts"])
        ]
        out_act = activation_by_name(arch["acts"][-1])
        s_last = arch["state_acts"][-1]
        out_sact = activation_by_name(s_last) if s_last is not None else None
        rnet = gen_rnet(be, arch["in"], arch["out"], hidden, out_act,
                        out_sact, Rng(be, seed=0))
    else:

        def _sact():
            return (None if state_act == "none"
                    else activation_by_name(state_act))

        rnet = gen_rnet(
            be, in_dim, out_dim,
            [(h, activation_by_name(act), _sact()) for h in layers],
            activation_by_name(act), _sact(), Rng(be, seed=0))
    return recurrent_from_arrays(arrays, meta, rnet, be), be


def load_model(path: str, layers, in_dim: int, out_dim: int, int8: bool,
               act: str = "logistic", preloaded=None):
    """Dispatch on the checkpoint's ``kind`` metadata (the file is read
    once — ``preloaded`` carries the (arrays, meta) main already read).
    Bare Network checkpoints rebuild the op graph from the activation
    names stored in the checkpoint (``save_network`` since round 2);
    older checkpoints without them fall back to the ``--act`` flag for
    hidden layers + softmax out."""
    from tensor_ops.utils import checkpoint as C

    arrays, meta = preloaded if preloaded is not None else load_arrays(path)
    kind = meta.get("kind", "network")
    if kind == "quantized_mlp":
        return C._quantized_from_arrays(arrays, meta)
    if kind == "fused_mlp":
        fm = C._fused_from_arrays(arrays, meta)
        return QuantizedMLP.from_fused(fm) if int8 else fm
    # staged-IR Network checkpoint: rebuild the graph, then load params
    be = T.JaxBackend()
    from tensor_ops.backend.rng import Rng

    saved_acts = meta.get("acts")
    if saved_acts is not None:
        if len(saved_acts) != len(layers) + 1:
            raise SystemExit(
                f"checkpoint has {len(saved_acts)} activations but "
                f"--layers {','.join(map(str, layers))} implies "
                f"{len(layers) + 1} — pass the architecture it was "
                f"trained with")
        hidden = [activation_by_name(a) for a in saved_acts[:-1]]
        out_act = activation_by_name(saved_acts[-1])
    else:
        hidden = [activation_by_name(act) for _ in layers]
        out_act = activation_by_name("softmax")
    net = gen_net(be, in_dim, out_dim,
                  list(zip(layers, hidden)), out_act, Rng(be, seed=0))
    net = network_from_arrays(arrays, meta, net, be)
    fm = FusedMLP.from_network(net)
    return QuantizedMLP.from_fused(fm) if int8 else fm


def _load_array_file(path: str) -> np.ndarray:
    """.npy / .npz (first array) / CSV -> float32 ndarray."""
    if path.endswith(".npy"):
        x = np.load(path)
    elif path.endswith(".npz"):
        with np.load(path) as z:
            x = z[list(z.files)[0]]
    else:  # CSV
        x = np.loadtxt(path, delimiter=",")
    return np.asarray(x, dtype=np.float32)


def read_batch(path: str, in_dim: int) -> np.ndarray:
    x = _load_array_file(path)
    if x.ndim == 1:
        # 1-D is ambiguous: N samples of one feature vs one sample of N
        # features — the model dim decides
        x = x.reshape(-1, 1) if in_dim == 1 else x.reshape(1, -1)
    if x.shape[1] != in_dim:
        raise SystemExit(f"input dim {x.shape[1]} != model dim {in_dim}")
    return x


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="tensor-ops-serve",
        description="Serve a trained tensor-ops checkpoint")
    p.add_argument("checkpoint", help=".npz checkpoint path")
    p.add_argument("-l", "--layers", type=str, default="300,100",
                   help="Hidden sizes for bare Network checkpoints "
                        "(default: 300,100)")
    p.add_argument("--in-dim", type=int, default=784)
    p.add_argument("--out-dim", type=int, default=10)
    p.add_argument("--int8", action="store_true",
                   help="Quantize weights to int8 at load (w8a8 layers)")
    p.add_argument("--bf16", action="store_true",
                   help="Store weights in bfloat16 (half the weight "
                        "bytes in device memory)")
    p.add_argument("--act", type=str, default="logistic",
                   choices=("logistic", "relu", "tanh"),
                   help="Hidden activation for OLD bare-Network "
                        "checkpoints without stored activation names "
                        "(new checkpoints carry them); also the "
                        "recurrent template's activation")
    p.add_argument("--state-act", type=str, default="logistic",
                   choices=("logistic", "relu", "tanh", "none"),
                   help="Recurrent checkpoints: the state activation "
                        "('none' = stateless layers)")
    p.add_argument("--seq-len", type=int, default=16,
                   help="Recurrent --bench: sequence length to time")
    p.add_argument("-i", "--input", type=str, default=None,
                   help="Batch file (.npy/.npz/CSV) to predict")
    p.add_argument("--probs", action="store_true",
                   help="Print class probabilities instead of argmax")
    p.add_argument("--buckets", type=str, default="8,64,512",
                   help="Padding buckets (jit specializations)")
    p.add_argument("--bench", action="store_true",
                   help="Warm up, run a latency self-benchmark, print JSON")
    args = p.parse_args(argv)

    layers = [int(x) for x in args.layers.split(",") if x]
    buckets = tuple(int(x) for x in args.buckets.split(",") if x)
    if args.int8 and args.bf16:
        p.error("--int8 and --bf16 are mutually exclusive")

    payload = load_arrays(args.checkpoint)
    if payload[1].get("kind") == "recurrent":
        if args.int8 or args.bf16:
            p.error("--int8/--bf16 do not apply to recurrent checkpoints")
        return serve_recurrent(p, args, layers, buckets, payload)

    model = load_model(args.checkpoint, layers, args.in_dim, args.out_dim,
                       args.int8, act=args.act, preloaded=payload)
    if args.bf16 and isinstance(model, QuantizedMLP):
        p.error("--bf16 does not apply to an int8 (quantized_mlp) "
                "checkpoint — it is already the smaller artifact")
    pred = Predictor(model, buckets=buckets,
                     dtype="bf16" if args.bf16 else None)
    print(f"Serving {type(model).__name__} from {args.checkpoint} "
          f"(buckets {buckets})")

    if args.bench:
        pred.warmup()
        r = np.random.default_rng(0)
        for b in buckets:
            x = r.uniform(0, 1, size=(b, args.in_dim)).astype(np.float32)
            for _ in range(5):
                pred.predict(x)
        print(json.dumps({"latency": pred.latency()}))
        return

    if args.input:
        x = read_batch(args.input, args.in_dim)
        out = pred.predict(x) if args.probs else pred.predict_class(x)
        for row in np.atleast_1d(out):
            if args.probs:
                print(",".join(f"{v:.6f}" for v in np.atleast_1d(row)))
            else:
                print(int(row))
        return

    p.error("nothing to do: pass --bench or -i BATCH")


def serve_recurrent(p, args, layers, buckets, payload):
    """Recurrent-checkpoint serving: whole sequences through the
    SequencePredictor (input: a ``(B, n, in_dim)`` .npy/.npz; output:
    one line per sequence — the final timestep's outputs, or the full
    per-timestep trajectory with ``--probs``)."""
    from tensor_ops.models.serve import SequencePredictor
    from tensor_ops.ops.shapes import ShapeError

    try:
        rnet, be = load_recurrent_model(
            payload, layers, args.in_dim, args.out_dim,
            args.act, args.state_act)
    except (ValueError, KeyError, ShapeError) as e:
        raise SystemExit(f"error: cannot rebuild the recurrent network "
                         f"from this checkpoint: {e!r}")
    sp = SequencePredictor(rnet, be, buckets=buckets)
    print(f"Serving RecurrentNetwork from {args.checkpoint} "
          f"(buckets {buckets})")

    if args.bench:
        sp.warmup(lengths=(args.seq_len,))
        r = np.random.default_rng(0)
        in_dim = rnet.in_shape[0]
        for b in buckets:
            xs = r.uniform(0, 1, size=(b, args.seq_len, in_dim)) \
                .astype(np.float32)
            for _ in range(5):
                sp.predict(xs)
        print(json.dumps({"latency": sp.latency()}))
        return

    if args.input:
        if not args.input.endswith((".npy", ".npz")):
            raise SystemExit("recurrent serving needs a (B, n, in_dim) "
                             ".npy/.npz of sequences")
        xs = _load_array_file(args.input)
        if xs.ndim == 2:
            xs = xs[None]
        in_dim = rnet.in_shape[0]
        if xs.ndim != 3 or xs.shape[2] != in_dim:
            raise SystemExit(f"expected (B, n, {in_dim}) sequences, "
                             f"got {xs.shape}")
        out = sp.predict(xs)
        for seq_out in out:
            if args.probs:
                # full trajectory: one line per timestep, blank between
                # sequences
                for t in range(seq_out.shape[0]):
                    print(",".join(f"{v:.6f}"
                                   for v in np.atleast_1d(seq_out[t])))
                print()
            else:
                print(",".join(f"{v:.6f}"
                               for v in np.atleast_1d(seq_out[-1])))
        return

    p.error("nothing to do: pass --bench or -i SEQS")


if __name__ == "__main__":
    from tensor_ops.utils.compile_cache import use_compile_cache

    use_compile_cache()
    main()
