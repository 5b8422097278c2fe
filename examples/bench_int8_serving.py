#!/usr/bin/env python
"""int8 serving benchmark at a weight-streaming-bound shape.

Four layers of 4096x4096, batch 16: weights dominate device-memory
traffic (256 MB f32 / 128 MB bf16 / 64 MB int8 per forward), activations
are noise, so forward latency ~ weight bytes / achieved bandwidth.
Compares the serving layer forms as XLA compiles them, with the repo's
differential-timing method (loop-carried input, two step counts,
wall-clock difference — ``utils/profiling.measure_loop``).

Run on the GPU:  python examples/bench_int8_serving.py
"""
import math
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from tensor_ops.models.fast import ACTS
from tensor_ops.ops.int8 import quantize_weights_int8, w8_linear, w8a8_linear
from tensor_ops.utils.profiling import measure_loop

N, L, B = 4096, 4, 16


def main():
    print("backend:", jax.default_backend(), jax.devices()[0].device_kind)
    r = np.random.default_rng(0)
    ws = [jnp.asarray(r.normal(size=(N, N)) * math.sqrt(2.0 / N), jnp.float32)
          for _ in range(L)]
    bs = [jnp.zeros((N,), jnp.float32) for _ in range(L)]
    qs, ss = zip(*(quantize_weights_int8(w) for w in ws))
    ws_bf = [w.astype(jnp.bfloat16) for w in ws]
    x = jnp.asarray(r.normal(size=(B, N)), jnp.float32)
    relu = ACTS["relu"]

    def dense(h, ws, bs):
        for w, b in zip(ws, bs):
            h = relu(h @ w.T.astype(jnp.float32) + b)
        return h

    def int8(layer):
        def f(h, qs, ss, bs):
            for q, s, b in zip(qs, ss, bs):
                h = layer(h, q, s, b, relu)
            return h
        return f

    rows = []

    def bench(name, f, *args, wbytes):
        # the output IS the next input (kaiming relu chain keeps variance
        # stable) so XLA cannot hoist the network; weights travel via
        # args= so they stay jit INPUTS, not compile-time constants
        dt = measure_loop(f, args[0], steps=(50, 250), reps=8,
                          args=args[1:])["per_step_s"]
        rows.append((name, dt))
        print(f"{name:24s} {dt*1e6:8.1f} us/fwd  ({dt/L*1e6:6.1f} us/layer, "
              f"{wbytes/dt/1e9:5.0f} GB/s weight stream)")

    print(f"shape: {L} layers {N}x{N}, batch {B}")
    bench("f32", dense, x, ws, bs, wbytes=L * N * N * 4)
    bench("bf16 storage", dense, x, ws_bf, bs, wbytes=L * N * N * 2)
    bench("w8 (bf16 products)", int8(w8_linear), x, qs, ss, bs,
          wbytes=L * N * N)
    bench("w8a8 (int32 products)", int8(w8a8_linear), x, qs, ss, bs,
          wbytes=L * N * N)

    base = dict(rows)["f32"]
    print("\nspeedup vs f32:")
    for name, dt in rows:
        print(f"  {name:24s} {base/dt:5.2f}x")


if __name__ == "__main__":
    main()
