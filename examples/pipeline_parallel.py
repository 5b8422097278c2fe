#!/usr/bin/env python
"""Pipeline-parallel training demo on a virtual multi-device mesh.

Runs a GPipe-microbatched MLP across pipeline stages (optionally combined
with data and tensor parallelism on a 3D mesh) and shows the loss
converging.  Needs 8 devices; on a machine with fewer, run it on a
virtual CPU mesh:

    export JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8
    python examples/pipeline_parallel.py            # 1D: 4 stages
    python examples/pipeline_parallel.py --mesh 3d  # (data=2, stage=2, model=2)
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", choices=["1d", "2d", "3d"], default="1d")
    ap.add_argument("--steps", type=int, default=200)
    args = ap.parse_args()

    import jax

    if len(jax.devices()) < 8:
        raise SystemExit(
            "need 8 devices; for a virtual CPU mesh launch with "
            "JAX_PLATFORMS=cpu "
            "XLA_FLAGS=--xla_force_host_platform_device_count=8")

    import jax.numpy as jnp

    from tensor_ops.parallel.pipeline import (
        PipelineMLP,
        make_3d_pipeline_mesh,
        make_dp_pipeline_mesh,
        make_pipeline_mesh,
        pipeline_train_step,
        shard_pipeline_model,
    )

    if args.mesh == "1d":
        mesh = make_pipeline_mesh(4)
        stages, lps = 4, 1
    elif args.mesh == "2d":
        mesh = make_dp_pipeline_mesh(2, 4)
        stages, lps = 4, 1
    else:
        mesh = make_3d_pipeline_mesh(2, 2, 2)
        stages, lps = 2, 2
    print(f"mesh: {dict(mesh.shape)}")

    model = shard_pipeline_model(
        PipelineMLP.init(4, 16, 2, n_stages=stages, layers_per_stage=lps,
                         key=jax.random.PRNGKey(0), scale=4.0),
        mesh,
    )
    step = pipeline_train_step(model, mesh, n_microbatches=4)

    r = np.random.default_rng(0)
    X = r.uniform(-1, 1, size=(64, 4)).astype(np.float32)
    Y = np.eye(2, dtype=np.float32)[(X[:, 0] * X[:, 1] > 0).astype(int)]
    xb, yb = jnp.asarray(X), jnp.asarray(Y)

    params = model.params()
    for t in range(args.steps):
        v, params = step(0.5, xb, yb, *params)
        if t % 50 == 0 or t == args.steps - 1:
            print(f"step {t}: loss {float(v):.4f}")


if __name__ == "__main__":
    main()
