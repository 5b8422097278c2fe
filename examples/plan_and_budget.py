#!/usr/bin/env python
"""The operator's pre-flight checklist, end to end:

    plan_meshes      — which (dp, pp, tp) factorization should this
                       model train on?  (analytic ranking with the
                       partitioners' own numbers)
    training_memory_report — what does the chosen config cost in HBM
                       per device, with adam vs adam8bit vs ZeRO-1?
    memory_analysis  — XLA's own compiled per-device byte counts for
                       the REAL step, to confirm the analytic numbers.

Runs on the 8-device virtual CPU mesh (JAX_PLATFORMS=cpu
XLA_FLAGS=--xla_force_host_platform_device_count=8) or real chips
alike.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import tensor_ops as T
from tensor_ops.backend.rng import Rng
from tensor_ops.models import (
    act_logistic,
    act_softmax,
    adam,
    adam8bit,
    cross_entropy,
    fit,
    gen_net,
)
from tensor_ops.parallel import describe_plans, plan_meshes
from tensor_ops.utils.profiling import training_memory_report


def main():
    import jax

    n_dev = len(jax.devices())
    be = T.JaxBackend()
    # the reference's flagship shape (MNIST.hs:89-104)
    net = gen_net(be, 784, 10,
                  [(300, act_logistic()), (100, act_logistic())],
                  act_softmax(), Rng(be, seed=0))
    batch = 4096

    print(f"== plan_meshes: {n_dev} devices, batch {batch} ==")
    plans = plan_meshes(net, n_dev, batch_size=batch, optimizer=adam(),
                        shard_opt_state=True)
    print(describe_plans(plans, top=6))
    best = plans[0]["mesh_shape"]
    print(f"\nanalytic winner: (dp={best['data']}, pp={best['stage']}, "
          f"tp={best['model']})")
    if best["stage"] > 1:
        # training_memory_report models dp/tp placements; a pipeline
        # winner's per-stage budget is in the plan table above — the
        # budget/step demo below uses the best non-pipeline config
        best = next(p["mesh_shape"] for p in plans
                    if p["mesh_shape"]["stage"] == 1)
        print(f"(pipeline winner: per-stage budget in the table; "
              f"demoing the best pp==1 config "
              f"(dp={best['data']}, tp={best['model']}) below)")

    print("\n== training-state budget for the winner, per optimizer ==")
    from tensor_ops.parallel.mesh import make_mesh

    mesh = make_mesh(n_dev, shape=(best["data"], best["model"]))
    for name, opt in (("adam", adam()), ("adam8bit", adam8bit())):
        for zero in (False, True):
            r = training_memory_report(
                net, optimizer=opt, batch_size=batch, mesh=mesh,
                shard_opt_state=zero)["per_device"]
            print(f"  {name:8s} zero1={str(zero):5s}  "
                  f"params {r['params_bytes'] / 1e6:6.2f} MB  "
                  f"moments {r['optimizer_bytes'] / 1e6:6.2f} MB  "
                  f"total {r['training_state_total_bytes'] / 1e6:6.2f} MB")

    print("\n== XLA's compiled per-device bytes for the real forward ==")
    from tensor_ops.models.training import batched_run
    from tensor_ops.utils.profiling import memory_analysis

    r = np.random.default_rng(0)
    X = r.uniform(0, 1, size=(batch, 784))
    fwd = batched_run(net, be)
    ma = memory_analysis(fwd, be.asarray(X), *net.params)
    print(f"  arguments {ma.get('argument_size_in_bytes', 0) / 1e6:.2f} "
          f"MB  temp {ma.get('temp_size_in_bytes', 0) / 1e6:.2f} MB  "
          f"total {ma['total_in_bytes'] / 1e6:.2f} MB")

    print("\n== one real step on the winner (fit prints the "
          "budget line) ==")
    Y = np.eye(10)[r.integers(0, 10, size=batch)]
    res = fit(net, cross_entropy(10), be, X, Y, epochs=1,
              batch_size=batch, lr=0.05, optimizer=adam(),
              mesh=mesh, shard_opt_state=True, prefetch=0,
              log_every=1, verbose=True)
    print(f"step loss: {res.history[-1]['loss']:.4f}")


if __name__ == "__main__":
    main()
