#!/usr/bin/env python
"""Multi-host training demo: launch N local processes wired into ONE
``jax.distributed`` runtime (the torchrun-style local launcher), each
with its own virtual CPU devices, and drive the production
``fit(mesh=...)`` path — per-process disjoint data shards, global batch
assembly, rank-0 checkpoints — exactly as a multi-host cluster would run
it (each rank gets the coordinator through the TOPS_* env).

    python examples/multihost_launch.py            # 2 procs x 4 devices
    python examples/multihost_launch.py --procs 4  # 4 procs x 2 devices
    python examples/multihost_launch.py --pipeline # cross-host stage ring

The parent spawns the workers and streams rank 0's losses; every rank
asserts the same global loss curve (the batch is global, so all ranks
observe the identical run).

``--pipeline`` runs TRUE cross-host pipeline parallelism instead: a
stage-only mesh over all global devices, so the staged-IR ppermute ring
crosses the process boundary — each rank loads the
identical stream and the replicated batch places globally.
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r'''
import json, os
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", int(os.environ["DEMO_LOCAL_DEVICES"]))

from tensor_ops.parallel.distributed import init_distributed, shutdown_distributed
info = init_distributed()   # TOPS_* env -> jax.distributed.initialize

import tensor_ops as T
from tensor_ops.backend.rng import Rng
from tensor_ops.models import act_logistic, act_softmax, adam, cross_entropy, gen_net
from tensor_ops.models.trainer import fit
from tensor_ops.parallel.mesh import make_mesh

be = T.JaxBackend()
r = np.random.default_rng(0)
n_dev = len(jax.devices())
if os.environ.get("DEMO_MODE") == "pipeline":
    # stage-only mesh over ALL global devices: the staged-IR ppermute
    # ring crosses the process boundary (DCN on a real pod); every rank
    # loads the identical stream and the replicated batch places globally
    from tensor_ops.parallel.pipeline import make_pipeline_mesh
    net = gen_net(be, 32, 32, [(32, act_logistic())] * n_dev,
                  act_logistic(), Rng(be, seed=0))
    from tensor_ops.models import squared_error
    X = r.uniform(0, 1, size=(256, 32))
    Y = r.uniform(0, 1, size=(256, 32))
    mesh = make_pipeline_mesh(n_dev)
    res = fit(net, squared_error(32), be, X, Y, epochs=2, batch_size=32,
              lr=0.05, optimizer=adam(), mesh=mesh, log_every=1,
              verbose=False, seed=0, pipeline_microbatches=4,
              checkpoint_path=os.environ["DEMO_CKPT"], checkpoint_every=4)
else:
    net = gen_net(be, 64, 8, [(32, act_logistic())], act_softmax(), Rng(be, seed=0))
    X = r.uniform(0, 1, size=(512, 64))
    Y = np.eye(8)[r.integers(0, 8, size=512)]
    # dp = process count keeps every data row on one process (fit
    # validates this), tp = the per-process device count
    mesh = make_mesh(n_dev, shape=(jax.process_count(),
                                   n_dev // jax.process_count()))
    res = fit(net, cross_entropy(8), be, X, Y, epochs=2, batch_size=64,
              lr=0.05, optimizer=adam(), mesh=mesh, log_every=1,
              verbose=False, seed=0,
              checkpoint_path=os.environ["DEMO_CKPT"], checkpoint_every=4)
out = {"rank": info["process_index"],
       "devices": info["global_devices"],
       "losses": [h["loss"] for h in res.history]}
print("RESULT " + json.dumps(out), flush=True)
shutdown_distributed()
'''


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--devices-per-proc", type=int, default=None,
                    help="virtual CPU devices per process (default 8//procs)")
    ap.add_argument("--pipeline", action="store_true",
                    help="cross-host pipeline parallelism (stage-only "
                         "mesh; the ppermute ring crosses processes)")
    args = ap.parse_args()
    local = args.devices_per_proc or max(1, 8 // args.procs)
    port = free_port()
    tmp = tempfile.mkdtemp(prefix="tops_mh_")
    ckpt = os.path.join(tmp, "demo_ck.npz")
    procs = []
    for rank in range(args.procs):
        env = dict(os.environ)
        env.pop("XLA_FLAGS", None)
        env.update({
            "JAX_PLATFORMS": "cpu",
            "TOPS_COORDINATOR": f"localhost:{port}",
            "TOPS_NUM_PROCESSES": str(args.procs),
            "TOPS_PROCESS_ID": str(rank),
            "DEMO_LOCAL_DEVICES": str(local),
            "DEMO_CKPT": ckpt,
            "DEMO_MODE": "pipeline" if args.pipeline else "dp_tp",
            "PYTHONPATH": ROOT + os.pathsep + env.get("PYTHONPATH", ""),
        })
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    results = {}
    for rank, p in enumerate(procs):
        out, _ = p.communicate(timeout=600)
        if p.returncode != 0:
            print(out)
            raise SystemExit(f"rank {rank} failed (exit {p.returncode})")
        for line in out.splitlines():
            if line.startswith("RESULT "):
                results[rank] = json.loads(line[len("RESULT "):])
    r0 = results[0]
    print(f"{args.procs} processes x {local} devices = "
          f"{r0['devices']} global devices, one jax.distributed mesh")
    print(f"rank-0 loss curve: "
          + " ".join(f"{v:.4f}" for v in r0["losses"][:8]) + " ...")
    for rank, res in results.items():
        assert res["losses"] == r0["losses"], (
            f"rank {rank} observed a different global run")
    print(f"all {args.procs} ranks observed the identical global loss "
          f"curve; rank-0 checkpoint at {ckpt}")


if __name__ == "__main__":
    main()
