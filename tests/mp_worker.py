"""Multi-process integration worker (NOT collected by pytest — launched
as a subprocess by ``test_multihost.py``, one copy per rank).

Each rank: 4 virtual CPU devices, ``jax.distributed`` wired through
``init_distributed`` (TOPS_* env), a shared global ``(data, model)``
mesh over all 8 devices, then the REAL production path end-to-end:
``fit(mesh=...)`` with the per-process ``NativeLoader(shard=(rank, 2))``
+ ``make_array_from_process_local_data`` branch, a rank-0 checkpoint
mid-run, and an exact resume — the round-2 "multi-host code paths have
zero executed coverage" gap, executed."""

import json
import os

import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 4)
jax.config.update("jax_enable_x64", True)

from tensor_ops.parallel.distributed import (  # noqa: E402
    init_distributed,
    shutdown_distributed,
)

info = init_distributed()
assert info["initialized"], info
assert info["process_count"] == 2, info
assert info["local_devices"] == 4, info
assert info["global_devices"] == 8, info

import jax.numpy as jnp  # noqa: E402

import tensor_ops as T  # noqa: E402
from tensor_ops.backend.rng import Rng  # noqa: E402
from tensor_ops.models import (  # noqa: E402
    act_logistic,
    act_softmax,
    adam,
    cross_entropy,
    gen_net,
)
from tensor_ops.models.trainer import fit  # noqa: E402
from tensor_ops.parallel.mesh import make_mesh  # noqa: E402


def build_net(be):
    return gen_net(be, 12, 4, [(8, act_logistic())], act_softmax(),
                   Rng(be, seed=0))


be = T.JaxBackend(dtype=jnp.float64)
r = np.random.default_rng(0)
X = r.uniform(0, 1, size=(64, 12))
Y = np.eye(4)[r.integers(0, 4, size=64)]
loss = cross_entropy(4)
mesh = make_mesh(len(jax.devices()))  # global (data=2, model=4)
ck = os.environ["TOPS_MP_CKPT"]
kw = dict(batch_size=16, lr=0.05, optimizer=adam(), log_every=1,
          verbose=False, seed=0, checkpoint_path=ck, checkpoint_every=2,
          # the FULL ZeRO-3 ladder with the data axis CROSSING the
          # process boundary: params+grads+moments all shard over a
          # host-spanning axis, placement takes the compiled-identity
          # reshard (_reshard_leaf's non-addressable branch), the step
          # gathers params at use across hosts, checkpoints gather the
          # process-spanning shards, resume re-places them onto the
          # extended shardings — and the run must STILL equal the
          # replicated single-process reference at 1e-9 (ZeRO is exact)
          zero_stage=3)

# leg 1: train 1 epoch (4 steps), checkpointing from rank 0
res1 = fit(build_net(be), loss, be, X, Y, epochs=1, mesh=mesh, **kw)
# leg 2: resume from the shared checkpoint to the 2-epoch budget
res2 = fit(build_net(be), loss, be, X, Y, epochs=2, mesh=mesh,
           resume=True, **kw)
assert res1.steps == 4 and res2.steps == 8

from tensor_ops.models.trainer import _global_host_tree  # noqa: E402

host_params = _global_host_tree(tuple(res2.net.params), mesh)

# scenario 2: dp x pp — the staged-IR pipeline over a (data=2, stage=4)
# mesh SPANNING BOTH PROCESSES (data rows process-aligned, the stage
# ring intra-process, the dp gradient psum crossing hosts), with a
# rank-0 checkpoint mid-run and exact cross-process resume
from tensor_ops.models import squared_error  # noqa: E402
from tensor_ops.parallel.pipeline import make_dp_pipeline_mesh  # noqa: E402


def build_pp_net(be):
    return gen_net(be, 8, 8, [(8, act_logistic())] * 4, act_logistic(),
                   Rng(be, seed=5))


r2 = np.random.default_rng(7)
X2 = r2.uniform(0, 1, size=(64, 8))
Y2 = r2.uniform(0, 1, size=(64, 8))
loss2 = squared_error(8)
mesh2 = make_dp_pipeline_mesh(2, 4)
ck2 = ck + ".pp"
kw2 = dict(batch_size=16, lr=0.05, optimizer=adam(), log_every=1,
           verbose=False, seed=0, checkpoint_path=ck2, checkpoint_every=2,
           pipeline_microbatches=2)
res3 = fit(build_pp_net(be), loss2, be, X2, Y2, epochs=1, mesh=mesh2, **kw2)
res4 = fit(build_pp_net(be), loss2, be, X2, Y2, epochs=2, mesh=mesh2,
           resume=True, **kw2)
assert res3.steps == 4 and res4.steps == 8
pp_params = _global_host_tree(tuple(res4.net.params), mesh2)

# scenario 3: TRUE cross-host pipelining — a stage-only (stage=8) mesh
# whose ppermute ring crosses the process boundary (devices 3->4 and
# 7->0 hop hosts); every rank loads the identical full stream and the
# replicated batch places via _place
from tensor_ops.parallel.pipeline import make_pipeline_mesh  # noqa: E402


def build_ring_net(be):
    return gen_net(be, 8, 8, [(8, act_logistic())] * 8, act_logistic(),
                   Rng(be, seed=9))


mesh3 = make_pipeline_mesh(8)
ck3 = ck + ".ring"
kw3 = dict(batch_size=16, lr=0.05, optimizer=adam(), log_every=1,
           verbose=False, seed=0, checkpoint_path=ck3, checkpoint_every=2,
           pipeline_microbatches=2)
res5 = fit(build_ring_net(be), loss2, be, X2, Y2, epochs=1, mesh=mesh3,
           **kw3)
res6 = fit(build_ring_net(be), loss2, be, X2, Y2, epochs=2, mesh=mesh3,
           resume=True, **kw3)
assert res5.steps == 4 and res6.steps == 8
ring_params = _global_host_tree(tuple(res6.net.params), mesh3)

# scenario 4: the recurrent family across processes — fit_sequences on
# the shared (data=2, model=4) mesh from scenario 1: each rank feeds its
# own row-block of every global sequence batch (same-seed global
# shuffle), Elman weights tp-sharded, rank-0 checkpoint + exact resume
from tensor_ops.models import fit_sequences  # noqa: E402
from tensor_ops.models.recurrent import gen_net as gen_rnet  # noqa: E402


def build_rnet(be):
    return gen_rnet(be, 1, 1, [(8, act_logistic(), act_logistic())],
                    act_logistic(), None, Rng(be, seed=11))


t4 = np.linspace(0, 1, 7)
r4 = np.random.default_rng(11)
waves = np.sin(2 * np.pi * t4[None, :]
               + r4.uniform(0, np.pi, size=(64, 1)))
XS4, TS4 = waves[:, :-1, None], waves[:, 1:, None]
ck4 = ck + ".seq"
kw4 = dict(batch_size=16, rate_state=0.01, rate_param=0.1, log_every=1,
           verbose=False, seed=0, checkpoint_path=ck4,
           checkpoint_every=2, mesh=mesh)
res7 = fit_sequences(build_rnet(be), squared_error(1), be, XS4, TS4,
                     epochs=1, **kw4)
res8 = fit_sequences(build_rnet(be), squared_error(1), be, XS4, TS4,
                     epochs=2, resume=True, **kw4)
assert res7.steps == 4 and res8.steps == 8
seq_leaves = _global_host_tree(
    tuple(res8.net.states) + tuple(res8.net.params), mesh)

out = {
    "rank": info["process_index"],
    "seq_losses": [h["loss"] for h in res7.history]
                  + [h["loss"] for h in res8.history],
    "seq_leaves": [p.tolist() for p in seq_leaves],
    "losses": [h["loss"] for h in res1.history]
              + [h["loss"] for h in res2.history],
    "params": [p.tolist() for p in host_params],
    "pp_losses": [h["loss"] for h in res3.history]
                 + [h["loss"] for h in res4.history],
    "pp_params": [p.tolist() for p in pp_params],
    "ring_losses": [h["loss"] for h in res5.history]
                   + [h["loss"] for h in res6.history],
    "ring_params": [p.tolist() for p in ring_params],
}
with open(os.environ["TOPS_MP_OUT"], "w") as f:
    json.dump(out, f)
shutdown_distributed()
