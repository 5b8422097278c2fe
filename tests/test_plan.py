"""Mesh planning: plan_meshes must rank factorizations by the same
analytic quantities the framework's partitioners actually use, exclude
configs fit would reject, and flag (never hide) idle axes."""

import numpy as np
import pytest

from tensor_ops.backend.rng import Rng
from tensor_ops.models import (
    act_logistic,
    act_softmax,
    adam,
    gen_net,
)
from tensor_ops.parallel.plan import describe_plans, plan_meshes


def _flagship(jb):
    return gen_net(jb, 784, 10,
                   [(300, act_logistic()), (100, act_logistic())],
                   act_softmax(), Rng(jb, seed=0))


def test_plan_enumerates_and_ranks(jb):
    net = _flagship(jb)
    plans = plan_meshes(net, 8, batch_size=4096, optimizer=adam())
    shapes = {tuple(p["mesh_shape"].values()) for p in plans}
    # all dp*pp*tp == 8 factorizations with <= 3 segments of pipeline
    assert (8, 1, 1) in shapes and (4, 2, 1) in shapes
    assert (2, 2, 2) in shapes
    assert all(np.prod(list(s)) == 8 for s in shapes)
    # pp > n_segments excluded: the flagship has 3 segments
    assert not any(p["mesh_shape"]["stage"] > 3 for p in plans)
    # costs are sorted ascending
    costs = [p["analytic_cost"] for p in plans]
    assert costs == sorted(costs)
    # pure dp has no bubble and perfect balance
    dp_only = next(p for p in plans
                   if tuple(p["mesh_shape"].values()) == (8, 1, 1))
    assert dp_only["bubble_fraction"] == 0.0
    assert dp_only["stage_balance"] == 1.0
    # for this tiny net, pure dp is the analytic winner (pipeline adds
    # bubble + imbalance; tp only divides the engaged FLOPs)
    assert plans[0]["mesh_shape"]["data"] == 8

    s = describe_plans(plans)
    assert "(8,1,1)" in s and "bubble" in s


def test_plan_flags_idle_tp_and_batch_misfit(jb):
    # ALL-odd dims: no weight has a tp=2-divisible dim anywhere ->
    # idle under both the pipeline row rule and param_specs' either-dim
    # rule
    odd = gen_net(jb, 15, 5, [(9, act_logistic())], act_softmax(),
                  Rng(jb, seed=1))
    plans = plan_meshes(odd, 4, batch_size=64)
    tp2 = [p for p in plans if p["mesh_shape"]["model"] == 2]
    assert tp2 and all(not p["tp_engaged"] for p in tp2)
    assert all(any("tp_idle" in n for n in p["notes"]) for p in tp2)

    # pp==1 follows param_specs' EITHER-dim rule: the flagship's
    # (10, 100) head column-shards under tp=4, so (2, 1, 4) is fully
    # engaged — while any pipeline config at tp=4 is idle (the row
    # rule needs o % 4 == 0 on every segment, and o=10 fails)
    flag = _flagship(jb)
    pf = plan_meshes(flag, 8, batch_size=4096)
    dp_tp = next(p for p in pf
                 if tuple(p["mesh_shape"].values()) == (2, 1, 4))
    assert dp_tp["tp_engaged"]
    assert not any("tp_idle" in n or "tp_partial" in n
                   for n in dp_tp["notes"])
    pp_tp = [p for p in pf if p["mesh_shape"]["stage"] > 1
             and p["mesh_shape"]["model"] == 4]
    assert pp_tp and all(not p["tp_engaged"] for p in pp_tp)
    # engaged tp divides the per-device FLOPs; idle tp must NOT
    even = gen_net(jb, 16, 4, [(8, act_logistic())], act_softmax(),
                   Rng(jb, seed=2))
    pe = plan_meshes(even, 4, batch_size=64)
    dp4 = next(p for p in pe
               if tuple(p["mesh_shape"].values()) == (4, 1, 1))
    tp2e = next(p for p in pe
                if tuple(p["mesh_shape"].values()) == (2, 1, 2))
    # (2,1,2): half the batch per device at half the engaged FLOPs ==
    # pure-dp per-device FLOPs; idle tp would be 2x
    assert tp2e["flops_per_device"] == pytest.approx(
        dp4["flops_per_device"], rel=1e-9)
    tp2o = next(p for p in plans
                if tuple(p["mesh_shape"].values()) == (2, 1, 2))
    dp4o = next(p for p in plans
                if tuple(p["mesh_shape"].values()) == (4, 1, 1))
    assert tp2o["flops_per_device"] == pytest.approx(
        2 * dp4o["flops_per_device"], rel=1e-9)

    # batch that can't grid over dp x microbatches is excluded
    small = plan_meshes(even, 8, batch_size=4)
    assert not any(p["mesh_shape"]["data"] == 8 for p in small)


def test_plan_memory_accounting(jb):
    net = _flagship(jb)
    n_param = sum(int(np.prod(p.shape)) for p in net.params)
    bytes_per = np.dtype(net.params[0].dtype).itemsize
    plans = plan_meshes(net, 8, batch_size=4096, optimizer=adam(),
                        shard_opt_state=True)
    dp_only = next(p for p in plans
                   if tuple(p["mesh_shape"].values()) == (8, 1, 1))
    # params + grads full, 2 moments / dp=8
    want = 2 * n_param * bytes_per + 2 * n_param * bytes_per / 8
    assert dp_only["training_state_bytes_per_device"] == int(want)
    assert any("zero1" in n for n in dp_only["notes"])
    # a pipeline config divides params over stages
    pp2 = next(p for p in plans
               if tuple(p["mesh_shape"].values()) == (4, 2, 1))
    assert (pp2["training_state_bytes_per_device"]
            < dp_only["training_state_bytes_per_device"])

def test_plan_zero2_memory_accounting(jb):
    """zero_stage=2 divides the gradient row by dp as well and notes it."""
    net = _flagship(jb)
    n_param = sum(int(np.prod(p.shape)) for p in net.params)
    bytes_per = np.dtype(net.params[0].dtype).itemsize
    plans = plan_meshes(net, 8, batch_size=4096, optimizer=adam(),
                        zero_stage=2)
    dp_only = next(p for p in plans
                   if tuple(p["mesh_shape"].values()) == (8, 1, 1))
    # params full; grads + 2 moments / dp=8
    want = n_param * bytes_per + 3 * n_param * bytes_per / 8
    assert dp_only["training_state_bytes_per_device"] == int(want)
    assert any("zero2" in n for n in dp_only["notes"])
    # zero_stage=1 spelling matches shard_opt_state=True
    p1 = plan_meshes(net, 8, batch_size=4096, optimizer=adam(),
                     zero_stage=1)
    ps = plan_meshes(net, 8, batch_size=4096, optimizer=adam(),
                     shard_opt_state=True)
    assert ([p["training_state_bytes_per_device"] for p in p1]
            == [p["training_state_bytes_per_device"] for p in ps])
