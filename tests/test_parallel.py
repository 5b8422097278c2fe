"""Multi-chip sharding tests on the virtual CPU mesh: a dp+tp sharded
training step must compute the same numbers as the single-device step
(collectives inserted by XLA from shardings must be semantics-preserving)."""

import numpy as np
import pytest

import jax

import tensor_ops as T
from tensor_ops.backend.rng import Rng
from tensor_ops.models import act_logistic, act_softmax, cross_entropy, gen_net
from tensor_ops.models.feedforward import Network
from tensor_ops.models.training import train_minibatch
from tensor_ops.parallel.mesh import (
    make_mesh,
    param_specs,
    shard_network,
    sharded_forward,
    sharded_train_step,
)

multi = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 devices (see conftest note)"
)


def build(jb, i=8, h1=16, h2=8, o=4, seed=0):
    rng = Rng(jb, seed=seed)
    return gen_net(
        jb, i, o, [(h1, act_logistic()), (h2, act_logistic())], act_softmax(), rng
    )


def data(jb, batch=16, i=8, o=4, seed=1):
    r = np.random.default_rng(seed)
    xb = jb.asarray(r.uniform(0, 1, size=(batch, i)))
    yb = jb.asarray(np.eye(o)[r.integers(0, o, size=batch)])
    return xb, yb


@multi
def test_sharded_step_matches_single_device(jb):
    net = build(jb)
    xb, yb = data(jb)
    loss = cross_entropy(4)

    # single-device reference step
    v_ref, net_ref = train_minibatch(net, loss, jb, 0.1, xb, yb)

    mesh = make_mesh(8)
    snet = shard_network(net, mesh)
    step = sharded_train_step(snet, loss, jb, mesh)
    v_sh, new_params = step(0.1, xb, yb, *snet.params)

    assert abs(float(v_ref) - float(v_sh)) < 1e-9
    for a, b in zip(net_ref.params, new_params):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-9)


@multi
def test_sharded_forward_matches_single(jb):
    net = build(jb, seed=3)
    xb, _ = data(jb, seed=4)
    mesh = make_mesh(8)
    snet = shard_network(net, mesh)
    fwd = sharded_forward(snet, jb, mesh)
    got = np.asarray(fwd(xb, *snet.params))
    from tensor_ops.models.training import batched_run

    want = np.asarray(batched_run(net, jb)(xb, *net.params))
    np.testing.assert_allclose(got, want, atol=1e-9)


@multi
def test_param_specs_alternate_row_col():
    mesh = make_mesh(8)  # (data=2, model=4)
    specs = param_specs(((16, 8), (16,), (8, 16), (8,), (4, 8), (4,)), mesh)
    # layer0 row-parallel, layer1 column-parallel, layer2 row... but 4%4==0
    assert specs[0] == jax.sharding.PartitionSpec("model", None)
    assert specs[1] == jax.sharding.PartitionSpec("model")
    assert specs[2] == jax.sharding.PartitionSpec(None, "model")
    assert specs[3] == jax.sharding.PartitionSpec(None)


def test_make_mesh_rejects_overask():
    with pytest.raises(ValueError):
        make_mesh(len(jax.devices()) + 1)


@multi
def test_dryrun_multichip_entrypoint():
    import __graft_entry__ as g

    g.dryrun_multichip(8)


def test_init_distributed_single_process_noop():
    """Single-process (no coordinator configured): init is a no-op that
    still reports the process/device topology."""
    from tensor_ops.parallel.distributed import init_distributed

    info = init_distributed()
    assert info["initialized"] is False
    assert info["process_count"] == 1 and info["process_index"] == 0
    assert info["global_devices"] >= info["local_devices"] >= 1


def test_init_distributed_env_resolution(monkeypatch):
    """TOPS_* env vars are picked up; with a bogus coordinator the call
    must at least ATTEMPT multi-process init (we assert it reaches
    jax.distributed.initialize with the resolved arguments)."""
    import tensor_ops.parallel.distributed as D

    seen = {}

    def fake_init(**kw):
        seen.update(kw)

    monkeypatch.setattr(D, "_initialized", False)
    import jax

    monkeypatch.setattr(jax.distributed, "initialize", fake_init)
    monkeypatch.setenv("TOPS_COORDINATOR", "10.0.0.1:8476")
    monkeypatch.setenv("TOPS_NUM_PROCESSES", "4")
    monkeypatch.setenv("TOPS_PROCESS_ID", "2")
    info = D.init_distributed()
    assert seen == {"coordinator_address": "10.0.0.1:8476",
                    "num_processes": 4, "process_id": 2}
    assert info["initialized"] is True
    monkeypatch.setattr(D, "_initialized", False)  # restore module state


def test_shard_fused_tensor_parallel_serving(jb):
    """shard_fused: Megatron-placed FusedMLP weights serve identically
    to the unsharded model — XLA inserts the activation collectives
    from the param shardings alone; Predictor works unmodified."""
    import jax
    from jax.sharding import PartitionSpec as PSpec

    from tensor_ops.backend.rng import Rng
    from tensor_ops.models import act_logistic, act_softmax, gen_net
    from tensor_ops.models.fast import FusedMLP
    from tensor_ops.models.serve import Predictor
    from tensor_ops.parallel.mesh import (MODEL_AXIS, make_mesh,
                                              shard_fused)

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device CPU mesh")
    mesh = make_mesh(8)  # dp=2 x tp=4

    net = gen_net(jb, 16, 8, [(32, act_logistic()), (16, act_logistic())],
                  act_softmax(), Rng(jb, seed=2))
    fm = FusedMLP.from_network(net)
    sfm = shard_fused(fm, mesh)

    # weights actually sharded over the model axis (alternating specs)
    assert sfm.weights[0].sharding.spec == PSpec(MODEL_AXIS, None)
    assert sfm.weights[1].sharding.spec == PSpec(None, MODEL_AXIS)

    x = np.random.default_rng(3).uniform(0, 1, size=(8, 16)) \
        .astype(np.float32)
    ref = np.asarray(fm.run(x))
    got = np.asarray(sfm.run(x))
    np.testing.assert_allclose(got, ref, atol=1e-6)

    # the Predictor serves the sharded weights as they are placed
    p = Predictor(sfm, buckets=(8,))
    np.testing.assert_allclose(np.asarray(p.predict(x)), ref, atol=1e-6)
    assert p.model.weights[0].sharding.spec == PSpec(MODEL_AXIS, None)
