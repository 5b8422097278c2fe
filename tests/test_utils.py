"""Checkpoint/metrics/timing utility tests."""

import json
import os

import pytest

import numpy as np

from tensor_ops.backend.rng import Rng
from tensor_ops.models import act_logistic, gen_net, squared_error
from tensor_ops.utils.checkpoint import (
    load_arrays,
    load_network,
    load_recurrent,
    save_arrays,
    save_network,
    save_recurrent,
)
from tensor_ops.utils.metrics import MetricsLogger


def test_array_roundtrip(tmp_path, nb):
    p = str(tmp_path / "x.npz")
    save_arrays(p, {"a": np.arange(6).reshape(2, 3)}, {"k": 1})
    arrays, meta = load_arrays(p)
    assert meta["k"] == 1
    np.testing.assert_array_equal(arrays["a"], np.arange(6).reshape(2, 3))


def test_network_checkpoint_roundtrip(tmp_path, nb):
    rng = Rng(nb, seed=0)
    net = gen_net(nb, 3, 2, [(4, act_logistic())], act_logistic(), rng)
    p = str(tmp_path / "net.npz")
    save_network(p, net)
    rng2 = Rng(nb, seed=99)  # different params
    net2 = gen_net(nb, 3, 2, [(4, act_logistic())], act_logistic(), rng2)
    restored = load_network(p, net2, nb)
    x = np.array([0.1, 0.2, 0.3])
    np.testing.assert_allclose(
        np.asarray(net.run(nb, x)), np.asarray(restored.run(nb, x)), atol=1e-12
    )


def test_recurrent_checkpoint_roundtrip(tmp_path, nb):
    from tensor_ops.models.recurrent import fully_connected

    rng = Rng(nb, seed=1)
    net = fully_connected(act_logistic(), nb, 2, 3, rng)
    p = str(tmp_path / "rnn.npz")
    save_recurrent(p, net)
    restored = load_recurrent(p, net, nb)
    x = np.array([0.5, -0.5])
    y1, _ = net.run(nb, x)
    y2, _ = restored.run(nb, x)
    np.testing.assert_allclose(np.asarray(y1), np.asarray(y2), atol=1e-12)


def test_checkpoint_shape_mismatch_raises(tmp_path, nb):
    import pytest

    from tensor_ops.ops.shapes import ShapeError

    rng = Rng(nb, seed=0)
    net = gen_net(nb, 3, 2, [(4, act_logistic())], act_logistic(), rng)
    p = str(tmp_path / "net.npz")
    save_network(p, net)
    other = gen_net(nb, 3, 2, [(5, act_logistic())], act_logistic(), rng)
    with pytest.raises((ShapeError, KeyError, ValueError)):
        load_network(p, other, nb)


def test_metrics_logger(tmp_path):
    p = str(tmp_path / "m.jsonl")
    with MetricsLogger(p) as m:
        m.log(0, loss=1.5, err=0.9)
        m.log(1, loss=np.float64(1.2))
    lines = [json.loads(l) for l in open(p)]
    assert lines[0]["loss"] == 1.5 and lines[1]["step"] == 1


def test_fused_checkpoint_roundtrip(tmp_path, jb):
    import jax.numpy as jnp

    from tensor_ops.models import act_logistic, act_softmax, gen_net
    from tensor_ops.models.fast import FusedMLP
    from tensor_ops.utils.checkpoint import load_fused, save_fused

    rng = Rng(jb, seed=0)
    net = gen_net(jb, 4, 2, [(3, act_logistic())], act_softmax(), rng)
    fm = FusedMLP.from_network(net, precision="highest")
    p = str(tmp_path / "fm.npz")
    save_fused(p, fm)
    fm2 = load_fused(p)
    assert fm2.acts == fm.acts and fm2.softmax_out == fm.softmax_out
    x = jnp.asarray(np.random.default_rng(0).uniform(0, 1, size=(3, 4)), jnp.float32)
    np.testing.assert_allclose(np.asarray(fm.run(x)), np.asarray(fm2.run(x)), atol=1e-6)


def test_pipeline_checkpoint_roundtrip(tmp_path):
    import jax

    from tensor_ops.parallel.pipeline import PipelineMLP
    from tensor_ops.utils.checkpoint import load_pipeline, save_pipeline

    model = PipelineMLP.init(4, 8, 2, n_stages=2, layers_per_stage=1,
                             key=jax.random.PRNGKey(0))
    p = str(tmp_path / "pipe.npz")
    save_pipeline(p, model)
    m2 = load_pipeline(p)
    for a, b in zip(model.params(), m2.params()):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=0)


def test_device_trace_writes_profile(tmp_path, jb):
    import glob

    from tensor_ops.utils.profiling import StepTimer, device_trace

    with device_trace(str(tmp_path)):
        x = jb.asarray(np.ones((8, 8)))
        from tensor_ops import prim as P
        from tensor_ops.ops import ir

        ir.run(P.mat_mat(8, 8, 8), jb, (x, x))
    files = glob.glob(str(tmp_path / "**" / "*"), recursive=True)
    assert files, "profiler wrote nothing"


def test_step_timer_summary():
    import time as _t

    from tensor_ops.utils.profiling import StepTimer

    t = StepTimer()
    for _ in range(5):
        with t.step():
            _t.sleep(0.001)
    s = t.summary()
    assert s["n"] == 5 and s["mean_s"] > 0 and s["p90_s"] >= s["p50_s"]


def test_enable_nan_checks_roundtrip():
    import jax

    from tensor_ops.utils.profiling import enable_nan_checks

    enable_nan_checks(True)
    assert jax.config.jax_debug_nans
    enable_nan_checks(False)
    assert not jax.config.jax_debug_nans


def test_quantized_checkpoint_roundtrip(tmp_path):
    import jax.numpy as jnp
    import numpy as np

    from tensor_ops.models.fast import QuantizedMLP
    from tensor_ops.ops.int8 import quantize_weights_int8
    from tensor_ops.testing import rand
    from tensor_ops.utils.checkpoint import load_quantized, save_quantized

    ws = [jnp.asarray(rand(1 + k, 6, 8) * 0.3, jnp.float32) for k in range(2)]
    ws[1] = jnp.asarray(rand(9, 4, 6) * 0.3, jnp.float32)
    bs = [jnp.zeros((6,), jnp.float32), jnp.zeros((4,), jnp.float32)]
    qs, ss = zip(*(quantize_weights_int8(w) for w in ws))
    qm = QuantizedMLP(tuple(qs), tuple(ss), tuple(bs),
                      ("logistic", "identity"), softmax_out=True, mode="w8")
    p = str(tmp_path / "q.npz")
    save_quantized(p, qm)
    qm2 = load_quantized(p)
    assert qm2.mode == "w8" and qm2.acts == qm.acts
    assert qm2.wqs[0].dtype == jnp.int8
    x = jnp.asarray(rand(11, 3, 8), jnp.float32)
    np.testing.assert_allclose(np.asarray(qm2.run(x)), np.asarray(qm.run(x)),
                               atol=1e-6)


def test_autoencoder_checkpoint_roundtrip(tmp_path):
    import jax.numpy as jnp
    import numpy as np

    from tensor_ops.backend.rng import Rng
    from tensor_ops.models import act_logistic, gen_net
    from tensor_ops.models.autoencoder import Encoder
    from tensor_ops.models.fast import FusedAutoencoder
    from tensor_ops.utils.checkpoint import (
        load_autoencoder,
        save_autoencoder,
    )

    import tensor_ops as T

    be = T.JaxBackend()
    rng = Rng(be, seed=7)
    enc = Encoder(gen_net(be, 6, 2, [], act_logistic(), rng),
                  gen_net(be, 2, 6, [], act_logistic(), rng))
    fae = FusedAutoencoder.from_encoder(enc)
    p = str(tmp_path / "ae.npz")
    save_autoencoder(p, fae)
    fae2 = load_autoencoder(p)
    assert fae2.n_enc == fae.n_enc
    x = jnp.asarray(np.random.default_rng(0).uniform(0, 1, (4, 6)), jnp.float32)
    np.testing.assert_allclose(np.asarray(fae2.encode_decode(x)),
                               np.asarray(fae.encode_decode(x)), atol=1e-6)


def test_profile_step_reports_rates():
    import jax.numpy as jnp

    from tensor_ops.utils.profiling import (
        cost_analysis,
        measure_loop,
        profile_step,
    )

    w = jnp.ones((64, 64), jnp.float32)

    def step(c):
        return jnp.tanh(c @ w)

    init = jnp.ones((8, 64), jnp.float32)
    # the differential can come out negative under heavy host
    # contention (two tiny walls subtracted); retry with a larger step
    # gap before declaring failure — the assertion targets the API
    # contract, not the machine's scheduler
    for attempt, steps in enumerate(((20, 200), (50, 1000), (50, 2000),
                                     (100, 4000))):
        stats = profile_step(step, init, steps=steps, reps=5)
        if stats["per_step_s"] > 0:
            break
    if stats["per_step_s"] <= 0:
        import pytest

        pytest.skip("differential wall stayed negative across four "
                    "step-gap escalations — the host is too "
                    "contended for a meaningful measurement; the API "
                    "contract is covered on quiet runs")
    assert stats["per_step_s"] > 0 and stats["steps_per_s"] > 0
    assert stats["compile_s"] >= 0
    # XLA's cost model counts the matmul flops
    ca = cost_analysis(step, init)
    assert ca.get("flops", 0) >= 2 * 8 * 64 * 64 * 0.5
    for steps in ((20, 200), (50, 1000), (50, 2000)):
        m = measure_loop(step, init, steps=steps, reps=3)
        if m["per_step_s"] > 0:
            break
    assert m["per_step_s"] > 0


def test_fused_checkpoint_preserves_loss_kind(tmp_path):
    """Regression (code review): a reloaded FusedAutoencoder must keep
    loss_kind='mse' so train() still works."""
    import jax.numpy as jnp
    import numpy as np

    from tensor_ops.backend.rng import Rng
    from tensor_ops.models import act_logistic, gen_net
    from tensor_ops.models.autoencoder import Encoder
    from tensor_ops.models.fast import FusedAutoencoder
    from tensor_ops.utils.checkpoint import (
        load_autoencoder,
        save_autoencoder,
    )

    import tensor_ops as T

    be = T.JaxBackend()
    rng = Rng(be, seed=3)
    enc = Encoder(gen_net(be, 6, 2, [], act_logistic(), rng),
                  gen_net(be, 2, 6, [], act_logistic(), rng))
    fae = FusedAutoencoder.from_encoder(enc)
    p = str(tmp_path / "ae2.npz")
    save_autoencoder(p, fae)
    fae2 = load_autoencoder(p)
    assert fae2.mlp.loss_kind == "mse" and not fae2.mlp.softmax_out
    x = jnp.asarray(np.random.default_rng(1).uniform(0, 1, (8, 6)), jnp.float32)
    v, _ = fae2.train(0.5, x)  # raised ValueError before the fix
    assert np.isfinite(v)


def test_network_checkpoint_stores_and_validates_acts(tmp_path, jb):
    """save_network records activation names; loading into a graph with
    different activations raises instead of serving silently wrong."""
    from tensor_ops.backend.rng import Rng
    from tensor_ops.models import (act_relu, act_softmax, gen_net)
    from tensor_ops.utils.checkpoint import (load_arrays, load_network,
                                                 save_network)

    net = gen_net(jb, 6, 3, [(8, act_relu())], act_softmax(),
                  Rng(jb, seed=0))
    path = str(tmp_path / "relu.npz")
    save_network(path, net)
    _, meta = load_arrays(path)
    assert meta["acts"] == ["relu", "softmax"]

    back = load_network(path, net, jb)
    assert back.act_names == ("relu", "softmax")

    from tensor_ops.models import act_logistic

    wrong = gen_net(jb, 6, 3, [(8, act_logistic())], act_softmax(),
                    Rng(jb, seed=0))
    with pytest.raises(ValueError, match="activations"):
        load_network(path, wrong, jb)


def test_train_state_roundtrip_without_jax_trees(tmp_path):
    """save/load_train_state use a dependency-free tuple flattener: an
    adam-shaped state (int step + nested tuples) round-trips with leaf
    types preserved, and a changed-hyperparameter resume is rejected via
    the stored struct key."""
    from tensor_ops.models.optim import adam
    from tensor_ops.utils.checkpoint import (load_train_state,
                                                 save_train_state)

    r = np.random.default_rng(0)
    params = (r.normal(size=(4, 3)), r.normal(size=(3,)))
    opt = adam()
    state = (7, tuple(p * 0.5 for p in params), tuple(p * 0.25 for p in params))
    path = str(tmp_path / "ts.npz")
    save_train_state(path, params, state, 21, opt_key=opt.struct_key())

    template = opt.init(params)
    p2, s2, step = load_train_state(path, template,
                                    opt_key=opt.struct_key())
    assert step == 21
    t, m, v = s2
    assert t == 7 and isinstance(t, int)
    for a, b in zip(p2, params):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(m, state[1]):
        np.testing.assert_array_equal(a, b)

    with pytest.raises(ValueError, match="optimizer mismatch"):
        load_train_state(path, template, opt_key=adam(b1=0.5).struct_key())


def test_train_state_roundtrip_namedtuple_and_dict_state(tmp_path):
    """Custom optimizer states built from NamedTuples / dicts / None
    round-trip through the dependency-free flattener with container
    types preserved (jax.tree_util semantics)."""
    from collections import namedtuple

    from tensor_ops.utils.checkpoint import (load_train_state,
                                                 save_train_state)

    State = namedtuple("State", ["mu", "nu", "extra"])
    r = np.random.default_rng(1)
    params = (r.normal(size=(3, 2)),)
    state = State(mu=(r.normal(size=(3, 2)),),
                  nu={"b": r.normal(size=(3, 2)), "a": 7},
                  extra=None)
    path = str(tmp_path / "nt.npz")
    save_train_state(path, params, state, 5)

    template = State(mu=(params[0] * 0,),
                     nu={"b": params[0] * 0, "a": 0}, extra=None)
    _, restored, step = load_train_state(path, template)
    assert step == 5
    assert isinstance(restored, State) and restored.extra is None
    assert isinstance(restored.nu, dict) and restored.nu["a"] == 7
    np.testing.assert_array_equal(restored.mu[0], state.mu[0])
    np.testing.assert_array_equal(restored.nu["b"], state.nu["b"])


def test_memory_analysis_reports_bytes():
    import jax.numpy as jnp

    from tensor_ops.utils.profiling import memory_analysis

    w = jnp.ones((64, 64), jnp.float32)

    def step(x):
        return jnp.tanh(x @ w)

    x = jnp.ones((8, 64), jnp.float32)
    ma = memory_analysis(step, x)
    # the (8, 64) argument and output are at least their array bytes
    assert ma["argument_size_in_bytes"] >= 8 * 64 * 4
    assert ma["output_size_in_bytes"] >= 8 * 64 * 4
    assert ma["total_in_bytes"] > 0


def test_training_memory_report_accounts_zero1(jb):
    """The analytic report: adam doubles the param bytes in moments;
    ZeRO-1 divides the moments by dp; tp divides the sharded params;
    mixed precision adds the 2-byte compute copies."""
    import jax

    from tensor_ops.models import act_logistic, adam, gen_net, sgd
    from tensor_ops.utils.profiling import training_memory_report
    from tensor_ops.backend.rng import Rng

    net = gen_net(jb, 16, 16, [(16, act_logistic())] * 2,
                  act_logistic(), Rng(jb, seed=0))
    nparams = sum(int(np.prod(p.shape)) for p in net.params)
    bytes_per = np.dtype(net.params[0].dtype).itemsize

    r = training_memory_report(net, optimizer=adam(), batch_size=32)
    per = r["per_device"]
    assert per["params_bytes"] == nparams * bytes_per
    assert per["optimizer_bytes"] == 2 * nparams * bytes_per
    assert r["n_moment_buffers"] == 2

    r0 = training_memory_report(net, optimizer=sgd(), batch_size=32)
    assert r0["per_device"]["optimizer_bytes"] == 0

    if len(jax.devices()) >= 8:
        from tensor_ops.parallel.mesh import make_mesh

        mesh = make_mesh(8, shape=(4, 2))
        rz = training_memory_report(net, optimizer=adam(), batch_size=32,
                                    mesh=mesh, shard_opt_state=True)
        assert rz["zero1"] is True
        # every 16-dim splits by tp=2; the free dim then splits by dp=4
        assert rz["per_device"]["params_bytes"] < per["params_bytes"]
        assert (rz["per_device"]["optimizer_bytes"]
                < 2 * rz["per_device"]["params_bytes"])
        rnz = training_memory_report(net, optimizer=adam(), batch_size=32,
                                     mesh=mesh, shard_opt_state=False)
        assert (rz["per_device"]["optimizer_bytes"]
                < rnz["per_device"]["optimizer_bytes"])
        # batch rows split over dp
        assert (rz["per_device"]["batch_bytes"]
                == 32 // 4 * 16 * bytes_per)

    rmp = training_memory_report(net, optimizer=adam(), batch_size=32,
                                 mixed_precision=True)
    assert rmp["per_device"]["bf16_compute_copy_bytes"] == 2 * nparams
