"""ZeRO-2 gradient sharding (``fit(zero_stage=2)``): the batch-gradient
reduction lowers to a REDUCE-SCATTER over the mesh's data axis — each dp
rank holds only its 1/dp gradient shard through clip and the optimizer
update, the moments shard identically (the ZeRO-1 rung is subsumed), and
XLA inserts the one param-update all-gather.  Training must stay EXACTLY
equal to the replicated run (VERDICT r3 item 2; the reference has no
distribution at all, SURVEY.md §2.5 — this is the rebuild's own scaling
ladder)."""

import numpy as np
import pytest

import jax
from jax.sharding import NamedSharding, PartitionSpec as PSpec

from tensor_ops.backend.rng import Rng
from tensor_ops.models import (
    act_logistic,
    act_softmax,
    adam,
    cross_entropy,
    gen_net,
    squared_error,
)
from tensor_ops.models.trainer import fit, fit_sequences, make_opt_step
from tensor_ops.parallel.mesh import (
    DATA_AXIS,
    make_mesh,
    param_specs,
    zero1_place,
    zero2_grad_constrain,
    zero2_grad_shardings,
)

multi = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 devices (see conftest note)"
)


def _net(jb, seed=0, h=16):
    rng = Rng(jb, seed=seed)
    return gen_net(jb, h, 4, [(h, act_logistic()), (h, act_logistic())],
                   act_softmax(), rng)


def _data(n=64, h=16, seed=1):
    r = np.random.default_rng(seed)
    X = r.uniform(0, 1, size=(n, h))
    Y = np.eye(4)[r.integers(0, 4, size=n)]
    return X, Y


def _axes(sharding):
    axes = set()
    for s in sharding.spec:
        if isinstance(s, str):
            axes.add(s)
        elif isinstance(s, (tuple, list)):
            axes.update(s)
    return axes


@multi
def test_zero2_grad_shardings_match_moment_rule(jb):
    """The gradient shardings use the SAME dim-choice rule as the ZeRO-1
    moments, so gradient shard and moment shard coincide leaf-for-leaf
    (the sharded optimizer update is collective-free)."""
    mesh = make_mesh(8, shape=(4, 2))
    net = _net(jb)
    pspecs = param_specs(net.param_stack, mesh)
    params = tuple(jax.device_put(p, NamedSharding(mesh, s))
                   for p, s in zip(net.params, pspecs))
    gshs = zero2_grad_shardings(params, mesh)
    state, _ = zero1_place(adam().init(params), mesh)
    _, m, _ = state
    assert any(sh is not None for sh in gshs)
    for gsh, mi, p in zip(gshs, m, params):
        want = mi.sharding  # the placed moment's sharding
        if gsh is None:
            # nothing to add => the moment gained nothing either
            assert _axes(want) == _axes(p.sharding)
        else:
            assert gsh.spec == want.spec, (gsh, want)


@multi
@pytest.mark.parametrize("accum", [1, 2])
def test_opt_step_zero2_equals_replicated(jb, accum):
    """make_opt_step with grad_constrain (+zero_constrain): three steps
    == the replicated run at 1e-9, moments stay data-sharded, and the
    compiled step program actually carries a reduce-scatter."""
    mesh = make_mesh(8, shape=(4, 2))
    loss = cross_entropy(4)
    X, Y = _data(n=32)
    opt = adam()

    def run(zero2):
        net = _net(jb, seed=2)
        pspecs = param_specs(net.param_stack, mesh)
        params = tuple(jax.device_put(p, NamedSharding(mesh, s))
                       for p, s in zip(net.params, pspecs))
        if zero2:
            state, zcons = zero1_place(opt.init(params), mesh)
            gcons = zero2_grad_constrain(params, mesh)
            assert zcons is not None and gcons is not None
        else:
            state, zcons, gcons = opt.init(params), None, None
        step = make_opt_step(net, loss, jb, opt, mesh=mesh,
                             accum_steps=accum, zero_constrain=zcons,
                             grad_constrain=gcons)
        data_sh = NamedSharding(mesh, PSpec(DATA_AXIS, None))
        xb = jax.device_put(jb.asarray(X), data_sh)
        yb = jax.device_put(jb.asarray(Y), data_sh)
        for _ in range(3):
            v, state, params = step(0.05, xb, yb, state, params)
        return v, state, params, step, (xb, yb)

    v_z, state_z, params_z, step_z, (xb, yb) = run(zero2=True)
    v_r, state_r, params_r, step_r, _ = run(zero2=False)
    assert abs(float(v_z) - float(v_r)) < 1e-9
    for a, b in zip(params_z, params_r):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-9, rtol=0)
    # moments kept their data-axis shard through the updates
    _, m, _ = state_z
    assert any(DATA_AXIS in _axes(mi.sharding) for mi in m)
    # structural signature in the lowered programs: the ZeRO-2 step
    # reassembles the params from per-rank update shards (a data-axis
    # all-gather per param — or a literal reduce-scatter where the
    # backend keeps it), while the replicated step has NO
    # all-gather at all (its only dp collective is the grad all-reduce).
    # CPU's HLO pipeline expands reduce-scatter, hence the OR.  Only
    # sharp at accum=1: the accumulation scan makes XLA introduce its
    # own gathers even in the replicated program.
    if accum != 1:
        return
    try:
        txt_z = step_z.lower(0.05, xb, yb, state_z, params_z).compile(
        ).as_text()
        txt_r = step_r.lower(0.05, xb, yb, state_r, params_r).compile(
        ).as_text()
    except Exception:  # noqa: BLE001 — introspection, not semantics
        pytest.skip("compiled HLO text unavailable")
    assert ("reduce-scatter" in txt_z or "all-gather" in txt_z), \
        "no sharded-gradient collective in the ZeRO-2 step"
    assert "all-gather" not in txt_r, \
        "replicated step unexpectedly carries an all-gather"


@multi
def test_fit_zero2_equals_replicated_and_zero1(jb, tmp_path):
    """fit(mesh=dp x tp, zero_stage=2): loss curve and params == both
    the replicated and the ZeRO-1 run at 1e-9; crash/resume reproduces
    the uninterrupted ZeRO-2 run exactly."""
    import warnings

    mesh = make_mesh(8, shape=(4, 2))
    loss = cross_entropy(4)
    X, Y = _data(n=64)
    kw = dict(epochs=2, batch_size=16, lr=0.05, optimizer=adam(),
              verbose=False, prefetch=0, log_every=1, mesh=mesh)

    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        r_2 = fit(_net(jb, seed=3), loss, jb, X, Y, zero_stage=2, **kw)
    assert not any("zero_stage" in str(x.message) for x in w)
    r_1 = fit(_net(jb, seed=3), loss, jb, X, Y, zero_stage=1, **kw)
    r_r = fit(_net(jb, seed=3), loss, jb, X, Y, **kw)
    for ra, rb, rc in zip(r_2.history, r_1.history, r_r.history):
        assert abs(ra["loss"] - rb["loss"]) < 1e-9
        assert abs(ra["loss"] - rc["loss"]) < 1e-9
    for a, b in zip(r_2.net.params, r_r.net.params):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-9, rtol=0)

    ck = str(tmp_path / "z2.npz")
    fit(_net(jb, seed=3), loss, jb, X, Y, zero_stage=2,
        checkpoint_path=ck, checkpoint_every=2, **{**kw, "epochs": 1})
    resumed = fit(_net(jb, seed=3), loss, jb, X, Y, zero_stage=2,
                  checkpoint_path=ck, checkpoint_every=2, resume=True,
                  **kw)
    for a, b in zip(resumed.net.params, r_2.net.params):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-9, rtol=0)


@multi
def test_fit_zero2_pipeline_mesh(jb):
    """ZeRO-2 composes with the staged-IR pipeline: on a dp x stage mesh
    the packed stage rows' gradients reduce-scatter over data and the
    loss curve still equals the single-device run at 1e-9."""
    from tensor_ops.parallel.pipeline import make_dp_pipeline_mesh

    h = 16
    r = np.random.default_rng(6)
    X = r.uniform(0, 1, size=(64, h))
    Y = r.uniform(0, 1, size=(64, h))
    loss = squared_error(h)
    mesh = make_dp_pipeline_mesh(2, 4)
    kw = dict(epochs=1, batch_size=16, lr=0.05, optimizer=adam(),
              verbose=False, prefetch=0, log_every=1,
              pipeline_microbatches=2)

    def mknet():
        return gen_net(jb, h, h, [(h, act_logistic())] * 3,
                       act_logistic(), Rng(jb, seed=5))

    r_2 = fit(mknet(), loss, jb, X, Y, mesh=mesh, zero_stage=2, **kw)
    r_sd = fit(mknet(), loss, jb, X, Y, **{
        k: v for k, v in kw.items() if k != "pipeline_microbatches"})
    for ra, rb in zip(r_2.history, r_sd.history):
        assert abs(ra["loss"] - rb["loss"]) < 1e-9, (ra, rb)
    for a, b in zip(r_2.net.params, r_sd.net.params):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-9, rtol=0)


@multi
def test_fit_sequences_zero2(jb):
    """ZeRO-2 on the recurrent loop: the joint state+param gradients
    reduce-scatter; == the replicated run at 1e-9."""
    from tensor_ops.models.recurrent import gen_net as gen_rnet

    def mknet():
        return gen_rnet(jb, 1, 1, [(8, act_logistic(), act_logistic())],
                        act_logistic(), None, Rng(jb, seed=7))

    t = np.linspace(0, 1, 9)
    r = np.random.default_rng(8)
    waves = np.sin(2 * np.pi * t[None, :]
                   + r.uniform(0, np.pi, size=(16, 1)))
    XS, TS = waves[:, :-1, None], waves[:, 1:, None]
    mesh = make_mesh(8, shape=(4, 2))
    kw = dict(epochs=2, batch_size=8, optimizer=adam(),
              rate_param=0.05, rate_state=0.01, verbose=False,
              prefetch=0, log_every=1, mesh=mesh)

    r_2 = fit_sequences(mknet(), squared_error(1), jb, XS, TS,
                        zero_stage=2, **kw)
    r_r = fit_sequences(mknet(), squared_error(1), jb, XS, TS, **kw)
    for ra, rb in zip(r_2.history, r_r.history):
        assert abs(ra["loss"] - rb["loss"]) < 1e-9, (ra, rb)
    for a, b in zip(r_2.net.params, r_r.net.params):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-9, rtol=0)


@multi
def test_zero2_memory_report_and_validation(jb):
    """training_memory_report divides the gradient row by dp under
    zero_stage=2; contradictory/invalid stages are rejected eagerly;
    a non-shardable mesh warns loudly and continues."""
    import warnings

    from tensor_ops.utils.profiling import training_memory_report

    mesh = make_mesh(8, shape=(4, 2))
    net = _net(jb)
    r1 = training_memory_report(net, optimizer=adam(), mesh=mesh,
                                zero_stage=1)["per_device"]
    r2 = training_memory_report(net, optimizer=adam(), mesh=mesh,
                                zero_stage=2)["per_device"]
    assert r2["grads_bytes"] < r1["grads_bytes"]
    assert r2["optimizer_bytes"] == r1["optimizer_bytes"]
    assert r2["params_bytes"] == r1["params_bytes"]

    X, Y = _data(n=32)
    loss = cross_entropy(4)
    with pytest.raises(ValueError, match="zero_stage must be"):
        fit(_net(jb), loss, jb, X, Y, mesh=mesh, zero_stage=4,
            verbose=False)
    with pytest.raises(ValueError, match="contradicts"):
        fit(_net(jb), loss, jb, X, Y, mesh=mesh, zero_stage=0,
            shard_opt_state=True, verbose=False)
    with pytest.raises(ValueError, match="ZeRO-2"):
        fit(_net(jb), loss, jb, X, Y, zero_stage=2, verbose=False)

    # dp=1 mesh: gradients can't shard -> loud warning, run continues
    mesh1 = make_mesh(8, shape=(1, 8))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        res = fit(_net(jb, seed=10), loss, jb, X, Y, epochs=1,
                  batch_size=16, optimizer=adam(), mesh=mesh1,
                  zero_stage=2, verbose=False, prefetch=0, log_every=1)
    assert any("zero_stage=2" in str(x.message) for x in w)
    assert all(np.isfinite(h["loss"]) for h in res.history)
