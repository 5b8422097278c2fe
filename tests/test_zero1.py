"""ZeRO-1 optimizer-state sharding (``shard_opt_state=True``): the
moments shard over the mesh's data axis — 1/dp of the optimizer memory
per device — while training stays EXACTLY equal to the replicated run
(the sharding is an annotation; XLA inserts the update's all-gather).
The reference has no distribution at all (SURVEY.md §2.5); this is the
rebuild's production surface, so equality is asserted at 1e-9 and
crash/resume must reproduce the uninterrupted run."""

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
    momentum,
    squared_error,
)
from tensor_ops.models.trainer import fit, fit_sequences, make_opt_step
from tensor_ops.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    make_mesh,
    param_specs,
    zero1_place,
    zero1_shardings,
)

multi = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 devices (see conftest note)"
)


def _net(jb, seed=0, h=16):
    rng = Rng(jb, seed=seed)
    return gen_net(jb, h, 4, [(h, act_logistic()), (h, act_logistic())],
                   act_softmax(), rng)


def _data(n=32, h=16, seed=1):
    r = np.random.default_rng(seed)
    X = r.uniform(0, 1, size=(n, h))
    Y = np.eye(4)[r.integers(0, 4, size=n)]
    return X, Y


def _spec_axes(sharding):
    axes = set()
    for s in sharding.spec:
        if isinstance(s, str):
            axes.add(s)
        elif isinstance(s, (tuple, list)):
            axes.update(s)
    return axes


@multi
def test_zero1_shardings_extend_inherited(jb):
    """Moment leaves gain the data axis on their first free divisible
    dim while KEEPING the inherited model-axis sharding; scalars and
    non-divisible leaves stay untouched."""
    mesh = make_mesh(8, shape=(4, 2))
    net = _net(jb)
    pspecs = param_specs(net.param_stack, mesh)
    params = tuple(jax.device_put(p, NamedSharding(mesh, s))
                   for p, s in zip(net.params, pspecs))
    opt = adam()
    state, cons = zero1_place(opt.init(params), mesh)
    assert cons is not None
    t, m, v = state
    assert t == 0 and not isinstance(t, jax.Array)  # scalar untouched
    for moments in (m, v):
        for mi, p in zip(moments, params):
            got = _spec_axes(mi.sharding)
            inherited = _spec_axes(p.sharding)
            # (16,16) weights: one free dim -> data joins; (16,) biases
            # sharded over model have no free dim -> unchanged
            assert inherited <= got
            free = sum(1 for s in list(p.sharding.spec)
                       + [None] * (p.ndim - len(p.sharding.spec))
                       if s is None)
            if free and all(d % 4 == 0 for d in mi.shape):
                assert DATA_AXIS in got, (mi.shape, mi.sharding)
    # flat-shardings helper agrees with the placement
    shs, _ = zero1_shardings(state, mesh)
    flat = jax.tree.leaves(state)
    for x, sh in zip(flat, shs):
        assert sh is None  # already data-sharded -> nothing left to add


@multi
def test_opt_step_zero1_moments_stay_sharded(jb):
    """Three steps through make_opt_step(zero_constrain=...): the
    updated moments KEEP their data-axis sharding (the constraint pins
    them; XLA must not re-replicate), and params equal the replicated
    run at 1e-9."""
    mesh = make_mesh(8, shape=(4, 2))
    loss = cross_entropy(4)
    X, Y = _data()
    opt = adam()

    def run(zero):
        net = _net(jb, seed=2)
        pspecs = param_specs(net.param_stack, mesh)
        params = tuple(jax.device_put(p, NamedSharding(mesh, s))
                       for p, s in zip(net.params, pspecs))
        if zero:
            state, cons = zero1_place(opt.init(params), mesh)
            assert cons is not None
        else:
            state, cons = opt.init(params), None
        step = make_opt_step(net, loss, jb, opt, mesh=mesh,
                             zero_constrain=cons)
        xb = jax.device_put(jb.asarray(X),
                            NamedSharding(mesh, PSpec(DATA_AXIS, None)))
        yb = jax.device_put(jb.asarray(Y),
                            NamedSharding(mesh, PSpec(DATA_AXIS, None)))
        for _ in range(3):
            v, state, params = step(0.05, xb, yb, state, params)
        return v, state, params

    v_z, state_z, params_z = run(zero=True)
    v_r, _, params_r = run(zero=False)
    assert abs(float(v_z) - float(v_r)) < 1e-9
    for a, b in zip(params_z, params_r):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-9, rtol=0)
    _, m, _ = state_z
    sharded = [mi for mi in m if DATA_AXIS in _spec_axes(mi.sharding)]
    assert sharded, "no moment kept its data-axis sharding after updates"
    for mi in sharded:
        assert not mi.sharding.is_fully_replicated


@multi
@pytest.mark.parametrize("opt_f", [adam, momentum])
def test_fit_zero1_equals_replicated(jb, tmp_path, opt_f):
    """fit(mesh=dp x tp, shard_opt_state=True): loss curve and params
    == the replicated-moments run at 1e-9; crash/resume reproduces the
    uninterrupted run exactly (moments re-place onto their ZeRO
    shardings at load)."""
    import warnings

    mesh = make_mesh(8, shape=(4, 2))
    loss = cross_entropy(4)
    X, Y = _data(n=64)
    kw = dict(epochs=2, batch_size=16, lr=0.05, optimizer=opt_f(),
              verbose=False, prefetch=0, log_every=1, mesh=mesh)

    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        r_z = fit(_net(jb, seed=3), loss, jb, X, Y,
                  shard_opt_state=True, **kw)
    assert not any("shard_opt_state" in str(x.message) for x in w)
    r_r = fit(_net(jb, seed=3), loss, jb, X, Y, **kw)
    for ra, rb in zip(r_z.history, r_r.history):
        assert abs(ra["loss"] - rb["loss"]) < 1e-9, (ra, rb)
    for a, b in zip(r_z.net.params, r_r.net.params):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-9, rtol=0)

    ck = str(tmp_path / "z1.npz")
    fit(_net(jb, seed=3), loss, jb, X, Y, shard_opt_state=True,
        checkpoint_path=ck, checkpoint_every=2,
        **{**kw, "epochs": 1})
    resumed = fit(_net(jb, seed=3), loss, jb, X, Y, shard_opt_state=True,
                  checkpoint_path=ck, checkpoint_every=2, resume=True,
                  **kw)
    for a, b in zip(resumed.net.params, r_z.net.params):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-9, rtol=0)


@multi
def test_fit_zero1_pipeline_mesh(jb):
    """ZeRO-1 composes with the staged-IR pipeline: on a dp x stage
    mesh the packed stage rows' moments additionally shard over data,
    and the loss curve still equals the single-device run at 1e-9."""
    from tensor_ops.parallel.pipeline import make_dp_pipeline_mesh

    h = 16
    rng = Rng(jb, seed=5)
    net = gen_net(jb, h, h, [(h, act_logistic())] * 3, act_logistic(),
                  rng)
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

    r_z = fit(mknet(), loss, jb, X, Y, mesh=mesh, shard_opt_state=True,
              **kw)
    r_sd = fit(mknet(), loss, jb, X, Y, **{
        k: v for k, v in kw.items() if k != "pipeline_microbatches"})
    for ra, rb in zip(r_z.history, r_sd.history):
        assert abs(ra["loss"] - rb["loss"]) < 1e-9, (ra, rb)
    for a, b in zip(r_z.net.params, r_sd.net.params):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-9, rtol=0)


@multi
def test_fit_sequences_zero1(jb):
    """ZeRO-1 on the recurrent loop: fit_sequences(mesh=dp x tp,
    shard_opt_state=True) == the replicated run at 1e-9."""
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

    r_z = fit_sequences(mknet(), squared_error(1), jb, XS, TS,
                        shard_opt_state=True, **kw)
    r_r = fit_sequences(mknet(), squared_error(1), jb, XS, TS, **kw)
    for ra, rb in zip(r_z.history, r_r.history):
        assert abs(ra["loss"] - rb["loss"]) < 1e-9, (ra, rb)
    for a, b in zip(r_z.net.params, r_r.net.params):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-9, rtol=0)


@multi
def test_zero1_validation_and_noop_warning(jb):
    """Mesh-less shard_opt_state and optimizer-less fit_sequences are
    rejected eagerly; a mesh whose data axis can't shard anything warns
    loudly and continues."""
    import warnings

    X, Y = _data()
    loss = cross_entropy(4)
    with pytest.raises(ValueError, match="ZeRO-1"):
        fit(_net(jb, seed=9), loss, jb, X, Y, epochs=1, batch_size=16,
            shard_opt_state=True, verbose=False, prefetch=0)

    t = np.linspace(0, 1, 5)
    XS = np.sin(t)[None, :, None].repeat(8, axis=0)
    with pytest.raises(ValueError, match="stateless"):
        fit_sequences(None, squared_error(1), jb, XS[:, :-1], XS[:, 1:],
                      shard_opt_state=True, mesh=make_mesh(8, shape=(4, 2)))

    # dp=1 mesh: nothing to shard -> loud warning, run continues
    mesh1 = make_mesh(8, shape=(1, 8))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        res = fit(_net(jb, seed=10), loss, jb, X, Y, epochs=1,
                  batch_size=16, optimizer=adam(), mesh=mesh1,
                  shard_opt_state=True, verbose=False, prefetch=0,
                  log_every=1)
    assert any("shard_opt_state" in str(x.message) for x in w)
    assert all(np.isfinite(h["loss"]) for h in res.history)


@multi
def test_fit_verbose_prints_memory_line(jb, capsys):
    """fit(verbose=True, mesh=...) prints the per-device training-state
    line (the training_memory_report one-liner) before the loop."""
    mesh = make_mesh(8, shape=(4, 2))
    X, Y = _data(n=32)
    fit(_net(jb, seed=11), cross_entropy(4), jb, X, Y, epochs=1,
        batch_size=16, optimizer=adam(), mesh=mesh, shard_opt_state=True,
        verbose=True, prefetch=0, log_every=100)
    out = capsys.readouterr().out
    assert "training state/device:" in out and "(zero1)" in out
