"""Optimizer-state HOST OFFLOAD (``fit(offload_opt_state=True)``): the
moments live in pinned host DRAM between steps — the ZeRO-Offload
placement done with ``jax.memory.Space`` transfers inside the jitted
step, so XLA schedules the device<->host copies itself.  Steady-
state optimizer HBM is ZERO; the update math must be BIT-identical to
the on-device run (placement changes nothing numerically), checkpoints
must resume exactly, and the knob must compose with the whole ZeRO
ladder.  The reference has no optimizer state at all (per-sample SGD,
``FeedForward.hs:141-147``) — this extends the rebuild's own production
surface (SURVEY.md §2.5's memory ladder).

On the CPU test backend host and device memory are the same DRAM, so
these tests pin the SEMANTICS (equality, resume, composition, errors);
the pinned-host residency itself is asserted by the ``gpu``-marked test,
which runs on the card."""

import warnings

import numpy as np
import pytest

import jax

from tensor_ops.backend.rng import Rng
from tensor_ops.models import (
    act_logistic,
    act_softmax,
    adam,
    adam8bit,
    cross_entropy,
    gen_net,
    sgd,
    squared_error,
)
from tensor_ops.models.trainer import fit, fit_sequences
from tensor_ops.parallel.mesh import make_mesh

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


def _assert_equal_runs(ra, rb, atol=0.0):
    for ha, hb in zip(ra.history, rb.history):
        assert abs(ha["loss"] - hb["loss"]) <= atol, (ha, hb)
    for a, b in zip(ra.net.params, rb.net.params):
        if atol == 0.0:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        else:
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       atol=atol, rtol=0)


@pytest.mark.parametrize("optf", [adam, adam8bit])
def test_offload_bit_identical_single_device(jb, optf):
    """fit(offload_opt_state=True) without a mesh: loss curve and
    params BIT-equal the on-device run — placement changes nothing
    numerically (adam and the int8-coded adam8bit state alike)."""
    X, Y = _data(n=64)
    loss = cross_entropy(4)
    kw = dict(epochs=2, batch_size=16, lr=0.05, optimizer=optf(),
              verbose=False, prefetch=0, log_every=1)
    r_off = fit(_net(jb, seed=3), loss, jb, X, Y,
                offload_opt_state=True, **kw)
    r_on = fit(_net(jb, seed=3), loss, jb, X, Y, **kw)
    _assert_equal_runs(r_off, r_on)


@multi
@pytest.mark.parametrize("zstage", [0, 3])
def test_offload_composes_with_zero_ladder(jb, zstage):
    """offload + dp x tp mesh (and + ZeRO-3, the full ladder with host
    moments on top): == the same configuration without offload,
    bit-for-bit."""
    mesh = make_mesh(8, shape=(4, 2))
    X, Y = _data(n=64)
    loss = cross_entropy(4)
    kw = dict(epochs=1, batch_size=16, lr=0.05, optimizer=adam(),
              verbose=False, prefetch=0, log_every=1, mesh=mesh)
    if zstage:
        kw["zero_stage"] = zstage
    r_off = fit(_net(jb, seed=4), loss, jb, X, Y,
                offload_opt_state=True, **kw)
    r_on = fit(_net(jb, seed=4), loss, jb, X, Y, **kw)
    _assert_equal_runs(r_off, r_on)


@multi
def test_offload_resume_exact(jb, tmp_path):
    """A crash/resume chain under offload reproduces the uninterrupted
    offloaded run exactly — moments save from and restore to their
    host placement."""
    mesh = make_mesh(8, shape=(4, 2))
    X, Y = _data(n=64)
    loss = cross_entropy(4)
    kw = dict(batch_size=16, lr=0.05, optimizer=adam(), verbose=False,
              prefetch=0, log_every=1, mesh=mesh, zero_stage=1,
              offload_opt_state=True)
    full = fit(_net(jb, seed=5), loss, jb, X, Y, epochs=2, **kw)
    ck = str(tmp_path / "off.npz")
    fit(_net(jb, seed=5), loss, jb, X, Y, epochs=1,
        checkpoint_path=ck, checkpoint_every=2, **kw)
    resumed = fit(_net(jb, seed=5), loss, jb, X, Y, epochs=2,
                  checkpoint_path=ck, checkpoint_every=2, resume=True,
                  **kw)
    for a, b in zip(resumed.net.params, full.net.params):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_offload_pipeline_mesh(jb):
    """offload composes with the staged-IR pipeline step (moments of
    the packed stage rows live on the host between steps)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    from tensor_ops.parallel.pipeline import make_pipeline_mesh

    h = 16
    r = np.random.default_rng(6)
    X = r.uniform(0, 1, size=(32, h))
    Y = r.uniform(0, 1, size=(32, h))
    loss = squared_error(h)
    mesh = make_pipeline_mesh(4)
    kw = dict(epochs=1, batch_size=16, lr=0.05, optimizer=adam(),
              verbose=False, prefetch=0, log_every=1, mesh=mesh,
              pipeline_microbatches=2)

    def mknet():
        return gen_net(jb, h, h, [(h, act_logistic())] * 3,
                       act_logistic(), Rng(jb, seed=7))

    r_off = fit(mknet(), loss, jb, X, Y, offload_opt_state=True, **kw)
    r_on = fit(mknet(), loss, jb, X, Y, **kw)
    _assert_equal_runs(r_off, r_on)


def test_offload_sequences_bit_identical(jb):
    """fit_sequences(offload_opt_state=True): the recurrent family gets
    the same knob; bit-equal to the on-device run."""
    from tensor_ops.models.recurrent import gen_net as gen_rnet

    def mknet():
        return gen_rnet(jb, 1, 1, [(8, act_logistic(), act_logistic())],
                        act_logistic(), None, Rng(jb, seed=8))

    t = np.linspace(0, 1, 9)
    r = np.random.default_rng(9)
    waves = np.sin(2 * np.pi * t[None, :]
                   + r.uniform(0, np.pi, size=(16, 1)))
    XS, TS = waves[:, :-1, None], waves[:, 1:, None]
    kw = dict(epochs=2, batch_size=8, optimizer=adam(), rate_param=0.05,
              rate_state=0.01, verbose=False, prefetch=0, log_every=1)
    r_off = fit_sequences(mknet(), squared_error(1), jb, XS, TS,
                          offload_opt_state=True, **kw)
    r_on = fit_sequences(mknet(), squared_error(1), jb, XS, TS, **kw)
    for ha, hb in zip(r_off.history, r_on.history):
        assert ha["loss"] == hb["loss"], (ha, hb)
    for a, b in zip(r_off.net.params, r_on.net.params):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_offload_validation(jb, nb):
    """Eager errors: numpy backend rejected (its state already lives on
    the host); dual-rate fit_sequences rejected (nothing to offload);
    sgd warns loudly instead of silently doing nothing."""
    X, Y = _data(n=32)
    loss = cross_entropy(4)
    with pytest.raises(ValueError, match="offload_opt_state"):
        from tensor_ops.models.feedforward import gen_net as _gn  # noqa: F401

        fit(_net(nb), loss, nb, X, Y, offload_opt_state=True,
            verbose=False)

    from tensor_ops.models.recurrent import gen_net as gen_rnet

    rnet = gen_rnet(jb, 1, 1, [(8, act_logistic(), act_logistic())],
                    act_logistic(), None, Rng(jb, seed=1))
    XS = np.zeros((8, 4, 1))
    with pytest.raises(ValueError, match="offload_opt_state"):
        fit_sequences(rnet, squared_error(1), jb, XS, XS,
                      offload_opt_state=True, verbose=False)

    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        fit(_net(jb, seed=2), loss, jb, X, Y, epochs=1, batch_size=16,
            optimizer=sgd(), offload_opt_state=True, verbose=False,
            prefetch=0, log_every=1)
    assert any("nothing to offload" in str(x.message) for x in w)


def test_offload_memory_report_rows(jb):
    """training_memory_report(offload_opt_state=True): the moments
    leave the per-device HBM account (0 bytes resident) and appear in
    an explicit host row — the operator's pre-flight numbers stay
    honest."""
    from tensor_ops.utils.profiling import training_memory_report

    net = _net(jb)
    base = training_memory_report(net, optimizer=adam())["per_device"]
    off = training_memory_report(net, optimizer=adam(),
                                 offload_opt_state=True)["per_device"]
    assert base["optimizer_bytes"] > 0
    assert off["optimizer_bytes"] == 0
    assert off["optimizer_host_bytes"] == base["optimizer_bytes"]
    assert base.get("optimizer_host_bytes", 0) == 0
    # the ladder composes: zero1 divides the HOST bytes by dp too
    if len(jax.devices()) >= 8:
        mesh = make_mesh(8, shape=(4, 2))
        z1 = training_memory_report(net, optimizer=adam(), mesh=mesh,
                                    zero_stage=1,
                                    offload_opt_state=True)["per_device"]
        assert z1["optimizer_bytes"] == 0
        assert 0 < z1["optimizer_host_bytes"] < off["optimizer_host_bytes"]


@pytest.mark.gpu
def test_offload_residency_on_gpu(jb):
    """On the card the moments actually sit in pinned_host between steps
    (the CPU canonicalizes Space.Host to its one memory; fit returns
    converted artifacts, so assert at the make_opt_step level)."""
    from tensor_ops.models.trainer import make_opt_step

    X, Y = _data(n=32)
    net = _net(jb, seed=11)
    opt = adam()
    step = make_opt_step(net, cross_entropy(4), jb, opt, offload=True)
    state = jax.device_put(opt.init(net.params), jax.memory.Space.Host)
    v, state, params = step(0.05, jb.asarray(X), jb.asarray(Y), state,
                            net.params)
    kinds = {x.sharding.memory_kind
             for x in jax.tree_util.tree_leaves(state)
             if hasattr(x, "sharding")}
    assert kinds == {"pinned_host"}, kinds
