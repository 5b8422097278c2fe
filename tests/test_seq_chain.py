"""Step-chaining for the recurrent loop
(``fit_sequences(chain_steps=...)``): one dispatch per observation
window, the same contract as ``fit``'s (tests/test_chain.py).

The recurrent analog exists because the measured realized rate of
``fit_sequences`` was only 59% of its own jitted step's ``fori_loop``
rate (BENCH.md "fit_sequences realized throughput", round 5) — the
per-step dispatch + sequence-batch upload dominated.  Chained, the
window runs as one ``lax.scan`` over the device-resident dataset.

Contract pinned here: the TRAINING TRAJECTORY is bit-identical in host
mode (states, params, EMA — the index stream IS ``_SeqStream``'s
stream, the scan body is the same traced step); the logged loss scalar
is allclose-but-not-always-bitwise (the scan's stacked loss output may
fuse with a different f32 reduction order than the standalone step's
scalar output — params prove the math itself is identical).  Device
modes are pure functions of (seed, absolute step): any window
partition and any crash/resume chain replays identical batches.
"""

import numpy as np
import pytest

import tensor_ops as T
from tensor_ops.backend.rng import Rng
from tensor_ops.models import act_logistic, fit_sequences, squared_error
from tensor_ops.models import recurrent as R
from tensor_ops.models.optim import adam, cosine_schedule


def _mknet(be, seed=7):
    return R.gen_net(be, 4, 3, [(8, act_logistic(), act_logistic())],
                     act_logistic(), None, Rng(be, seed=seed))


def _data(n=48, seq=5, seed=0):
    g = np.random.default_rng(seed)
    XS = g.standard_normal((n, seq, 4)).astype(np.float32)
    TS = g.standard_normal((n, seq, 3)).astype(np.float32)
    return XS, TS


def _leaves(res):
    return tuple(res.net.states) + tuple(res.net.params)


def _assert_bitwise(r1, r2):
    for a, b in zip(_leaves(r1), _leaves(r2)):
        assert np.array_equal(np.asarray(a), np.asarray(b)), \
            float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


KW = dict(batch_size=8, rate_state=0.01, rate_param=0.05, verbose=False,
          seed=3)


def test_chained_equals_unchained_dual_rate(jb):
    XS, TS = _data()
    kw = dict(KW, epochs=4, log_every=3)
    r1 = fit_sequences(_mknet(jb), squared_error(3), jb, XS, TS,
                       chain_steps=1, **kw)
    r2 = fit_sequences(_mknet(jb), squared_error(3), jb, XS, TS,
                       chain_steps="auto", **kw)
    _assert_bitwise(r1, r2)
    l1 = [h["loss"] for h in r1.history]
    l2 = [h["loss"] for h in r2.history]
    assert [h["step"] for h in r1.history] == [h["step"] for h in
                                               r2.history]
    np.testing.assert_allclose(l1, l2, rtol=1e-5)


def test_chained_equals_unchained_adam_ema_schedule(jb):
    XS, TS = _data()
    kw = dict(KW, epochs=3, log_every=4, optimizer=adam(),
              ema_decay=0.9, lr_schedule=cosine_schedule(0.05, 18))
    r1 = fit_sequences(_mknet(jb), squared_error(3), jb, XS, TS,
                       chain_steps=1, **kw)
    r2 = fit_sequences(_mknet(jb), squared_error(3), jb, XS, TS,
                       chain_steps="auto", **kw)
    _assert_bitwise(r1, r2)
    for a, b in zip(tuple(r1.ema_net.states) + tuple(r1.ema_net.params),
                    tuple(r2.ema_net.states) + tuple(r2.ema_net.params)):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_explicit_k_and_cap(jb):
    XS, TS = _data()
    kw = dict(KW, epochs=3, log_every=6)
    r1 = fit_sequences(_mknet(jb), squared_error(3), jb, XS, TS,
                       chain_steps=1, **kw)
    r3 = fit_sequences(_mknet(jb), squared_error(3), jb, XS, TS,
                       chain_steps=3, **kw)
    _assert_bitwise(r1, r3)


def test_chain_validation(jb):
    XS, TS = _data()
    with pytest.raises(ValueError, match="chain_steps"):
        fit_sequences(_mknet(jb), squared_error(3), jb, XS, TS,
                      chain_steps=0, **KW)
    with pytest.raises(ValueError, match="chain_steps"):
        fit_sequences(_mknet(jb), squared_error(3), jb, XS, TS,
                      chain_steps="always", **KW)
    with pytest.raises(ValueError, match="chain_shuffle"):
        fit_sequences(_mknet(jb), squared_error(3), jb, XS, TS,
                      chain_shuffle="nope", **KW)
    with pytest.raises(ValueError, match="whole batches"):
        fit_sequences(_mknet(jb), squared_error(3), jb, XS[:45], TS[:45],
                      chain_shuffle="device", **KW)
    with pytest.raises(ValueError, match="offload"):
        fit_sequences(_mknet(jb), squared_error(3), jb, XS, TS,
                      chain_steps=4, optimizer=adam(),
                      offload_opt_state=True, **KW)


@pytest.mark.parametrize("mode", ["device", "device_fixed"])
def test_device_modes_partition_invariant(jb, mode):
    """In-graph index streams are pure functions of (seed, absolute
    step): different observation cadences — different window
    partitions — produce the identical final training state."""
    XS, TS = _data()
    r1 = fit_sequences(_mknet(jb), squared_error(3), jb, XS, TS,
                       epochs=3, log_every=3, chain_shuffle=mode, **KW)
    r2 = fit_sequences(_mknet(jb), squared_error(3), jb, XS, TS,
                       epochs=3, log_every=5, chain_shuffle=mode, **KW)
    _assert_bitwise(r1, r2)


def test_chained_resume_bit_exact(jb, tmp_path):
    XS, TS = _data()
    ck = str(tmp_path / "seqchain.npz")
    kw = dict(KW, log_every=3, checkpoint_path=ck, checkpoint_every=6)
    full = fit_sequences(_mknet(jb), squared_error(3), jb, XS, TS,
                         epochs=3, **kw)
    fit_sequences(_mknet(jb), squared_error(3), jb, XS, TS, epochs=2,
                  **kw)
    resumed = fit_sequences(_mknet(jb), squared_error(3), jb, XS, TS,
                            epochs=3, resume=True, **kw)
    _assert_bitwise(full, resumed)


@pytest.mark.parametrize("mode", ["device", "device_fixed"])
def test_device_mode_resume_bit_exact(jb, tmp_path, mode):
    XS, TS = _data()
    ck = str(tmp_path / f"seqchain_{mode}.npz")
    kw = dict(KW, log_every=3, checkpoint_path=ck, checkpoint_every=6,
              chain_shuffle=mode)
    full = fit_sequences(_mknet(jb), squared_error(3), jb, XS, TS,
                         epochs=3, **kw)
    fit_sequences(_mknet(jb), squared_error(3), jb, XS, TS, epochs=2,
                  **kw)
    resumed = fit_sequences(_mknet(jb), squared_error(3), jb, XS, TS,
                            epochs=3, resume=True, **kw)
    _assert_bitwise(full, resumed)


def test_val_and_early_stop_still_work_chained(jb):
    XS, TS = _data(n=56)
    r = fit_sequences(_mknet(jb), squared_error(3), jb, XS[:48], TS[:48],
                      epochs=50, log_every=3, val=(XS[48:], TS[48:]),
                      early_stop_patience=2, chain_steps="auto", **KW)
    assert r.steps < 50 * 6  # stopped early
    assert all("val_loss" in h for h in r.history)


def test_chain_backs_off_on_numpy_backend(nb):
    XS, TS = _data(n=16)
    r = fit_sequences(_mknet(nb), squared_error(3), nb, XS, TS,
                      epochs=1, chain_steps="auto", **KW)
    assert r.steps == 2  # ran unchained, no error
