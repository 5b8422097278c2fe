"""Device-side chained shuffle (``fit(chain_shuffle='device')``).

The host-index chained path streams ``batch*4`` bytes of indices per
step to the device; device mode computes them IN-GRAPH from
counter-based threefry epoch permutations — zero host index traffic,
the production loop.  Contract pinned here: each epoch
visits every row exactly once, indices are a pure function of
``(seed, absolute step)`` (so every window partition and every
crash/resume chain replays the identical batch sequence bit for bit),
and the knob errors loudly where it cannot hold that contract.
"""

import numpy as np
import pytest

from tensor_ops.backend.rng import Rng
from tensor_ops.models import (act_logistic, act_softmax, cross_entropy,
                                   gen_net)
from tensor_ops.models.optim import adam, cosine_schedule, sgd
from tensor_ops.models.trainer import (_device_fixed_perm,
                                           _device_window_indices,
                                           _device_window_offsets, fit)


def _mknet(be, seed=1):
    return gen_net(be, 16, 4, [(32, act_logistic())], act_softmax(),
                   Rng(be, seed=seed))


def _data(n=512, seed=0):
    g = np.random.default_rng(seed)
    X = g.uniform(-1, 1, (n, 16)).astype(np.float32)
    Y = np.eye(4, dtype=np.float32)[g.integers(0, 4, n)]
    return X, Y


def _max_diff(ps, qs):
    return max(float(np.max(np.abs(np.asarray(a) - np.asarray(b))))
               for a, b in zip(ps, qs))


# ---------------------------------------------------------------------------
# the in-graph index stream itself
# ---------------------------------------------------------------------------

def test_device_indices_cover_each_epoch_exactly_once():
    n, batch = 96, 16
    spe = n // batch  # 6
    idx = np.asarray(_device_window_indices(3, n, batch, spe, 0, 3 * spe))
    assert idx.shape == (3 * spe, batch)
    for e in range(3):
        epoch_rows = np.sort(idx[e * spe:(e + 1) * spe].ravel())
        assert np.array_equal(epoch_rows, np.arange(n))
    # distinct epochs shuffle differently
    assert not np.array_equal(idx[:spe], idx[spe:2 * spe])


def test_device_indices_are_window_partition_invariant():
    n, batch, spe = 64, 16, 4
    whole = np.asarray(_device_window_indices(7, n, batch, spe, 0, 11))
    # any split at any offset reproduces the same per-step rows
    parts = [np.asarray(_device_window_indices(7, n, batch, spe, s0, k))
             for s0, k in [(0, 3), (3, 5), (8, 3)]]
    assert np.array_equal(whole, np.concatenate(parts, axis=0))
    # mid-epoch window start (step 5 = epoch 1 slot 1) — same rows
    assert np.array_equal(
        whole[5:9], np.asarray(_device_window_indices(7, n, batch, spe,
                                                      5, 4)))


def test_device_indices_seed_sensitivity():
    a = np.asarray(_device_window_indices(0, 64, 16, 4, 0, 4))
    b = np.asarray(_device_window_indices(1, 64, 16, 4, 0, 4))
    assert not np.array_equal(a, b)


def test_device_fixed_offsets_cover_each_epoch_exactly_once():
    """Shuffle-once mode: each epoch visits every batch SLOT exactly
    once (fresh order per epoch), so composed with the fixed row
    permutation every epoch still covers every row exactly once."""
    spe, batch = 6, 16
    offs = np.asarray(_device_window_offsets(3, batch, spe, 0, 3 * spe))
    assert offs.shape == (3 * spe,)
    for e in range(3):
        slots = np.sort(offs[e * spe:(e + 1) * spe]) // batch
        assert np.array_equal(slots, np.arange(spe))
    assert not np.array_equal(offs[:spe], offs[spe:2 * spe])
    # window-partition invariance, mid-epoch starts included
    parts = [np.asarray(_device_window_offsets(3, batch, spe, s0, k))
             for s0, k in [(0, 5), (5, 9), (14, 4)]]
    assert np.array_equal(offs, np.concatenate(parts))
    # the row permutation is a permutation and differs from the slot
    # stream's key (split siblings)
    p = np.asarray(_device_fixed_perm(3, 96))
    assert np.array_equal(np.sort(p), np.arange(96))


# ---------------------------------------------------------------------------
# fit(chain_shuffle='device')
# ---------------------------------------------------------------------------

def test_device_mode_partition_invariance_full_surface(jb):
    """The trajectory depends only on (seed, step): different window
    caps and observation cadences — which cut the run into completely
    different dispatch windows — give bit-identical params, EMA, and
    (where steps coincide) logged losses."""
    X, Y = _data(512)
    kw = dict(epochs=3, batch_size=64, optimizer=adam(),
              lr_schedule=cosine_schedule(0.01, 24), ema_decay=0.9,
              chain_shuffle="device", verbose=False, seed=3)
    r1 = fit(_mknet(jb), cross_entropy(4), jb, X, Y, chain_steps="auto",
             log_every=7, **kw)
    r2 = fit(_mknet(jb), cross_entropy(4), jb, X, Y, chain_steps=5,
             log_every=3, **kw)
    assert r1.steps == r2.steps == 24
    assert _max_diff(r1.net.params, r2.net.params) == 0.0
    assert _max_diff(r1.ema_net.params, r2.ema_net.params) == 0.0
    l1 = {r["step"]: r["loss"] for r in r1.history}
    l2 = {r["step"]: r["loss"] for r in r2.history}
    for s in set(l1) & set(l2):
        assert l1[s] == l2[s]


def test_device_mode_resume_bit_exact(jb, tmp_path):
    X, Y = _data(512)
    ck = str(tmp_path / "dev.npz")
    kw = dict(batch_size=64, optimizer=sgd(), lr=0.05, log_every=4,
              chain_shuffle="device", verbose=False, seed=9)
    r_full = fit(_mknet(jb), cross_entropy(4), jb, X, Y, epochs=4, **kw)
    fit(_mknet(jb), cross_entropy(4), jb, X, Y, epochs=2,
        checkpoint_path=ck, checkpoint_every=8, **kw)
    r_res = fit(_mknet(jb, seed=99), cross_entropy(4), jb, X, Y, epochs=4,
                checkpoint_path=ck, checkpoint_every=8, resume=True, **kw)
    assert r_res.steps == r_full.steps == 32
    assert _max_diff(r_full.net.params, r_res.net.params) == 0.0


def test_device_mode_trains_and_history_complete(jb):
    X, Y = _data(512)
    r = fit(_mknet(jb), cross_entropy(4), jb, X, Y, epochs=6,
            batch_size=64, lr=0.5, log_every=8, chain_shuffle="device",
            verbose=False)
    assert [h["step"] for h in r.history] == [1] + list(range(8, 49, 8))
    assert r.history[-1]["loss"] < r.history[0]["loss"]


def test_device_fixed_mode_full_surface(jb, tmp_path):
    """device_fixed: partition invariance, exact resume, training
    sanity, epoch coverage via the loss trajectory."""
    X, Y = _data(512)
    kw = dict(epochs=3, batch_size=64, optimizer=adam(),
              lr_schedule=cosine_schedule(0.01, 24), ema_decay=0.9,
              chain_shuffle="device_fixed", verbose=False, seed=3)
    r1 = fit(_mknet(jb), cross_entropy(4), jb, X, Y, chain_steps="auto",
             log_every=7, **kw)
    r2 = fit(_mknet(jb), cross_entropy(4), jb, X, Y, chain_steps=5,
             log_every=3, **kw)
    assert r1.steps == r2.steps == 24
    assert _max_diff(r1.net.params, r2.net.params) == 0.0
    assert _max_diff(r1.ema_net.params, r2.ema_net.params) == 0.0
    # differs from the per-epoch-reshuffle stream (different batches)
    r3 = fit(_mknet(jb), cross_entropy(4), jb, X, Y, chain_steps="auto",
             log_every=7, epochs=3, batch_size=64, optimizer=adam(),
             lr_schedule=cosine_schedule(0.01, 24), ema_decay=0.9,
             chain_shuffle="device", verbose=False, seed=3)
    assert _max_diff(r1.net.params, r3.net.params) > 0.0

    ck = str(tmp_path / "fx.npz")
    kw2 = dict(batch_size=64, optimizer=sgd(), lr=0.5, log_every=4,
               chain_shuffle="device_fixed", verbose=False, seed=9)
    r_full = fit(_mknet(jb), cross_entropy(4), jb, X, Y, epochs=4, **kw2)
    fit(_mknet(jb), cross_entropy(4), jb, X, Y, epochs=2,
        checkpoint_path=ck, checkpoint_every=8, **kw2)
    r_res = fit(_mknet(jb, seed=99), cross_entropy(4), jb, X, Y, epochs=4,
                checkpoint_path=ck, checkpoint_every=8, resume=True, **kw2)
    assert _max_diff(r_full.net.params, r_res.net.params) == 0.0
    assert r_full.history[-1]["loss"] < r_full.history[0]["loss"]


def test_device_mode_validation(jb, nb):
    X, Y = _data(130)  # ragged vs batch 64
    with pytest.raises(ValueError, match="ragged tail"):
        fit(_mknet(jb), cross_entropy(4), jb, X, Y, batch_size=64,
            chain_shuffle="device", verbose=False)
    X, Y = _data(128)
    with pytest.raises(ValueError, match="chain_shuffle"):
        fit(_mknet(jb), cross_entropy(4), jb, X, Y, batch_size=64,
            chain_shuffle="both", verbose=False)
    with pytest.raises(ValueError, match="fell back"):
        fit(_mknet(jb), cross_entropy(4), jb, X, Y, batch_size=64,
            chain_steps=1, chain_shuffle="device", verbose=False)
    with pytest.raises(ValueError, match="fell back"):
        fit(_mknet(nb), cross_entropy(4), nb, X, Y, batch_size=64,
            chain_shuffle="device", verbose=False)
