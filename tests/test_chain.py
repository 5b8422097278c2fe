"""Step-chaining (``fit(chain_steps=...)``): one dispatch per
observation window, bit-identical to the step-at-a-time loop.

The chained path exists to close the measured gap between the benched
``fori_loop`` step rate and ``fit()``'s realized throughput (round-5
VERDICT item 1): between observation boundaries (log_every /
checkpoint_every / ragged epoch tails / the budget) the loop runs the
whole window in one jitted ``lax.scan`` over the donated step, gathering
each step's batch on-device by loader indices.  These tests pin the
contract: same batches (the index stream IS the loader's stream), same
math (the scan body is the same traced step), same EMA recurrence, same
exact-resume guarantees — the reference's training loop productionized
(/root/reference/app/MNIST.hs:390-396) without changing its numbers.
"""

import os

import numpy as np
import pytest

import tensor_ops as T
from tensor_ops.backend.rng import Rng
from tensor_ops.models import (act_logistic, act_softmax, cross_entropy,
                                   gen_net)
from tensor_ops.models.optim import adam, adam8bit, cosine_schedule, sgd
from tensor_ops.models.trainer import fit
from tensor_ops.utils.native import NativeLoader


def _mknet(be, seed=1):
    return gen_net(be, 16, 4, [(32, act_logistic())], act_softmax(),
                   Rng(be, seed=seed))


def _data(n=530, seed=0):
    g = np.random.default_rng(seed)
    X = g.uniform(-1, 1, (n, 16)).astype(np.float32)
    Y = np.eye(4, dtype=np.float32)[g.integers(0, 4, n)]
    return X, Y


def _max_diff(ps, qs):
    return max(float(np.max(np.abs(np.asarray(a) - np.asarray(b))))
               for a, b in zip(ps, qs))


# ---------------------------------------------------------------------------
# index-mode loader: the chained stream IS the gathered stream
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("drop_last", [False, True])
def test_index_mode_matches_gathered_stream(drop_last):
    X, Y = _data(103)
    a = NativeLoader(X, Y, batch=16, seed=5, drop_last=drop_last)
    b = NativeLoader(X, Y, batch=16, seed=5, drop_last=drop_last,
                     index_mode=True)
    for _ in range(30):  # crosses several epoch reshuffles
        xa, ya = a.next()
        idx = b.next_indices()
        assert np.array_equal(xa, b.X[idx])
        assert np.array_equal(ya, b.Y[idx])
    a.close()
    b.close()


def test_index_mode_next_and_skip():
    X, Y = _data(103)
    a = NativeLoader(X, Y, batch=16, seed=9)
    b = NativeLoader(X, Y, batch=16, seed=9, index_mode=True)
    for _ in range(20):
        xa, ya = a.next()
        xb, yb = b.next()  # host gather from indices
        assert np.array_equal(xa, xb) and np.array_equal(ya, yb)
    # skip(n) advances the index stream exactly n batches
    c = NativeLoader(X, Y, batch=16, seed=9, index_mode=True)
    d = NativeLoader(X, Y, batch=16, seed=9, index_mode=True)
    c.skip(7)
    for _ in range(7):
        d.next_indices()
    for _ in range(10):
        assert np.array_equal(c.next_indices(), d.next_indices())
    for ld in (a, b, c, d):
        ld.close()


def test_index_mode_python_fallback(monkeypatch):
    # the numpy fallback must agree with itself across modes (the
    # native/fallback streams use different RNGs, so parity is checked
    # per-implementation)
    import tensor_ops.utils.native as nat

    monkeypatch.setattr(nat, "get_lib", lambda: None)
    X, Y = _data(103)
    a = nat.NativeLoader(X, Y, batch=16, seed=5)
    b = nat.NativeLoader(X, Y, batch=16, seed=5, index_mode=True)
    assert not a.is_native and not b.is_native
    for _ in range(30):
        xa, ya = a.next()
        idx = b.next_indices()
        assert np.array_equal(xa, X[idx])
        assert np.array_equal(ya, Y[idx])


def test_next_indices_requires_index_mode():
    X, Y = _data(40)
    a = NativeLoader(X, Y, batch=8, seed=0)
    with pytest.raises(ValueError, match="index_mode"):
        a.next_indices()
    a.close()


# ---------------------------------------------------------------------------
# chained fit == unchained fit, bit for bit
# ---------------------------------------------------------------------------

def test_chained_equals_unchained_full_surface(jb):
    """Ragged dataset, adam, cosine schedule, EMA, val logging: the
    chained run must reproduce the step-at-a-time run exactly —
    params, EMA, and every logged loss."""
    X, Y = _data(530)
    Xv, Yv = _data(64, seed=7)
    yv = np.argmax(Yv, axis=1)
    kw = dict(epochs=3, batch_size=64, optimizer=adam(),
              lr_schedule=cosine_schedule(0.01, 27), ema_decay=0.9,
              log_every=7, val=(Xv, yv), verbose=False, seed=3)
    r1 = fit(_mknet(jb), cross_entropy(4), jb, X, Y, chain_steps=1, **kw)
    r2 = fit(_mknet(jb), cross_entropy(4), jb, X, Y, chain_steps="auto",
             **kw)
    assert r1.steps == r2.steps == 27
    assert _max_diff(r1.net.params, r2.net.params) == 0.0
    assert _max_diff(r1.ema_net.params, r2.ema_net.params) == 0.0
    h1 = [(r["step"], r["loss"], r.get("val_acc")) for r in r1.history]
    h2 = [(r["step"], r["loss"], r.get("val_acc")) for r in r2.history]
    assert h1 == h2


def test_chained_equals_unchained_adam8bit(jb):
    X, Y = _data(512)
    kw = dict(epochs=2, batch_size=64, optimizer=adam8bit(),
              log_every=5, verbose=False, seed=1)
    r1 = fit(_mknet(jb), cross_entropy(4), jb, X, Y, chain_steps=1, **kw)
    r2 = fit(_mknet(jb), cross_entropy(4), jb, X, Y, chain_steps="auto",
             **kw)
    assert _max_diff(r1.net.params, r2.net.params) == 0.0


def test_chain_cap_and_explicit_k(jb):
    # explicit chain_steps caps the window; results identical anyway
    X, Y = _data(512)
    kw = dict(epochs=2, batch_size=64, optimizer=sgd(), lr=0.05,
              log_every=8, verbose=False, seed=2)
    r1 = fit(_mknet(jb), cross_entropy(4), jb, X, Y, chain_steps=1, **kw)
    r3 = fit(_mknet(jb), cross_entropy(4), jb, X, Y, chain_steps=3, **kw)
    assert _max_diff(r1.net.params, r3.net.params) == 0.0


def test_chain_validation(jb):
    X, Y = _data(128)
    with pytest.raises(ValueError, match="chain_steps"):
        fit(_mknet(jb), cross_entropy(4), jb, X, Y, chain_steps=0,
            verbose=False)
    with pytest.raises(ValueError, match="chain_steps"):
        fit(_mknet(jb), cross_entropy(4), jb, X, Y, chain_steps="always",
            verbose=False)
    with pytest.raises(ValueError, match="offload_opt_state"):
        fit(_mknet(jb), cross_entropy(4), jb, X, Y, chain_steps=4,
            offload_opt_state=True, optimizer=adam(), verbose=False)


# ---------------------------------------------------------------------------
# exact resume across chained windows
# ---------------------------------------------------------------------------

def test_chained_resume_bit_exact(jb, tmp_path):
    """A chained run checkpointed mid-way and resumed equals the
    uninterrupted chained run (and therefore the unchained one, by the
    equality above) — window boundaries are absolute step positions, so
    the resumed run re-derives the identical window sequence."""
    X, Y = _data(512)
    ck = str(tmp_path / "m.npz")
    kw = dict(batch_size=64, optimizer=adam(), ema_decay=0.95,
              log_every=4, verbose=False, seed=5)
    full = fit(_mknet(jb), cross_entropy(4), jb, X, Y, epochs=3,
               chain_steps="auto", **kw)
    # run 2 epochs with checkpoints, then resume for the third
    fit(_mknet(jb), cross_entropy(4), jb, X, Y, epochs=2,
        chain_steps="auto", checkpoint_path=ck, checkpoint_every=6, **kw)
    resumed = fit(_mknet(jb), cross_entropy(4), jb, X, Y, epochs=3,
                  chain_steps="auto", checkpoint_path=ck,
                  checkpoint_every=6, resume=True, **kw)
    assert resumed.steps == full.steps
    assert _max_diff(full.net.params, resumed.net.params) == 0.0
    assert _max_diff(full.ema_net.params, resumed.ema_net.params) == 0.0


def test_unchained_checkpoint_resumes_chained(jb, tmp_path):
    # mode change across a resume is allowed: the stream position and
    # state are mode-independent
    X, Y = _data(512)
    ck = str(tmp_path / "m.npz")
    kw = dict(batch_size=64, optimizer=adam(), log_every=4,
              verbose=False, seed=6)
    full = fit(_mknet(jb), cross_entropy(4), jb, X, Y, epochs=3,
               chain_steps=1, **kw)
    fit(_mknet(jb), cross_entropy(4), jb, X, Y, epochs=1, chain_steps=1,
        checkpoint_path=ck, checkpoint_every=8, **kw)
    resumed = fit(_mknet(jb), cross_entropy(4), jb, X, Y, epochs=3,
                  chain_steps="auto", checkpoint_path=ck,
                  checkpoint_every=8, resume=True, **kw)
    assert resumed.steps == full.steps
    assert _max_diff(full.net.params, resumed.net.params) == 0.0


# ---------------------------------------------------------------------------
# window planning: boundaries land where observation happens
# ---------------------------------------------------------------------------

def test_chained_history_and_checkpoint_cadence(jb, tmp_path):
    """Logging/checkpoint cadence is indistinguishable from the
    unchained loop: same logged steps, same checkpoint step recorded."""
    X, Y = _data(512)  # 8 steps/epoch, no ragged tail
    ck1, ck2 = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    kw = dict(epochs=2, batch_size=64, optimizer=sgd(), lr=0.1,
              log_every=5, checkpoint_every=6, verbose=False, seed=8)
    r1 = fit(_mknet(jb), cross_entropy(4), jb, X, Y, chain_steps=1,
             checkpoint_path=ck1, **kw)
    r2 = fit(_mknet(jb), cross_entropy(4), jb, X, Y, chain_steps="auto",
             checkpoint_path=ck2, **kw)
    assert [r["step"] for r in r1.history] == [r["step"] for r in r2.history]
    from tensor_ops.utils.checkpoint import load_train_state

    tmpl = sgd().init(tuple(np.asarray(p) for p in r1.net.params))
    _, _, step1 = load_train_state(ck1 + ".state", tmpl)
    _, _, step2 = load_train_state(ck2 + ".state", tmpl)
    assert step1 == step2
    assert _max_diff(r1.net.params, r2.net.params) == 0.0


def test_chain_backs_off_on_numpy_backend(nb):
    # the numpy oracle has no jit: auto must silently run unchained
    X, Y = _data(128)
    r = fit(_mknet(nb), cross_entropy(4), nb, X, Y, epochs=1,
            batch_size=64, chain_steps="auto", log_every=1,
            verbose=False)
    assert r.steps == 2
