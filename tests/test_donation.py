"""Buffer donation in the jitted train steps.

``fit`` / ``fit_sequences`` compile their steps with ``donate=True``:
the previous training state (params, optimizer moments, recurrent
states) is donated to XLA, which aliases the update in place — steady
state HBM holds ONE copy of the training state instead of the two a
copy-on-update step needs.  (The reference's training loop rebuilds its
whole network functionally each step, ``app/MNIST.hs:390-396``; GHC
never promises in-place reuse.  Donation is the XLA-native statement of
the same single-owner discipline, with the compiler enforcing it.)

These tests pin the contract's edges:
- donation actually happens when asked (inputs die) and never happens
  by default (the public builders keep their inputs alive),
- the loops' working-copy discipline keeps caller-owned arrays alive
  (the user's net survives fit, EMA templates never alias donated
  buffers),
- duplicate leaves in a donated optimizer state are deduped (adam8bit's
  init shares the zero-quantized arrays between both moments — XLA
  rejects donating one buffer twice),
- the SIGINT shield defers a mid-step Ctrl-C past the snapshot rebind,
  so the exact-resume guarantee survives donation.
"""

import os
import signal
import time

import numpy as np
import pytest

from tensor_ops.backend.rng import Rng
from tensor_ops.models import (act_logistic, act_softmax,
                                   cross_entropy, gen_net, squared_error)
from tensor_ops.models.optim import adam, adam8bit, sgd
from tensor_ops.models.trainer import (_make_ema_update,
                                           _sigint_shield, fit,
                                           fit_sequences, make_opt_step)


def _toy(n=64, seed=0):
    r = np.random.default_rng(seed)
    X = r.uniform(-1, 1, size=(n, 2))
    labels = (X[:, 0] * X[:, 1] > 0).astype(int)
    return X, np.eye(2)[labels]


def _net(be, seed=0):
    return gen_net(be, 2, 2, [(16, act_logistic())], act_softmax(),
                   Rng(be, seed=seed))


def _deleted(x) -> bool:
    return getattr(x, "is_deleted", lambda: False)()


def test_make_opt_step_donates_only_when_asked(jb):
    """donate=True deletes the passed (opt_state, params); the default
    keeps them alive; both produce identical updates."""
    X, Y = _toy()
    loss = cross_entropy(2)
    net = _net(jb, seed=3)
    xb, yb = jb.asarray(X[:32]), jb.asarray(Y[:32])

    plain = make_opt_step(net, loss, jb, adam())
    o0 = adam().init(net.params)
    p0 = tuple(net.params)
    _, o1, p1 = plain(0.05, xb, yb, o0, p0)
    assert not any(_deleted(p) for p in p0), "default must not donate"

    donating = make_opt_step(net, loss, jb, adam(), donate=True)
    assert donating is not plain, "donate must be part of the cache key"
    import jax.numpy as jnp

    o0d = adam().init(net.params)
    p0d = tuple(jnp.copy(p) for p in net.params)
    _, o1d, p1d = donating(0.05, xb, yb, o0d, p0d)
    assert all(_deleted(p) for p in p0d), "params must be donated"
    assert any(_deleted(x) for x in o0d[1]), "moments must be donated"
    for a, b in zip(p1, p1d):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_fit_preserves_callers_network(jb):
    """fit trains on working copies: the user's net stays usable (and
    re-trainable) after a donated run."""
    X, Y = _toy()
    net = _net(jb, seed=4)
    before = tuple(np.asarray(p).copy() for p in net.params)
    res = fit(net, cross_entropy(2), jb, X, Y, epochs=2, batch_size=32,
              optimizer=adam(), lr=0.05, verbose=False, prefetch=0)
    assert not any(_deleted(p) for p in net.params)
    for p, b in zip(net.params, before):
        np.testing.assert_array_equal(np.asarray(p), b)
    # the returned params are distinct live buffers, and the original
    # net still runs and can be trained again (cache-hit path)
    out = net.run(jb, jb.asarray(X[0]))
    assert np.isfinite(np.asarray(out)).all()
    res2 = fit(net, cross_entropy(2), jb, X, Y, epochs=1, batch_size=32,
               optimizer=adam(), lr=0.05, verbose=False, prefetch=0)
    assert np.isfinite(res2.history[-1]["loss"])
    assert not any(_deleted(p) for p in res.net.params)


def test_fit_sequences_preserves_callers_network(jb):
    from tensor_ops.models.recurrent import gen_net as gen_rnet

    r = np.random.default_rng(7)
    t = np.linspace(0, 4 * np.pi, 33)
    XS = np.stack([np.sin(t[:-1] + ph)[:, None]
                   for ph in r.uniform(0, np.pi, 24)])
    TS = np.stack([np.sin(t[1:] + ph)[:, None]
                   for ph in r.uniform(0, np.pi, 24)])
    rnet = gen_rnet(jb, 1, 1, [(6, act_logistic(), act_logistic())],
                    act_logistic(), None, Rng(jb, seed=8))
    before = tuple(np.asarray(p).copy() for p in rnet.params)
    fit_sequences(rnet, squared_error(1), jb, XS, TS, epochs=1,
                  batch_size=8, optimizer=adam(), rate_param=0.05,
                  rate_state=0.01, verbose=False, prefetch=0)
    assert not any(_deleted(p) for p in rnet.params)
    assert not any(_deleted(s) for s in rnet.states)
    for p, b in zip(rnet.params, before):
        np.testing.assert_array_equal(np.asarray(p), b)


def test_ema_survives_donation(jb):
    """EMA templates are copies, not aliases: ema_decay + donation run
    together, and the EMA equals the hand recurrence."""
    X, Y = _toy()
    net = _net(jb, seed=5)
    d = 0.5
    res = fit(net, cross_entropy(2), jb, X, Y, epochs=1, batch_size=32,
              optimizer=sgd(), lr=0.1, ema_decay=d, verbose=False,
              prefetch=0, log_every=1)
    assert res.ema_net is not None
    # EMA != raw params (decay 0.5 over 2 steps keeps init influence)
    diffs = [float(np.abs(np.asarray(a) - np.asarray(b)).max())
             for a, b in zip(res.ema_net.params, res.net.params)]
    assert max(diffs) > 0
    assert not any(_deleted(p) for p in res.ema_net.params)


def test_ema_update_donates_previous_average(jb):
    import jax.numpy as jnp

    fn = _make_ema_update({}, 0.9, None, jb, "donation-test")
    e = (jnp.ones((4,)), jnp.zeros((2, 2)))
    p = (jnp.zeros((4,)), jnp.ones((2, 2)))
    e2 = fn(e, p)
    assert all(_deleted(x) for x in e)
    np.testing.assert_allclose(np.asarray(e2[0]), 0.9 * np.ones(4))


def test_adam8bit_duplicate_state_leaves_are_deduped(jb):
    """adam8bit's init aliases the zero moment codes/scales; the loop
    dedupes before donating (XLA rejects donating a buffer twice)."""
    X, Y = _toy()
    net = _net(jb, seed=6)
    res = fit(net, cross_entropy(2), jb, X, Y, epochs=2, batch_size=32,
              optimizer=adam8bit(), lr=0.05, verbose=False, prefetch=0)
    assert np.isfinite(res.history[-1]["loss"])


def test_mesh_step_donates_and_keeps_shardings(jb):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from tensor_ops.parallel.mesh import make_mesh, param_specs

    if len(jax.devices()) < 4:
        pytest.skip("needs >= 4 devices")
    mesh = make_mesh(4, shape=(2, 2))
    X, Y = _toy()
    net = _net(jb, seed=9)
    specs = param_specs(net.param_stack, mesh)
    placed = tuple(jax.device_put(p, NamedSharding(mesh, s))
                   for p, s in zip(net.params, specs))
    opt = adam()
    o0 = opt.init(placed)
    step = make_opt_step(net, cross_entropy(2), jb, opt, mesh=mesh,
                         donate=True)
    xb = jax.device_put(jb.asarray(X[:32]),
                        NamedSharding(mesh, P("data", None)))
    yb = jax.device_put(jb.asarray(Y[:32]),
                        NamedSharding(mesh, P("data", None)))
    _, o1, p1 = step(0.05, xb, yb, o0, placed)
    assert all(_deleted(p) for p in placed)
    for p, s in zip(p1, specs):
        assert p.sharding == NamedSharding(mesh, s)


def test_sigint_shield_defers_to_exit():
    prev = signal.getsignal(signal.SIGINT)
    saw_pending = []
    with pytest.raises(KeyboardInterrupt):
        with _sigint_shield() as sh:
            os.kill(os.getpid(), signal.SIGINT)
            time.sleep(0.02)  # let the interpreter run the handler
            saw_pending.append(sh.pending)
    assert saw_pending == [True], "SIGINT must be deferred, not raised"
    assert signal.getsignal(signal.SIGINT) is prev


def test_sigint_shield_double_press_escapes():
    prev = signal.getsignal(signal.SIGINT)
    reached_end = False
    with pytest.raises(KeyboardInterrupt):
        with _sigint_shield():
            os.kill(os.getpid(), signal.SIGINT)
            time.sleep(0.02)
            os.kill(os.getpid(), signal.SIGINT)
            time.sleep(0.02)
            reached_end = True
    assert not reached_end, "second press must raise immediately"
    assert signal.getsignal(signal.SIGINT) is prev
