"""Recurrent/BPTT tests: ScanOp forward parity with an explicit Python
unroll, gradients vs finite differences (SURVEY.md §7.3 hard part 6:
scan-based gradients must equal unrolled-graph gradients), and the
fullyConnected/compose semantics of ``Recurrent.hs``."""

import numpy as np
import pytest

import tensor_ops as T
from tensor_ops import prim as P
from tensor_ops.backend.rng import Rng
from tensor_ops.models import act_logistic, squared_error
from tensor_ops.models.recurrent import (
    RecurrentNetwork,
    ff_layer,
    fully_connected,
    gen_net,
    stateless,
)
from tensor_ops.ops import ir
from tensor_ops.ops.loops import MappedOp, ScanOp


from tensor_ops.testing import rand as r  # noqa: E402


def make_rnn(be, i=3, o=2, seed=11):
    rng = Rng(be, seed=seed)
    return fully_connected(act_logistic(), be, i, o, rng)


def explicit_unroll(net, be, xs, targets, loss):
    """Reference semantics by hand: thread state, sum per-step losses."""
    total = 0.0
    m = net
    for t in range(xs.shape[0]):
        y, m = m.run(be, xs[t])
        total += float(np.asarray(ir.run(loss, be, (y, targets[t]))[0]))
    return total


def test_scan_forward_matches_explicit_loop(nb):
    net = make_rnn(nb)
    xs = r(1, 5, 3)
    tg = r(2, 5, 2)
    loss = squared_error(2)
    want = explicit_unroll(net, nb, xs, tg, loss)
    got = float(np.asarray(net.seq_loss(loss, nb, xs, tg)))
    assert np.isclose(got, want), (got, want)


def test_scan_forward_numpy_vs_jax(nb, jb):
    net = make_rnn(nb)
    xs, tg = r(3, 4, 3), r(4, 4, 2)
    loss = squared_error(2)
    jnet = RecurrentNetwork(net.op,
                            tuple(jb.asarray(s) for s in net.states),
                            tuple(jb.asarray(p) for p in net.params))
    a = float(np.asarray(net.seq_loss(loss, nb, xs, tg)))
    b = float(np.asarray(jnet.seq_loss(loss, jb, jb.asarray(xs), jb.asarray(tg))))
    assert abs(a - b) < 1e-9


def test_scan_grads_vs_finite_differences(nb):
    net = make_rnn(nb, i=2, o=2)
    xs, tg = r(5, 3, 2), r(6, 3, 2)
    loss = squared_error(2)
    dxs, dS, dP = net.seq_grad(loss, nb, xs, tg)
    eps = 1e-6

    def seq_loss_with(states, params, xs_):
        m = RecurrentNetwork(net.op, states, params)
        return float(np.asarray(m.seq_loss(loss, nb, xs_, tg)))

    # initial state grad
    for k in range(len(net.states)):
        for idx in np.ndindex(*net.states[k].shape):
            sp = [s.copy() for s in net.states]
            sm = [s.copy() for s in net.states]
            sp[k][idx] += eps
            sm[k][idx] -= eps
            fd = (seq_loss_with(tuple(sp), net.params, xs)
                  - seq_loss_with(tuple(sm), net.params, xs)) / (2 * eps)
            assert abs(fd - dS[k][idx]) < 1e-5, ("state", k, idx)
    # param grads (spot check every param tensor, a few indices)
    for k in range(len(net.params)):
        flat_idx = list(np.ndindex(*net.params[k].shape))[:6]
        for idx in flat_idx:
            pp = [p.copy() for p in net.params]
            pm = [p.copy() for p in net.params]
            pp[k][idx] += eps
            pm[k][idx] -= eps
            fd = (seq_loss_with(net.states, tuple(pp), xs)
                  - seq_loss_with(net.states, tuple(pm), xs)) / (2 * eps)
            assert abs(fd - dP[k][idx]) < 1e-5, ("param", k, idx)
    # input grads
    for idx in list(np.ndindex(*xs.shape))[:6]:
        xp, xm = xs.copy(), xs.copy()
        xp[idx] += eps
        xm[idx] -= eps
        fd = (seq_loss_with(net.states, net.params, xp)
              - seq_loss_with(net.states, net.params, xm)) / (2 * eps)
        assert abs(fd - dxs[idx]) < 1e-5, ("input", idx)


def test_scan_grad_parity_numpy_vs_jax(nb, jb):
    net = make_rnn(nb)
    xs, tg = r(7, 4, 3), r(8, 4, 2)
    loss = squared_error(2)
    jnet = RecurrentNetwork(net.op,
                            tuple(jb.asarray(s) for s in net.states),
                            tuple(jb.asarray(p) for p in net.params))
    a = net.seq_grad(loss, nb, xs, tg)
    b = jnet.seq_grad(loss, jb, jb.asarray(xs), jb.asarray(tg))
    np.testing.assert_allclose(np.asarray(a[0]), np.asarray(b[0]), atol=1e-9)
    for x, y in zip(a[1], b[1]):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), atol=1e-9)
    for x, y in zip(a[2], b[2]):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), atol=1e-9)


def test_training_reduces_sequence_loss(nb):
    net = make_rnn(nb, i=1, o=1, seed=3)
    # learn to echo a sine wave one step ahead
    t = np.linspace(0, 2 * np.pi, 21)
    xs = np.sin(t[:-1]).reshape(20, 1)
    tg = np.sin(t[1:]).reshape(20, 1)
    loss = squared_error(1)
    l0 = float(np.asarray(net.seq_loss(loss, nb, xs, tg)))
    m = net
    for _ in range(100):
        m = m.train(loss, 0.02, 0.05, nb, xs, tg)
    l1 = float(np.asarray(m.seq_loss(loss, nb, xs, tg)))
    assert l1 < 0.5 * l0, (l0, l1)


def test_stateless_embedding_matches_ff(nb):
    from tensor_ops.models.feedforward import ff_layer as ffl

    rng = Rng(nb, seed=9)
    ff = ffl(nb, 3, 2, rng)
    rec = stateless(ff)
    x = r(9, 3)
    y_ff = ff.run(nb, x)
    y_rec, rec2 = rec.run(nb, x)
    np.testing.assert_allclose(np.asarray(y_ff), np.asarray(y_rec))
    assert rec2.states == ()


def test_fully_connected_output_is_preactivation(nb):
    """fc outputs z = Ws.s + Wx.x + b and state act(z)
    (Recurrent.hs:97-125)."""
    net = make_rnn(nb, i=2, o=2, seed=21)
    wS, wX, b = net.params
    (s0,) = net.states
    x = r(10, 2)
    y, net2 = net.run(nb, x)
    z = wS @ s0 + wX @ x + b
    np.testing.assert_allclose(np.asarray(y), z, atol=1e-12)
    from tensor_ops.models.neuralnet import logistic

    np.testing.assert_allclose(np.asarray(net2.states[0]), logistic(z), atol=1e-12)


def test_recurrent_compose_threads_both_states(nb):
    a = make_rnn(nb, i=2, o=3, seed=31)
    bnet = make_rnn(nb, i=3, o=2, seed=32)
    comp = a.then(bnet)
    assert len(comp.states) == 2
    x = r(11, 2)
    # manual: run a then b
    ya, a2 = a.run(nb, x)
    yb, b2 = bnet.run(nb, ya)
    y, comp2 = comp.run(nb, x)
    np.testing.assert_allclose(np.asarray(y), np.asarray(yb), atol=1e-12)
    # state order: ss2 ++ ss1 (Recurrent.hs:218-222)
    np.testing.assert_allclose(np.asarray(comp2.states[0]), np.asarray(b2.states[0]), atol=1e-12)
    np.testing.assert_allclose(np.asarray(comp2.states[1]), np.asarray(a2.states[0]), atol=1e-12)


def test_gen_net_recurrent(nb):
    rng = Rng(nb, seed=41)
    net = gen_net(nb, 4, 2,
                  [(5, act_logistic(), act_logistic()),
                   (3, act_logistic(), None)],
                  act_logistic(), None, rng)
    xs, tg = r(12, 6, 4), np.clip(r(13, 6, 2), 0.05, 0.95)
    loss = squared_error(2)
    l0 = float(np.asarray(net.seq_loss(loss, nb, xs, tg)))
    m = net.train(loss, 0.1, 0.1, nb, xs, tg)
    l1 = float(np.asarray(m.seq_loss(loss, nb, xs, tg)))
    assert l1 < l0


def test_mapped_op(nb, jb):
    op = P.dot(3)
    m = MappedOp(op, 4)
    xs, ys = r(14, 4, 3), r(15, 4, 3)
    want = (xs * ys).sum(axis=1)
    for be in (nb, jb):
        got = np.asarray(ir.run(m, be, (be.asarray(xs), be.asarray(ys)))[0])
        np.testing.assert_allclose(got, want, atol=1e-10)
    # grads through mapped op
    g = m >> P.sum_rows((4,))
    _, grads = ir.value_and_grad(g, nb, (xs, ys))
    np.testing.assert_allclose(grads[0], ys, atol=1e-10)


def test_train_batch_matches_mean_of_singles(nb, jb):
    """Batched-sequence SGD == averaging per-sequence gradients."""
    net = make_rnn(nb, i=2, o=2, seed=51)
    loss = squared_error(2)
    xb = r(60, 3, 4, 2)   # B=3 sequences of length 4
    tb = r(61, 3, 4, 2)
    # manual mean of per-sequence grads
    gS_acc = [np.zeros_like(s) for s in net.states]
    gP_acc = [np.zeros_like(p) for p in net.params]
    for i in range(3):
        _, gS, gP = net.seq_grad(loss, nb, xb[i], tb[i])
        for a, g in zip(gS_acc, gS):
            a += np.asarray(g)
        for a, g in zip(gP_acc, gP):
            a += np.asarray(g)
    want_s = [s - 0.1 * a / 3 for s, a in zip(net.states, gS_acc)]
    want_p = [p - 0.2 * a / 3 for p, a in zip(net.params, gP_acc)]
    got = net.train_batch(loss, 0.1, 0.2, nb, xb, tb)
    for a, b in zip(got.states, want_s):
        np.testing.assert_allclose(np.asarray(a), b, atol=1e-10)
    for a, b in zip(got.params, want_p):
        np.testing.assert_allclose(np.asarray(a), b, atol=1e-10)
    # jax path parity
    jnet = RecurrentNetwork(net.op,
                            tuple(jb.asarray(s) for s in net.states),
                            tuple(jb.asarray(p) for p in net.params))
    got_j = jnet.train_batch(loss, 0.1, 0.2, jb, jb.asarray(xb), jb.asarray(tb))
    for a, b in zip(got_j.params, want_p):
        np.testing.assert_allclose(np.asarray(a), b, atol=1e-9)


def test_scan_with_two_states_composed_rnn(nb, jb):
    """ScanOp with a 2-state step (two composed recurrent layers)."""
    a = make_rnn(nb, i=2, o=3, seed=71)
    bnet = make_rnn(nb, i=3, o=2, seed=72)
    comp = a.then(bnet)
    assert len(comp.states) == 2
    xs, tg = r(73, 5, 2), r(74, 5, 2)
    loss = squared_error(2)
    # scan loss == explicit step-by-step threading
    want = explicit_unroll(comp, nb, xs, tg, loss)
    got = float(np.asarray(comp.seq_loss(loss, nb, xs, tg)))
    assert np.isclose(got, want), (got, want)
    # jax parity
    jcomp = RecurrentNetwork(comp.op,
                             tuple(jb.asarray(s) for s in comp.states),
                             tuple(jb.asarray(p) for p in comp.params))
    got_j = float(np.asarray(jcomp.seq_loss(loss, jb, jb.asarray(xs), jb.asarray(tg))))
    assert abs(got - got_j) < 1e-9
    # gradient spot-check vs finite differences on one param entry
    _, gS, gP = comp.seq_grad(loss, nb, xs, tg)
    eps = 1e-6
    pp = [p.copy() for p in comp.params]
    pm = [p.copy() for p in comp.params]
    pp[0][0, 0] += eps
    pm[0][0, 0] -= eps
    lp = float(np.asarray(RecurrentNetwork(comp.op, comp.states, tuple(pp))
                          .seq_loss(loss, nb, xs, tg)))
    lm = float(np.asarray(RecurrentNetwork(comp.op, comp.states, tuple(pm))
                          .seq_loss(loss, nb, xs, tg)))
    assert abs((lp - lm) / (2 * eps) - gP[0][0, 0]) < 1e-5


def test_recurrent_compose_associative(nb):
    """(a . b) . c == a . (b . c) in outputs and state threading."""
    a = make_rnn(nb, i=2, o=3, seed=81)
    b = make_rnn(nb, i=3, o=4, seed=82)
    c = make_rnn(nb, i=4, o=2, seed=83)
    left = a.then(b).then(c)
    right = a.then(b.then(c))
    xs = r(84, 4, 2)
    yl = left
    yr = right
    for t in range(4):
        out_l, yl = yl.run(nb, xs[t])
        out_r, yr = yr.run(nb, xs[t])
        np.testing.assert_allclose(np.asarray(out_l), np.asarray(out_r), atol=1e-12)
    # same multiset of final states (ordering differs by association)
    sl = sorted(float(np.asarray(s).sum()) for s in yl.states)
    sr = sorted(float(np.asarray(s).sum()) for s in yr.states)
    np.testing.assert_allclose(sl, sr, atol=1e-12)
    # sequence training agrees too
    tg = r(85, 4, 2)
    loss = squared_error(2)
    ll = float(np.asarray(left.seq_loss(loss, nb, xs, tg)))
    lr_ = float(np.asarray(right.seq_loss(loss, nb, xs, tg)))
    assert np.isclose(ll, lr_)


# ---------------------------------------------------------------------------
# checkpointed scan (remat_every)
# ---------------------------------------------------------------------------


def _scan_grads(be, net, xs, tg, loss, remat_every):
    g = net._seq_graph(loss, xs.shape[0], remat_every=remat_every)
    return ir.grad(g, be, (be.asarray(xs),) + tuple(net.states)
                   + tuple(net.params) + (be.asarray(tg),))


@pytest.mark.parametrize("remat", [2, 4, 6, "sqrt", 12])
def test_remat_scan_grads_equal_plain(nb, jb, remat):
    """Checkpointed-scan gradients == plain-scan gradients at 1e-9 on
    both backends (VERDICT r2 item 5): same ops, same order, just
    recomputed."""
    net = make_rnn(nb)
    n = 12
    xs, tg = r(5, n, 3), r(6, n, 2)
    loss = squared_error(2)
    plain = _scan_grads(nb, net, xs, tg, loss, None)
    ck = _scan_grads(nb, net, xs, tg, loss, remat)
    for a, b in zip(plain, ck):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-9, rtol=0)
    jnet = RecurrentNetwork(net.op,
                            tuple(jb.asarray(s) for s in net.states),
                            tuple(jb.asarray(p) for p in net.params))
    jck = _scan_grads(jb, jnet, xs, tg, loss, remat)
    for a, b in zip(plain, jck):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-9, rtol=0)


def test_remat_scan_forward_identical(nb, jb):
    net = make_rnn(nb)
    n = 8
    xs, tg = r(7, n, 3), r(8, n, 2)
    loss = squared_error(2)
    for be, m in ((nb, net),
                  (jb, RecurrentNetwork(
                      net.op, tuple(jb.asarray(s) for s in net.states),
                      tuple(jb.asarray(p) for p in net.params)))):
        a = np.asarray(m.seq_loss(loss, be, be.asarray(xs), be.asarray(tg)))
        g = m._seq_graph(loss, n, remat_every=4)
        b = np.asarray(ir.run(g, be, (be.asarray(xs),) + tuple(m.states)
                              + tuple(m.params) + (be.asarray(tg),))[0])
        np.testing.assert_allclose(a, b, atol=1e-12, rtol=0)


def test_remat_requires_divisor():
    from tensor_ops.ops.shapes import ShapeError

    step_net = make_rnn(T.NumpyBackend())
    with pytest.raises(ShapeError, match="divisor"):
        ScanOp(step_net.op, 10, 1, remat_every=3)


def test_sqrt_divisor_schedule():
    from tensor_ops.ops.loops import _sqrt_divisor

    assert _sqrt_divisor(4096) == 64
    assert _sqrt_divisor(12) in (3, 4)
    assert _sqrt_divisor(7) in (1, 7)
    assert 100 % _sqrt_divisor(100) == 0


def test_remat_tape_is_smaller(nb):
    """The taped carries shrink from n to n/k block entries."""
    net = make_rnn(nb)
    n, k = 12, 4
    xs = r(9, n, 3)
    plain = ScanOp(net.op, n, 1)
    ck = ScanOp(net.op, n, 1, remat_every=k)
    args = (xs,) + tuple(net.states) + tuple(net.params)
    _, tape_p = plain.apply_tape(nb, args)
    _, tape_c = ck.apply_tape(nb, args)
    assert tape_p[1][0].shape[0] == n
    assert tape_c[1][0].shape[0] == n // k
