"""Scan-BPTT ACTIVATION OFFLOAD (``ScanOp(offload_tape=True)`` /
``fit_sequences(offload_activations=True)``): the taped carries stream
through pinned host DRAM — the forward scan body writes each taped
carry to host as it is produced, the backward scan body copies each
slice back right before use, so residual HBM per sequence is O(state)
instead of O(n*state) (or O(n/k*state) under ``remat_every``).

The contract mirrors ``offload_opt_state``'s: placement changes nothing
numerically — gradients must be BIT-identical to the on-device tape —
and the knob composes with ``remat_every`` (only block-entry carries
ever travel).  The reference unrolls BPTT at compile time with the
whole tape in memory (``Recurrent.hs:392-463``); both the scan and its
offload are the rebuild's extension (SURVEY.md §2.5 memory ladder).

On the CPU test backend host and device memory are the same DRAM, so
these tests pin the SEMANTICS; the on-card compile/run is covered by the
``gpu``-marked test."""


import numpy as np
import pytest

import jax

from tensor_ops.backend.rng import Rng
from tensor_ops.models import (
    act_logistic,
    adam,
    squared_error,
)
from tensor_ops.models.recurrent import gen_net as gen_rnet
from tensor_ops.models.trainer import fit_sequences
from tensor_ops.ops import ir

multi = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 devices (see conftest note)"
)


def _rnet(be, seed=0, h=6):
    return gen_rnet(be, 2, 2, [(h, act_logistic(), act_logistic())],
                    act_logistic(), None, Rng(be, seed=seed))


def _seq_data(n=8, b=None, seed=1):
    r = np.random.default_rng(seed)
    shape = (n, 2) if b is None else (b, n, 2)
    return (r.uniform(-1, 1, size=shape),
            r.uniform(-1, 1, size=shape))


@pytest.mark.parametrize("remat", [None, 2, "sqrt"])
def test_offload_tape_grads_bit_identical(jb, remat):
    """The whole-sequence gradient with the host-streamed tape equals
    the on-device tape BIT-for-bit, plain and checkpointed scans
    alike."""
    net = _rnet(jb)
    xs, ts = _seq_data(n=8)
    loss = squared_error(2)
    g_on = net._seq_graph(loss, 8, remat_every=remat)
    g_off = net._seq_graph(loss, 8, remat_every=remat, offload_tape=True)
    args = (jb.asarray(xs),) + net.states + net.params + (jb.asarray(ts),)
    v_on, gr_on = ir.value_and_grad(g_on, jb, args)
    v_off, gr_off = ir.value_and_grad(g_off, jb, args)
    np.testing.assert_array_equal(np.asarray(v_on), np.asarray(v_off))
    for a, b in zip(gr_on, gr_off):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_offload_tape_numpy_oracle_ignores_flag(nb):
    """The numpy oracle's tape is host-resident by construction: the
    flag changes nothing (same gradients), so graph caches keyed on it
    stay consistent across backends."""
    net = _rnet(nb)
    xs, ts = _seq_data(n=4)
    loss = squared_error(2)
    g_on = net._seq_graph(loss, 4)
    g_off = net._seq_graph(loss, 4, offload_tape=True)
    args = (xs,) + net.states + net.params + (ts,)
    for a, b in zip(ir.grad(g_on, nb, args), ir.grad(g_off, nb, args)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(remat_every=2),
    dict(optimizer=adam()),
])
def test_fit_sequences_offload_activations(jb, kw):
    """fit_sequences(offload_activations=True): loss curve and params
    BIT-equal the on-device run — dual-rate SGD, checkpointed scan, and
    optimizer paths alike."""
    XS, TS = _seq_data(n=8, b=16)
    base = dict(epochs=2, batch_size=8, rate_param=0.05, rate_state=0.01,
                verbose=False, prefetch=0, log_every=1, **kw)
    r_off = fit_sequences(_rnet(jb, seed=3), squared_error(2), jb, XS, TS,
                          offload_activations=True, **base)
    r_on = fit_sequences(_rnet(jb, seed=3), squared_error(2), jb, XS, TS,
                         **base)
    for ha, hb in zip(r_off.history, r_on.history):
        assert ha["loss"] == hb["loss"], (ha, hb)
    for a, b in zip(r_off.net.params, r_on.net.params):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@multi
def test_offload_activations_on_mesh(jb):
    """offload_activations composes with dp×tp mesh training (and with
    offload_opt_state on top — both hosts-offload knobs at once)."""
    from tensor_ops.parallel.mesh import make_mesh

    mesh = make_mesh(8, shape=(4, 2))
    XS, TS = _seq_data(n=8, b=16)
    base = dict(epochs=1, batch_size=8, rate_param=0.05, rate_state=0.01,
                optimizer=adam(), verbose=False, prefetch=0, log_every=1,
                mesh=mesh)
    r_off = fit_sequences(_rnet(jb, seed=4, h=8), squared_error(2), jb,
                          XS, TS, offload_activations=True,
                          offload_opt_state=True, **base)
    r_on = fit_sequences(_rnet(jb, seed=4, h=8), squared_error(2), jb,
                         XS, TS, **base)
    for ha, hb in zip(r_off.history, r_on.history):
        assert ha["loss"] == hb["loss"], (ha, hb)


def test_offload_activations_validation(nb):
    """numpy backend rejected eagerly (its tape is already on the
    host)."""
    XS, TS = _seq_data(n=4, b=8)
    with pytest.raises(ValueError, match="offload_activations"):
        fit_sequences(_rnet(nb), squared_error(2), nb, XS, TS,
                      offload_activations=True, verbose=False)


@pytest.mark.gpu
def test_offload_tape_on_gpu():
    """On-card compile+run: the host-streamed tape produces the same
    gradients as the on-device tape on the card's real memory spaces,
    at float32, the dtype the knob exists for."""
    import jax.numpy as jnp

    from tensor_ops.backend.jax_backend import JaxBackend

    be = JaxBackend(dtype=jnp.float32)
    net = _rnet(be)
    xs, ts = _seq_data(n=16)
    loss = squared_error(2)
    g_on = net._seq_graph(loss, 16, remat_every=4)
    g_off = net._seq_graph(loss, 16, remat_every=4, offload_tape=True)
    args = (be.asarray(xs),) + net.states + net.params + (be.asarray(ts),)
    for a, b in zip(ir.grad(g_on, be, args), ir.grad(g_off, be, args)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
