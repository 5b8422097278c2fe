"""Structured-loop IR nodes: ``ScanOp`` (recurrence over a time axis) and
``MappedOp`` (vmap of an op over a leading axis).

These are the staged replacement for the reference's *compile-time*
BPTT unrolling (``unroll``/``rollup``, ``src/TensorOps/Learn/NeuralNet/
Recurrent.hs:392-463``): the reference builds an O(n)-size graph per
sequence length and — because its composition recomputes forwards inside
backwards — pays O(n^2) gradient cost (SURVEY.md §3.4).  Here the step op
is traced once and driven by ``jax.lax.scan``; the backward pass is a
*reversed* scan that recomputes each step's forward from the saved carry
(O(n) total, O(n*state) memory — the standard checkpointed-RNN recipe),
so XLA compiles one program regardless of sequence length.

``MappedOp`` likewise turns per-slice mapping (``mapRows``-style) and
batching into a single vmapped XLA program.
"""

from __future__ import annotations

import numpy as np

from .ir import TOp
from .shapes import ShapeError, fmt_stack


def _sqrt_divisor(n: int) -> int:
    """The divisor of ``n`` nearest sqrt(n) — the block size minimizing
    the checkpointed scan's O(n/k + k) residual state."""
    best, target = 1, n ** 0.5
    for d in range(1, int(n ** 0.5) + 1):
        if n % d == 0:
            for cand in (d, n // d):
                if abs(cand - target) < abs(best - target):
                    best = cand
    return best


class ScanOp(TOp):
    """Run ``step`` — a TOp ``([x] : ss ++ ps) -> ([y] : ss)`` — over a
    stacked time axis.

    Stacks::

        in :  [(n, *x_shape)] ++ ss ++ ps
        out:  [(n, *y_shape)] ++ ss        (final states)

    Inputs are time-major stacked arrays (index 0 = first step), unlike
    the reference's one-stack-slot-per-step unroll with reversed input
    order (``Recurrent.hs:392-431``); gradients are verified equal to the
    unrolled-graph semantics in tests.

    ``remat_every=k`` checkpoints the scan: only every k-th carry is
    taped and the backward recomputes the intervening forwards per
    block, dropping residual state from O(n·state) to O((n/k + k)·state)
    — the long-sequence memory wall the plain scan hits at n ~ 10^4.
    ``remat_every="sqrt"`` picks the divisor of ``n`` nearest sqrt(n)
    (the minimizing schedule).  Gradients are bit-identical to the plain
    scan (the same ops run in the same order, just recomputed).

    ``offload_tape=True`` (jax path; the numpy oracle is host-resident
    already) STREAMS the taped carries through pinned host DRAM — the
    activation-offload analog of the trainer's ``offload_opt_state``,
    done with memory spaces: the forward scan body emits each taped
    carry via ``jax.device_put(..., Space.Host)`` (XLA lowers the
    per-step writes to device->host copies it overlaps with the next
    steps),
    so the stacked residual buffer lives in host DRAM, and the backward
    scan body copies each step's slice back to device right before use.
    Residual HBM for the scan drops from O(n·state) (or O(n/k·state)
    with ``remat_every``) to O(state): one in-flight slice.  Gradients
    are bit-identical — placement changes nothing numerically.  Composes
    with ``remat_every`` (only the block-entry carries ever travel).
    """

    __slots__ = ("step", "n", "n_state", "remat_every", "offload_tape")

    def __init__(self, step: TOp, n: int, n_state: int, remat_every=None,
                 offload_tape: bool = False):
        if n < 1:
            raise ShapeError("scan needs n >= 1 steps")
        if remat_every == "sqrt":
            remat_every = _sqrt_divisor(n)
        if remat_every is not None:
            remat_every = int(remat_every)
            if remat_every < 1 or n % remat_every != 0:
                raise ShapeError(
                    f"remat_every ({remat_every}) must be a divisor of the "
                    f"scan length ({n}); pass 'sqrt' to pick the divisor "
                    f"nearest sqrt(n) automatically")
            if remat_every == 1:
                remat_every = None  # every carry saved == the plain scan
        self.remat_every = remat_every
        self.offload_tape = bool(offload_tape)
        if len(step.out_stack) != 1 + n_state:
            raise ShapeError(
                f"scan step must output [y] + {n_state} states, got "
                f"{fmt_stack(step.out_stack)}"
            )
        if step.in_stack[1 : 1 + n_state] != step.out_stack[1:]:
            raise ShapeError(
                "scan step state shapes must match between input "
                f"{fmt_stack(step.in_stack)} and output {fmt_stack(step.out_stack)}"
            )
        self.step = step
        self.n = int(n)
        self.n_state = int(n_state)
        x_shape = step.in_stack[0]
        y_shape = step.out_stack[0]
        ss = step.out_stack[1:]
        ps = step.in_stack[1 + n_state :]
        super().__init__(
            ((self.n,) + x_shape,) + ss + ps,
            ((self.n,) + y_shape,) + ss,
        )

    def _skey_parts(self):
        return (self.step.struct_key(), self.n, self.n_state,
                self.remat_every, self.offload_tape)

    def _split(self, xs):
        k = self.n_state
        return xs[0], tuple(xs[1 : 1 + k]), tuple(xs[1 + k :])

    def apply_tape(self, be, xs, with_tape=True):
        xarr, s0, params = self._split(xs)
        k = self.remat_every
        if be.name == "jax":
            import jax

            def _host(carry):
                # offload_tape: the taped carry leaves the device as it
                # is written — the scan's stacked residual buffer lives
                # in pinned host DRAM, one HBM->host DMA per step
                if not self.offload_tape:
                    return carry
                return tuple(jax.device_put(c, jax.memory.Space.Host)
                             for c in carry)

            def f(carry, x_t):
                outs = self.step.apply(be, (x_t,) + carry + params)
                y_t, s_new = outs[0], tuple(outs[1:])
                if with_tape and k is None:
                    return s_new, (y_t, _host(carry))
                return s_new, y_t

            if with_tape and k is not None:
                # checkpointed: tape only every k-th carry (the block
                # entry); the backward recomputes the k-1 intervening
                # carries per block — O(n/k + k) residual state instead
                # of O(n)
                xb = xarr.reshape((self.n // k, k) + xarr.shape[1:])

                def blk(carry, x_blk):
                    c_end, ys_blk = jax.lax.scan(f, carry, x_blk)
                    return c_end, (ys_blk, _host(carry))

                s_final, (ys_b, s_blk_ins) = jax.lax.scan(blk, s0, xb)
                ys = ys_b.reshape((self.n,) + ys_b.shape[2:])
                return (ys,) + s_final, (xarr, s_blk_ins, params)
            if with_tape:
                s_final, (ys, s_ins) = jax.lax.scan(f, s0, xarr)
                return (ys,) + s_final, (xarr, s_ins, params)
            s_final, ys = jax.lax.scan(f, s0, xarr)
            return (ys,) + s_final, None
        # numpy oracle: plain loop
        s = s0
        ys = []
        s_ins = []
        for t in range(self.n):
            if k is None or t % k == 0:
                s_ins.append(s)
            outs = self.step.apply(be, (xarr[t],) + s + params)
            ys.append(outs[0])
            s = tuple(outs[1:])
        stacked_s_ins = tuple(
            np.stack([si[j] for si in s_ins]) for j in range(self.n_state)
        )
        tape = (xarr, stacked_s_ins, params) if with_tape else None
        return (np.stack(ys),) + s, tape

    def transpose(self, be, tape, cts):
        xarr, s_ins, params = tape
        y_cts, s_final_cts = cts[0], tuple(cts[1 : 1 + self.n_state])
        n_params = len(params)

        def backstep(s_ct, x_t, s_in, y_ct):
            """One reverse step: recompute the forward from the saved
            carry, transpose, and split the input cotangents."""
            _, step_tape = self.step.apply_tape(be, (x_t,) + s_in + params)
            in_cts = self.step.transpose(be, step_tape, (y_ct,) + s_ct)
            dx_t = in_cts[0]
            ds_in = tuple(in_cts[1 : 1 + self.n_state])
            dp = tuple(in_cts[1 + self.n_state :])
            return ds_in, dx_t, dp

        k = self.remat_every
        if be.name == "jax":
            import jax
            import jax.numpy as jnp

            def _dev(s_in):
                # offload_tape: the scanned-in slice of the host-resident
                # tape comes back to HBM right before use — one
                # host->HBM DMA per step, O(state) resident
                if not self.offload_tape:
                    return s_in
                return tuple(jax.device_put(c, jax.memory.Space.Device)
                             for c in s_in)

            def f(carry, scanned):
                s_ct, p_acc = carry
                x_t, s_in, y_ct = scanned
                ds_in, dx_t, dp = backstep(s_ct, x_t, _dev(s_in), y_ct)
                p_acc = tuple(a + d for a, d in zip(p_acc, dp))
                return (ds_in, p_acc), dx_t

            p_zero = tuple(jnp.zeros_like(p) for p in params)
            if k is not None:
                # s_ins holds only block-entry carries; re-run each
                # block's forward from its entry to recover the per-step
                # carries, then reverse inside the block — blocks
                # themselves reverse in the outer scan
                xb = xarr.reshape((self.n // k, k) + xarr.shape[1:])
                yb = y_cts.reshape((self.n // k, k) + y_cts.shape[1:])

                def fwd(carry, x_t):
                    outs = self.step.apply(be, (x_t,) + carry + params)
                    return tuple(outs[1:]), carry  # emit carry-IN per step

                def blk(carry, scanned):
                    x_blk, s_blk_in, y_ct_blk = scanned
                    _, s_in_blk = jax.lax.scan(fwd, _dev(s_blk_in), x_blk)
                    carry, dx_blk = jax.lax.scan(
                        f, carry, (x_blk, s_in_blk, y_ct_blk), reverse=True)
                    return carry, dx_blk

                (s0_cts, p_cts), dxb = jax.lax.scan(
                    blk, (s_final_cts, p_zero), (xb, s_ins, yb),
                    reverse=True)
                dxs = dxb.reshape((self.n,) + dxb.shape[2:])
                return (dxs,) + s0_cts + p_cts
            (s0_cts, p_cts), dxs_rev = jax.lax.scan(
                f, (s_final_cts, p_zero), (xarr, s_ins, y_cts), reverse=True
            )
            return (dxs_rev,) + s0_cts + p_cts

        s_ct = s_final_cts
        p_cts = tuple(np.zeros_like(p) for p in params)
        dxs = [None] * self.n
        if k is not None:
            # recover all per-step carries from the block-entry saves
            full = [None] * self.n
            for bidx in range(self.n // k):
                s = tuple(si[bidx] for si in s_ins)
                for t in range(bidx * k, bidx * k + k):
                    full[t] = s
                    outs = self.step.apply(be, (xarr[t],) + s + params)
                    s = tuple(outs[1:])
            s_ins = tuple(
                np.stack([full[t][j] for t in range(self.n)])
                for j in range(self.n_state))
        for t in range(self.n - 1, -1, -1):
            s_in = tuple(si[t] for si in s_ins)
            ds_in, dx_t, dp = backstep(s_ct, xarr[t], s_in, y_cts[t])
            dxs[t] = dx_t
            p_cts = tuple(a + d for a, d in zip(p_cts, dp))
            s_ct = ds_in
        return (np.stack(dxs),) + s_ct + p_cts


class MappedOp(TOp):
    """Vmap an op over a new leading axis of size ``n`` on every input and
    output slot — the staged analog of the reference's per-slice
    ``mapRows`` (``src/TensorOps/Types.hs:77-81``), and the IR-native way
    to express batching."""

    __slots__ = ("op", "n")

    def __init__(self, op: TOp, n: int):
        self.op = op
        self.n = int(n)
        super().__init__(
            tuple((self.n,) + s for s in op.in_stack),
            tuple((self.n,) + s for s in op.out_stack),
        )

    def _skey_parts(self):
        return (self.op.struct_key(), self.n)

    def apply_tape(self, be, xs, with_tape=True):
        if be.name == "jax":
            import jax

            if with_tape:
                ys, tape = jax.vmap(
                    lambda *row: self.op.apply_tape(be, row, True)
                )(*xs)
                return tuple(ys), tape
            ys = jax.vmap(lambda *row: self.op.apply(be, row))(*xs)
            return tuple(ys), None
        rows = []
        tapes = []
        for t in range(self.n):
            y, tp = self.op.apply_tape(be, tuple(x[t] for x in xs), with_tape)
            rows.append(y)
            tapes.append(tp)
        ys = tuple(np.stack([r[k] for r in rows]) for k in range(len(self.op.out_stack)))
        return ys, (tapes if with_tape else None)

    def transpose(self, be, tape, cts):
        if be.name == "jax":
            import jax

            return tuple(
                jax.vmap(lambda tp, *row: self.op.transpose(be, tp, row))(tape, *cts)
            )
        outs = []
        for t in range(self.n):
            outs.append(self.op.transpose(be, tape[t], tuple(c[t] for c in cts)))
        return tuple(
            np.stack([o[k] for o in outs]) for k in range(len(self.op.in_stack))
        )


class Remat(TOp):
    """Rematerialization wrapper: store only the wrapped op's *inputs* on
    the tape and recompute its forward inside the backward pass — the
    IR-level ``jax.checkpoint``, trading FLOPs for residual memory (the
    standard recipe for deep chains when device memory is the limit).
    Gradients are identical to the unwrapped op."""

    __slots__ = ("op",)

    def __init__(self, op: TOp):
        self.op = op
        super().__init__(op.in_stack, op.out_stack)

    def _skey_parts(self):
        return (self.op.struct_key(),)

    def apply_tape(self, be, xs, with_tape=True):
        ys, _ = self.op.apply_tape(be, xs, with_tape=False)
        return ys, (xs if with_tape else None)

    def transpose(self, be, tape, cts):
        _, inner_tape = self.op.apply_tape(be, tape, with_tape=True)
        return self.op.transpose(be, inner_tape, cts)
