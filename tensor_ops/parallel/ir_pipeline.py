"""Pipeline parallelism over the staged IR itself.

The reference's network-composition points (``~*~``,
``src/TensorOps/Learn/NeuralNet/FeedForward.hs:82-90``) are the designated
pipeline cut points (SURVEY.md §2.5).  A :class:`~tensor_ops.models.
feedforward.Network` built with ``then``/``gen_net`` has exactly that
shape in its op graph — ``Compose(First(prefix, rest), layer)`` per
composition — so :func:`unchain` recovers the per-layer sub-graphs, and
:func:`ir_pipeline_train_step` shards a uniform run of them over a
``stage`` mesh axis as a GPipe microbatch pipeline (``lax.scan`` +
``lax.ppermute`` ring inside ``shard_map``, like
:mod:`tensor_ops.parallel.pipeline`).

Unlike ``pipeline.PipelineMLP`` (a hand-written MLP), every stage here
evaluates its *actual staged-IR sub-graph*, and its backward pass is the
framework's own graph transposition: each segment is wrapped in a
``jax.custom_vjp`` whose forward runs ``op.apply_tape`` and whose backward
runs ``op.transpose`` — ``jax.grad`` only orchestrates the pipeline
schedule (transposing ``ppermute``/``scan``), never differentiates the
model itself.  Gradients are therefore exactly the sequential staged-IR
gradients (tested to 1e-9).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as PSpec

from ..backend.base import Backend
from ..ops.ir import Compose, First, GMul, LiftOp, Shuffle, SumOp, TOp
from ..ops.shapes import ShapeError
from ..models.feedforward import Network, unchain  # noqa: F401 — unchain re-exported (public API since round 2)
from .mesh import DATA_AXIS, MODEL_AXIS
from .pipeline import STAGE_AXIS, shard_map


# ---------------------------------------------------------------------------
# unchaining a Network op at its composition points
# ---------------------------------------------------------------------------


def network_segments(net: Network) -> List[Tuple[TOp, Tuple[Any, ...]]]:
    """The network's layer sub-graphs paired with their parameter slices
    (in stack order)."""
    segs = unchain(net.op)
    out = []
    cursor = 0
    for seg in segs:
        k = len(seg.in_stack) - 1
        out.append((seg, tuple(net.params[cursor : cursor + k])))
        cursor += k
    if cursor != len(net.params):
        raise ShapeError(
            f"unchain consumed {cursor} params but network has "
            f"{len(net.params)}"
        )
    return out


# ---------------------------------------------------------------------------
# the framework-AD seam: custom_vjp around a staged sub-graph
# ---------------------------------------------------------------------------


def ir_call(op: TOp, be: Backend) -> Callable:
    """``fn(*xs) -> ys tuple`` evaluating ``op`` with gradients supplied
    by the op's OWN transposition rule: the custom_vjp forward tapes
    residuals via ``apply_tape`` and the backward runs ``op.transpose`` —
    jax AD never sees inside the sub-graph."""

    @jax.custom_vjp
    def f(*xs):
        return op.apply(be, xs)

    def fwd(*xs):
        ys, tape = op.apply_tape(be, xs, with_tape=True)
        return ys, tape

    def bwd(tape, cts):
        return tuple(op.transpose(be, tape, tuple(cts)))

    f.defvjp(fwd, bwd)
    return f


def batched_ir_call(op: TOp, be: Backend) -> Callable:
    """``fn(xb, *params) -> yb``: the per-sample sub-graph vmapped over a
    leading batch axis (params broadcast), framework AD inside."""
    call = ir_call(op, be)
    n_params = len(op.in_stack) - 1

    def single(x, *params):
        return call(x, *params)[0]

    return jax.vmap(single, in_axes=(0,) + (None,) * n_params)


# ---------------------------------------------------------------------------
# stage partitioning
# ---------------------------------------------------------------------------


@dataclass
class PipelinedNetwork:
    """A Network split for pipelining: replicated ``pre`` segments, a
    uniform ``body`` (one op evaluated with per-stage stacked params),
    replicated ``post`` segments."""

    pre: List[Tuple[TOp, Tuple[Any, ...]]]
    body_op: Optional[TOp]
    body_params: Tuple[Any, ...]  # each (n_body, *param_shape)
    n_body: int
    post: List[Tuple[TOp, Tuple[Any, ...]]]

    def flat_params(self) -> Tuple[Any, ...]:
        ps: List[Any] = []
        for _, p in self.pre:
            ps.extend(p)
        ps.extend(self.body_params)
        for _, p in self.post:
            ps.extend(p)
        return tuple(ps)

    def unflatten(self, flat: Tuple[Any, ...]) -> "PipelinedNetwork":
        it = iter(flat)
        pre = [(op, tuple(next(it) for _ in p)) for op, p in self.pre]
        body = tuple(next(it) for _ in self.body_params)
        post = [(op, tuple(next(it) for _ in p)) for op, p in self.post]
        return PipelinedNetwork(pre, self.body_op, body, self.n_body, post)

    def skeleton(self) -> "PipelinedNetwork":
        """Structure-only copy (param arrays replaced by None): safe to
        capture in long-lived closures/jit caches without pinning a full
        parameter copy — ``unflatten``/``flat_params`` only count."""
        return PipelinedNetwork(
            [(op, tuple(None for _ in p)) for op, p in self.pre],
            self.body_op,
            tuple(None for _ in self.body_params),
            self.n_body,
            [(op, tuple(None for _ in p)) for op, p in self.post])

    def to_network_params(self) -> Tuple[Any, ...]:
        """Back to the original Network param stack (body unstacked in
        segment order)."""
        ps: List[Any] = []
        for _, p in self.pre:
            ps.extend(p)
        for k in range(self.n_body):
            ps.extend(b[k] for b in self.body_params)
        for _, p in self.post:
            ps.extend(p)
        return tuple(ps)


def _op_flops(op: TOp) -> float:
    """Crude FLOP estimate of a sub-graph — enough to balance stage
    cuts.  Contractions dominate (2*|ms|*|os|*|ns| per GMul); structure
    nodes recurse; everything else counts its output elements."""
    from ..ops.ir import Compose, Fanout, First, GMul, Par, Second

    if isinstance(op, GMul):
        return 2.0 * float(np.prod(op.ms + op.os + op.ns, dtype=np.float64))
    if isinstance(op, Compose):
        return _op_flops(op.f) + _op_flops(op.g)
    if isinstance(op, (Par, Fanout)):
        return _op_flops(op.f) + _op_flops(op.g)
    if isinstance(op, (First, Second)):
        return _op_flops(op.op)
    inner = getattr(op, "op", None) or getattr(op, "step", None)
    if isinstance(inner, TOp):  # MappedOp/Remat (.op) and ScanOp (.step)
        return float(getattr(op, "n", 1)) * _op_flops(inner)
    return float(sum(np.prod(s, dtype=np.float64) if s else 1.0
                     for s in op.out_stack))


def _balanced_partition(costs, n_groups: int):
    """Contiguous partition of ``costs`` into ``n_groups`` non-empty
    groups minimizing the maximum group cost (DP, exact).  Returns
    ``[(start, end), ...]`` index bounds."""
    n = len(costs)
    prefix = [0.0]
    for c in costs:
        prefix.append(prefix[-1] + c)
    INF = float("inf")
    dp = [[INF] * (n + 1) for _ in range(n_groups + 1)]
    cut = [[0] * (n + 1) for _ in range(n_groups + 1)]
    dp[0][0] = 0.0
    for s in range(1, n_groups + 1):
        for i in range(s, n + 1):
            for j in range(s - 1, i):
                v = max(dp[s - 1][j], prefix[i] - prefix[j])
                if v < dp[s][i]:
                    dp[s][i], cut[s][i] = v, j
    bounds = []
    i = n
    for s in range(n_groups, 0, -1):
        j = cut[s][i]
        bounds.append((j, i))
        i = j
    return list(reversed(bounds))


@dataclass
class HeteroPipelinedNetwork:
    """A Network cut into S contiguous, FLOP-balanced stage groups of
    (possibly structurally distinct) segments — the general partition
    that pipelines the REAL flagship 784->300->100->10 chain
    (``/root/reference/app/MNIST.hs:89-104``), not just uniform-width
    bodies.

    Ragged per-stage parameters pack into one ``(S, Lmax)`` array of
    flattened-and-padded rows (sharded over the stage axis); ragged
    inter-stage activations ride the ppermute ring padded to the
    maximum boundary width.  Each device evaluates ITS stage's segment
    sequence via ``lax.switch`` on the stage index — every segment
    still runs the framework's own transposition AD (``ir_call``)."""

    stage_ops: List[List[TOp]]      # S stages of segment sub-ops
    packed: Optional[Any]           # (S, Lmax) padded flat param rows
    width: int                      # ring activation width H (max boundary)
    lmax: int

    @property
    def n_stages(self) -> int:
        return len(self.stage_ops)

    @property
    def in_width(self) -> int:
        return self.stage_ops[0][0].in_stack[0][0]

    @property
    def out_width(self) -> int:
        return self.stage_ops[-1][-1].out_stack[0][0]

    def flat_params(self) -> Tuple[Any, ...]:
        return (self.packed,)

    def unflatten(self, flat: Tuple[Any, ...]) -> "HeteroPipelinedNetwork":
        (packed,) = flat
        return HeteroPipelinedNetwork(self.stage_ops, packed, self.width,
                                      self.lmax)

    def skeleton(self) -> "HeteroPipelinedNetwork":
        return HeteroPipelinedNetwork(self.stage_ops, None, self.width,
                                      self.lmax)

    def to_network_params(self) -> Tuple[Any, ...]:
        """Back to the original Network param stack (unpack each stage
        row into its segments' shapes, in chain order)."""
        ps: List[Any] = []
        for s, ops in enumerate(self.stage_ops):
            row = self.packed[s]
            ofs = 0
            for op in ops:
                for sh in op.in_stack[1:]:
                    k = int(np.prod(sh, dtype=np.int64)) if sh else 1
                    ps.append(row[ofs : ofs + k].reshape(sh))
                    ofs += k
        return tuple(ps)


def _hetero_groups(net: Network, n_groups: int
                   ) -> Tuple[List[List[TOp]], List[Any], int]:
    """Cut the ``then``-chain into ``n_groups`` contiguous FLOP-balanced
    groups: ``(group_ops, flat_param_rows, ring_width)`` — the shared
    core of the heterogeneous GPipe and circular partitions."""
    segs = network_segments(net)
    if len(segs) < n_groups:
        raise ShapeError(
            f"pipeline needs >= {n_groups} composition segments, the "
            f"network has {len(segs)}")
    widths = set()
    for op, _ in segs:
        for sh in (op.in_stack[0], op.out_stack[0]):
            if len(sh) != 1:
                raise ShapeError(
                    f"hetero pipeline stages exchange rank-1 activations; "
                    f"segment boundary has shape {sh}")
            widths.add(sh[0])
    H = max(widths)
    bounds = _balanced_partition([_op_flops(op) for op, _ in segs],
                                 n_groups)
    group_ops: List[List[TOp]] = []
    rows = []
    for a, b in bounds:
        group_ops.append([op for op, _ in segs[a:b]])
        flat = [jnp.ravel(p) for _, ps in segs[a:b] for p in ps]
        dtype = (net.params[0].dtype if net.params else jnp.float32)
        rows.append(jnp.concatenate(flat) if flat
                    else jnp.zeros((0,), dtype))
    return group_ops, rows, H


def split_network_hetero(net: Network, n_stages: int
                         ) -> HeteroPipelinedNetwork:
    """Cut ANY ``then``-chain into ``n_stages`` contiguous stage groups
    (FLOP-balanced via exact min-max DP) — the generalization of
    :func:`split_network` beyond uniform bodies."""
    stage_ops, rows, H = _hetero_groups(net, n_stages)
    lmax = max(int(r.shape[0]) for r in rows)
    packed = jnp.stack([
        jnp.pad(r, (0, lmax - r.shape[0])) for r in rows])
    return HeteroPipelinedNetwork(stage_ops, packed, H, lmax)


def _make_stage_branch(ops_s: List[TOp], be: Backend, H: int):
    """One stage's callable ``(pvec, x_padded) -> y_padded``: slice the
    live input width, unpack the stage's params from its flat row, run
    each segment's staged sub-graph (framework AD), re-pad the output."""
    calls = [batched_ir_call(op, be) for op in ops_s]
    pshapes = [tuple(op.in_stack[1:]) for op in ops_s]
    in_w = ops_s[0].in_stack[0][0]
    out_w = ops_s[-1].out_stack[0][0]

    def branch(pv, x):
        h = x[:, :in_w]
        ofs = 0
        for call, shapes in zip(calls, pshapes):
            ps = []
            for sh in shapes:
                k = int(np.prod(sh, dtype=np.int64)) if sh else 1
                ps.append(pv[ofs : ofs + k].reshape(sh))
                ofs += k
            h = call(h, *ps)
        if out_w < H:
            h = jnp.pad(h, ((0, 0), (0, H - out_w)))
        return h

    return branch


def _make_hetero_spmd_body(stage_ops: List[List[TOp]], be: Backend):
    """The shard_map-ed GPipe loop over heterogeneous stages: the same
    schedule as :func:`_make_spmd_body`, but each device evaluates its
    OWN stage's segment sequence via ``lax.switch`` on the stage index
    (ragged activations ride the ring padded to the max width)."""

    def spmd(packed_local, mb_inputs):
        pv = packed_local[0]            # this device's (Lmax,) row
        s = lax.axis_index(STAGE_AXIS)
        S = lax.axis_size(STAGE_AXIS)
        H = mb_inputs.shape[-1]
        branches = [_make_stage_branch(ops_s, be, H)
                    for ops_s in stage_ops]
        M = mb_inputs.shape[0]
        T = M + S - 1
        state = jnp.zeros_like(mb_inputs[0])
        outputs = jnp.zeros_like(mb_inputs)

        def step(carry, t):
            state, outputs = carry
            inject = mb_inputs[jnp.minimum(t, M - 1)]
            x_in = jnp.where(s == 0, inject, state)
            y = lax.switch(s, branches, pv, x_in)
            oidx = t - (S - 1)
            updated = lax.dynamic_update_index_in_dim(
                outputs, y, jnp.maximum(oidx, 0), 0)
            outputs = jnp.where((s == S - 1) & (oidx >= 0), updated, outputs)
            state = lax.ppermute(
                y, STAGE_AXIS, [(i, (i + 1) % S) for i in range(S)])
            return (state, outputs), None

        (state, outputs), _ = lax.scan(step, (state, outputs), jnp.arange(T))
        return lax.psum(outputs, STAGE_AXIS)

    return spmd


def split_network(net: Network, n_stages: int) -> PipelinedNetwork:
    """Cut the network at its composition points: find the maximal run of
    structurally identical segments (the uniform ffLayer body), require
    its length divisible by ``n_stages``, and stack its params with a
    leading segment axis; segments before/after run replicated."""
    segs = network_segments(net)
    keys = [op.struct_key() for op, _ in segs]
    # longest run of equal keys
    best_start, best_len = 0, 1
    start = 0
    for i in range(1, len(keys) + 1):
        if i == len(keys) or keys[i] != keys[start]:
            if i - start > best_len:
                best_start, best_len = start, i - start
            start = i
    n_body = (best_len // n_stages) * n_stages
    if n_body < n_stages:
        raise ShapeError(
            f"pipeline needs >= {n_stages} structurally identical layer "
            f"segments; longest uniform run is {best_len} "
            f"(segments: {[tuple(op.in_stack) for op, _ in segs]})"
        )
    body = segs[best_start : best_start + n_body]
    body_op = body[0][0]
    body_params = tuple(
        jnp.stack([seg_params[j] for _, seg_params in body])
        for j in range(len(body[0][1]))
    )
    return PipelinedNetwork(
        pre=segs[:best_start],
        body_op=body_op,
        body_params=body_params,
        n_body=n_body,
        post=segs[best_start + n_body :],
    )


@dataclass
class HeteroTpPipelinedNetwork:
    """A heterogeneous partition that ALSO tensor-parallels: every
    segment matches the row-shardable ffLayer pattern — elementwise
    tails (an autoencoder's 784→512→256→128→… logistic pyramid) AND
    softmax tails (the flagship's output head, whose normalization runs
    replicated after the all-gather) — so each stage's params pack as
    ``(S, tp, Lmax)`` rows of per-shard row-slices, sharded over BOTH
    the stage and model axes.  Each device evaluates its stage's
    tp-local segment sequence (``_tp_local_segment_split`` graphs
    through ``ir_call``'s transposition AD) with an activation
    all-gather between segments."""

    stage_ops: List[List[TOp]]        # full-width segment ops per stage
    local_ops: List[List[Tuple[TOp, Optional[TOp]]]]  # (tp-local, replicated-suffix) per segment
    packed: Optional[Any]             # (S, tp, Lmax)
    width: int                        # ring activation width H
    lmax: int
    tp: int

    @property
    def n_stages(self) -> int:
        return len(self.stage_ops)

    @property
    def in_width(self) -> int:
        return self.stage_ops[0][0].in_stack[0][0]

    @property
    def out_width(self) -> int:
        return self.stage_ops[-1][-1].out_stack[0][0]

    def flat_params(self) -> Tuple[Any, ...]:
        return (self.packed,)

    def unflatten(self, flat) -> "HeteroTpPipelinedNetwork":
        (packed,) = flat
        return HeteroTpPipelinedNetwork(
            self.stage_ops, self.local_ops, packed, self.width,
            self.lmax, self.tp)

    def skeleton(self) -> "HeteroTpPipelinedNetwork":
        return HeteroTpPipelinedNetwork(
            self.stage_ops, self.local_ops, None, self.width,
            self.lmax, self.tp)

    def to_network_params(self) -> Tuple[Any, ...]:
        """Reassemble the Network stack: concatenate each param's tp
        row-slices back to full width, in chain order."""
        ps: List[Any] = []
        for s, ops in enumerate(self.stage_ops):
            ofs = 0
            rows = self.packed[s]  # (tp, Lmax)
            for op in ops:
                for sh in op.in_stack[1:]:
                    o_l = sh[0] // self.tp
                    loc = (o_l,) + tuple(sh[1:])
                    k = int(np.prod(loc, dtype=np.int64))
                    parts = [rows[m, ofs : ofs + k].reshape(loc)
                             for m in range(self.tp)]
                    ps.append(jnp.concatenate(parts, axis=0))
                    ofs += k
        return tuple(ps)


def _hetero_tp_groups(net: Network, n_groups: int, tp: int):
    """Shared core of the tensor-parallel heterogeneous cuts (GPipe
    stages and circular chunk groups): cut the ``then``-chain into
    ``n_groups`` contiguous FLOP-balanced groups with every segment
    row-sharded over ``tp`` — ``(group_ops, local_ops, per_shard_rows,
    ring_width)``, or None when any segment doesn't match the ffLayer
    pattern / isn't tp-divisible (the caller falls back, loudly)."""
    segs = network_segments(net)
    if len(segs) < n_groups:
        return None
    local = [_tp_local_segment_split(op, tp) for op, _ in segs]
    if any(lo is None for lo in local):
        return None
    widths = set()
    for op, _ in segs:
        for sh in (op.in_stack[0], op.out_stack[0]):
            if len(sh) != 1:
                return None
            widths.add(sh[0])
    H = max(widths)
    bounds = _balanced_partition([_op_flops(op) for op, _ in segs],
                                 n_groups)
    group_ops, local_ops, rows = [], [], []
    for a, b in bounds:
        group_ops.append([op for op, _ in segs[a:b]])
        local_ops.append(local[a:b])
        per_shard = []
        for m in range(tp):
            flat = []
            for op, ps in segs[a:b]:
                for sh, p in zip(op.in_stack[1:], ps):
                    o_l = sh[0] // tp
                    flat.append(jnp.ravel(p[m * o_l : (m + 1) * o_l]))
            per_shard.append(jnp.concatenate(flat) if flat
                             else jnp.zeros((0,), net.params[0].dtype))
        rows.append(per_shard)
    return group_ops, local_ops, rows, H


def split_network_hetero_tp(net: Network, n_stages: int, tp: int
                            ) -> Optional[HeteroTpPipelinedNetwork]:
    """The heterogeneous FLOP-balanced cut with every segment
    row-sharded over ``tp`` model shards — possible only when EVERY
    segment matches the ffLayer pattern with a tp-divisible output
    width (odd widths return None; the caller falls back to the
    model-replicated hetero cut).  Softmax-tailed segments (the
    flagship's output head) shard too: the affine rows + exp run
    tp-local and the normalization runs replicated after the
    all-gather (``_tp_local_segment_split``)."""
    r = _hetero_tp_groups(net, n_stages, tp)
    if r is None:
        return None
    stage_ops, local_ops, rows, H = r
    lmax = max(int(x.shape[0]) for sh in rows for x in sh)
    packed = jnp.stack([
        jnp.stack([jnp.pad(x, (0, lmax - x.shape[0])) for x in sh])
        for sh in rows])
    return HeteroTpPipelinedNetwork(stage_ops, local_ops, packed, H,
                                    lmax, tp)


def _make_tp_stage_branch(local_segs: List[Tuple[TOp, Optional[TOp]]],
                          be: Backend, H: int):
    """One tp-sharded stage: unpack the device's row-slice params, run
    each tp-local segment through framework AD, all-gather the full
    activation between segments (then any replicated non-rowwise tail —
    the sharded-softmax normalization), re-pad the final output."""
    calls = [(batched_ir_call(loc, be), tuple(loc.in_stack[1:]),
              batched_ir_call(suf, be) if suf is not None else None)
             for loc, suf in local_segs]
    in_w = local_segs[0][0].in_stack[0][0]

    def branch(pv, x):
        h = x[:, :in_w]
        ofs = 0
        for call, shapes, suf_call in calls:
            ps = []
            for sh in shapes:
                k = int(np.prod(sh, dtype=np.int64)) if sh else 1
                ps.append(pv[ofs : ofs + k].reshape(sh))
                ofs += k
            a_local = call(h, *ps)
            h = lax.all_gather(a_local, MODEL_AXIS, axis=1, tiled=True)
            if suf_call is not None:
                h = suf_call(h)
        if h.shape[1] < H:
            h = jnp.pad(h, ((0, 0), (0, H - h.shape[1])))
        return h

    return branch


def _make_hetero_tp_spmd_body(pnet: "HeteroTpPipelinedNetwork",
                              be: Backend):
    """The hetero GPipe loop with tp-sharded stages: identical schedule
    to :func:`_make_hetero_spmd_body`, but each branch computes its
    model shard's activation rows and all-gathers between segments."""

    def spmd(packed_local, mb_inputs):
        pv = packed_local[0, 0]          # this device's (Lmax,) row
        s = lax.axis_index(STAGE_AXIS)
        S = lax.axis_size(STAGE_AXIS)
        H = mb_inputs.shape[-1]
        branches = [
            _make_tp_stage_branch(pnet.local_ops[k], be, H)
            for k in range(pnet.n_stages)]
        M = mb_inputs.shape[0]
        T = M + S - 1
        state = jnp.zeros_like(mb_inputs[0])
        outputs = jnp.zeros_like(mb_inputs)

        def step(carry, t):
            state, outputs = carry
            inject = mb_inputs[jnp.minimum(t, M - 1)]
            x_in = jnp.where(s == 0, inject, state)
            y = lax.switch(s, branches, pv, x_in)
            oidx = t - (S - 1)
            updated = lax.dynamic_update_index_in_dim(
                outputs, y, jnp.maximum(oidx, 0), 0)
            outputs = jnp.where((s == S - 1) & (oidx >= 0), updated, outputs)
            state = lax.ppermute(
                y, STAGE_AXIS, [(i, (i + 1) % S) for i in range(S)])
            return (state, outputs), None

        (state, outputs), _ = lax.scan(step, (state, outputs), jnp.arange(T))
        return lax.psum(outputs, STAGE_AXIS)

    return spmd


# ---------------------------------------------------------------------------
# circular (interleaved) schedule over the staged IR
# ---------------------------------------------------------------------------


def _interleave_perm(n_body: int, S: int, V: int) -> np.ndarray:
    """Segment permutation for the circular schedule: global chunk
    ``c = v*S + d`` (``Lc`` consecutive segments) lands at device ``d``'s
    local chunk ``v`` — stored device-major so a plain stage-axis shard
    hands each device its V chunks contiguously."""
    Lc = n_body // (S * V)
    idx = []
    for d in range(S):
        for v in range(V):
            c = v * S + d
            idx.extend(range(c * Lc, (c + 1) * Lc))
    return np.asarray(idx)


@dataclass
class CircularPipelinedNetwork(PipelinedNetwork):
    """A uniform-body partition stored in circular-schedule order: the
    body param stacks are segment-permuted (``_interleave_perm``) so the
    stage-axis shard gives device ``d`` chunks ``d, S+d, 2S+d, ...`` —
    the interleaved placement that shrinks the pipeline bubble from
    (SV·Lc-terms) to (S-1)/(VM+S-1).  ``to_network_params`` undoes the
    permutation, so checkpoints stay ordinary Network stacks."""

    n_stages: int = 0
    n_chunks: int = 0  # V

    def to_network_params(self) -> Tuple[Any, ...]:
        perm = _interleave_perm(self.n_body, self.n_stages, self.n_chunks)
        inv = np.argsort(perm)
        logical = PipelinedNetwork(
            self.pre, self.body_op,
            tuple(b[inv] for b in self.body_params), self.n_body,
            self.post)
        return logical.to_network_params()

    def unflatten(self, flat: Tuple[Any, ...]) -> "CircularPipelinedNetwork":
        p = super().unflatten(flat)
        return CircularPipelinedNetwork(
            p.pre, p.body_op, p.body_params, p.n_body, p.post,
            n_stages=self.n_stages, n_chunks=self.n_chunks)

    def skeleton(self) -> "CircularPipelinedNetwork":
        p = super().skeleton()
        return CircularPipelinedNetwork(
            p.pre, p.body_op, p.body_params, p.n_body, p.post,
            n_stages=self.n_stages, n_chunks=self.n_chunks)


def split_network_circular(net: Network, n_stages: int, n_chunks: int
                           ) -> CircularPipelinedNetwork:
    """The uniform split with the body stored in circular order: the
    longest uniform run must hold S*V chunk-rows (each device runs V
    round-robin chunks of Lc = n_body/(S*V) segments)."""
    if n_chunks < 1:
        raise ShapeError(
            f"circular schedule needs n_chunks >= 1, got {n_chunks}")
    p = split_network(net, n_stages * n_chunks)
    perm = _interleave_perm(p.n_body, n_stages, n_chunks)
    return CircularPipelinedNetwork(
        p.pre, p.body_op, tuple(b[perm] for b in p.body_params),
        p.n_body, p.post, n_stages=n_stages, n_chunks=n_chunks)


@dataclass
class HeteroCircularPipelinedNetwork:
    """A heterogeneous partition in circular-schedule order: the whole
    ``then``-chain cut into ``S*V`` contiguous FLOP-balanced chunk
    groups; device ``d`` runs chunks ``d, S+d, ..., (V-1)S+d``
    round-robin — the interleaved placement that shrinks the pipeline
    bubble exactly as the uniform circular schedule does, for chains
    the uniform split rejects (e.g. autoencoder pyramids, whose widths
    vary layer to layer).

    Packed rows ``(S, V, Lmax)``: ``[d, v]`` holds chunk ``v*S + d``'s
    flattened-and-padded params, so a plain stage-axis shard hands each
    device its V chunk rows.  ``to_network_params`` walks chunks in
    chain order, so checkpoints stay ordinary Network stacks."""

    chunk_ops: List[List[TOp]]      # S*V chunk groups, chain order
    packed: Optional[Any]           # (S, V, Lmax)
    width: int                      # ring activation width H
    lmax: int
    S: int
    V: int

    @property
    def n_stages(self) -> int:
        return self.S

    @property
    def n_chunks(self) -> int:
        return self.V

    @property
    def in_width(self) -> int:
        return self.chunk_ops[0][0].in_stack[0][0]

    @property
    def out_width(self) -> int:
        return self.chunk_ops[-1][-1].out_stack[0][0]

    def flat_params(self) -> Tuple[Any, ...]:
        return (self.packed,)

    def unflatten(self, flat: Tuple[Any, ...]
                  ) -> "HeteroCircularPipelinedNetwork":
        (packed,) = flat
        return HeteroCircularPipelinedNetwork(
            self.chunk_ops, packed, self.width, self.lmax, self.S, self.V)

    def skeleton(self) -> "HeteroCircularPipelinedNetwork":
        return HeteroCircularPipelinedNetwork(
            self.chunk_ops, None, self.width, self.lmax, self.S, self.V)

    def to_network_params(self) -> Tuple[Any, ...]:
        ps: List[Any] = []
        for c, ops in enumerate(self.chunk_ops):
            row = self.packed[c % self.S, c // self.S]
            ofs = 0
            for op in ops:
                for sh in op.in_stack[1:]:
                    k = int(np.prod(sh, dtype=np.int64)) if sh else 1
                    ps.append(row[ofs : ofs + k].reshape(sh))
                    ofs += k
        return tuple(ps)


def split_network_hetero_circular(net: Network, n_stages: int,
                                  n_chunks: int
                                  ) -> HeteroCircularPipelinedNetwork:
    """The heterogeneous FLOP-balanced cut stored in circular order:
    ``S*V`` chunk groups packed as ``(S, V, Lmax)`` rows (``[d, v]`` =
    chunk ``v*S + d``) — the interleaved schedule for chains
    :func:`split_network_circular`'s uniform-run requirement rejects."""
    if n_chunks < 1:
        raise ShapeError(
            f"circular schedule needs n_chunks >= 1, got {n_chunks}")
    S, V = n_stages, n_chunks
    group_ops, rows, H = _hetero_groups(net, S * V)
    lmax = max(int(r.shape[0]) for r in rows)
    padded = [jnp.pad(r, (0, lmax - r.shape[0])) for r in rows]
    packed = jnp.stack([
        jnp.stack([padded[v * S + d] for v in range(V)])
        for d in range(S)])
    return HeteroCircularPipelinedNetwork(group_ops, packed, H, lmax, S, V)


@dataclass
class HeteroTpCircularPipelinedNetwork:
    """A heterogeneous circular partition that ALSO tensor-parallels:
    the ``S*V`` chunk groups of :class:`HeteroCircularPipelinedNetwork`
    with every segment row-sharded over ``tp`` model shards (the
    :class:`HeteroTpPipelinedNetwork` decomposition lifted to the
    interleaved schedule).  Packed rows ``(S, V, tp, Lmax)``:
    ``[d, v, m]`` holds chunk ``v*S + d``'s shard-``m`` row-slices, so
    a plain ``(stage, None, model)`` shard hands each device its V
    chunk rows for its model shard.  Softmax-tailed segments run the
    sharded-softmax decomposition (tp-local affine + exp, replicated
    normalization after the activation all-gather)."""

    chunk_ops: List[List[TOp]]        # S*V chunk groups, chain order
    local_ops: List[List[Tuple[TOp, Optional[TOp]]]]  # per chunk/segment
    packed: Optional[Any]             # (S, V, tp, Lmax)
    width: int                        # ring activation width H
    lmax: int
    tp: int
    S: int
    V: int

    @property
    def n_stages(self) -> int:
        return self.S

    @property
    def n_chunks(self) -> int:
        return self.V

    @property
    def in_width(self) -> int:
        return self.chunk_ops[0][0].in_stack[0][0]

    @property
    def out_width(self) -> int:
        return self.chunk_ops[-1][-1].out_stack[0][0]

    def flat_params(self) -> Tuple[Any, ...]:
        return (self.packed,)

    def unflatten(self, flat: Tuple[Any, ...]
                  ) -> "HeteroTpCircularPipelinedNetwork":
        (packed,) = flat
        return HeteroTpCircularPipelinedNetwork(
            self.chunk_ops, self.local_ops, packed, self.width,
            self.lmax, self.tp, self.S, self.V)

    def skeleton(self) -> "HeteroTpCircularPipelinedNetwork":
        return HeteroTpCircularPipelinedNetwork(
            self.chunk_ops, self.local_ops, None, self.width,
            self.lmax, self.tp, self.S, self.V)

    def to_network_params(self) -> Tuple[Any, ...]:
        """Reassemble the Network stack: walk chunks in chain order,
        concatenating each param's tp row-slices back to full width."""
        ps: List[Any] = []
        for c, ops in enumerate(self.chunk_ops):
            rows = self.packed[c % self.S, c // self.S]  # (tp, Lmax)
            ofs = 0
            for op in ops:
                for sh in op.in_stack[1:]:
                    o_l = sh[0] // self.tp
                    loc = (o_l,) + tuple(sh[1:])
                    k = int(np.prod(loc, dtype=np.int64))
                    parts = [rows[m, ofs : ofs + k].reshape(loc)
                             for m in range(self.tp)]
                    ps.append(jnp.concatenate(parts, axis=0))
                    ofs += k
        return tuple(ps)


def split_network_hetero_tp_circular(
        net: Network, n_stages: int, n_chunks: int, tp: int
        ) -> Optional[HeteroTpCircularPipelinedNetwork]:
    """The heterogeneous circular cut with every segment row-sharded
    over ``tp`` model shards: ``S*V`` FLOP-balanced chunk groups packed
    as ``(S, V, tp, Lmax)`` per-shard rows (``[d, v, m]`` = chunk
    ``v*S + d`` shard ``m``).  None when any segment doesn't match the
    ffLayer pattern or isn't tp-divisible — the caller falls back to
    the model-replicated hetero circular cut, loudly."""
    if n_chunks < 1:
        raise ShapeError(
            f"circular schedule needs n_chunks >= 1, got {n_chunks}")
    S, V = n_stages, n_chunks
    r = _hetero_tp_groups(net, S * V, tp)
    if r is None:
        return None
    group_ops, local_ops, rows, H = r
    lmax = max(int(x.shape[0]) for sh in rows for x in sh)
    padded = [jnp.stack([jnp.pad(x, (0, lmax - x.shape[0])) for x in sh])
              for sh in rows]                      # S*V of (tp, Lmax)
    packed = jnp.stack([
        jnp.stack([padded[v * S + d] for v in range(V)])
        for d in range(S)])                        # (S, V, tp, Lmax)
    return HeteroTpCircularPipelinedNetwork(
        group_ops, local_ops, packed, H, lmax, tp, S, V)


def _circular_ticks(chunk_eval, mb_inputs, V: int):
    """THE circular-schedule tick loop, shared by every chunk-program
    variant (uniform stacked, uniform x tp, heterogeneous, hetero x
    tp): device d evaluates its local chunk v's microbatch m at tick
    ``t = v*M + m + d``; the activation ring wraps V times; with M > S
    the wrapped activation waits in a depth-(M-S) FIFO (one slot
    written + read per tick).  ``chunk_eval(v, x) -> y`` is the
    per-device chunk program — the only thing the variants change, so
    the scheduler itself exists exactly once."""
    d = lax.axis_index(STAGE_AXIS)
    S = lax.axis_size(STAGE_AXIS)
    M = mb_inputs.shape[0]
    T = V * M + S - 1
    F = M - S  # FIFO depth (ticks a wrapped activation waits)
    state = jnp.zeros_like(mb_inputs[0])
    outputs = jnp.zeros_like(mb_inputs)

    def step(carry, t):
        if F > 0:
            state, outputs, fifo = carry
        else:
            state, outputs = carry
        k = t - d
        kc = jnp.clip(k, 0, V * M - 1)
        v = kc // M
        m = kc % M
        inject = mb_inputs[m]
        if F > 0:
            slot = t % F
            x_wrap = lax.dynamic_index_in_dim(fifo, slot, 0,
                                              keepdims=False)
            fifo = lax.dynamic_update_index_in_dim(fifo, state, slot, 0)
        else:
            x_wrap = state
        x_in = jnp.where((d == 0) & (v == 0), inject,
                         jnp.where(d == 0, x_wrap, state))
        y = chunk_eval(v, x_in)
        collect = (d == S - 1) & (v == V - 1) & (k >= 0) & (k < V * M)
        updated = lax.dynamic_update_index_in_dim(outputs, y, m, 0)
        outputs = jnp.where(collect, updated, outputs)
        state = lax.ppermute(
            y, STAGE_AXIS, [(i, (i + 1) % S) for i in range(S)])
        if F > 0:
            return (state, outputs, fifo), None
        return (state, outputs), None

    if F > 0:
        fifo0 = jnp.zeros((F,) + mb_inputs.shape[1:], mb_inputs.dtype)
        init = (state, outputs, fifo0)
    else:
        init = (state, outputs)
    out = lax.scan(step, init, jnp.arange(T))[0]
    return lax.psum(out[1], STAGE_AXIS)


def _make_spmd_body_circular(body_op: TOp, be: Backend, V: int, Lc: int,
                             n_body_params: int,
                             tp_local_op: Optional[TOp] = None):
    """The circular-schedule shard_map body over the staged IR
    (uniform stacked chunks through :func:`_circular_ticks`): each
    chunk evaluates its Lc segments' staged sub-graphs through the
    framework's transposition AD (``ir_call``); with ``tp_local_op``
    each segment is additionally row-sharded over ``model`` with an
    activation all-gather (same as the GPipe body)."""
    seg_call = batched_ir_call(tp_local_op or body_op, be)
    gather = tp_local_op is not None

    def chunk_forward(params_local, v, x):
        # params_local: each (V, Lc, *shape); dynamic chunk v, static l
        h = x
        for l in range(Lc):
            ps = tuple(
                lax.dynamic_index_in_dim(p, v, 0, keepdims=False)[l]
                for p in params_local)
            a = seg_call(h, *ps)
            h = (lax.all_gather(a, MODEL_AXIS, axis=1, tiled=True)
                 if gather else a)
        return h

    def spmd(*args):
        params_local = tuple(
            p.reshape((V, Lc) + p.shape[1:]) for p in args[:n_body_params])
        mb_inputs = args[n_body_params]
        return _circular_ticks(
            lambda v, x: chunk_forward(params_local, v, x), mb_inputs, V)

    return spmd


def _make_hetero_spmd_body_circular(pnet, be: Backend):
    """The circular-schedule shard_map body over HETEROGENEOUS chunk
    groups (:func:`_circular_ticks` drives the schedule): each global
    chunk ``c = v*S + d`` evaluates its OWN segment sequence via
    ``lax.switch`` over all ``S*V`` chunk programs — the hetero-GPipe
    branch trick lifted to the interleaved schedule.  Ragged
    activations ride the ring padded to the max boundary width.

    With a :class:`HeteroTpCircularPipelinedNetwork` each chunk program
    is additionally tensor-parallel over the ``model`` axis (the
    ``_make_tp_stage_branch`` decomposition: row-slice params compute
    local activation rows, an all-gather restores full width between
    segments) — the schedule itself is unchanged."""
    V = pnet.V
    tp = isinstance(pnet, HeteroTpCircularPipelinedNetwork)

    def spmd(packed_local, mb_inputs):
        # this device's (V, Lmax) rows: under tp the packed leaf is
        # (S, V, tp, Lmax) sharded (stage, None, model) -> local
        # (1, V, 1, Lmax); without tp (S, V, Lmax) -> (1, V, Lmax)
        pv = packed_local[0, :, 0] if tp else packed_local[0]
        d = lax.axis_index(STAGE_AXIS)
        S = lax.axis_size(STAGE_AXIS)
        H = mb_inputs.shape[-1]
        branches = ([_make_tp_stage_branch(locs, be, H)
                     for locs in pnet.local_ops] if tp else
                    [_make_stage_branch(ops_c, be, H)
                     for ops_c in pnet.chunk_ops])

        def chunk_eval(v, x):
            row = lax.dynamic_index_in_dim(pv, v, 0, keepdims=False)
            return lax.switch(v * S + d, branches, row, x)

        return _circular_ticks(chunk_eval, mb_inputs, V)

    return spmd


# ---------------------------------------------------------------------------
# the pipelined step
# ---------------------------------------------------------------------------


def _tp_local_segment_split(op: TOp, tp: int
                            ) -> Optional[Tuple[TOp, Optional[TOp]]]:
    """Row-parallel (Megatron) split of an ffLayer segment: if ``op``
    matches the gen_net layer pattern
    ``First(swap >> matVec, rest=[(o,)]) >> add >> [tail...]`` and
    ``tp`` divides ``o``, return ``(local, suffix)`` — ``local`` is the
    affine part plus the maximal rowwise (elementwise) prefix of the
    tail rebuilt at width ``o/tp`` (weights/bias row-sharded over the
    ``model`` axis), and ``suffix`` is the remaining non-rowwise tail
    (e.g. the softmax normalization ``duplicate >> first(sumRows >>
    recip) >> outer``, ``NeuralNet.hs:52-59``) recomposed at FULL width,
    to run replicated after the activation all-gather — the standard
    sharded-softmax decomposition (local exp rows, global sum after the
    gather).  ``suffix`` is None for all-elementwise tails.  Returns
    None when the segment doesn't match (caller falls back, loudly)."""
    from ..ops import prim as P

    def flat(o):
        return (flat(o.f) + flat(o.g)) if isinstance(o, Compose) else [o]

    nodes = flat(op)
    if len(nodes) < 2 or not isinstance(nodes[0], First):
        return None
    inner = flat(nodes[0].op)
    if len(inner) != 2:
        return None
    sw, gm = inner
    if not (isinstance(sw, Shuffle) and sw.idxs == (1, 0)):
        return None
    if not (isinstance(gm, GMul) and len(gm.ms) == 1 and len(gm.os) == 1
            and not gm.ns):
        return None
    o, i = gm.ms[0], gm.os[0]
    if o % tp != 0 or nodes[0].rest != ((o,),):
        return None
    if not (isinstance(nodes[1], SumOp) and nodes[1].n == 2
            and nodes[1].shape == (o,)):
        return None
    k = 2
    while (k < len(nodes) and isinstance(nodes[k], LiftOp)
           and nodes[k].shape == (o,) and nodes[k].vf.n_args == 1):
        k += 1
    suffix: Optional[TOp] = None
    if k < len(nodes):
        suffix = nodes[k]
        for nd in nodes[k + 1:]:
            suffix = suffix >> nd
        if (suffix.in_stack != ((o,),) or len(suffix.out_stack) != 1
                or len(suffix.out_stack[0]) != 1):
            return None
    o_l = o // tp
    local = P.first(P.swap((i,), (o_l, i)) >> P.mat_vec(o_l, i),
                    rest=[(o_l,)]) >> SumOp(2, (o_l,))
    for nd in nodes[2:k]:
        local = local >> LiftOp(nd.vf, (o_l,))
    return local, suffix


def _tp_local_segment(op: TOp, tp: int) -> Optional[TOp]:
    """The suffix-free case of :func:`_tp_local_segment_split` — the
    uniform-body tp path, where every stage evaluates the same stacked
    segment and no replicated tail is plumbed."""
    r = _tp_local_segment_split(op, tp)
    if r is None or r[1] is not None:
        return None
    return r[0]


def pipeline_tp_segment(pnet, mesh: Mesh) -> Optional[TOp]:
    """The row-local body segment when this partition can tensor-parallel
    over the mesh's ``model`` axis (uniform body matching the ffLayer
    pattern with tp-divisible width); None otherwise."""
    if MODEL_AXIS not in mesh.axis_names or mesh.shape[MODEL_AXIS] <= 1:
        return None
    if not isinstance(pnet, PipelinedNetwork) or pnet.body_op is None:
        return None
    return _tp_local_segment(pnet.body_op, mesh.shape[MODEL_AXIS])


def _ir_pipeline_specs(mesh: Mesh, body_param_shapes, tp: bool):
    """shard_map specs: body param stacks over ``stage`` (and, under
    tp, their leading per-segment row dim over ``model``); microbatches
    over ``data``, replicated over ``model``."""
    has_data = DATA_AXIS in mesh.axis_names
    mb_spec = PSpec(None, DATA_AXIS, None) if has_data else PSpec()
    if tp:
        param_specs = tuple(
            PSpec(STAGE_AXIS, MODEL_AXIS, *([None] * (len(s) - 1)))
            for s in body_param_shapes)
    else:
        param_specs = tuple(PSpec(STAGE_AXIS) for _ in body_param_shapes)
    return param_specs + (mb_spec,), mb_spec


def _make_spmd_body(body_op: TOp, be: Backend, L: int, n_body_params: int,
                    tp_local_op: Optional[TOp] = None):
    """The shard_map-ed GPipe loop: each device holds L consecutive body
    segments' params; microbatches ring-shift with ppermute; every
    segment evaluates its staged sub-graph via framework AD.

    With ``tp_local_op`` each segment is additionally tensor-parallel
    over the ``model`` axis: the device's row-slice of the weights
    computes its slice of the activation through the LOCAL staged
    sub-graph (still framework transposition AD via ``ir_call``), and an
    ``all_gather`` restores the full activation between segments (AD
    transposes it to a reduce-scatter)."""
    if tp_local_op is not None:
        seg_call_local = batched_ir_call(tp_local_op, be)

        def stage_forward(params_local, x):
            h = x  # full width, replicated over the model axis
            for l in range(L):
                a_local = seg_call_local(h, *(p[l] for p in params_local))
                h = lax.all_gather(a_local, MODEL_AXIS, axis=1, tiled=True)
            return h
    else:
        seg_call = batched_ir_call(body_op, be)

        def stage_forward(params_local, x):
            h = x
            for l in range(L):
                h = seg_call(h, *(p[l] for p in params_local))
            return h

    def spmd(*args):
        params_local = args[:n_body_params]  # each (L, *shape)
        mb_inputs = args[n_body_params]      # (M, mb, h)
        s = lax.axis_index(STAGE_AXIS)
        S = lax.axis_size(STAGE_AXIS)
        M = mb_inputs.shape[0]
        T = M + S - 1
        state = jnp.zeros_like(mb_inputs[0])
        outputs = jnp.zeros_like(mb_inputs)

        def step(carry, t):
            state, outputs = carry
            inject = mb_inputs[jnp.minimum(t, M - 1)]
            x_in = jnp.where(s == 0, inject, state)
            y = stage_forward(params_local, x_in)
            oidx = t - (S - 1)
            updated = lax.dynamic_update_index_in_dim(
                outputs, y, jnp.maximum(oidx, 0), 0)
            outputs = jnp.where((s == S - 1) & (oidx >= 0), updated, outputs)
            state = lax.ppermute(
                y, STAGE_AXIS, [(i, (i + 1) % S) for i in range(S)])
            return (state, outputs), None

        (state, outputs), _ = lax.scan(step, (state, outputs), jnp.arange(T))
        return lax.psum(outputs, STAGE_AXIS)

    return spmd


def make_ir_pipeline_loss(
    net: Network,
    loss: TOp,
    be: Backend,
    mesh: Mesh,
    n_microbatches: int,
    pnet: Optional[PipelinedNetwork] = None,
    schedule: str = "gpipe",
    n_chunks: int = 2,
) -> Tuple[Callable, PipelinedNetwork]:
    """``(loss_fn, pnet)``: the pipelined batch-mean loss over the
    stage-partitioned flat params — ``loss_fn(flat_params, xb, yb)`` —
    differentiable under ``jax.grad`` (every segment evaluates through
    the framework's own transposition AD via ``ir_call``; jax only
    transposes the schedule).  Building block for both the SGD
    ``ir_pipeline_train_step`` and the optimizer-generic ``fit(mesh=
    <stage mesh>)`` path.

    ``pnet`` may be a prebuilt partition (or a skeleton of one — the
    closure uses only its STRUCTURE: ops and per-segment param counts,
    never the array values), avoiding a second ``split_network`` and
    keeping no extra parameter copy alive.

    Uniform-body networks take the stacked-params fast path
    (:func:`split_network`); any other ``then``-chain falls back to the
    heterogeneous FLOP-balanced partition
    (:func:`split_network_hetero`) — so the real flagship
    784->300->100->10 pipelines too.

    ``schedule="circular"`` runs the interleaved schedule instead of
    GPipe: each device holds ``n_chunks`` (V) round-robin chunks of the
    chain and the activation ring wraps V times, shrinking the bubble
    from (S-1)/(M+S-1) ticks of an SV-long GPipe chain to
    (S-1)/(VM+S-1); requires ``n_microbatches >= S`` (M > S buffers the
    wrap in a depth-(M-S) FIFO).  Uniform bodies take the stacked cut
    (:func:`split_network_circular`); any other chain takes the
    heterogeneous circular cut — tensor-parallel over the mesh's
    ``model`` axis when every segment row-shards
    (:func:`split_network_hetero_tp_circular`), model-replicated (with
    a loud warning) otherwise."""
    if be.name != "jax":
        raise ValueError("ir pipeline requires the jax backend")
    S = mesh.shape[STAGE_AXIS]
    if pnet is None:
        pnet = (partition_network_circular(net, S, n_chunks, mesh)
                if schedule == "circular"
                else partition_network(net, S, mesh))
    if isinstance(pnet, (HeteroCircularPipelinedNetwork,
                         HeteroTpCircularPipelinedNetwork)):
        if schedule != "circular":
            raise ValueError(
                "a hetero circular partition runs only under "
                "schedule='circular'")
        if pnet.S != S:
            # a prebuilt partition for the wrong stage count would
            # otherwise SILENTLY train a different network: shard_map
            # splits the packed rows across whatever stages exist and
            # lax.switch only ever selects the first S*V chunk programs
            raise ValueError(
                f"partition was built for {pnet.S} stages but the "
                f"mesh's stage axis is {S} — rebuild pnet for this "
                f"mesh (or omit it)")
        if n_microbatches < S:
            raise ValueError(
                f"circular schedule requires n_microbatches "
                f"({n_microbatches}) >= stage-axis size ({S})")
        if (isinstance(pnet, HeteroCircularPipelinedNetwork)
                and MODEL_AXIS in mesh.axis_names
                and mesh.shape[MODEL_AXIS] > 1):
            import warnings

            warnings.warn(
                "staged-IR pipeline: this heterogeneous circular "
                "partition does not shard over the model axis (a "
                "segment doesn't match the row-shardable ffLayer "
                "pattern or its width doesn't divide the model-axis "
                "size) — it will sit idle (replicated chunks)",
                stacklevel=2)
        tp_c = isinstance(pnet, HeteroTpCircularPipelinedNetwork)
        return _make_packed_loss(
            loss, be, mesh, n_microbatches, pnet,
            _make_hetero_spmd_body_circular(pnet, be),
            PSpec(STAGE_AXIS, None, MODEL_AXIS, None) if tp_c
            else PSpec(STAGE_AXIS, None, None))
    if isinstance(pnet, HeteroTpPipelinedNetwork):
        if schedule == "circular":
            raise ShapeError(
                "the circular schedule needs a hetero-circular partition "
                "for this network: build pnet with "
                "split_network_hetero_tp_circular (or omit pnet)")
        if pnet.n_stages != S:
            raise ValueError(
                f"partition was built for {pnet.n_stages} stages but "
                f"the mesh's stage axis is {S} — rebuild pnet for this "
                f"mesh (or omit it)")
        return _make_packed_loss(
            loss, be, mesh, n_microbatches, pnet,
            _make_hetero_tp_spmd_body(pnet, be),
            PSpec(STAGE_AXIS, MODEL_AXIS))
    if isinstance(pnet, HeteroPipelinedNetwork):
        if schedule == "circular":
            raise ShapeError(
                "the circular schedule needs chunk-ordered params: build "
                "pnet with split_network_hetero_circular (or omit pnet)")
        if pnet.n_stages != S:
            raise ValueError(
                f"partition was built for {pnet.n_stages} stages but "
                f"the mesh's stage axis is {S} — rebuild pnet for this "
                f"mesh (or omit it)")
        if MODEL_AXIS in mesh.axis_names and mesh.shape[MODEL_AXIS] > 1:
            import warnings

            warnings.warn(
                "staged-IR pipeline: heterogeneous partitions do not "
                "shard over the model axis — it will sit idle "
                "(replicated stages)", stacklevel=2)
        return _make_packed_loss(
            loss, be, mesh, n_microbatches, pnet,
            _make_hetero_spmd_body(pnet.stage_ops, be),
            PSpec(STAGE_AXIS))
    circ = isinstance(pnet, CircularPipelinedNetwork)
    if schedule == "circular" and not circ:
        raise ValueError(
            "schedule='circular' needs a circular partition: omit pnet "
            "or build it with split_network_circular")
    if circ and n_microbatches < S:
        raise ValueError(
            f"circular schedule requires n_microbatches "
            f"({n_microbatches}) >= stage-axis size ({S})")
    if circ and pnet.n_stages != S:
        # the interleave permutation baked into the packed stacks is
        # S-specific: running it on a different stage count would
        # silently evaluate chunks in the wrong order
        raise ValueError(
            f"circular partition was built for {pnet.n_stages} stages "
            f"but the mesh's stage axis is {S} — rebuild pnet for this "
            f"mesh (or omit it)")
    L = pnet.n_body // S
    n_bp = len(pnet.body_params)
    M = n_microbatches

    tp_local = pipeline_tp_segment(pnet, mesh)
    if (tp_local is None and MODEL_AXIS in mesh.axis_names
            and mesh.shape[MODEL_AXIS] > 1):
        import warnings

        warnings.warn(
            "staged-IR pipeline: the body segment does not match the "
            "row-shardable ffLayer pattern (or its width does not divide "
            "the model-axis size) — the model axis will sit idle "
            "(replicated body)", stacklevel=2)
    per_seg_shapes = [p.shape[1:] if p is not None else None
                      for p in pnet.body_params]
    if per_seg_shapes and per_seg_shapes[0] is None:
        # skeleton partitions carry no arrays; shapes come from the op
        per_seg_shapes = list(pnet.body_op.in_stack[1:])
    in_specs, out_spec = _ir_pipeline_specs(mesh, per_seg_shapes,
                                            tp=tp_local is not None)
    if circ:
        V = pnet.n_chunks
        body_fn = _make_spmd_body_circular(
            pnet.body_op, be, V, pnet.n_body // (S * V), n_bp,
            tp_local_op=tp_local)
    else:
        body_fn = _make_spmd_body(pnet.body_op, be, L, n_bp,
                                  tp_local_op=tp_local)
    pipelined = shard_map(
        body_fn,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=out_spec,
        check_vma=False,
    )

    pre_calls = [batched_ir_call(op, be) for op, _ in pnet.pre]
    post_calls = [batched_ir_call(op, be) for op, _ in pnet.post]
    loss_call = ir_call(loss, be)
    loss_batched = jax.vmap(lambda o, y: loss_call(o, y)[0])

    def loss_fn(flat_params, xb, yb):
        p = pnet.unflatten(flat_params)
        h = xb
        for call, (_, seg_p) in zip(pre_calls, p.pre):
            h = call(h, *seg_p)
        B = h.shape[0]
        mb = h.reshape(M, B // M, -1)
        h = pipelined(*p.body_params, mb).reshape(B, -1)
        for call, (_, seg_p) in zip(post_calls, p.post):
            h = call(h, *seg_p)
        return jnp.mean(loss_batched(h, yb))

    return loss_fn, pnet


def partition_network(net: Network, n_stages: int, mesh: Optional[Mesh] = None):
    """The stage partition ``fit``/``make_ir_pipeline_loss`` use: the
    uniform stacked-body cut when the network has one; else — when the
    mesh carries a model axis and every segment row-shards — the
    tensor-parallel heterogeneous cut; else the model-replicated
    heterogeneous FLOP-balanced cut."""
    try:
        return split_network(net, n_stages)
    except ShapeError:
        pass
    if (mesh is not None and MODEL_AXIS in mesh.axis_names
            and mesh.shape[MODEL_AXIS] > 1):
        tp = split_network_hetero_tp(net, n_stages,
                                     mesh.shape[MODEL_AXIS])
        if tp is not None:
            return tp
    return split_network_hetero(net, n_stages)


def partition_network_circular(net: Network, n_stages: int, n_chunks: int,
                               mesh: Optional[Mesh] = None):
    """The circular-schedule partition: the uniform interleaved cut when
    the network has a long-enough uniform run; else — when the mesh
    carries a model axis and every segment row-shards — the
    tensor-parallel heterogeneous circular cut; else the
    model-replicated heterogeneous FLOP-balanced circular cut (S*V
    chunk groups) — so any chain with >= S*V segments (autoencoder
    pyramids, varied-width MLPs) runs the interleaved schedule, not
    just uniform bodies."""
    try:
        return split_network_circular(net, n_stages, n_chunks)
    except ShapeError:
        pass
    if (mesh is not None and MODEL_AXIS in mesh.axis_names
            and mesh.shape[MODEL_AXIS] > 1):
        tp = split_network_hetero_tp_circular(net, n_stages, n_chunks,
                                              mesh.shape[MODEL_AXIS])
        if tp is not None:
            return tp
    return split_network_hetero_circular(net, n_stages, n_chunks)


def _make_packed_loss(loss, be, mesh, n_microbatches, pnet, body_fn,
                      packed_spec):
    """(loss_fn, pnet) for every packed-row partition — heterogeneous
    GPipe (``(S, Lmax)`` over stage), hetero x tp (``(S, tp, Lmax)``
    over (stage, model)), hetero circular (``(S, V, Lmax)``), and
    hetero circular x tp (``(S, V, tp, Lmax)``): the whole chain is
    pipelined (no replicated pre/post); the batch is padded to the
    ring width on entry and sliced to the output width before the
    loss.  ``body_fn`` is the variant's shard_map body, ``packed_spec``
    its packed-leaf PSpec — the only two things the variants differ
    in, so the loss plumbing exists exactly once."""
    M = n_microbatches
    has_data = DATA_AXIS in mesh.axis_names
    mb_spec = PSpec(None, DATA_AXIS, None) if has_data else PSpec()
    pipelined = shard_map(
        body_fn,
        mesh=mesh,
        in_specs=(packed_spec, mb_spec),
        out_specs=mb_spec,
        check_vma=False,
    )
    H, out_w = pnet.width, pnet.out_width
    loss_call = ir_call(loss, be)
    loss_batched = jax.vmap(lambda o, y: loss_call(o, y)[0])

    def loss_fn(flat_params, xb, yb):
        (packed,) = flat_params
        B = xb.shape[0]
        h = xb if xb.shape[1] == H else jnp.pad(
            xb, ((0, 0), (0, H - xb.shape[1])))
        mb = h.reshape(M, B // M, H)
        out = pipelined(packed, mb).reshape(B, H)[:, :out_w]
        return jnp.mean(loss_batched(out, yb))

    return loss_fn, pnet


def ir_pipeline_train_step(
    net: Network,
    loss: TOp,
    be: Backend,
    mesh: Mesh,
    n_microbatches: int,
    schedule: str = "gpipe",
    n_chunks: int = 2,
) -> Tuple[Callable, PipelinedNetwork]:
    """Jitted pipeline-parallel SGD step over the staged IR:
    ``fn(lr, xb, yb, *flat_params) -> (mean_loss, new_flat_params)``.

    Returns ``(step, pnet)`` where ``pnet`` is the stage-partitioned
    parameter container (``pnet.flat_params()`` feeds the step;
    ``pnet.unflatten(new).to_network_params()`` rebuilds a Network stack).
    Gradients equal the sequential staged-IR gradients exactly: every
    segment — pre, body stages, post, and the loss — evaluates through
    ``ir_call`` (forward ``apply_tape``, backward ``op.transpose``)."""
    loss_fn, pnet = make_ir_pipeline_loss(net, loss, be, mesh,
                                          n_microbatches,
                                          schedule=schedule,
                                          n_chunks=n_chunks)

    @jax.jit
    def step(lr, xb, yb, *flat_params):
        v, grads = jax.value_and_grad(loss_fn)(tuple(flat_params), xb, yb)
        new_params = tuple(p - lr * g for p, g in zip(flat_params, grads))
        return v, new_params

    return step, pnet


def ir_pipeline_grads(
    net: Network,
    loss: TOp,
    be: Backend,
    mesh: Mesh,
    n_microbatches: int,
    schedule: str = "gpipe",
    n_chunks: int = 2,
) -> Callable:
    """``fn(xb, yb, *flat_params) -> (mean_loss, grads)`` — the raw
    pipelined batch-mean gradient, for direct comparison against the
    sequential staged-IR gradient."""
    step, pnet = ir_pipeline_train_step(net, loss, be, mesh, n_microbatches,
                                        schedule=schedule, n_chunks=n_chunks)

    @jax.jit
    def grads(xb, yb, *flat_params):
        # recover grads from one SGD step with lr=1: g = p - new_p
        v, new_params = step(1.0, xb, yb, *flat_params)
        return v, tuple(p - np_ for p, np_ in zip(flat_params, new_params))

    return grads


def shard_pipelined_params(pnet, mesh: Mesh):
    """Place the body param stacks over the stage axis — and, when the
    body tensor-parallels (``pipeline_tp_segment``), their per-segment
    row dim over the model axis too — pre/post replicated (uniform
    partition); or the packed ``(S, Lmax)`` rows over the stage axis
    (heterogeneous partition).  Placement goes through
    :func:`~tensor_ops.parallel.mesh.place_host`, so meshes spanning
    multiple processes (multi-host pipeline training) place correctly —
    ``device_put`` alone rejects non-addressable targets."""
    from .mesh import place_host

    repl = NamedSharding(mesh, PSpec())
    stage_sh = NamedSharding(mesh, PSpec(STAGE_AXIS))
    if isinstance(pnet, HeteroTpCircularPipelinedNetwork):
        return HeteroTpCircularPipelinedNetwork(
            pnet.chunk_ops, pnet.local_ops,
            place_host(pnet.packed, NamedSharding(
                mesh, PSpec(STAGE_AXIS, None, MODEL_AXIS, None))),
            pnet.width, pnet.lmax, pnet.tp, pnet.S, pnet.V)
    if isinstance(pnet, HeteroCircularPipelinedNetwork):
        return HeteroCircularPipelinedNetwork(
            pnet.chunk_ops,
            place_host(pnet.packed, NamedSharding(
                mesh, PSpec(STAGE_AXIS, None, None))),
            pnet.width, pnet.lmax, pnet.S, pnet.V)
    if isinstance(pnet, HeteroTpPipelinedNetwork):
        return HeteroTpPipelinedNetwork(
            pnet.stage_ops, pnet.local_ops,
            place_host(pnet.packed, NamedSharding(
                mesh, PSpec(STAGE_AXIS, MODEL_AXIS))),
            pnet.width, pnet.lmax, pnet.tp)
    if isinstance(pnet, HeteroPipelinedNetwork):
        return HeteroPipelinedNetwork(
            pnet.stage_ops, place_host(pnet.packed, stage_sh),
            pnet.width, pnet.lmax)
    pre = [(op, tuple(place_host(x, repl) for x in p))
           for op, p in pnet.pre]
    post = [(op, tuple(place_host(x, repl) for x in p))
            for op, p in pnet.post]
    if pipeline_tp_segment(pnet, mesh) is not None:
        body = tuple(
            place_host(x, NamedSharding(
                mesh, PSpec(STAGE_AXIS, MODEL_AXIS,
                            *([None] * (x.ndim - 2)))))
            for x in pnet.body_params)
    else:
        body = tuple(place_host(x, stage_sh) for x in pnet.body_params)
    if isinstance(pnet, CircularPipelinedNetwork):
        return CircularPipelinedNetwork(
            pre, pnet.body_op, body, pnet.n_body, post,
            n_stages=pnet.n_stages, n_chunks=pnet.n_chunks)
    return PipelinedNetwork(pre, pnet.body_op, body, pnet.n_body, post)


# ---------------------------------------------------------------------------
# partition introspection
# ---------------------------------------------------------------------------


def describe_partition(pnet) -> str:
    """Human-readable stage map of a pipeline partition: per-stage
    segment counts, boundary widths, parameter counts, FLOP estimates
    and the load-balance ratio (max/mean stage FLOPs — 1.00 is
    perfect).  The operator-facing answer to "how did my network cut,
    and is the pipeline balanced?" before committing a mesh shape.

    Works for every partition kind ``partition_network`` returns:
    uniform (stacked body), circular (interleaved chunks),
    heterogeneous, and heterogeneous x tensor-parallel."""
    lines: List[str] = []

    def seg_width(op: TOp) -> str:
        i = op.in_stack[0]
        o = op.out_stack[0]
        return f"{i[0] if len(i) == 1 else i}->{o[0] if len(o) == 1 else o}"

    def seg_nparams(op: TOp) -> int:
        return int(sum(np.prod(s, dtype=np.int64) if s else 1
                       for s in op.in_stack[1:]))

    if isinstance(pnet, HeteroTpCircularPipelinedNetwork):
        lines.append(
            f"heterogeneous circular x tp partition: {pnet.S} stages x "
            f"{pnet.V} chunks/device, tp={pnet.tp}, ring width "
            f"{pnet.width}, packed rows (S={pnet.S}, V={pnet.V}, "
            f"tp={pnet.tp}, Lmax={pnet.lmax})")
        flops = []
        for c, (ops_c, locs) in enumerate(zip(pnet.chunk_ops,
                                              pnet.local_ops)):
            f = sum(_op_flops(op) for op in ops_c)
            flops.append(f)
            tags = []
            for op, (loc, suf) in zip(ops_c, locs):
                t = seg_width(op)
                if suf is not None:
                    t += " (+replicated tail)"
                tags.append(t)
            lines.append(
                f"  chunk {c} (device {c % pnet.S}, slot {c // pnet.S}): "
                f"{len(ops_c)} segment(s) [{', '.join(tags)}], "
                f"{sum(seg_nparams(op) for op in ops_c)} params "
                f"(1/{pnet.tp} per shard), ~{f:.0f} FLOPs/sample")
        # a device runs ALL its V chunks: balance is over per-device
        # sums, not per-chunk values
        flops = [sum(flops[c] for c in range(len(flops))
                     if c % pnet.S == d) for d in range(pnet.S)]
    elif isinstance(pnet, HeteroCircularPipelinedNetwork):
        lines.append(
            f"heterogeneous circular partition: {pnet.S} stages x "
            f"{pnet.V} chunks/device, ring width {pnet.width}, packed "
            f"rows (S={pnet.S}, V={pnet.V}, Lmax={pnet.lmax})")
        flops = []
        for c, ops_c in enumerate(pnet.chunk_ops):
            f = sum(_op_flops(op) for op in ops_c)
            flops.append(f)
            lines.append(
                f"  chunk {c} (device {c % pnet.S}, slot {c // pnet.S}): "
                f"{len(ops_c)} segment(s) "
                f"[{', '.join(seg_width(op) for op in ops_c)}], "
                f"{sum(seg_nparams(op) for op in ops_c)} params, "
                f"~{f:.0f} FLOPs/sample")
        # a device runs ALL its V chunks: balance is over per-device
        # sums, not per-chunk values
        flops = [sum(flops[c] for c in range(len(flops))
                     if c % pnet.S == d) for d in range(pnet.S)]
    elif isinstance(pnet, HeteroTpPipelinedNetwork):
        lines.append(
            f"heterogeneous x tp partition: {pnet.n_stages} stages, "
            f"tp={pnet.tp}, ring width {pnet.width}, packed rows "
            f"(S={pnet.n_stages}, tp={pnet.tp}, Lmax={pnet.lmax})")
        flops = []
        for s, (ops_s, locs) in enumerate(zip(pnet.stage_ops,
                                              pnet.local_ops)):
            f = sum(_op_flops(op) for op in ops_s)
            flops.append(f)
            tags = []
            for op, (loc, suf) in zip(ops_s, locs):
                t = seg_width(op)
                if suf is not None:
                    t += " (+replicated tail)"
                tags.append(t)
            lines.append(
                f"  stage {s}: {len(ops_s)} segment(s) [{', '.join(tags)}]"
                f", {sum(seg_nparams(op) for op in ops_s)} params"
                f" (1/{pnet.tp} per shard), ~{f:.0f} FLOPs/sample")
    elif isinstance(pnet, HeteroPipelinedNetwork):
        lines.append(
            f"heterogeneous partition: {pnet.n_stages} stages, ring "
            f"width {pnet.width}, packed rows (S={pnet.n_stages}, "
            f"Lmax={pnet.lmax})")
        flops = []
        for s, ops_s in enumerate(pnet.stage_ops):
            f = sum(_op_flops(op) for op in ops_s)
            flops.append(f)
            lines.append(
                f"  stage {s}: {len(ops_s)} segment(s) "
                f"[{', '.join(seg_width(op) for op in ops_s)}], "
                f"{sum(seg_nparams(op) for op in ops_s)} params, "
                f"~{f:.0f} FLOPs/sample")
    elif isinstance(pnet, PipelinedNetwork):
        kind = ("circular (interleaved)"
                if isinstance(pnet, CircularPipelinedNetwork)
                else "uniform")
        head = (f"{kind} partition: {pnet.n_body} identical body "
                f"segment(s) [{seg_width(pnet.body_op)}], "
                f"{len(pnet.pre)} pre / {len(pnet.post)} post "
                f"replicated segment(s)")
        if isinstance(pnet, CircularPipelinedNetwork):
            head += (f", {pnet.n_chunks} chunks/device over "
                     f"{pnet.n_stages} stages")
        lines.append(head)
        per = _op_flops(pnet.body_op)
        lines.append(
            f"  body segment: {seg_nparams(pnet.body_op)} params, "
            f"~{per:.0f} FLOPs/sample; stage load is exactly balanced "
            f"(identical segments)")
        for name, part in (("pre", pnet.pre), ("post", pnet.post)):
            for op, ps in part:
                lines.append(
                    f"  {name}: [{seg_width(op)}], "
                    f"{seg_nparams(op)} params (replicated)")
        flops = [per]
    else:
        raise TypeError(f"not a pipeline partition: {type(pnet).__name__}")
    if len(flops) > 1:
        mean = sum(flops) / len(flops)
        lines.append(f"  balance: max/mean stage FLOPs = "
                     f"{max(flops) / mean:.2f}")
    return "\n".join(lines)
