"""High-level training loop: the production ``fit`` the reference never
had (its loop is an inline ``foldl'`` over samples with printf reporting,
``app/MNIST.hs:390-396``).

Composes the pieces of this framework: the staged-IR network, the native
threaded batch loader, an optimizer, optional mesh sharding, JSONL
metrics, and periodic checkpoints — with the whole optimizer step jitted
(gradients from the framework's transposition AD, vmapped over the batch).
"""

from __future__ import annotations

import os
import sys

from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import numpy as np

from ..backend.base import Backend
from ..ops import ir
from ..ops.ir import TOp
from ..utils.metrics import MetricsLogger
from ..utils.native import NativeLoader
from .feedforward import Network
from .optim import Optimizer, clip_by_global_norm, sgd


@dataclass
class FitResult:
    net: Network
    history: list
    steps: int
    # exponential moving average of the params (fit(ema_decay=...)) —
    # the serving artifact Polyak averaging produces; None when off
    ema_net: Optional[Network] = None


class _CheckpointWrites:
    """Bounded async checkpoint-write tracker shared by the fit loops.

    Writes run on the checkpoint module's 1-worker pool (so files never
    interleave); ``add`` joins the oldest futures once more than two
    checkpoint boundaries are in flight, surfacing write errors
    promptly; ``join`` drains everything and RETURNS the first error —
    the caller re-raises only when no exception is already unwinding
    (the crash being checkpointed against outranks a failed save of
    it)."""

    def __init__(self):
        self._futures = []

    def add(self, *futures) -> None:
        self._futures.extend(futures)
        while len(self._futures) > 4:
            self._futures.pop(0).result()

    def join(self) -> Optional[Exception]:
        err = None
        for f in self._futures:
            try:
                f.result()
            except Exception as e:  # noqa: BLE001 — returned to caller
                err = err or e
        self._futures = []
        return err


def _place(host, sharding):
    """Place a host array onto a device sharding — including shardings
    spanning OTHER processes (multi-host resume).  Shared logic in
    :func:`tensor_ops.parallel.mesh.place_host`."""
    from ..parallel.mesh import place_host

    return place_host(host, sharding)


def _check_process_data_alignment(mesh, n_proc: int) -> None:
    """Multi-process batch assembly (``make_array_from_process_local_data``
    with per-rank disjoint loader shards) requires every data-axis row of
    the mesh to live on ONE process: a row spanning processes cannot be
    fed from any single rank's local rows.  Raise a clear error (instead
    of jax's opaque host-data shape complaint) with the fix."""
    from ..parallel.mesh import DATA_AXIS

    axis = mesh.axis_names.index(DATA_AXIS)
    dev = np.moveaxis(np.asarray(mesh.devices), axis, 0)
    bad = []
    for i in range(dev.shape[0]):
        procs = {d.process_index for d in dev[i].flat}
        if len(procs) != 1:
            bad.append((i, sorted(procs)))
    if bad:
        raise ValueError(
            f"multi-process fit needs the mesh's data axis aligned to "
            f"process boundaries, but data row(s) {bad} span multiple "
            f"processes — each rank's loader shard can only fill rows "
            f"its own devices hold.  Pick a mesh shape whose data-axis "
            f"size is a multiple of the process count with "
            f"process-contiguous rows, e.g. "
            f"make_mesh(n, shape=({n_proc}*k, tp)).")


_RESHARD_CACHE: dict = {}


def _global_host_tree(tree, mesh):
    """Host numpy copies of every jax leaf in a (possibly sharded,
    possibly multi-process) pytree: reshard each leaf fully-replicated
    over ``mesh`` (a collective when the mesh spans processes — ALL
    processes must call this together) and read the local replica.
    What multi-host checkpointing needs before rank 0 writes."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as PSpec

    # one jitted identity per mesh: a fresh wrapper per leaf/call would
    # re-trace the resharding collective at every checkpoint boundary
    reshard = _RESHARD_CACHE.get(mesh)
    if reshard is None:
        rep = NamedSharding(mesh, PSpec())
        # the Space.Device transfer is a no-op for ordinary leaves and
        # brings offload_opt_state's pinned-host moments back into
        # device memory so the replicate collective can run on them
        reshard = jax.jit(
            lambda a: jax.device_put(a, jax.memory.Space.Device),
            out_shardings=rep)
        _RESHARD_CACHE[mesh] = reshard

    def fetch(x):
        if isinstance(x, jax.Array) and not x.is_fully_addressable:
            return np.asarray(reshard(x).addressable_data(0))
        if isinstance(x, jax.Array):
            return np.asarray(x)
        return x

    return jax.tree.map(fetch, tree)


def _accum_scan(vag_xy, leaves, xb, yb, accum_steps: int,
                grad_constrain=None):
    """Sequential gradient accumulation shared by ``make_opt_step``,
    ``fit``'s pipeline step, and ``_seq_train_step``: reshape the batch
    into ``accum_steps`` equal chunks, ``lax.scan`` the
    ``(x_chunk, y_chunk) -> (loss, grads)`` closure over them summing
    both, and return the chunk means (== the batch mean for equal
    chunks; the fit loops validate divisibility eagerly).  ``leaves``
    supplies the gradient-accumulator structure (``zeros_like`` each).
    ``grad_constrain`` (ZeRO-2) pins data-axis shardings on each chunk's
    gradients AND the accumulator carry, so the accumulated gradient
    memory is 1/dp per device throughout the scan — each chunk is
    reduce-scattered as it is produced, not all-reduced then re-split."""
    import jax.numpy as jnp
    from jax import lax

    micro = xb.shape[0] // accum_steps
    xm = xb[: micro * accum_steps].reshape(
        (accum_steps, micro) + xb.shape[1:])
    ym = yb[: micro * accum_steps].reshape(
        (accum_steps, micro) + yb.shape[1:])

    def _shard(gs):
        return gs if grad_constrain is None else grad_constrain(gs)

    def body(carry, chunk):
        vsum, gsum = carry
        v, gs = vag_xy(chunk[0], chunk[1])
        gs = _shard(gs)
        return (vsum + v, tuple(a + g for a, g in zip(gsum, gs))), None

    zero = _shard(tuple(jnp.zeros_like(x) for x in leaves))
    (vsum, gsum), _ = lax.scan(body, (0.0, zero), (xm, ym))
    return vsum / accum_steps, tuple(g / accum_steps for g in gsum)


def _normalize_zero_stage(shard_opt_state: bool, zero_stage):
    """One ladder, two spellings: ``shard_opt_state=True`` is ZeRO-1;
    ``zero_stage=1|2|3`` names the rung explicitly (each subsumes the
    ones below — 1: moments shard, 2: + gradients reduce-scatter,
    3: + params shard between steps with gather-at-use).  Returns
    ``(shard_opt_state, stage)`` with ``shard_opt_state`` true for any
    stage >= 1.  An explicit ``zero_stage=0`` alongside
    ``shard_opt_state=True`` is contradictory and rejected."""
    if zero_stage is None:
        return shard_opt_state, (1 if shard_opt_state else 0)
    if zero_stage not in (0, 1, 2, 3):
        raise ValueError(
            f"zero_stage must be 0, 1, 2, or 3, got {zero_stage!r}")
    if zero_stage == 0 and shard_opt_state:
        raise ValueError(
            "zero_stage=0 contradicts shard_opt_state=True — drop one "
            "(shard_opt_state=True is exactly zero_stage=1)")
    return zero_stage >= 1, int(zero_stage)


def _normalize_mp(mixed_precision) -> str:
    """``'off' | 'auto' | 'bf16'`` from the ``mixed_precision`` knob.

    ``True`` means AUTO-ROUTE: at first compile, both the f32 and the
    bf16 step are built and timed on the device and the faster one
    wins (measured once per configuration, recorded loudly).  bf16
    halves the bytes each product moves, but need not win at small
    layer widths — a "go faster" switch must never go slower.
    ``'bf16'`` forces the bf16 compute path unconditionally
    (memory-bound deployments; exact bf16 semantics in tests)."""
    if mixed_precision is False or mixed_precision is None:
        return "off"
    if mixed_precision is True or mixed_precision == "auto":
        return "auto"
    if mixed_precision == "bf16":
        return "bf16"
    if not isinstance(mixed_precision, str):
        # pre-router callers passed any truthy/falsy value (ints,
        # numpy bools) — keep accepting them with the same semantics
        return "auto" if mixed_precision else "off"
    raise ValueError(
        f"mixed_precision must be False, True/'auto' (measure f32 vs "
        f"bf16 once and take the faster), or 'bf16' (force the bf16 "
        f"path), got {mixed_precision!r}")


def _measure_mp_route(step_f32, step_bf16, args, carry_from: int = 3,
                      rounds: int = 3):
    """(f32_us, bf16_us) per-step device times for two compiled steps
    on identical args, by DIFFERENTIAL loop-carried timing: each arm
    runs n chained steps inside a ``fori_loop`` (the training state
    ``args[carry_from:]`` is the carry, so no iteration can be
    hoisted), walls for a small and a big n are min-of-``rounds``
    interleaved, and the per-step time is their difference over
    (big - small) — the per-call dispatch and sync cost cancels.
    Synchronization is a host scalar fetch.  n escalates (x8, same
    compiled program — n is a traced bound) until the differential rises above wall-clock noise
    (20 ms) so microsecond steps and millisecond steps both resolve."""
    import time as _time

    import jax
    import jax.numpy as jnp
    from jax import lax

    head, carry0 = tuple(args[:carry_from]), tuple(args[carry_from:])

    def make_loop(step):
        @jax.jit
        def run(head, carry, n):
            def body(_i, c):
                out = step(*head, *c)
                return tuple(out[1:])

            return lax.fori_loop(0, n, body, carry)

        def loop_fn(n):
            out = run(head, carry0, n)
            leaf = jax.tree_util.tree_leaves(out)[0]
            return float(jnp.asarray(leaf).reshape(-1)[0]
                         .astype(jnp.float32))

        return loop_fn

    loops = (make_loop(step_f32), make_loop(step_bf16))
    for lf in loops:
        lf(2)  # compile outside the clock (n is traced: one program)
    small, big = 4, 20
    while True:
        walls = [[float("inf"), float("inf")] for _ in loops]
        for _ in range(rounds):
            for i, lf in enumerate(loops):
                t0 = _time.perf_counter()
                lf(small)
                walls[i][0] = min(walls[i][0], _time.perf_counter() - t0)
                t0 = _time.perf_counter()
                lf(big)
                walls[i][1] = min(walls[i][1], _time.perf_counter() - t0)
        diffs = [w[1] - w[0] for w in walls]
        # host wall clocks jitter per call: only a differential well
        # above that separates two dtypes honestly
        if min(diffs) > 0.15 or big >= 20480:
            break
        small, big = big, big * 8  # same programs, bigger signal
    per_step = [max(d, 1e-9) / (big - small) * 1e6 for d in diffs]
    return per_step[0], per_step[1]


def _decide_mp_route(build_step, make_args, n_proc: int,
                     carry_from: int = 3):
    """Measure-once auto-routing for ``mixed_precision=True``: compile
    both steps, time them on a dummy placed batch (zeros — dense
    matmul time is data-independent), and keep bf16 only when it is >3%
    faster (hysteresis: near-ties stay on the f32 default so repeated
    runs of the same config don't flip routes on timing noise).  Under
    multi-process jax every rank measures the SAME global program but
    rank 0's verdict is broadcast — per-rank verdicts could differ on
    a near-tie and diverging programs would deadlock the mesh."""
    step_f32 = build_step(False)
    step_bf16 = build_step(True)
    f32_us, bf16_us = _measure_mp_route(step_f32, step_bf16, make_args(),
                                        carry_from=carry_from)
    use_bf16 = bf16_us < 0.97 * f32_us
    if n_proc > 1:
        from jax.experimental import multihost_utils

        use_bf16 = bool(multihost_utils.broadcast_one_to_all(
            np.asarray(use_bf16)))
    return use_bf16, {"mp_f32_us": round(f32_us, 2),
                      "mp_bf16_us": round(bf16_us, 2)}


def _resolve_mp_route(net, build_step, dummy_args, route_key, *,
                      resume, state_path, n_proc, carry_from, verbose):
    """The one auto-routing ladder both fit loops share.  Priority:
    route recorded in the checkpoint being resumed (the resumed chain
    must re-take the saving run's numerics exactly — a re-measure
    could flip on timing noise and break bit-exact resume) >
    LEGACY-resume adoption (a checkpoint with no ``mp_route`` was
    saved by a build where ``mixed_precision=True`` FORCED bf16, so
    resuming it under ``True`` adopts bf16 with a warning rather than
    silently re-measuring into a mid-chain dtype flip) > in-process
    measured cache > measure both compiled steps now.  Returns
    ``(mp_active, mp_rec)``."""
    mp_rec = None
    stored = legacy = None
    if resume and state_path and os.path.exists(state_path):
        from ..utils.checkpoint import load_meta

        stored = load_meta(state_path).get("mp_route")
        legacy = stored is None
    if stored in ("f32", "bf16"):
        mp_active = stored == "bf16"
        mp_src = f"route recorded in {state_path}"
    elif legacy:
        import warnings

        warnings.warn(
            f"resuming {state_path} which records no mp_route (saved "
            "by a pre-auto-routing build, where mixed_precision=True "
            "forced bf16) — adopting bf16 to preserve the saving "
            "run's numerics; pass mixed_precision='bf16' or False to "
            "choose explicitly", stacklevel=3)
        mp_active = True
        mp_src = "legacy checkpoint (no recorded route): bf16 adopted"
    elif route_key in net.op._compiled:
        mp_active, mp_rec = net.op._compiled[route_key]
        mp_src = (f"cached measurement: f32 {mp_rec['mp_f32_us']}us "
                  f"vs bf16 {mp_rec['mp_bf16_us']}us")
    else:
        mp_active, mp_rec = _decide_mp_route(build_step, dummy_args,
                                             n_proc, carry_from=carry_from)
        net.op._compiled[route_key] = (mp_active, mp_rec)
        mp_src = (f"measured f32 {mp_rec['mp_f32_us']}us vs "
                  f"bf16 {mp_rec['mp_bf16_us']}us")
    if verbose:
        print(f"mixed_precision auto-routed to "
              f"{'bf16' if mp_active else 'f32'} ({mp_src})")
    return mp_active, mp_rec


def _zero2_grads(leaves, mesh, exact: bool = False):
    """ZeRO-2 gradient constraint over the placed training leaves
    (``parallel.mesh.zero2_grad_constrain``), warning loudly when
    nothing can shard — the run continues as ZeRO-1, never silently.

    ``exact=True`` (``adam8bit(exact_reduction=True)``) returns None
    WITHOUT the warning: exact mode deliberately keeps the gradients
    on the replicated run's layout, so the batch-gradient reduction is
    the replicated run's own all-reduce — bit-identical summation
    order — instead of a reduce-scatter whose different partial-sum
    grouping perturbs gradients by epsilon (which int8 block
    quantization amplifies to ~1e-3).  The cost is the documented
    trade: all-reduce bytes (2x the reduce-scatter) and no gradient
    memory sharding; moment (and, at stage 3, param) sharding is kept."""
    if exact:
        return None
    from ..parallel.mesh import zero2_grad_constrain

    cons = zero2_grad_constrain(leaves, mesh)
    if cons is None:
        import warnings

        warnings.warn(
            "zero_stage=2: no gradient leaf can shard over the data "
            "axis (no data axis in the mesh, dp == 1, or no dp-divisible "
            "dimension) — continuing with replicated gradients (ZeRO-1)",
            stacklevel=4)
    return cons


def _zero3_params(leaves, mesh):
    """ZeRO-3 placement over the training leaves
    (``parallel.mesh.zero3_param_place``): params shard over ``data``
    between steps and gather at use inside the step.  Returns
    ``(placed, unshard, constrain, shardings)``; warns loudly when
    nothing can shard — the run continues as ZeRO-2, never silently."""
    from ..parallel.mesh import zero3_param_place

    placed, unshard, cons, shs = zero3_param_place(leaves, mesh)
    if unshard is None:
        import warnings

        warnings.warn(
            "zero_stage=3: no parameter leaf can shard over the data "
            "axis (no data axis in the mesh, dp == 1, or no dp-divisible "
            "dimension) — continuing with replicated params (ZeRO-2)",
            stacklevel=4)
    return placed, unshard, cons, shs


def _zero3_opt_init(opt, params, mesh):
    """ZeRO-3 optimizer state: ``opt.init`` on the already-data-sharded
    params INHERITS the extended shardings (moments are built as
    ``p * 0``), so nothing is extended — the in-step constraint just
    keeps the inherited shards pinned (``parallel.mesh.pin_inherited``)
    so XLA never re-replicates the updated moments."""
    from ..parallel.mesh import pin_inherited

    opt_state = opt.init(params)
    return opt_state, pin_inherited(opt_state, what="optimizer state")


def _zero1_wrap(opt_state, mesh):
    """Placed optimizer state + in-step constraint for ZeRO-1
    (``shard_opt_state=True``): the moments shard over the mesh's data
    axis (``parallel.mesh.zero1_place``), dropping optimizer memory to
    1/dp per device; XLA's sharding propagation inserts the update's
    all-gather.  Warns loudly when nothing shards (no data axis,
    dp == 1, a stateless optimizer, or no divisible dimension) — the
    run continues with replicated moments, never silently."""
    from ..parallel.mesh import zero1_place

    opt_state, zero_cons = zero1_place(opt_state, mesh)
    if zero_cons is None:
        import warnings

        warnings.warn(
            "shard_opt_state: no optimizer-state leaf can shard over "
            "the data axis (no data axis in the mesh, dp == 1, a "
            "stateless optimizer, or no dp-divisible dimension) — "
            "continuing with replicated moments", stacklevel=4)
    return opt_state, zero_cons


def _zero1_init(opt, params, mesh):
    """:func:`_zero1_wrap` over a fresh ``opt.init(params)``."""
    return _zero1_wrap(opt.init(params), mesh)


def _offload_state(opt_state, label: str):
    """Place every leaf of an optimizer state in pinned HOST DRAM
    (``jax.memory.Space.Host``), keeping each leaf's sharding — the
    between-steps residence for ``offload_opt_state=True``.  Warns
    loudly when the state holds no array leaves (sgd: nothing to
    offload) instead of silently doing nothing."""
    import warnings

    import jax

    if not any(hasattr(x, "shape") and getattr(x, "ndim", 0) > 0
               for x in jax.tree_util.tree_leaves(opt_state)):
        warnings.warn(
            f"{label}: offload_opt_state=True but the optimizer state "
            f"holds no arrays (sgd is stateless) — nothing to offload",
            stacklevel=3)
        return opt_state

    def host(x):
        # keep each leaf's OWN sharding (replicated / ZeRO data-shards /
        # Megatron-inherited) and flip only the memory kind; plain
        # python scalars (adam's step counter at init) pass through —
        # a bare Space.Host put would commit them to one device,
        # conflicting with mesh-wide arguments
        if isinstance(x, jax.Array):
            return jax.device_put(
                x, x.sharding.with_memory_kind("pinned_host"))
        return x

    return jax.tree_util.tree_map(host, opt_state)


def _fresh_leaves(leaves, be: Backend):
    """Donation-safe working copies of training-state leaves (jax only;
    the numpy oracle never mutates its inputs).  The jitted train steps
    donate their state arguments so XLA updates params/moments in place
    (no double-buffered copy of the whole training state per step) — the
    price is that the donated buffers die at the call, so the loop must
    never feed it arrays the caller still owns (``net.params`` of the
    user's network, EMA templates).  ``jnp.copy`` preserves each leaf's
    sharding (incl. mesh/ZeRO placements) while making the buffer ours."""
    if be.name != "jax":
        return tuple(leaves)
    import jax.numpy as jnp

    return tuple(jnp.copy(p) if hasattr(p, "shape") else p
                 for p in leaves)


def _dedupe_donated(tree, be: Backend):
    """Copy any jax leaf appearing more than once (by identity) in a
    donated pytree: XLA rejects donating the same buffer twice
    (``f(donate(a), donate(a))``) — adam8bit's init, for example, shares
    the zero-quantized code/scale arrays between both moments."""
    if be.name != "jax":
        return tree
    import jax
    import jax.numpy as jnp

    seen = set()

    def f(x):
        if isinstance(x, jax.Array):
            if id(x) in seen:
                return jnp.copy(x)
            seen.add(id(x))
        return x

    return jax.tree_util.tree_map(f, tree)


def _leaves_alive(tree) -> bool:
    """False when any jax leaf was donated-and-deleted — the Ctrl-C
    handler checks this before checkpointing a snapshot whose buffers a
    double-press interrupt may have invalidated mid-step.  On installs
    without jax (the numpy-backend-only configuration checkpoint.py
    supports) there is no donation and nothing can be deleted, so the
    snapshot is always safe to save."""
    try:
        import jax
    except ImportError:
        return True

    return not any(isinstance(x, jax.Array) and x.is_deleted()
                   for x in jax.tree_util.tree_leaves(tree))


class _sigint_shield:
    """Defer Ctrl-C across the donation window of one training step.

    The jitted step donates the previous (params, opt_state) buffers, so
    a KeyboardInterrupt landing between the step call and the snapshot
    rebind would leave the handler a snapshot of deleted arrays.  Inside
    ``with _sigint_shield():`` the first SIGINT only sets a flag; the
    shield re-raises it at ``__exit__``, after the snapshot points at the
    new (live) state — the exact-resume guarantee survives donation.  A
    SECOND press while shielded restores the previous handler and raises
    immediately (the user insists; the handler then skips the save via
    ``_leaves_alive``).  No-op off the main thread, where CPython never
    delivers signals anyway.  If the shielded step itself raises while a
    Ctrl-C is pending, the interrupt is re-raised chained onto that
    exception (``raise KeyboardInterrupt from ev``) so the user's intent
    to stop is never silently dropped by retry-style callers."""

    def __enter__(self):
        self._armed = False
        self.pending = False
        import threading

        if threading.current_thread() is not threading.main_thread():
            return self  # signals never delivered here; shield per-call
        import signal

        def h(signum, frame):
            if self.pending:
                signal.signal(signal.SIGINT, self._prev)
                raise KeyboardInterrupt
            self.pending = True

        try:
            self._prev = signal.signal(signal.SIGINT, h)
            self._armed = True
        except ValueError:  # main-thread check raced an interpreter edge
            pass
        return self

    def __exit__(self, et, ev, tb):
        if self._armed:
            import signal

            signal.signal(signal.SIGINT, self._prev)
            if self.pending:
                if et is None:
                    raise KeyboardInterrupt
                # the step failed while a Ctrl-C was pending: surface
                # the interrupt chained onto the step's own exception
                raise KeyboardInterrupt from ev
        return False


def _make_ema_update(cache: dict, decay: float, mesh, be: Backend,
                     tag: str):
    """The tiny jitted Polyak update ``e' = d*e + (1-d)*p`` shared by
    both fit loops (cached per (tag, decay, mesh)); a plain tuple map
    on the numpy oracle."""
    d = float(decay)
    if be.name != "jax":
        return lambda e, p: tuple(d * ei + (1 - d) * pi
                                  for ei, pi in zip(e, p))
    import jax

    key = (tag, d, mesh) + be.cache_key()
    fn = cache.get(key)
    if fn is None:
        # the previous EMA is donated: the average updates in place
        # (the loop rebinds to the output immediately)
        fn = jax.jit(lambda e, p: tuple(d * ei + (1 - d) * pi
                                        for ei, pi in zip(e, p)),
                     donate_argnums=(0,))
        cache[key] = fn
    return fn


def _ema_init(r_ema, templates, be: Backend, resumed_step: int,
              label: str):
    """The EMA leaves at loop entry, shared by both fit loops: the
    checkpoint's EMA section re-placed like the training-layout
    templates — or, LOUDLY when a resumed checkpoint carries none (the
    saving run had ema_decay off), a fresh average started from the
    restored params.  The EMA lives in the same .state file as the
    params it averages, so the pair can never be torn by a crash."""
    if r_ema is not None:
        if len(r_ema) != len(templates):
            raise ValueError(
                f"checkpoint EMA holds {len(r_ema)} leaves but this "
                f"configuration expects {len(templates)} — resume with "
                f"the same model/pipeline configuration")
        if be.name == "jax":
            return tuple(_place(np.asarray(le), t.sharding)
                         for le, t in zip(r_ema, templates))
        return tuple(be.asarray(le) for le in r_ema)
    if resumed_step > 0:
        import warnings

        warnings.warn(
            f"{label}: the resumed checkpoint carries no EMA (the "
            f"saving run had ema_decay off) — the Polyak average "
            f"restarts from the restored params at step {resumed_step}",
            stacklevel=3)
    # fresh copies, NOT aliases: the train step donates the params and
    # the EMA update donates the previous average — starting the EMA on
    # the very buffers the first step deletes would read dead arrays
    return _fresh_leaves(templates, be)


def _device_window_indices(seed: int, n_rows: int, batch: int, spe: int,
                           step0, k: int):
    """``(k, batch)`` batch indices for global steps ``step0 ..
    step0+k-1``, computed entirely in-graph (jittable; ``step0`` may be
    traced): epoch ``e``'s batches are consecutive ``batch``-sized
    slices of ``jax.random.permutation(fold_in(key(seed), e), n_rows)``.

    A pure function of ``(seed, absolute step)``: every window
    partition of a run — and every crash/resume chain — replays the
    identical batch sequence, and each epoch visits every row exactly
    once (a true permutation).  Counter-based (threefry), so no RNG
    state is carried between windows and the host streams zero index
    bytes.  Requires ``n_rows % batch == 0`` (``spe = n_rows //
    batch``)."""
    import jax
    import jax.numpy as jnp

    base = jax.random.key(seed)
    e0 = step0 // spe
    # upper bound on distinct epochs the k steps can touch, any step0
    E = (k - 1) // spe + 2
    perms = jax.vmap(
        lambda j: jax.random.permutation(
            jax.random.fold_in(base, e0 + j), n_rows)
    )(jnp.arange(E))

    def one(i):
        s = step0 + i
        erel = s // spe - e0
        slot = (s % spe) * batch
        return jax.lax.dynamic_slice(perms, (erel, slot), (1, batch))[0]

    return jax.vmap(one)(jnp.arange(k))


def _device_window_offsets(seed: int, batch: int, spe: int, step0, k: int):
    """``(k,)`` int32 ROW OFFSETS into a once-shuffled resident dataset
    for global steps ``step0 .. step0+k-1`` — the in-graph index stream
    of ``chain_shuffle='device_fixed'`` (shuffle-once).

    Epoch ``e`` visits the dataset's ``spe`` fixed batch slots in the
    order ``jax.random.permutation(fold_in(slot_key(seed), e), spe)``;
    step ``s`` reads ``batch`` contiguous rows at ``slot * batch``.
    Contiguous ``dynamic_slice`` loads instead of row gathers, which
    move the same bytes at a fraction of stream bandwidth.  Same purity
    contract as
    ``_device_window_indices``: a function of (seed, absolute step)
    only, so window partitions and crash/resume chains replay
    identically and every epoch still covers every row exactly once
    (fixed slots x fresh slot order); only the ROW-to-slot assignment
    is frozen after the initial shuffle — the statistical compromise a
    user opts into for speed-of-light batch selection."""
    import jax
    import jax.numpy as jnp

    _, slot_key = jax.random.split(jax.random.key(seed))
    e0 = step0 // spe
    E = (k - 1) // spe + 2
    sperm = jax.vmap(
        lambda j: jax.random.permutation(
            jax.random.fold_in(slot_key, e0 + j), spe)
    )(jnp.arange(E))

    def one(i):
        s = step0 + i
        return sperm[s // spe - e0, s % spe] * batch

    return jax.vmap(one)(jnp.arange(k))


def _device_fixed_perm(seed: int, n_rows: int):
    """The once-per-run row permutation ``chain_shuffle='device_fixed'``
    applies to the resident dataset before training (its sibling key is
    ``_device_window_offsets``' slot stream)."""
    import jax

    row_key, _ = jax.random.split(jax.random.key(seed))
    return jax.random.permutation(row_key, n_rows)


def make_opt_step(net: Network, loss: TOp, be: Backend, opt: Optimizer,
                  accum_steps: int = 1,
                  clip_norm: Optional[float] = None,
                  mixed_precision: bool = False,
                  mesh=None, zero_constrain=None,
                  grad_constrain=None, param_unshard=None,
                  param_constrain=None, param_shardings=None,
                  offload: bool = False,
                  donate: bool = False,
                  chain: bool = False,
                  chain_spec: Optional[Tuple[int, int, int, int,
                                             str]] = None,
                  ema_decay: Optional[float] = None) -> Callable:
    """Jitted ``(lr, xb, yb, opt_state, params) -> (loss, opt_state, params)``.

    ``donate=True`` (jax only; what ``fit`` uses) donates the
    (opt_state, params) arguments to XLA — the update aliases the old
    buffers in place instead of double-buffering the whole training
    state for the duration of the step.  The caller must rebind to the
    outputs and NEVER touch the passed-in arrays again (they are
    deleted at the call); the default keeps the builder's inputs alive
    for interactive use.

    With ``accum_steps > 1`` the batch is split into that many
    micro-batches whose gradients are accumulated sequentially inside a
    ``lax.scan`` before one optimizer update — big effective batches
    without the activation memory (jax path only).  The batch length must
    be a multiple of ``accum_steps``: a remainder would be silently
    truncated inside the jitted step (``fit`` validates this eagerly).
    ``clip_norm`` applies global-L2 gradient clipping before the update.

    ``mixed_precision=True`` (jax only) runs the forward/backward in
    bfloat16 — half the bytes per operand — while the
    params the optimizer carries stay full-precision f32 masters;
    gradients are upcast before clip/update, so the loss-scaling tricks
    fp16 needs are unnecessary (bf16 shares f32's exponent range).

    ``mesh`` (a ``(data, model)`` jax Mesh) jits the step with explicit
    multi-chip shardings: the batch over ``data``, the params Megatron-
    style over ``model`` (``parallel.mesh.param_specs``) — XLA inserts
    the gradient psums and activation collectives from the shardings
    alone.  Optimizer state inherits the param shardings from
    its init arrays (pass params already device_put with the specs).

    ``zero_constrain`` (from ``parallel.mesh.zero1_place``) pins ZeRO-1
    data-axis shardings on the updated optimizer state inside the step,
    so the moments stay 1/dp per device across steps instead of XLA
    re-replicating them.  ``grad_constrain`` (from
    ``parallel.mesh.zero2_grad_constrain``) additionally pins ZeRO-2
    shardings on the MEAN GRADIENTS, lowering the batch-gradient
    reduction to a reduce-scatter — each dp rank holds only its 1/dp
    gradient shard through clip and optimizer update.

    ``param_unshard`` / ``param_constrain`` / ``param_shardings`` (from
    ``parallel.mesh.zero3_param_place``) complete the ladder (ZeRO-3):
    the step receives DATA-SHARDED master params (``param_shardings``
    replaces the Megatron specs as the step's param in/out shardings),
    gathers them at use (``param_unshard`` — the forward/backward
    differentiates w.r.t. the gathered copy, so no cotangent flows
    through the constraint itself), and pins the updated masters back
    onto their shards (``param_constrain``) — params, gradients, and
    moments are all 1/dp resident between steps.

    ``offload=True`` (jax only) keeps the optimizer state resident in
    pinned HOST DRAM between steps (the ZeRO-Offload placement, done
    with ``jax.memory.Space`` transfers inside the jitted step, so XLA
    schedules the device<->host copies itself): the step
    receives host-resident moments, copies them into HBM at the top
    (``Space.Device``), updates, and writes them back
    (``Space.Host``) — steady-state optimizer HBM is ZERO, the update
    math is bit-identical (placement changes nothing numerically), and
    the transient in-step copy is the only HBM the moments ever hold.
    Composes with every ZeRO stage (the host leaves keep their
    data-axis shards).  The caller places the initial state with
    ``jax.device_put(state, jax.memory.Space.Host)``.

    ``chain=True`` (jax only; what ``fit(chain_steps=...)`` uses)
    returns a CHAINED step
    ``(lrs, idxw, Xd, Yd, opt_state, params, ema) ->
    (loss_last, opt_state, params, ema)`` that runs ``k = len(lrs)``
    optimizer steps in ONE dispatch via ``lax.scan``: step ``i``
    gathers its batch from the HBM-resident dataset ``(Xd, Yd)`` by
    the precomputed loader indices ``idxw[i]`` and steps with
    ``lrs[i]``; the EMA (``ema_decay``) updates in-chain with the
    identical ``d*e + (1-d)*p`` recurrence.  Per-step math is the same
    traced ``step`` closure, so a chained run equals the step-at-a-time
    run exactly; the win is dispatch amortization — one host round
    trip per observation window instead of per step.  The previous
    (opt_state, params, ema) are donated; the dataset is not.

    ``chain_spec=(n_rows, batch, steps_per_epoch, seed, mode)``
    switches the chained step to DEVICE-SIDE shuffling: the signature
    becomes
    ``(lrs, step0, Xd, Yd, opt_state, params, ema)`` and step
    ``step0 + i`` gathers batch ``(step0+i) % spe`` of the epoch
    permutation ``jax.random.permutation(fold_in(key(seed), epoch),
    n_rows)`` — all computed IN-GRAPH, so the host streams ZERO index
    bytes per step (the host-index path uploads batch*4 B/step of PCIe
    traffic).  Indices are a pure function of (seed, absolute
    step): any window partition of the same run — and any crash/resume
    chain — replays the identical batch sequence bit for bit.  Each
    epoch still visits every row exactly once (threefry permutation);
    only the ORDER differs from the host loader's numpy-PCG stream, so
    a device-shuffled run is statistically, not bitwise, equal to the
    host-shuffled one.  Requires ``n_rows % batch == 0``.  ``mode``:
    ``"perm"`` reshuffles rows every epoch (in-graph row gathers);
    ``"fixed"`` (``chain_shuffle='device_fixed'``) shuffles rows ONCE —
    the caller passes the pre-shuffled dataset — and per epoch only the
    BATCH-SLOT order is re-randomized, so batches are contiguous
    ``dynamic_slice`` loads at stream bandwidth instead of gathers
    (measured ~45 vs ~176 us/step marginal at the flagship)."""
    composed = net._loss_op(loss)
    n_params = len(net.params)

    def _clip(grads):
        return clip_by_global_norm(grads, clip_norm) if clip_norm else grads

    # structural keys: a fresh-but-identical loss/optimizer (the
    # fit(net, cross_entropy(o), optimizer=adam())-in-a-loop pattern)
    # hits the same cache entry instead of recompiling per call
    key = ("optstep", loss.struct_key(), opt.struct_key(),
           int(accum_steps), clip_norm, mixed_precision, mesh,
           zero_constrain is not None,
           grad_constrain is not None,
           param_unshard is not None, bool(offload),
           bool(donate), bool(chain), chain_spec,
           float(ema_decay) if ema_decay is not None else None,
           ) + be.cache_key()
    fn = net.op._compiled.get(key)
    if fn is not None:
        return fn
    if mesh is not None and be.name != "jax":
        raise ValueError("mesh sharding requires the jax backend")
    if chain and (be.name != "jax" or mesh is not None):
        raise ValueError(
            "chain=True (single-dispatch step chaining) requires the "
            "jax backend without a mesh — fit gates this itself")
    if offload and be.name != "jax":
        raise ValueError(
            "offload keeps optimizer state in pinned host DRAM via "
            "jax memory-space transfers and requires the jax backend "
            "(numpy state already lives on the host)")

    if be.name == "jax":
        import jax
        import jax.numpy as jnp

        from .training import make_vmapped_grads

        if mixed_precision:
            from ..backend.jax_backend import JaxBackend
            from .batched import batched_loss_graph

            be_c = JaxBackend(dtype=jnp.bfloat16,
                              precision=getattr(be, "_precision_name",
                                                "default"))
            vmapped_lp = make_vmapped_grads(net, loss, be_c)

            def batch_vag(xb, yb, params):
                # BATCHED-GRAPH lowering when the net supports it: the
                # weight gradients are GEMMs by construction.  The
                # vmapped per-sample path materializes B stacked outer
                # products in bf16, which XLA need not rewrite into a
                # GEMM.
                lp = tuple(p.astype(jnp.bfloat16) for p in params)
                g = batched_loss_graph(net, loss, int(xb.shape[0]))
                if g is not None:
                    v, grads = ir.value_and_grad(
                        g, be_c, (xb.astype(jnp.bfloat16),) + lp
                        + (yb.astype(jnp.bfloat16),))
                    return (v.astype(jnp.float32),
                            tuple(gg.astype(jnp.float32)
                                  for gg in grads[1:-1]))
                vals, grads = vmapped_lp(xb.astype(jnp.bfloat16),
                                         yb.astype(jnp.bfloat16), *lp)
                # upcast BEFORE the mean: the batch-mean carries more
                # precision than any single bf16 sample
                return (jnp.mean(vals.astype(jnp.float32)),
                        tuple(jnp.mean(gg.astype(jnp.float32), axis=0)
                              for gg in grads))
        else:
            vmapped = make_vmapped_grads(net, loss, be)

            def batch_vag(xb, yb, params):
                vals, grads = vmapped(xb, yb, *params)
                return jnp.mean(vals), tuple(jnp.mean(g, axis=0)
                                             for g in grads)

        # ZeRO-2: pin reduce-scatter shardings on the mean grads BEFORE
        # clip — the global-norm clip is a scalar reduction, so it works
        # on shards, and everything downstream (moment update) stays 1/dp
        def _shard_grads(grads):
            return grads if grad_constrain is None else grad_constrain(grads)

        # ZeRO-3: gather the sharded masters ONCE at the top of the step
        # and differentiate w.r.t. the gathered copy — identical values,
        # and the cotangent never flows through the sharding constraint
        def _gather_params(params):
            return params if param_unshard is None else param_unshard(params)

        def _pin_params(params):
            return params if param_constrain is None \
                else param_constrain(params)

        if accum_steps <= 1:

            def step(lr, xb, yb, opt_state, params):
                v, mean_grads = batch_vag(xb, yb, _gather_params(params))
                mean_grads = _clip(_shard_grads(mean_grads))
                opt_state, params = opt.update(opt_state, params, mean_grads, lr)
                if zero_constrain is not None:
                    opt_state = zero_constrain(opt_state)
                return v, opt_state, _pin_params(params)

        else:

            def step(lr, xb, yb, opt_state, params):
                full = _gather_params(params)
                v, mean_grads = _accum_scan(
                    lambda xc, yc: batch_vag(xc, yc, full),
                    params, xb, yb, accum_steps,
                    grad_constrain=grad_constrain)
                mean_grads = _clip(_shard_grads(mean_grads))
                opt_state, new_params = opt.update(opt_state, params,
                                                   mean_grads, lr)
                if zero_constrain is not None:
                    opt_state = zero_constrain(opt_state)
                return v, opt_state, _pin_params(new_params)

        param_sh = repl = data_sh = None
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as PSpec

            from ..parallel.mesh import DATA_AXIS, param_specs

            pspecs = param_specs(net.param_stack, mesh)
            param_sh = tuple(NamedSharding(mesh, s) for s in pspecs)
            if param_shardings is not None:
                # ZeRO-3: the step's param in/out shardings are the
                # data-extended ones (None entries keep the Megatron spec)
                param_sh = tuple(z3 or sh for z3, sh
                                 in zip(param_shardings, param_sh))
            repl = NamedSharding(mesh, PSpec())
            data_sh = NamedSharding(mesh, PSpec(DATA_AXIS, None))

        if offload:
            # host-resident moments: HBM copy at the top of the step,
            # write-back at the bottom — XLA lowers both to DMAs it can
            # overlap with compute; everything in between (update math,
            # ZeRO constraints) sees ordinary device arrays, so the
            # result is bit-identical to the non-offloaded step
            inner_step = step

            def step(lr, xb, yb, opt_state, params):  # noqa: F811
                opt_state = jax.device_put(opt_state,
                                           jax.memory.Space.Device)
                v, opt_state, params = inner_step(lr, xb, yb, opt_state,
                                                  params)
                if mesh is not None:
                    # the offload jit has no out_shardings (the SPMD
                    # partitioner rejects output placement annotations
                    # mixed with the memory-space transfers), so pin the
                    # loss and params IN-GRAPH — otherwise propagation
                    # can bleed the moments' ZeRO data-axis shard onto
                    # the param outputs and step 2's in_shardings check
                    # rejects them
                    v = jax.lax.with_sharding_constraint(v, repl)
                    params = jax.lax.with_sharding_constraint(
                        params, param_sh)
                return (v,
                        jax.device_put(opt_state, jax.memory.Space.Host),
                        params)

        # donate=True: the previous training state is donated — XLA
        # aliases the update in place instead of double-buffering every
        # param and moment for the duration of the step (the memory
        # ladder's free rung; fit rebinds to the outputs immediately
        # and works on copies so caller-owned arrays never die).
        # Under offload the moments are pinned-host between steps; only
        # the params are donated (conservative: host-buffer aliasing
        # through memory-space transfers is left untried)
        if chain:
            inner = step

            def chain_step(lrs, idxw, Xd, Yd, opt_state, params, ema):
                # lrs come in as exact f64 schedule values; casting to
                # the param dtype inside the trace reproduces the
                # unchained path's weak-scalar cast bit for bit
                pdt = params[0].dtype

                def body(carry, per_step):
                    o, p, e = carry
                    lr_i, idx = per_step
                    xb = jnp.take(Xd, idx, axis=0)
                    yb = jnp.take(Yd, idx, axis=0)
                    v, o, p = inner(jnp.asarray(lr_i, dtype=pdt),
                                    xb, yb, o, p)
                    if ema_decay is not None:
                        d = float(ema_decay)
                        e = tuple(d * ei + (1 - d) * pi
                                  for ei, pi in zip(e, p))
                    return (o, p, e), v

                (o, p, e), vs = jax.lax.scan(
                    body, (opt_state, params, ema), (lrs, idxw))
                return vs[-1], o, p, e

            cdargs = ((5, 6) if offload else (4, 5, 6)) if donate else ()
            if chain_spec is not None and chain_spec[-1] == "fixed":
                # shuffle-once: contiguous dynamic_slice batches off the
                # once-shuffled resident dataset in a per-epoch random
                # slot order — no per-step gather at all
                n_rows, cbatch, spe, cseed, _ = chain_spec

                def chain_step_fix(lrs, step0, Xs, Ys, opt_state,
                                   params, ema):
                    pdt = params[0].dtype
                    offs = _device_window_offsets(
                        cseed, cbatch, spe, step0, int(lrs.shape[0]))

                    def body(carry, per_step):
                        o, p, e = carry
                        lr_i, off = per_step
                        xb = jax.lax.dynamic_slice(
                            Xs, (off,) + (0,) * (Xs.ndim - 1),
                            (cbatch,) + Xs.shape[1:])
                        yb = jax.lax.dynamic_slice(
                            Ys, (off,) + (0,) * (Ys.ndim - 1),
                            (cbatch,) + Ys.shape[1:])
                        v, o, p = inner(jnp.asarray(lr_i, dtype=pdt),
                                        xb, yb, o, p)
                        if ema_decay is not None:
                            d = float(ema_decay)
                            e = tuple(d * ei + (1 - d) * pi
                                      for ei, pi in zip(e, p))
                        return (o, p, e), v

                    (o, p, e), vs = jax.lax.scan(
                        body, (opt_state, params, ema), (lrs, offs))
                    return vs[-1], o, p, e

                fn = jax.jit(chain_step_fix, donate_argnums=cdargs)
            elif chain_spec is not None:
                # device-side shuffle: batch indices computed in-graph
                # from (seed, absolute step) — zero host index traffic
                n_rows, cbatch, spe, cseed, _ = chain_spec

                def chain_step_dev(lrs, step0, Xd, Yd, opt_state,
                                   params, ema):
                    idxw = _device_window_indices(
                        cseed, n_rows, cbatch, spe, step0,
                        int(lrs.shape[0]))
                    return chain_step(lrs, idxw, Xd, Yd, opt_state,
                                      params, ema)

                fn = jax.jit(chain_step_dev, donate_argnums=cdargs)
            else:
                fn = jax.jit(chain_step, donate_argnums=cdargs)
        elif mesh is None:
            dargs = (() if not donate else ((4,) if offload else (3, 4)))
            fn = jax.jit(step, donate_argnums=dargs)
        else:
            dargs = (() if not donate else ((4,) if offload else (3, 4)))
            # opt_state shardings are left None (inferred from the arrays
            # the caller built via opt.init on the sharded params)
            if offload:
                # no out_shardings: XLA's SPMD partitioner rejects
                # output placement annotations mixed with the step's
                # memory-space transfers (annotate_device_placement
                # custom-calls without shardings); propagation keeps
                # the param shards (pinned in-step by _pin_params for
                # ZeRO-3) and the moments' host placement
                fn = jax.jit(
                    step,
                    in_shardings=(repl, data_sh, data_sh, None, param_sh),
                    donate_argnums=dargs,
                )
            else:
                fn = jax.jit(
                    step,
                    in_shardings=(repl, data_sh, data_sh, None, param_sh),
                    out_shardings=(repl, None, param_sh),
                    donate_argnums=dargs,
                )
    else:

        def step(lr, xb, yb, opt_state, params):
            vals = []
            sums = [np.zeros_like(p) for p in params]
            for x, y in zip(xb, yb):
                v, grads = ir.value_and_grad(composed, be, (x,) + tuple(params) + (y,))
                vals.append(v)
                for s, g in zip(sums, grads[1:-1]):
                    s += g
            mean_grads = _clip(tuple(s / len(xb) for s in sums))
            opt_state, params = opt.update(opt_state, tuple(params), mean_grads, lr)
            return float(np.mean(vals)), opt_state, params

        fn = step
    net.op._compiled[key] = fn
    return fn


def fit(
    net: Network,
    loss: TOp,
    be: Backend,
    X: np.ndarray,
    Y: np.ndarray,
    *,
    epochs: int = 1,
    batch_size: int = 128,
    lr: float = 0.01,
    optimizer: Optional[Optimizer] = None,
    accum_steps: int = 1,
    clip_norm: Optional[float] = None,
    lr_schedule: Optional[Callable[[int], float]] = None,
    mixed_precision: bool = False,
    shard_opt_state: bool = False,
    zero_stage: Optional[int] = None,
    offload_opt_state: bool = False,
    ema_decay: Optional[float] = None,
    early_stop_patience: int = 0,
    val_metric: str = "accuracy",
    profile_dir: Optional[str] = None,
    mesh=None,
    pipeline_microbatches: int = 4,
    pipeline_schedule: str = "gpipe",
    pipeline_chunks: int = 2,
    prefetch: int = 2,
    chain_steps="auto",
    chain_shuffle: str = "host",
    seed: int = 0,
    val: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    metrics_path: Optional[str] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 0,
    resume: bool = False,
    log_every: int = 50,
    verbose: bool = True,
) -> FitResult:
    """Minibatch-train ``net`` on (X, Y) arrays.

    ``chain_steps`` closes the dispatch-rate gap between the benched
    step rate and the realized production rate: between observation
    boundaries (``log_every`` / ``checkpoint_every`` / the final step —
    the points where the host must SEE the loss or the state) the loop
    runs the whole window of steps in ONE jitted dispatch (a
    ``lax.scan`` over the donated step), gathering each step's batch
    on-device by loader indices from the HBM-resident dataset.  The
    math is the identical traced step, so results, EMA, exact resume,
    and Ctrl-C semantics are unchanged (an interrupt defers to the
    window edge — the same granularity checkpoints already have).
    ``"auto"`` (default) chains whenever it applies: jax backend, no
    mesh, no ``profile_dir`` (per-step traces), no
    ``offload_opt_state`` (host DMAs inside scan), and the f32 dataset
    fits the on-device cap (1 GiB); an int >= 2 forces chaining with
    that window-length cap (dataset size becomes your responsibility);
    ``1`` disables — one dispatch per step, the pre-round-5 behavior.

    ``chain_shuffle`` picks where a chained run's batch indices come
    from.  ``"host"`` (default) streams the native loader's indices to
    the device — bitwise the batches an unchained run consumes, at
    ``batch*4`` bytes of host->device traffic per step.  ``"device"``
    computes them IN-GRAPH (``_device_window_indices``: epoch
    permutations from a counter-based threefry key of ``(seed,
    epoch)``) — ZERO host index traffic, which is what the production
    loop should do on any host.  Device mode still
    visits every row exactly once per epoch and is bit-reproducible
    (same seed -> same run; indices depend only on the absolute step,
    so ANY window partition — and any crash/resume chain — replays the
    identical batch sequence), but its shuffle ORDER differs from the
    host loader's numpy stream, so it equals a ``chain_steps=1`` run
    statistically, not bitwise.  Requires chaining to engage and the
    dataset to divide evenly into batches (no ragged tail).

    Data flows through the native threaded loader (C++ shuffle/batch
    assembly when available, NumPy fallback otherwise); each step is one
    jitted XLA program.  ``clip_norm`` clips gradients by global L2 norm
    inside the jitted step; ``lr_schedule`` maps the global step index to
    a learning rate (see ``optim.cosine_schedule`` /
    ``optim.exponential_schedule``) — the lr is a traced scalar argument,
    so schedules cause no recompilation.

    ``mixed_precision=True`` (== ``"auto"``, jax only) AUTO-ROUTES: at
    first compile both the f32 and the bf16 (f32-master) step are built
    and timed on the device and the faster one runs — bf16 halves the
    operand bytes but need not win at small widths, and a "go faster"
    switch must never go slower.  The decision is measured once per
    configuration, kept f32 on near-ties (<3% — timing noise must not flip routes between
    runs), printed, logged to the metrics JSONL (``mp_route`` +
    microsecond timings), cached in-process, and recorded in every
    ``.state`` checkpoint so ``resume=True`` re-takes the same numerics
    without re-measuring.  ``mixed_precision="bf16"`` forces the bf16
    path unconditionally (memory-bound deployments).

    ``prefetch`` (jax, single-process) keeps that many batches already
    in flight to the device (``DevicePrefetcher``): batch k+1's
    host->HBM transfer overlaps batch k's step.  0/1 disables.

    ``checkpoint_path`` + ``checkpoint_every`` save the servable network
    AND a sibling ``<path>.state`` file with optimizer moments + global
    step (writes are atomic and happen off the training thread);
    ``resume=True`` restores all three on start — same optimizer /
    hyperparameters required and validated via the stored
    ``Optimizer.struct_key``.  ``epochs`` is the TOTAL training budget:
    a resumed run executes only the remaining
    ``epochs * steps_per_epoch - restored_step`` steps (so a crash/
    resume loop with fixed arguments converges to exactly the requested
    schedule, and ``lr_schedule`` is never evaluated past it), and the
    data stream is fast-forwarded to the restored step so no batch is
    replayed — production checkpoint/resume the reference lacks
    entirely (``trainEpoch`` recurses to Ctrl-C, ``MNIST.hs:297-313``).
    Ctrl-C itself (KeyboardInterrupt) saves an exact-resume checkpoint
    at the interrupted step before propagating — even with
    ``checkpoint_every=0`` — so the reference's train-until-Ctrl-C UX
    loses nothing (single-process runs only: the multi-host checkpoint
    gather is a collective no lone rank may enter).

    ``ema_decay`` (e.g. 0.999) maintains a Polyak/EMA copy of the
    params — ``ema = d*ema + (1-d)*params`` after every step — returned
    as ``FitResult.ema_net`` (the usual serving artifact), stored
    INSIDE the ``.state`` checkpoint (atomic with the params it
    averages — a crash can never tear the pair) and restored on resume
    (a resumed chain equals the uninterrupted EMA exactly; resuming a
    non-EMA checkpoint with ``ema_decay`` set warns and restarts the
    average from the restored params).  ``early_stop_patience=k``
    stops training once the validation metric (``val=``, evaluated
    every ``log_every`` steps) has not improved for k consecutive
    evaluations; ``val_metric`` picks it — ``"accuracy"`` (default,
    ``val=(Xv, class labels)``) or ``"loss"`` (``val=(Xv, targets)``
    through the training loss — the regression/reconstruction case
    where argmax accuracy is meaningless).  ``profile_dir`` captures a
    ``jax.profiler`` device trace of steady-state steps 2-5 of this run
    (past the compile, short enough to view) into that directory for
    TensorBoard/xprof — profiling the REAL production step, shardings
    and all, instead of a reconstruction.

    ``mesh`` (jax only) trains multi-chip: params are placed with
    Megatron-style ``model``-axis shardings, each batch is placed over the
    ``data`` axis, and the jitted step carries explicit in/out shardings —
    dp + tp on one ``(data, model)`` mesh with XLA-inserted collectives
    (the reference has no distribution whatsoever, SURVEY.md §2.5).
    ``shard_opt_state=True`` (ZeRO-1) additionally shards the optimizer
    moments over the ``data`` axis — 1/dp of the optimizer memory per
    device, with the update's all-gather inserted by XLA from the
    sharding alone; training remains bit-identical to the replicated
    run, and checkpoints/resume keep working (moments gather at save,
    re-place on their ZeRO shardings at load).  ``zero_stage`` names
    the rung explicitly: ``1`` == ``shard_opt_state=True``; ``2``
    (ZeRO-2) ALSO shards the mean gradients — the batch-gradient
    reduction lowers to a reduce-scatter, each dp rank carries only its
    1/dp gradient shard through clip and the moment update (with
    ``accum_steps`` the accumulator itself is sharded), and XLA inserts
    the one param-update all-gather.  ``3`` (ZeRO-3) ALSO shards the
    PARAMS between steps: each rank stores only its 1/dp param shard,
    the step gathers them at use (one all-gather in), gradients
    reduce-scatter back onto the same shards (one reduce-scatter out),
    and the optimizer update is collective-free shard-local math —
    params + grads + moments all 1/dp resident, the full ladder.
    Every stage stays bit-identical to the
    replicated run; exact crash/resume.  Works on every mesh
    kind with a data axis (dp, dp x tp, dp x pipeline).
    ``offload_opt_state=True`` (jax only; orthogonal to the ZeRO
    ladder, composes with every stage) keeps the optimizer moments
    resident in pinned HOST DRAM between steps — the ZeRO-Offload
    placement done with ``jax.memory.Space`` transfers inside the
    jitted step so XLA schedules the device<->host copies: the
    step copies the moments into HBM, updates, writes them back, so
    steady-state optimizer HBM is ZERO (big-optimizer regimes: adam's
    2x-param f32 moments dwarfing bf16-servable params) at the price
    of a per-step host round-trip.  The update math is bit-identical
    to the on-device run; checkpoints/resume keep working (moments
    save from and restore to their host placement).  Under
    multi-process jax each host offloads only its own shards.  Under
    multi-process jax each host loads only its own disjoint shard via
    ``NativeLoader(shard=(process_index, process_count))`` and the global
    batch is assembled with ``make_array_from_process_local_data``.

    A mesh with a ``stage`` axis (``make_pipeline_mesh(S)`` /
    ``make_dp_pipeline_mesh(D, S)``) instead trains PIPELINE-parallel
    over the staged IR: the network is cut at its composition points,
    each device runs its stages' sub-graphs through the framework's own
    transposition AD, and ``pipeline_microbatches`` microbatches flow
    through the GPipe schedule per step — same optimizer/clip/schedule/
    checkpoint/resume surface as every other mode (checkpoints store
    the ordinary Network param stack, so a pipeline-trained model
    serves anywhere).  Under multi-process jax a pipeline mesh WITH a
    data axis uses the per-process shard loaders above (data rows must
    be process-aligned); a stage-only mesh is true cross-host
    pipelining — the ppermute ring crosses hosts, every rank loads the
    identical stream, and the replicated batch places globally."""
    opt = optimizer or sgd()
    mp_mode = _normalize_mp(mixed_precision)
    if mp_mode != "off" and be.name != "jax":
        raise ValueError("mixed_precision requires the jax backend")
    if profile_dir and be.name != "jax":
        raise ValueError(
            "profile_dir captures a jax.profiler trace and requires the "
            "jax backend (the numpy backend has nothing to trace)")
    shard_opt_state, zstage = _normalize_zero_stage(
        shard_opt_state, zero_stage)
    if shard_opt_state and mesh is None:
        raise ValueError(
            f"ZeRO-{zstage} (shard_opt_state/zero_stage) shards over "
            f"the mesh's data axis — pass mesh=make_mesh(...)")
    if offload_opt_state and be.name != "jax":
        raise ValueError(
            "offload_opt_state keeps optimizer state in pinned host "
            "DRAM via jax memory-space transfers and requires the jax "
            "backend (numpy state already lives on the host)")
    if ema_decay is not None and not (0.0 < ema_decay < 1.0):
        raise ValueError(f"ema_decay must be in (0, 1), got {ema_decay}")
    if early_stop_patience and val is None:
        raise ValueError(
            "early_stop_patience watches the validation metric — pass "
            "val=(Xv, labels_or_targets) (evaluated every log_every "
            "steps)")
    if val_metric not in ("accuracy", "loss"):
        raise ValueError(
            f"val_metric must be 'accuracy' (val=(Xv, class labels)) or "
            f"'loss' (val=(Xv, targets) through the training loss — for "
            f"regression/reconstruction objectives), got {val_metric!r}")
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if chain_steps != "auto" and (not isinstance(chain_steps, int)
                                  or chain_steps < 1):
        raise ValueError(
            f"chain_steps must be 'auto' or an int >= 1, got "
            f"{chain_steps!r}")
    if (isinstance(chain_steps, int) and chain_steps > 1
            and offload_opt_state):
        raise ValueError(
            "chain_steps > 1 cannot combine with offload_opt_state: the "
            "moments' host DMAs cannot ride inside the chained scan — "
            "use chain_steps='auto' (which backs off) or chain_steps=1")
    if chain_shuffle not in ("host", "device", "device_fixed"):
        raise ValueError(
            f"chain_shuffle must be 'host', 'device', or "
            f"'device_fixed', got {chain_shuffle!r}")
    if chain_shuffle != "host" and X.shape[0] % batch_size != 0:
        raise ValueError(
            f"chain_shuffle={chain_shuffle!r} computes the batch "
            f"stream in-graph and needs the dataset ({X.shape[0]} "
            f"rows) to divide evenly into batches ({batch_size}): a "
            f"ragged tail batch cannot ride the fixed-shape index "
            f"window — trim the dataset or use chain_shuffle='host'")
    if accum_steps > 1 and batch_size % accum_steps != 0:
        raise ValueError(
            f"batch_size ({batch_size}) must be divisible by accum_steps "
            f"({accum_steps}): the jitted step would silently drop the "
            f"remainder {batch_size % accum_steps} samples of every batch"
        )
    pipeline_mode = False
    if mesh is None and be.name == "jax":
        import jax

        if jax.process_count() > 1:
            raise ValueError(
                "fit without a mesh under a multi-process jax runtime "
                "would train an independent (divergent) replica per "
                "process on the full dataset; pass mesh=make_mesh("
                "len(jax.devices())) so the batch shards globally")
    if mesh is not None:
        from ..parallel.pipeline import STAGE_AXIS

        pipeline_mode = STAGE_AXIS in mesh.axis_names
    spnet = None
    params = net.params
    data_sh = None
    zero_cons = None   # ZeRO-1: pins moment shardings inside the step
    grad_cons = None   # ZeRO-2: pins reduce-scatter shardings on grads
    p_unshard = None   # ZeRO-3: gathers the sharded params at use ...
    p_cons = None      # ... and pins the updated masters back on shards
    z3_shs = None      # ... the extended shardings (grads + resume)
    opt_state0 = None  # ... and the matching placed initial state
    n_proc, proc_idx = 1, 0
    mp_replicated = False  # multi-process stage-only mesh: identical
    #                        full batches on every rank (no data axis)
    if pipeline_mode:
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as PSpec

        from ..parallel.ir_pipeline import (make_ir_pipeline_loss,
                                            partition_network,
                                            partition_network_circular,
                                            shard_pipelined_params)
        from ..parallel.mesh import DATA_AXIS

        if be.name != "jax":
            raise ValueError("pipeline mesh requires the jax backend")
        M = pipeline_microbatches
        # with accumulation each chunk (batch/accum rows) flows through
        # the microbatch grid separately, so the grid constraints apply
        # to the chunk, not the whole batch
        chunk = batch_size // accum_steps
        if chunk % M != 0:
            raise ValueError(
                f"batch rows per accumulation chunk ({chunk}) must be "
                f"divisible by pipeline_microbatches ({M})")
        has_data = DATA_AXIS in mesh.axis_names
        dp = mesh.shape[DATA_AXIS] if has_data else 1
        if (chunk // M) % dp != 0:
            raise ValueError(
                f"microbatch rows ({chunk // M}) must be divisible "
                f"by the data-axis size ({dp})")
        n_proc, proc_idx = jax.process_count(), jax.process_index()
        if n_proc > 1 and has_data:
            _check_process_data_alignment(mesh, n_proc)
        # a stage-only mesh spanning processes is TRUE cross-host
        # pipelining (the ppermute ring rides the inter-host link):
        # the batch replicates, so every rank loads the identical full
        # stream (same seed) and places it with _place
        mp_replicated = n_proc > 1 and not has_data
        # a model axis in the mesh tensor-parallels the body segments
        # (row-sharded weights + activation all-gather) when they match
        # the ffLayer pattern; make_ir_pipeline_loss warns loudly on the
        # non-shardable fallback (replicated body)
        if pipeline_schedule == "circular":
            part = partition_network_circular(net, mesh.shape[STAGE_AXIS],
                                              pipeline_chunks, mesh)
        elif pipeline_schedule == "gpipe":
            part = partition_network(net, mesh.shape[STAGE_AXIS], mesh)
        else:
            raise ValueError(
                f"pipeline_schedule must be 'gpipe' or 'circular', got "
                f"{pipeline_schedule!r}")
        if verbose:
            from ..parallel.ir_pipeline import describe_partition

            print(describe_partition(part))
        spnet = shard_pipelined_params(part, mesh)
        params = spnet.flat_params()
        data_sh = NamedSharding(
            mesh, PSpec(DATA_AXIS, None) if has_data else PSpec())
        if shard_opt_state:
            if zstage >= 3:
                from ..parallel.mesh import pin_shardings

                params, p_unshard, p_cons, z3_shs = _zero3_params(
                    params, mesh)
            if zstage >= 3 and p_unshard is not None:
                opt_state0, zero_cons = _zero3_opt_init(opt, params, mesh)
                # exact_reduction: leave the gradients on the replicated
                # run's layout (all-reduce, not reduce-scatter) — see
                # _zero2_grads; params/moments stay sharded
                grad_cons = (None if opt.exact_reduction else pin_shardings(
                    z3_shs, what="zero_stage=3 gradient shards"))
            else:
                opt_state0, zero_cons = _zero1_init(opt, params, mesh)
                if zstage >= 2:
                    grad_cons = _zero2_grads(
                        params, mesh, exact=opt.exact_reduction)

        def build_step(mp_active: bool):
            key = ("plstep", loss.struct_key(), opt.struct_key(), clip_norm,
                   mesh, M, int(accum_steps), bool(mp_active),
                   pipeline_schedule, pipeline_chunks,
                   zero_cons is not None,
                   grad_cons is not None,
                   p_unshard is not None,
                   bool(offload_opt_state)) + be.cache_key()
            step_fn = net.op._compiled.get(key)
            if step_fn is not None:
                return step_fn
            import jax.numpy as jnp

            # the closure captures only a structure skeleton — no pinned
            # parameter copy survives in the jit cache
            if mp_active:
                # bf16 compute, f32 master params (same recipe as
                # make_opt_step): the pipelined forward/backward runs in
                # bf16; grads upcast before clip/update
                from ..backend.jax_backend import JaxBackend

                be_c = JaxBackend(dtype=jnp.bfloat16,
                                  precision=getattr(be, "_precision_name",
                                                    "default"))
                loss_fn_lp, _ = make_ir_pipeline_loss(
                    net, loss, be_c, mesh, M, pnet=spnet.skeleton(),
                    schedule=pipeline_schedule, n_chunks=pipeline_chunks)

                def _vag(params, xc, yc):
                    lp = tuple(p.astype(jnp.bfloat16) for p in params)
                    v, grads = jax.value_and_grad(loss_fn_lp)(
                        lp, xc.astype(jnp.bfloat16),
                        yc.astype(jnp.bfloat16))
                    return (v.astype(jnp.float32),
                            tuple(g.astype(jnp.float32) for g in grads))
            else:
                loss_fn, _ = make_ir_pipeline_loss(
                    net, loss, be, mesh, M, pnet=spnet.skeleton(),
                    schedule=pipeline_schedule, n_chunks=pipeline_chunks)
                _vag = jax.value_and_grad(loss_fn)

            def _pl_step(lr, xb, yb, opt_state, params):
                # ZeRO-3: gather the sharded masters once at the top;
                # the pipelined forward/backward differentiates w.r.t.
                # the gathered copy (identical values)
                full = (tuple(params) if p_unshard is None
                        else p_unshard(tuple(params)))
                if accum_steps <= 1:
                    v, grads = _vag(full, xb, yb)
                    if grad_cons is not None:
                        grads = grad_cons(grads)
                else:
                    v, grads = _accum_scan(
                        lambda xc, yc: _vag(full, xc, yc),
                        tuple(params), xb, yb, accum_steps,
                        grad_constrain=grad_cons)
                if clip_norm:
                    grads = clip_by_global_norm(grads, clip_norm)
                opt_state, params = opt.update(opt_state, tuple(params),
                                               grads, lr)
                if zero_cons is not None:
                    opt_state = zero_cons(opt_state)
                if p_cons is not None:
                    params = p_cons(params)
                return v, opt_state, params

            if offload_opt_state:
                # host-resident moments (see make_opt_step): HBM copy
                # at the top, write-back at the bottom, bit-identical
                # math in between
                _pl_inner = _pl_step

                def _pl_step(lr, xb, yb, opt_state, params):  # noqa: F811
                    opt_state = jax.device_put(opt_state,
                                               jax.memory.Space.Device)
                    v, opt_state, params = _pl_inner(lr, xb, yb,
                                                     opt_state, params)
                    return (v,
                            jax.device_put(opt_state,
                                           jax.memory.Space.Host),
                            params)

            # donate the previous training state (see make_opt_step);
            # params only under offload
            step_fn = jax.jit(
                _pl_step,
                donate_argnums=(4,) if offload_opt_state else (3, 4))
            net.op._compiled[key] = step_fn
            return step_fn
    elif mesh is not None:
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as PSpec

        from ..parallel.mesh import DATA_AXIS, param_specs

        dp = mesh.shape[DATA_AXIS]
        if batch_size % dp != 0:
            raise ValueError(
                f"batch_size ({batch_size}) must be divisible by the "
                f"data-axis size ({dp})"
            )
        pspecs = param_specs(net.param_stack, mesh)
        params = tuple(
            jax.device_put(be.asarray(p), NamedSharding(mesh, s))
            for p, s in zip(params, pspecs)
        )
        data_sh = NamedSharding(mesh, PSpec(DATA_AXIS, None))
        n_proc, proc_idx = jax.process_count(), jax.process_index()
        if n_proc > 1:
            _check_process_data_alignment(mesh, n_proc)
        if shard_opt_state:
            if zstage >= 3:
                params, p_unshard, p_cons, z3_shs = _zero3_params(
                    params, mesh)
            if zstage >= 3 and p_unshard is not None:
                from ..parallel.mesh import pin_shardings

                opt_state0, zero_cons = _zero3_opt_init(opt, params, mesh)
                # exact_reduction: see _zero2_grads — gradients keep the
                # replicated run's all-reduce; params/moments stay sharded
                grad_cons = (None if opt.exact_reduction else pin_shardings(
                    z3_shs, what="zero_stage=3 gradient shards"))
            else:
                opt_state0, zero_cons = _zero1_init(opt, params, mesh)
                if zstage >= 2:
                    grad_cons = _zero2_grads(
                        params, mesh, exact=opt.exact_reduction)
    if not pipeline_mode:
        def build_step(mp_active: bool):
            return make_opt_step(net, loss, be, opt,
                                 accum_steps=accum_steps,
                                 clip_norm=clip_norm,
                                 mixed_precision=mp_active, mesh=mesh,
                                 zero_constrain=zero_cons,
                                 grad_constrain=grad_cons,
                                 param_unshard=p_unshard,
                                 param_constrain=p_cons,
                                 param_shardings=z3_shs,
                                 offload=offload_opt_state,
                                 donate=True)

    if pipeline_mode and X.shape[0] < batch_size:
        raise ValueError(
            f"pipeline training drops ragged batches (the microbatch "
            f"grid needs full ones): dataset ({X.shape[0]} rows) must "
            f"hold at least one batch ({batch_size})")
    # --- step chaining: one dispatch per observation window ---
    # applies when there is nothing the host must observe between
    # boundaries: jax, no mesh (single-process by the guard above), no
    # per-step profiler trace, no host-DMA offload, and (in auto mode)
    # a dataset small enough to live in HBM for on-device batch gathers
    use_chain = False
    if (be.name == "jax" and not pipeline_mode and mesh is None
            and not offload_opt_state and not profile_dir
            and chain_steps != 1):
        if chain_steps == "auto":
            ds_bytes = (X.size + Y.size) * be.dtype.itemsize
            use_chain = ds_bytes <= (1 << 30)
        else:
            use_chain = True
    chain_dev = use_chain and chain_shuffle != "host"
    if chain_shuffle != "host" and not use_chain:
        raise ValueError(
            f"chain_shuffle={chain_shuffle!r} needs step chaining to "
            f"engage: jax backend, no mesh/offload/profile_dir, "
            f"chain_steps != 1, and (in auto mode) a dataset small "
            f"enough for HBM residency — this configuration fell back "
            f"to unchained dispatch, where the host loader already "
            f"owns the shuffle")
    if mp_replicated:
        # stage-only multi-process mesh: every rank loads the identical
        # full stream (same seed) — batches replicate over the mesh
        loader = NativeLoader(X, Y, batch=batch_size, seed=seed,
                              drop_last=True)
    elif n_proc > 1:
        # each host loads only its disjoint shard; per-host batches are
        # local rows of the global batch
        loader = NativeLoader(X, Y, batch=batch_size // n_proc, seed=seed,
                              shard=(proc_idx, n_proc),
                              drop_last=pipeline_mode)
    else:
        loader = NativeLoader(X, Y, batch=batch_size, seed=seed,
                              drop_last=pipeline_mode,
                              index_mode=use_chain and not chain_dev)

    if pipeline_mode:
        # ragged final batches cannot flow through the fixed (M, B//M)
        # microbatch grid — the loader reshuffles instead (drop_last)
        steps_per_epoch = X.shape[0] // batch_size
    else:
        steps_per_epoch = (X.shape[0] + batch_size - 1) // batch_size
    total_steps = epochs * steps_per_epoch
    opt_state = opt_state0 if shard_opt_state else opt.init(params)
    if offload_opt_state:
        opt_state = _offload_state(opt_state, "fit")
    history = []
    step = 0
    # layout identity of the flat .state leaves: pipeline schedules
    # reorder the same-shaped stacks, so resuming across layouts would
    # silently permute body rows -- recorded at save, validated at load
    if pipeline_mode:
        layout = f"pipeline:{pipeline_schedule}:S{mesh.shape[STAGE_AXIS]}"
        if pipeline_schedule == "circular":
            layout += f":V{pipeline_chunks}"
        packed = getattr(part, "packed", None)
        if packed is not None:
            # hetero / hetero-tp partitions hold ONE packed leaf, so the
            # leaf-count check can't catch a tp or Lmax change across a
            # resume — the packed shape itself is part of the layout
            layout += ":P" + "x".join(str(int(d)) for d in packed.shape)
    else:
        layout = "flat"
    state_path = (checkpoint_path + ".state") if checkpoint_path else None
    # id-based struct keys (custom optimizers without `hyper`) don't
    # survive process restarts — only validate factory-made optimizers
    opt_key = opt.struct_key() if opt.hyper is not None else None

    # --- mixed-precision routing: resolve BEFORE the step compiles ---
    # Priority: explicit force ('bf16') > route recorded in the
    # checkpoint being resumed (the resumed chain must re-take the
    # saving run's numerics exactly — a re-measure could flip on timing
    # noise and break bit-exact resume) > in-process measured cache >
    # measure both steps now on a dummy placed batch.
    mp_active = mp_mode == "bf16"
    mp_rec = None
    if mp_mode == "auto":

        def _dummy_batch():
            # mirrors the loop's placement exactly (same shapes =>
            # the winning route's compile is reused by step 1)
            rows = batch_size if pipeline_mode else min(batch_size,
                                                        X.shape[0])
            if n_proc > 1 and not mp_replicated:
                rows //= n_proc
            xb = np.zeros((rows,) + tuple(X.shape[1:]), dtype=X.dtype)
            yb = np.zeros((rows,) + tuple(Y.shape[1:]), dtype=Y.dtype)
            if data_sh is not None:
                import jax

                if mp_replicated:
                    return (_place(np.asarray(be.asarray(xb)), data_sh),
                            _place(np.asarray(be.asarray(yb)), data_sh))
                if n_proc > 1:
                    gx = (rows * n_proc,) + xb.shape[1:]
                    gy = (rows * n_proc,) + yb.shape[1:]
                    return (jax.make_array_from_process_local_data(
                                data_sh, np.asarray(be.asarray(xb)), gx),
                            jax.make_array_from_process_local_data(
                                data_sh, np.asarray(be.asarray(yb)), gy))
                return (jax.device_put(be.asarray(xb), data_sh),
                        jax.device_put(be.asarray(yb), data_sh))
            return be.asarray(xb), be.asarray(yb)

        # ZeRO knobs change the step's collective traffic (bf16 halves
        # the all-gather/reduce-scatter bytes), so a verdict measured
        # at one stage must not be reused at another
        route_key = ("mproute", loss.struct_key(), opt.struct_key(),
                     clip_norm, mesh, int(accum_steps), int(batch_size),
                     pipeline_mode,
                     pipeline_schedule if pipeline_mode else None,
                     zstage, zero_cons is not None, grad_cons is not None,
                     p_unshard is not None, bool(offload_opt_state),
                     tuple(X.shape[1:]), tuple(Y.shape[1:])) + be.cache_key()
        mp_active, mp_rec = _resolve_mp_route(
            net, build_step,
            lambda: (lr,) + _dummy_batch() + (opt_state, tuple(params)),
            route_key, resume=resume, state_path=state_path,
            n_proc=n_proc, carry_from=3, verbose=verbose)
    step_fn = build_step(mp_active)
    chain_fn = X_dev = Y_dev = None
    if use_chain:
        # the loader's own f32 copies are the chained path's source of
        # truth: gathering X_dev[idx] on-device yields bitwise the rows
        # the gathered-mode loader would have assembled on the host
        X_dev = be.asarray(loader.X)
        Y_dev = be.asarray(loader.Y)
        if chain_shuffle == "device_fixed":
            # the once-per-run row shuffle, applied on-device (its
            # sibling slot stream lives inside the chained program)
            import jax

            _p0 = _device_fixed_perm(seed, X.shape[0])
            X_dev, Y_dev = jax.jit(
                lambda x, y, p: (x[p], y[p]))(X_dev, Y_dev, _p0)
        chain_fn = make_opt_step(net, loss, be, opt,
                                 accum_steps=accum_steps,
                                 clip_norm=clip_norm,
                                 mixed_precision=mp_active,
                                 donate=True, chain=True,
                                 chain_spec=((X.shape[0], batch_size,
                                              steps_per_epoch, seed,
                                              "fixed"
                                              if chain_shuffle
                                              == "device_fixed"
                                              else "perm")
                                             if chain_dev else None),
                                 ema_decay=ema_decay)
    # the route travels with every .state checkpoint so resume re-takes
    # it without re-measuring (and so operators can see what ran)
    state_meta = {"layout": layout}
    if mp_mode != "off":
        state_meta["mp_route"] = "bf16" if mp_active else "f32"

    r_ema = None
    if resume and state_path and os.path.exists(state_path):
        from ..utils.checkpoint import load_train_state

        rparams, r_opt_state, step, r_ema = load_train_state(
            state_path, opt_state, opt_key=opt_key,
            expect_meta={"layout": layout}, with_ema=True)
        if len(rparams) != len(params):
            raise ValueError(
                f"checkpoint holds {len(rparams)} parameter leaves but "
                f"this configuration expects {len(params)} -- resume "
                f"with the same model/pipeline configuration")
        if pipeline_mode:
            # .state stores the FLAT pipelined layout; re-place each
            # leaf on its stage/replicated sharding from setup (_place
            # handles shardings spanning other processes)
            params = tuple(
                _place(np.asarray(p), t.sharding)
                for p, t in zip(rparams, params))
        elif mesh is not None:
            from jax.sharding import NamedSharding

            # ZeRO-3 resumes onto the data-extended shardings (z3_shs
            # entry where the leaf sharded, the Megatron spec otherwise)
            place_shs = tuple(
                (z3_shs[i] if z3_shs is not None and z3_shs[i] is not None
                 else NamedSharding(mesh, s))
                for i, s in enumerate(pspecs))
            params = tuple(
                _place(np.asarray(be.asarray(p)), sh)
                for p, sh in zip(rparams, place_shs))
        else:
            params = tuple(be.asarray(p) for p in rparams)
        # restored leaves are host numpy; re-place each onto its
        # template's device/sharding (the template came from
        # opt.init(sharded params), so Adam moments keep their
        # model-axis shardings instead of entering replicated)
        opt_state = _restore_opt_state(opt_state, r_opt_state, be)
        # stream position == global step: a resumed run continues the
        # epoch's shuffle where the saving run stopped (no replayed or
        # skipped batches), invariant across repeated crash/resume.
        # Skipping is pointless when the budget is already met — zero
        # steps will run, so don't drain `step` batches for nothing.
        if step < total_steps and not chain_dev:
            # (device-shuffled chains need no fast-forward: their
            # indices are a pure function of the absolute step)
            loader.skip(step)
        if verbose:
            print(f"resumed from {state_path} at step {step} "
                  f"({max(total_steps - step, 0)} of {total_steps} steps "
                  f"remaining)")

    # the jitted step donates its state arguments; train on working
    # copies so the caller's ``net.params`` (and any checkpoint
    # template) survive the first step (mesh/pipeline/resume paths
    # already placed fresh arrays — one extra copy at entry is cheap
    # and uniform).  The donated opt_state must not hold the same
    # buffer twice (offload keeps the moments out of the donation, and
    # copying pinned-host leaves would disturb their placement)
    params = _fresh_leaves(params, be)
    if not offload_opt_state:
        opt_state = _dedupe_donated(opt_state, be)

    # Polyak averaging: the EMA copy lives in the TRAINING layout (flat
    # pipelined or param-stack) with the params' shardings, rides a
    # tiny separate jitted update so every fit mode gets it unchanged,
    # is stored INSIDE the .state file (atomic with the params it
    # averages), and converts to a servable Network only at the edges
    # (FitResult.ema_net)
    ema_params = None
    _ema_step = None
    if ema_decay is not None:
        ema_params = _ema_init(r_ema, tuple(params), be, step, "fit")
        _ema_step = _make_ema_update(net.op._compiled, ema_decay, mesh,
                                     be, "emastep")

    source = None
    if (prefetch > 1 and be.name == "jax" and n_proc == 1
            and not use_chain and step < total_steps):
        from ..utils.native import DevicePrefetcher

        if data_sh is not None:
            import jax

            def _put(xb, yb, _sh=data_sh):
                return (jax.device_put(be.asarray(xb), _sh),
                        jax.device_put(be.asarray(yb), _sh))
        else:
            def _put(xb, yb):
                return be.asarray(xb), be.asarray(yb)

        source = DevicePrefetcher(loader, _put, depth=prefetch)

    first_step_of_run = step + 1  # resumed runs log their first step too

    if use_chain:
        _ragged = X.shape[0] % batch_size != 0
        # the index window is tiny (k*batch*4B) but bound it anyway so a
        # no-logging run can't build a multi-GB index array in one shot
        _kcap = max(1, (1 << 25) // max(batch_size, 1))
        if isinstance(chain_steps, int):
            _kcap = min(_kcap, chain_steps)

        def _window_len(s: int) -> int:
            """Steps until the next observation boundary from step s —
            the chained dispatch's window.  Boundaries are absolute step
            positions (multiples of log_every / checkpoint_every, the
            run's first logged step, epoch-final ragged batches, the
            budget), so a resumed run re-derives the identical window
            sequence and stays bit-exact."""
            nb = total_steps
            if s < first_step_of_run:
                nb = min(nb, first_step_of_run)
            nb = min(nb, (s // log_every + 1) * log_every)
            if checkpoint_path and checkpoint_every:
                nb = min(nb, (s // checkpoint_every + 1) * checkpoint_every)
            if _ragged:
                # the epoch's final batch has fewer rows — it cannot ride
                # the fixed-shape (k, batch) index window; run it alone
                rag = ((s // steps_per_epoch) * steps_per_epoch
                       + steps_per_epoch - 1)
                if s == rag:
                    return 1
                nb = min(nb, rag)
            return max(1, min(nb - s, _kcap))

    if verbose and mesh is not None and not pipeline_mode:
        from ..utils.profiling import training_memory_report

        rep = training_memory_report(
            net, optimizer=opt, batch_size=batch_size, mesh=mesh,
            shard_opt_state=shard_opt_state, zero_stage=zstage,
            mixed_precision=mp_active,
            offload_opt_state=offload_opt_state)["per_device"]
        print(f"training state/device: "
              f"params {rep['params_bytes'] / 1e6:.2f} MB + "
              f"grads {rep['grads_bytes'] / 1e6:.2f} MB + "
              f"moments {rep['optimizer_bytes'] / 1e6:.2f} MB"
              + (f" (zero{zstage})" if shard_opt_state else "")
              + (f" (+{rep['optimizer_host_bytes'] / 1e6:.2f} MB "
                 f"host-offloaded)" if offload_opt_state else "")
              + f" + batch {rep['batch_bytes'] / 1e6:.2f} MB")

    def _as_network(cur_params) -> Network:
        # pipeline mode trains the flat stage-partitioned layout; every
        # outward-facing artifact (val accuracy, servable checkpoint,
        # FitResult) converts back to the ordinary Network param stack
        if pipeline_mode:
            cur_params = spnet.unflatten(
                tuple(cur_params)).to_network_params()
        return Network(net.op, tuple(cur_params), net.act_names)

    logger = MetricsLogger(metrics_path)
    # log-only boundaries defer the (blocking) loss fetch: the D2H copy
    # starts immediately (copy_to_host_async) but float() happens a few
    # windows later, so the round trip hides behind the NEXT windows'
    # already-dispatched compute instead of stalling the loop once per
    # log_every steps.  val / checkpoint / early-stop boundaries still
    # synchronize — they genuinely need the values or the state.
    pending_logs = []  # (step, epoch, v_device) in step order
    _flush_depth = 2 if verbose else 64

    def _flush_logs():
        for ps, pe, pv in pending_logs:
            pl = float(pv)
            history.append(logger.log(ps, epoch=pe, loss=pl))
            if verbose:
                print(f"[epoch {pe}] step {ps}: loss {pl:.4f}")
        pending_logs.clear()

    if mp_mode != "off":
        # the routing decision lands in the metrics JSONL too — the
        # record an operator audits when asking "what precision ran?"
        logger.log(step, mp_route="bf16" if mp_active else "f32",
                   **(mp_rec or {}))
    saves = _CheckpointWrites()
    best_val, evals_since_best = float("-inf"), 0
    # the Ctrl-C handler reads ONLY this snapshot: it is replaced by a
    # single assignment after the whole (params, opt_state, ema, step)
    # update, so an interrupt landing mid-update can never checkpoint
    # new params under the old step (which would replay a batch on
    # resume)
    snap = (params, opt_state, ema_params, step)
    # profile_dir: trace steps 2-5 OF THIS RUN (relative — past step
    # 1's compile), stopped in the finally for short/interrupted runs
    prof_stop = None
    prof_on = False
    if profile_dir and be.name == "jax":
        import jax.profiler as _jprof

        prof_stop = step + 5
    try:
        while step < total_steps:
            if prof_stop is not None:
                if not prof_on and step == prof_stop - 4:
                    _jprof.start_trace(profile_dir)
                    prof_on = True
                elif prof_on and step >= prof_stop:
                    _jprof.stop_trace()
                    prof_on = False
                    prof_stop = None
            k = _window_len(step) if use_chain else 1
            if k > 1 or (chain_dev and use_chain):
                # chained window: k steps in one dispatch.  Batch
                # indices come from the same loader stream the
                # unchained path would consume (host mode; rows gather
                # on-device) or are computed in-graph (device mode —
                # which also owns the k == 1 boundary windows, so the
                # whole run consumes ONE index stream)
                if chain_dev:
                    idx_arg = np.int32(step)
                else:
                    idxw = np.empty((k, batch_size), dtype=np.int32)
                    for i in range(k):
                        idxw[i] = loader.next_indices()
                    idx_arg = idxw
                if lr_schedule is not None:
                    lrs = np.asarray([lr_schedule(s)
                                      for s in range(step, step + k)],
                                     dtype=np.float64)
                else:
                    lrs = np.full(k, lr, dtype=np.float64)
                epoch = (step + k - 1) // steps_per_epoch
                # the chain donates (opt_state, params, ema); a Ctrl-C
                # inside the window defers to its edge (double-press
                # escapes), same as the single-step shield below
                with _sigint_shield():
                    v, new_opt, new_params, new_ema = chain_fn(
                        lrs, idx_arg, X_dev, Y_dev, opt_state, params,
                        ema_params if ema_params is not None else ())
                    if ema_params is None:
                        new_ema = None
                    snap = (new_params, new_opt, new_ema, step + k)
                    params, opt_state, ema_params = (new_params, new_opt,
                                                     new_ema)
                    step += k
                # the shared post-step block below handles logging,
                # val/early-stop, and checkpoints — the window ended on
                # a boundary by construction
            else:
                epoch = step // steps_per_epoch
                cur_lr = (lr_schedule(step) if lr_schedule is not None
                          else lr)
                if source is not None:
                    # already transferred (+sharded), k+1 in flight
                    xb, yb = source.next()
                elif data_sh is not None:
                    import jax

                    xb, yb = loader.next()
                    if mp_replicated:
                        xb = _place(np.asarray(be.asarray(xb)), data_sh)
                        yb = _place(np.asarray(be.asarray(yb)), data_sh)
                    elif n_proc > 1:
                        gshape_x = (xb.shape[0] * n_proc,) + xb.shape[1:]
                        gshape_y = (yb.shape[0] * n_proc,) + yb.shape[1:]
                        xb = jax.make_array_from_process_local_data(
                            data_sh, np.asarray(be.asarray(xb)), gshape_x)
                        yb = jax.make_array_from_process_local_data(
                            data_sh, np.asarray(be.asarray(yb)), gshape_y)
                    else:
                        xb = jax.device_put(be.asarray(xb), data_sh)
                        yb = jax.device_put(be.asarray(yb), data_sh)
                else:
                    xb, yb = loader.next()
                    xb, yb = be.asarray(xb), be.asarray(yb)
                # the step donates (opt_state, params) and the EMA update
                # donates the previous average: a Ctrl-C inside this window
                # would catch `snap` pointing at deleted buffers, so SIGINT
                # is deferred to the end of the block (double-press escapes)
                with _sigint_shield():
                    v, new_opt, new_params = step_fn(cur_lr, xb, yb,
                                                     opt_state, params)
                    new_ema = (_ema_step(ema_params, tuple(new_params))
                               if ema_params is not None else None)
                    snap = (new_params, new_opt, new_ema, step + 1)
                    params, opt_state, ema_params = (new_params, new_opt,
                                                     new_ema)
                    step += 1
            stop_early = False
            if step % log_every == 0 or step == first_step_of_run:
                if val is None:
                    # log-only boundary: start the D2H copy, defer the
                    # blocking fetch past the next windows' dispatches
                    try:
                        v.copy_to_host_async()
                    except AttributeError:
                        pass  # numpy backend: already a host scalar
                    pending_logs.append((step, epoch, v))
                    if len(pending_logs) >= _flush_depth:
                        _flush_logs()
                    rec = None
                else:
                    _flush_logs()  # keep history/JSONL in step order
                    rec = {"epoch": epoch, "loss": float(v)}
                if rec is not None:  # val boundary (sync path)
                    cur = _as_network(params)
                    if val_metric == "accuracy":
                        from .training import accuracy

                        rec["val_acc"] = accuracy(
                            cur, be, be.asarray(val[0]),
                            np.asarray(val[1]))
                        score = rec["val_acc"]
                    else:
                        from .training import batch_loss

                        rec["val_loss"] = batch_loss(
                            cur, loss, be, val[0], val[1])
                        score = -rec["val_loss"]
                    if early_stop_patience:
                        if score > best_val + 1e-12:
                            best_val, evals_since_best = score, 0
                        else:
                            evals_since_best += 1
                            stop_early = (evals_since_best
                                          >= early_stop_patience)
                if rec is not None:
                    history.append(logger.log(step, **rec))
                    if verbose:
                        msg = (f"[epoch {epoch}] step {step}: "
                               f"loss {float(v):.4f}")
                        if "val_acc" in rec:
                            msg += f"  val_acc {rec['val_acc']:.3f}"
                        if "val_loss" in rec:
                            msg += f"  val_loss {rec['val_loss']:.4f}"
                        print(msg)
            if checkpoint_path and checkpoint_every and step % checkpoint_every == 0:
                from ..utils.checkpoint import (save_network_async,
                                                save_train_state_async)

                # file writes happen on the checkpoint thread; device
                # arrays are fetched synchronously — the step pipeline
                # stalls only for the D2H copy, not the serialization.
                # The sibling .state file carries optimizer moments +
                # step for exact resume (fit(resume=True)).
                if n_proc > 1:
                    # leaves sharded ACROSS processes aren't host-
                    # fetchable directly: every rank joins the
                    # replicate-and-fetch collective, rank 0 writes
                    host_p, host_o, host_e = _global_host_tree(
                        (tuple(params), opt_state, ema_params), mesh)
                    if proc_idx == 0:
                        saves.add(
                            save_network_async(
                                checkpoint_path, _as_network(host_p)),
                            save_train_state_async(
                                state_path, host_p, host_o, step,
                                opt_key=opt_key, ema=host_e,
                                extra_meta=state_meta))
                else:
                    saves.add(
                        save_network_async(checkpoint_path,
                                           _as_network(params)),
                        save_train_state_async(
                            state_path, params, opt_state, step,
                            opt_key=opt_key, ema=ema_params,
                            extra_meta=state_meta))
            if stop_early:
                if verbose:
                    name = ("val_acc" if val_metric == "accuracy"
                            else "val_loss")
                    shown = (best_val if val_metric == "accuracy"
                             else -best_val)
                    print(f"early stop at step {step}: {name} has not "
                          f"improved over {early_stop_patience} "
                          f"evaluations (best {shown:.4f})")
                break
    except KeyboardInterrupt:
        # the reference's training UX is "recurse until Ctrl-C"
        # (/root/reference/app/MNIST.hs:297-313, trainEpoch); the
        # production analog: Ctrl-C leaves an exact-resume artifact at
        # the interrupted step, then propagates.  Single-process only —
        # an interrupt hits ranks asynchronously and the multi-host
        # checkpoint gather is a collective, so entering it from one
        # rank's handler would deadlock the mesh.
        _flush_logs()  # deferred losses are from completed windows
        s_params, s_opt, s_ema, s_step = snap
        if checkpoint_path and s_step > 0 and n_proc == 1:
            if not _leaves_alive((s_params, s_opt, s_ema)):
                # a double-press escaped the shield mid-step: the
                # snapshot's buffers were donated to the in-flight step
                # and are gone — the last periodic checkpoint stands
                if verbose:
                    print("interrupt landed inside a training step "
                          "(double Ctrl-C): the in-flight step is lost; "
                          "no checkpoint written")
                raise
            from ..utils.checkpoint import save_network, save_train_state

            saves.join()  # in-flight async writes first (ordering)
            save_network(checkpoint_path, _as_network(s_params))
            save_train_state(state_path, s_params, s_opt, s_step,
                             opt_key=opt_key, ema=s_ema,
                             extra_meta=state_meta)
            if verbose:
                print(f"interrupted at step {s_step}: checkpoint saved "
                      f"to {checkpoint_path} — fit(resume=True) "
                      f"continues exactly here")
        raise
    finally:
        if prof_on:
            _jprof.stop_trace()
        try:
            _flush_logs()  # idempotent; except-path flushes cleared it
        except Exception:
            pass  # never mask the propagating exception from cleanup
        save_err = saves.join()
        loader.close()
        logger.close()
        if save_err is not None and sys.exc_info()[0] is None:
            raise save_err
    return FitResult(_as_network(params), history, step,
                     ema_net=(_as_network(ema_params)
                              if ema_params is not None else None))


def _seq_train_step(net, loss: TOp, be: Backend, n: int,
                    opt: Optional[Optimizer] = None,
                    clip_norm: Optional[float] = None,
                    remat_every=None, mesh=None, accum_steps: int = 1,
                    mixed_precision: bool = False, zero_constrain=None,
                    grad_constrain=None, param_unshard=None,
                    param_constrain=None, leaf_shardings=None,
                    offload: bool = False, offload_tape: bool = False,
                    donate: bool = False, chain: bool = False,
                    chain_spec: Optional[Tuple[int, int, int, int,
                                               str]] = None,
                    ema_decay: Optional[float] = None):
    """Jitted fused sequence-batch step — the vmapped scan-BPTT
    ``value_and_grad`` plus the update in ONE program, so the logged
    batch loss costs no extra forward pass.

    Without ``opt``: ``fn(rs, rp, xb, tb, states, params) ->
    (mean_loss, new_states, new_params)`` — the reference's dual-rate
    SGD (``Recurrent.hs:326-354``).  With ``opt``: ``fn(ratio, rp, xb,
    tb, opt_state, states, params) -> (mean_loss, opt_state,
    new_states, new_params)`` — states and params update through the
    optimizer at rate ``rp``, with the state gradients pre-scaled by
    ``ratio`` = rate_state/rate_param so the dual-rate semantic
    survives any optimizer.  The ratio is an explicit argument (NOT
    rs/rp computed in-step): a warmup schedule hits rp == 0 at step 0
    and 0/0 would NaN-poison the whole run.  ``clip_norm`` clips the
    joint (state+param) gradient by global L2 norm before either
    update.  ``remat_every`` checkpoints the scan's backward.

    ``mesh`` (jax only) jits the step with multi-chip shardings: the
    sequence batch over ``data`` (each sequence's scan-BPTT gradient
    computes shard-locally; XLA inserts ONE psum for the batch mean),
    params Megatron-style over ``model`` via ``param_specs``.  States
    are network-global (every sequence reads the same initial states),
    so they replicate.

    ``accum_steps > 1`` splits the sequence batch into that many chunks
    whose gradients accumulate sequentially inside a ``lax.scan`` before
    one update — big effective sequence batches without the vmapped
    activation memory.  ``mixed_precision`` runs the scan-BPTT
    forward/backward in bfloat16 with f32/f64 master states+params
    (grads upcast before the batch mean), the same recipe as
    ``make_opt_step``.  ``offload`` keeps the optimizer state resident
    in pinned host DRAM between steps (see ``make_opt_step``); requires
    ``opt``.  ``offload_tape`` streams the scan-BPTT carry tape through
    pinned host DRAM (``ScanOp(offload_tape=True)``): residual HBM per
    sequence drops to O(state), gradients bit-identical.

    ``chain=True`` (jax, no mesh/offload; what
    ``fit_sequences(chain_steps=...)`` uses) wraps the step in a
    ``lax.scan`` over a whole observation window, gathering sequence
    batches from the DEVICE-RESIDENT dataset — the recurrent analog of
    ``make_opt_step(chain=True)``.  Without ``opt``:
    ``fn(rss, rps, idxw, XSd, TSd, states, params, ema)``; with:
    ``fn(ratio, rps, idxw, XSd, TSd, opt_state, states, params, ema)``
    — ``rss``/``rps`` are the window's exact f64 schedule values, cast
    to the leaf dtype in-trace to reproduce the unchained weak-scalar
    cast bit for bit.  ``chain_spec=(n_rows, batch, steps_per_epoch,
    seed, mode)`` switches to device-side shuffling exactly as in
    ``make_opt_step`` (``idxw`` becomes the window's absolute start
    step; ``mode='fixed'`` reads contiguous ``dynamic_slice`` batches
    off the once-shuffled resident dataset).  The EMA (``ema_decay``)
    updates in-chain with the same ``d*e + (1-d)*leaf`` recipe as
    ``_make_ema_update``."""
    g = net._seq_graph(loss, n, remat_every=remat_every,
                       offload_tape=offload_tape)
    k = len(net.states)
    key = ("seq_fit_step", loss.struct_key(), n,
           opt.struct_key() if opt is not None else None, clip_norm,
           remat_every, mesh, int(accum_steps),
           mixed_precision, zero_constrain is not None,
           grad_constrain is not None,
           param_unshard is not None, bool(offload),
           bool(offload_tape), bool(donate), bool(chain), chain_spec,
           ema_decay if chain else None) + be.cache_key()
    fn = net.op._compiled.get(key)
    if fn is not None:
        return fn

    def _clip(grads):
        return clip_by_global_norm(grads, clip_norm) if clip_norm else grads

    if be.name == "jax":
        import jax
        import jax.numpy as jnp

        nsp = k + len(net.params)
        if mixed_precision:
            from ..backend.jax_backend import JaxBackend

            be_c = JaxBackend(dtype=jnp.bfloat16,
                              precision=getattr(be, "_precision_name",
                                                "default"))

            def one(xs, tgt, *sp):
                v, grads = ir.value_and_grad(g, be_c, (xs,) + sp + (tgt,))
                return v, grads[1:-1]

            vm = jax.vmap(one, in_axes=(0, 0) + (None,) * nsp)

            def vag(xb, tb, sp):
                lp = tuple(x.astype(jnp.bfloat16) for x in sp)
                vals, grads = vm(xb.astype(jnp.bfloat16),
                                 tb.astype(jnp.bfloat16), *lp)
                # upcast BEFORE the mean: the batch-mean carries more
                # precision than any single bf16 sample
                return (jnp.mean(vals.astype(jnp.float32)),
                        tuple(jnp.mean(gr.astype(jnp.float32), axis=0)
                              for gr in grads))
        else:

            def one(xs, tgt, *sp):
                v, grads = ir.value_and_grad(g, be, (xs,) + sp + (tgt,))
                return v, grads[1:-1]

            vm = jax.vmap(one, in_axes=(0, 0) + (None,) * nsp)

            def vag(xb, tb, sp):
                vals, grads = vm(xb, tb, *sp)
                return (jnp.mean(vals),
                        tuple(jnp.mean(gr, axis=0) for gr in grads))

        if accum_steps > 1:
            inner_vag = vag

            def vag(xb, tb, sp):  # noqa: F811 — accum wraps the plain vag
                return _accum_scan(
                    lambda xc, tc: inner_vag(xc, tc, sp),
                    sp, xb, tb, accum_steps,
                    grad_constrain=grad_constrain)

        if opt is None:

            def step(rs, rp, xb, tb, states, params):
                v, mean = vag(xb, tb, tuple(states) + tuple(params))
                mean = _clip(mean)
                gS, gP = mean[:k], mean[k:]
                return (v,
                        tuple(s - rs * gg for s, gg in zip(states, gS)),
                        tuple(p - rp * gg for p, gg in zip(params, gP)))

        else:

            def step(ratio, rp, xb, tb, opt_state, states, params):
                leaves = tuple(states) + tuple(params)
                # ZeRO-3: gather the sharded joint masters once and
                # differentiate w.r.t. the gathered copy
                full = (leaves if param_unshard is None
                        else param_unshard(leaves))
                v, mean = vag(xb, tb, full)
                if grad_constrain is not None:
                    mean = grad_constrain(mean)
                mean = _clip(mean)
                scaled = tuple(ratio * gg for gg in mean[:k]) + mean[k:]
                opt_state, leaves = opt.update(opt_state, leaves, scaled, rp)
                if zero_constrain is not None:
                    opt_state = zero_constrain(opt_state)
                if param_constrain is not None:
                    leaves = param_constrain(leaves)
                return (v, opt_state,
                        tuple(leaves[:k]), tuple(leaves[k:]))

        repl = data_sh = state_sh = param_sh = None
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as PSpec

            from ..parallel.mesh import DATA_AXIS, param_specs

            repl = NamedSharding(mesh, PSpec())
            data_sh = NamedSharding(mesh, PSpec(DATA_AXIS))
            state_sh = tuple(repl for _ in range(k))
            param_sh = tuple(NamedSharding(mesh, s)
                             for s in param_specs(net.param_stack, mesh))
            if leaf_shardings is not None:
                # ZeRO-3: the step's joint in/out shardings are the
                # data-extended ones where a leaf sharded
                joint = tuple(z3 or sh for z3, sh
                              in zip(leaf_shardings, state_sh + param_sh))
                state_sh, param_sh = joint[:k], joint[k:]

        if offload:
            if opt is None:
                raise ValueError(
                    "offload needs optimizer state to offload — "
                    "dual-rate SGD is stateless")
            # host-resident moments (see make_opt_step): HBM copy at
            # the top, write-back at the bottom, bit-identical math
            inner_step = step

            def step(ratio, rp, xb, tb, opt_state, states,  # noqa: F811
                     params):
                opt_state = jax.device_put(opt_state,
                                           jax.memory.Space.Device)
                v, opt_state, states, params = inner_step(
                    ratio, rp, xb, tb, opt_state, states, params)
                if mesh is not None:
                    # pin the non-offloaded outputs in-graph: the
                    # offload jit has no out_shardings, and propagation
                    # would otherwise bleed the moments' ZeRO data-axis
                    # shard onto the state/param outputs (see
                    # make_opt_step)
                    v = jax.lax.with_sharding_constraint(v, repl)
                    states = jax.lax.with_sharding_constraint(
                        states, state_sh)
                    params = jax.lax.with_sharding_constraint(
                        params, param_sh)
                return (v,
                        jax.device_put(opt_state, jax.memory.Space.Host),
                        states, params)

        if chain:
            if mesh is not None or offload:
                raise ValueError(
                    "chain=True (single-dispatch window chaining) "
                    "requires the jax backend without a mesh and "
                    "without offload — fit_sequences gates this itself")
            inner = step
            _d = float(ema_decay) if ema_decay is not None else None

            def _ema_upd(e, st, pa):
                # same recipe as _make_ema_update, inlined per step
                return (e if _d is None else
                        tuple(_d * ei + (1 - _d) * li
                              for ei, li in zip(e, tuple(st) + tuple(pa))))

            def _mk_scan(get_batch):
                # per-step lr values cast to the leaf dtype inside the
                # trace — reproduces the unchained weak-scalar cast bit
                # for bit (see make_opt_step's chain_step)
                if opt is None:

                    def run(rss, rps, sel, Xd, Td, states, params, ema):
                        sdt = params[0].dtype

                        def body(carry, per):
                            st, pa, e = carry
                            rs_i, rp_i, s_i = per
                            xb, tb = get_batch(Xd, Td, s_i)
                            v, st, pa = inner(
                                jnp.asarray(rs_i, dtype=sdt),
                                jnp.asarray(rp_i, dtype=sdt),
                                xb, tb, st, pa)
                            e = _ema_upd(e, st, pa)
                            return (st, pa, e), v

                        (st, pa, e), vs = jax.lax.scan(
                            body, (tuple(states), tuple(params),
                                   tuple(ema)), (rss, rps, sel))
                        return vs[-1], st, pa, e

                    return run

                def run(ratio, rps, sel, Xd, Td, opt_state, states,
                        params, ema):
                    sdt = params[0].dtype

                    def body(carry, per):
                        o, st, pa, e = carry
                        rp_i, s_i = per
                        xb, tb = get_batch(Xd, Td, s_i)
                        v, o, st, pa = inner(
                            ratio, jnp.asarray(rp_i, dtype=sdt),
                            xb, tb, o, st, pa)
                        e = _ema_upd(e, st, pa)
                        return (o, st, pa, e), v

                    (o, st, pa, e), vs = jax.lax.scan(
                        body, (opt_state, tuple(states), tuple(params),
                               tuple(ema)), (rps, sel))
                    return vs[-1], o, st, pa, e

                return run

            def _take(Xd, Td, idx):
                return (jnp.take(Xd, idx, axis=0),
                        jnp.take(Td, idx, axis=0))

            cdargs = ()
            if donate:
                cdargs = (5, 6, 7) if opt is None else (5, 6, 7, 8)
            if chain_spec is not None and chain_spec[-1] == "fixed":
                # shuffle-once: contiguous dynamic_slice batches off the
                # once-shuffled resident dataset (see make_opt_step)
                _, cbatch, spe, cseed, _ = chain_spec

                def _slice(Xd, Td, off):
                    return (jax.lax.dynamic_slice(
                                Xd, (off,) + (0,) * (Xd.ndim - 1),
                                (cbatch,) + Xd.shape[1:]),
                            jax.lax.dynamic_slice(
                                Td, (off,) + (0,) * (Td.ndim - 1),
                                (cbatch,) + Td.shape[1:]))

                _run = _mk_scan(_slice)
                if opt is None:

                    def chain_fn(rss, rps, step0, Xd, Td, states,
                                 params, ema):
                        offs = _device_window_offsets(
                            cseed, cbatch, spe, step0, int(rss.shape[0]))
                        return _run(rss, rps, offs, Xd, Td, states,
                                    params, ema)
                else:

                    def chain_fn(ratio, rps, step0, Xd, Td, opt_state,
                                 states, params, ema):
                        offs = _device_window_offsets(
                            cseed, cbatch, spe, step0, int(rps.shape[0]))
                        return _run(ratio, rps, offs, Xd, Td, opt_state,
                                    states, params, ema)
            elif chain_spec is not None:
                # device-side shuffle: batch indices computed in-graph
                # from (seed, absolute step)
                n_rows, cbatch, spe, cseed, _ = chain_spec
                _run = _mk_scan(_take)
                if opt is None:

                    def chain_fn(rss, rps, step0, Xd, Td, states,
                                 params, ema):
                        idxw = _device_window_indices(
                            cseed, n_rows, cbatch, spe, step0,
                            int(rss.shape[0]))
                        return _run(rss, rps, idxw, Xd, Td, states,
                                    params, ema)
                else:

                    def chain_fn(ratio, rps, step0, Xd, Td, opt_state,
                                 states, params, ema):
                        idxw = _device_window_indices(
                            cseed, n_rows, cbatch, spe, step0,
                            int(rps.shape[0]))
                        return _run(ratio, rps, idxw, Xd, Td, opt_state,
                                    states, params, ema)
            else:
                chain_fn = _mk_scan(_take)
            fn = jax.jit(chain_fn, donate_argnums=cdargs)
            net.op._compiled[key] = fn
            return fn

        # donate=True: the previous (opt_state, states, params) are
        # donated — in-place update, no double-buffered training state
        # (see make_opt_step); offload keeps the pinned-host moments
        # out of the donation
        if not donate:
            dargs = ()
        elif opt is None:
            dargs = (4, 5)            # (rs, rp, xb, tb, states, params)
        elif offload:
            dargs = (5, 6)            # moments are host-resident
        else:
            dargs = (4, 5, 6)   # (ratio, rp, xb, tb, opt, states, params)
        if mesh is None:
            fn = jax.jit(step, donate_argnums=dargs)
        else:
            if opt is None:
                fn = jax.jit(
                    step,
                    in_shardings=(repl, repl, data_sh, data_sh,
                                  state_sh, param_sh),
                    out_shardings=(repl, state_sh, param_sh),
                    donate_argnums=dargs)
            elif offload:
                # no out_shardings under offload (see make_opt_step):
                # the partitioner rejects output placement annotations
                # mixed with the step's memory-space transfers
                fn = jax.jit(
                    step,
                    in_shardings=(repl, repl, data_sh, data_sh, None,
                                  state_sh, param_sh),
                    donate_argnums=dargs)
            else:
                # opt_state shardings inferred from its arrays (built by
                # opt.init on the already-placed states + params)
                fn = jax.jit(
                    step,
                    in_shardings=(repl, repl, data_sh, data_sh, None,
                                  state_sh, param_sh),
                    out_shardings=(repl, None, state_sh, param_sh),
                    donate_argnums=dargs)
    else:
        if mesh is not None:
            raise ValueError("mesh sharding requires the jax backend")

        def _mean_grads(xb, tb, states, params):
            accS = [np.zeros_like(s) for s in states]
            accP = [np.zeros_like(p) for p in params]
            vals = []
            B = len(xb)
            for i in range(B):
                v, grads = ir.value_and_grad(
                    g, be, (xb[i],) + states + params + (tb[i],))
                vals.append(float(np.asarray(v)))
                for a, gg in zip(accS, grads[1 : 1 + k]):
                    a += gg
                for a, gg in zip(accP, grads[1 + k : -1]):
                    a += gg
            mean = _clip(tuple(a / B for a in accS) + tuple(a / B for a in accP))
            return float(np.mean(vals)), mean[:k], mean[k:]

        if opt is None:

            def fn(rs, rp, xb, tb, states, params):
                v, gS, gP = _mean_grads(xb, tb, states, params)
                return (v,
                        tuple(s - rs * a for s, a in zip(states, gS)),
                        tuple(p - rp * a for p, a in zip(params, gP)))

        else:

            def fn(ratio, rp, xb, tb, opt_state, states, params):
                v, gS, gP = _mean_grads(xb, tb, states, params)
                scaled = tuple(ratio * a for a in gS) + tuple(gP)
                leaves = tuple(states) + tuple(params)
                opt_state, leaves = opt.update(opt_state, leaves, scaled, rp)
                return v, opt_state, tuple(leaves[:k]), tuple(leaves[k:])

    net.op._compiled[key] = fn
    return fn


class _SeqStream:
    """The shuffled sequence-minibatch stream with the same position
    invariant as ``NativeLoader.skip``: stream position == global step,
    reconstructed from ``start_step`` alone — so crash/resume chains
    draw the identical batch sequence."""

    def __init__(self, XS, TS, batch: int, seed: int, start_step: int,
                 steps_per_epoch: int, shard=None):
        self.XS, self.TS, self.batch = XS, TS, batch
        self.spe = steps_per_epoch
        # multi-process: every rank draws the SAME global permutation
        # (same seed) and slices its contiguous row-block of each batch
        # — together the ranks assemble the single-process batch exactly
        self.shard = shard
        self._rng = np.random.default_rng(seed)
        self._perm = self._rng.permutation(XS.shape[0])
        for _ in range(start_step // steps_per_epoch):
            self._perm = self._rng.permutation(XS.shape[0])
        self._b = start_step % steps_per_epoch

    def next(self):
        idx = self._perm[self._b * self.batch : (self._b + 1) * self.batch]
        self._b += 1
        if self._b == self.spe:
            self._b = 0
            self._perm = self._rng.permutation(self.XS.shape[0])
        if self.shard is not None:
            rank, n = self.shard
            local = self.batch // n
            idx = idx[rank * local : (rank + 1) * local]
        return self.XS[idx], self.TS[idx]

    def next_indices(self):
        """The next batch's sequence indices, advancing the SAME stream
        position as ``next()`` — chained host-mode windows and unchained
        boundary steps interleave onto one consistent index sequence
        (the recurrent analog of ``NativeLoader.next_indices``)."""
        if self.shard is not None:
            raise RuntimeError(
                "next_indices is single-process only (chaining is "
                "gated to mesh=None, one process)")
        idx = self._perm[self._b * self.batch : (self._b + 1) * self.batch]
        self._b += 1
        if self._b == self.spe:
            self._b = 0
            self._perm = self._rng.permutation(self.XS.shape[0])
        return idx.astype(np.int32)


@dataclass
class FitSeqResult:
    net: "RecurrentNetwork"
    history: list
    steps: int
    ema_net: Optional[Any] = None  # Polyak average (ema_decay=...)


def fit_sequences(
    rnet,
    loss: TOp,
    be: Backend,
    XS: np.ndarray,
    TS: np.ndarray,
    *,
    epochs: int = 1,
    batch_size: int = 16,
    rate_state: float = 0.01,
    rate_param: float = 0.05,
    optimizer: Optional[Optimizer] = None,
    accum_steps: int = 1,
    clip_norm: Optional[float] = None,
    lr_schedule: Optional[Callable[[int], float]] = None,
    mixed_precision: bool = False,
    shard_opt_state: bool = False,
    zero_stage: Optional[int] = None,
    offload_opt_state: bool = False,
    offload_activations: bool = False,
    ema_decay: Optional[float] = None,
    val: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    early_stop_patience: int = 0,
    remat_every=None,
    mesh=None,
    seed: int = 0,
    metrics_path: Optional[str] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 0,
    resume: bool = False,
    prefetch: int = 2,
    chain_steps="auto",
    chain_shuffle: str = "host",
    log_every: int = 10,
    verbose: bool = True,
) -> FitSeqResult:
    """The production loop for the recurrent family — ``fit``'s
    epochs/metrics/checkpoint/resume surface over scan-BPTT sequence
    minibatches (vmapped sequence value-and-gradients, dual state/param
    learning rates — the reference's ``trainNetwork'`` semantics,
    ``Recurrent.hs:326-354``, which it only ever ran hand-looped one
    sequence at a time), the logged batch loss fused into the step.

    ``XS``: ``(N, n, *in_shape)`` sequences, ``TS`` their targets.
    ``epochs`` is the TOTAL budget (as in ``fit``): a resumed run
    executes only the remaining steps and fast-forwards the shuffle to
    the restored step, so a crash/resume chain reproduces an
    uninterrupted run.  Ragged trailing batches are dropped (each
    distinct batch size would recompile the jitted step).  ``prefetch``
    overlaps the next batches' host->device transfer with the step
    (jax).  Checkpoints: ``checkpoint_path`` saves the servable
    recurrent net (``save_recurrent``) and a sibling ``.state`` with
    states + params + optimizer moments + step.

    ``chain_steps`` / ``chain_shuffle`` — single-dispatch step chaining,
    exactly ``fit``'s (see there for the full contract): between
    observation boundaries (log_every / checkpoint_every / the budget)
    the whole window of sequence steps runs as ONE jitted ``lax.scan``
    over the device-resident dataset, eliminating the per-step
    dispatch + batch-upload cost of the unchained loop.
    ``"auto"``
    chains when it applies (jax, no mesh, no offload, dataset <= 1 GiB
    on device); ``chain_shuffle="host"`` consumes the host stream's
    index sequence (bit-identical to ``chain_steps=1``), ``"device"``
    computes epoch permutations in-graph (zero host index traffic;
    pure function of (seed, absolute step) — window partitions and
    crash/resume chains replay identical batches), ``"device_fixed"``
    shuffles rows once and re-randomizes only the batch-slot order per
    epoch (contiguous slices, no per-step gather).  Device modes need
    ``N % batch_size == 0``.

    ``optimizer`` (e.g. ``adam()``) replaces the dual-rate SGD update:
    states and params update through the optimizer at ``rate_param``,
    with state gradients pre-scaled by ``rate_state/rate_param`` so the
    dual-rate semantic survives (dual-rate SGD stays the default, for
    reference parity).  ``clip_norm`` clips the joint gradient by
    global L2 norm; ``lr_schedule`` maps the global step to the param
    rate (the state rate keeps its ratio); ``remat_every`` checkpoints
    the scan-BPTT backward for long sequences
    (O(n/k + k) residual state, see ``ScanOp``);
    ``offload_activations=True`` (jax only) streams the scan-BPTT carry
    tape through pinned host DRAM instead
    (``ScanOp(offload_tape=True)``: the forward scan writes each taped
    carry to host as it goes, the backward copies each slice back right
    before use — O(state) residual HBM per sequence, gradients
    BIT-identical, composes with ``remat_every`` so only block-entry
    carries ever travel).

    ``mesh`` (jax only) trains multi-chip, exactly as in ``fit``: the
    sequence batch shards over ``data`` (XLA inserts one gradient psum),
    params Megatron-style over ``model`` (``param_specs``); states
    replicate (they are network-global).  A ``stage`` axis is rejected —
    the recurrent scan is sequential over time, so pipeline stages would
    idle.  Under a multi-process runtime each host feeds its own
    row-block of every global batch (same-seed global shuffle) and rank
    0 writes checkpoints assembled with a replicate-and-fetch
    collective; resume is exact across process counts.

    ``accum_steps`` accumulates gradients over that many sequence-batch
    chunks inside the jitted step before one update (jax only, batch
    divisibility validated eagerly); ``mixed_precision`` (jax only)
    enables the bf16 scan-BPTT step with full-precision master
    states+params — ``True``/``"auto"`` measures the f32 and bf16 steps
    once and takes the faster (recorded in checkpoints for exact
    resume, same router as ``fit``); ``"bf16"`` forces the bf16 path;
    ``shard_opt_state=True`` (ZeRO-1) shards the
    optimizer moments over the ``data`` axis (requires ``optimizer=``
    and a mesh), ``zero_stage=2`` also reduce-scatters the joint
    state+param gradients, and ``zero_stage=3`` also shards the joint
    states+params between steps with gather-at-use (as in ``fit``,
    every stage bit-identical to replicated);
    ``ema_decay`` keeps a Polyak/EMA copy of states+params
    (``FitSeqResult.ema_net``, stored inside the ``.state`` checkpoint,
    exact across resume); ``val=(XSv, TSv)`` logs the held-out mean
    sequence loss (``val_loss``) every ``log_every`` steps and
    ``early_stop_patience=k`` halts once it stops improving for k
    consecutive evaluations — the same surface as ``fit``."""
    from ..utils.checkpoint import (load_train_state, save_recurrent_async,
                                    save_train_state_async)
    from .recurrent import RecurrentNetwork

    opt = optimizer
    mp_mode = _normalize_mp(mixed_precision)
    if mp_mode != "off" and be.name != "jax":
        raise ValueError("mixed_precision requires the jax backend")
    shard_opt_state, zstage = _normalize_zero_stage(
        shard_opt_state, zero_stage)
    if shard_opt_state and mesh is None:
        raise ValueError(
            f"ZeRO-{zstage} (shard_opt_state/zero_stage) shards over "
            f"the mesh's data axis — pass mesh=make_mesh(...)")
    if shard_opt_state and opt is None:
        raise ValueError(
            "shard_opt_state needs optimizer state to shard — dual-rate "
            "SGD is stateless; pass optimizer=adam() (or momentum())")
    if offload_opt_state and be.name != "jax":
        raise ValueError(
            "offload_opt_state keeps optimizer state in pinned host "
            "DRAM via jax memory-space transfers and requires the jax "
            "backend (numpy state already lives on the host)")
    if offload_opt_state and opt is None:
        raise ValueError(
            "offload_opt_state needs optimizer state to offload — "
            "dual-rate SGD is stateless; pass optimizer=adam() (or "
            "momentum())")
    if offload_activations and be.name != "jax":
        raise ValueError(
            "offload_activations streams the scan-BPTT carry tape "
            "through pinned host DRAM via jax memory-space transfers "
            "and requires the jax backend (the numpy oracle's tape is "
            "host-resident already)")
    if ema_decay is not None and not (0.0 < ema_decay < 1.0):
        raise ValueError(f"ema_decay must be in (0, 1), got {ema_decay}")
    if early_stop_patience and val is None:
        raise ValueError(
            "early_stop_patience watches the held-out sequence loss — "
            "pass val=(XSv, TSv) (evaluated every log_every steps)")
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if accum_steps > 1:
        if be.name != "jax":
            raise ValueError("accum_steps > 1 requires the jax backend "
                             "(the numpy oracle's per-sequence loop has "
                             "no batched activations to amortize)")
        if batch_size % accum_steps != 0:
            raise ValueError(
                f"batch_size ({batch_size}) must be divisible by "
                f"accum_steps ({accum_steps}): the jitted step would "
                f"silently drop the remainder "
                f"{batch_size % accum_steps} sequences of every batch")
    if chain_steps != "auto" and (not isinstance(chain_steps, int)
                                  or chain_steps < 1):
        raise ValueError(
            f"chain_steps must be 'auto' or an int >= 1, got "
            f"{chain_steps!r}")
    if (isinstance(chain_steps, int) and chain_steps > 1
            and (offload_opt_state or offload_activations)):
        raise ValueError(
            "chain_steps > 1 cannot combine with offload_opt_state/"
            "offload_activations: the host DMAs cannot ride inside the "
            "chained scan — use chain_steps='auto' (which backs off) or "
            "chain_steps=1")
    if chain_shuffle not in ("host", "device", "device_fixed"):
        raise ValueError(
            f"chain_shuffle must be 'host', 'device', or "
            f"'device_fixed', got {chain_shuffle!r}")
    if chain_shuffle != "host" and XS.shape[0] % batch_size != 0:
        raise ValueError(
            f"chain_shuffle={chain_shuffle!r} computes the batch "
            f"stream in-graph over {XS.shape[0]} sequences, which must "
            f"divide into whole batches of {batch_size} — trim the "
            f"dataset or use chain_shuffle='host'")
    n_proc, proc_idx = 1, 0
    data_sh = None
    pspecs = None
    if mesh is not None:
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as PSpec

        from ..parallel.mesh import DATA_AXIS, param_specs
        from ..parallel.pipeline import STAGE_AXIS

        if be.name != "jax":
            raise ValueError("mesh sharding requires the jax backend")
        if STAGE_AXIS in mesh.axis_names:
            raise ValueError(
                "fit_sequences has no pipeline mode (the recurrent scan "
                "is sequential over time, so S-1 stages would idle); "
                "pass a (data, model) mesh from make_mesh")
        dp = mesh.shape[DATA_AXIS]
        if batch_size % dp != 0:
            raise ValueError(
                f"batch_size ({batch_size}) must be divisible by the "
                f"data-axis size ({dp})")
        n_proc, proc_idx = jax.process_count(), jax.process_index()
        if n_proc > 1:
            _check_process_data_alignment(mesh, n_proc)
        data_sh = NamedSharding(mesh, PSpec(DATA_AXIS))
        pspecs = param_specs(rnet.param_stack, mesh)
    elif be.name == "jax":
        import jax

        if jax.process_count() > 1:
            raise ValueError(
                "fit_sequences without a mesh under a multi-process jax "
                "runtime would train an independent (divergent) replica "
                "per process on the full dataset; pass "
                "mesh=make_mesh(len(jax.devices())) so the batch shards "
                "globally")
    N = XS.shape[0]
    if N < batch_size:
        raise ValueError(
            f"dataset ({N} sequences) must hold at least one batch "
            f"({batch_size}); ragged batches are dropped")
    steps_per_epoch = N // batch_size
    total_steps = epochs * steps_per_epoch
    k = len(rnet.states)
    net = rnet
    if mesh is not None:
        from ..parallel.mesh import place_host

        # place BEFORE opt.init so moments inherit the param shardings;
        # place_host handles shardings spanning other processes
        repl = NamedSharding(mesh, PSpec())
        net = RecurrentNetwork(
            net.op,
            tuple(place_host(np.asarray(be.asarray(s)), repl)
                  for s in net.states),
            tuple(place_host(np.asarray(be.asarray(p)),
                             NamedSharding(mesh, sp))
                  for p, sp in zip(net.params, pspecs)),
            net.arch)
    step = 0
    state_path = (checkpoint_path + ".state") if checkpoint_path else None
    zero_cons = None
    grad_cons = None
    p_unshard = None   # ZeRO-3: gather the sharded joint leaves at use
    p_cons = None      # ... and pin the updated masters back on shards
    z3_shs = None
    if shard_opt_state and zstage >= 3:
        # ZeRO-3 over the JOINT (states + params) leaves, BEFORE
        # opt.init so the moments inherit the extended shardings
        placed, p_unshard, p_cons, z3_shs = _zero3_params(
            tuple(net.states) + tuple(net.params), mesh)
        if p_unshard is not None:
            net = RecurrentNetwork(net.op, placed[:k], placed[k:],
                                   net.arch)
    opt_state = (opt.init(tuple(net.states) + tuple(net.params))
                 if opt is not None else ())
    if shard_opt_state:
        if p_unshard is not None:
            from ..parallel.mesh import pin_inherited, pin_shardings

            zero_cons = pin_inherited(opt_state, what="optimizer state")
            # exact_reduction: see _zero2_grads — gradients keep the
            # replicated run's all-reduce; params/moments stay sharded
            grad_cons = (None if getattr(opt, "exact_reduction", False)
                         else pin_shardings(
                             z3_shs, what="zero_stage=3 gradient shards"))
        else:
            opt_state, zero_cons = _zero1_wrap(opt_state, mesh)
            if zstage >= 2:
                # the joint gradient covers states THEN params — build
                # the ZeRO-2 constraint from the same placed leaf order
                grad_cons = _zero2_grads(
                    tuple(net.states) + tuple(net.params), mesh,
                    exact=getattr(opt, "exact_reduction", False))
    if offload_opt_state and opt is not None:
        # BEFORE resume: the host placement becomes the template
        # sharding restored moments re-place onto
        opt_state = _offload_state(opt_state, "fit_sequences")
    opt_key = (opt.struct_key()
               if opt is not None and opt.hyper is not None else None)
    r_ema = None
    if resume and state_path and os.path.exists(state_path):
        # the .state "params" slot holds states + params; opt_state
        # carries the optimizer moments (empty for dual-rate SGD)
        flat, r_opt_state, step, r_ema = load_train_state(
            state_path, opt_state, opt_key=opt_key, with_ema=True)
        if len(flat) != k + len(net.params):
            raise ValueError(
                f"checkpoint has {len(flat)} leaves, the network needs "
                f"{k} states + {len(net.params)} params")
        if mesh is None:
            net = RecurrentNetwork(
                net.op,
                tuple(be.asarray(s) for s in flat[:k]),
                tuple(be.asarray(p) for p in flat[k:]), net.arch)
        else:
            # restored leaves are host numpy; re-place each onto its
            # training-time sharding (cross-process aware; ZeRO-3
            # leaves resume onto their data-extended shardings)
            base_shs = ([repl] * k
                        + [NamedSharding(mesh, sp) for sp in pspecs])
            if z3_shs is not None:
                base_shs = [z3 or sh for z3, sh in zip(z3_shs, base_shs)]
            net = RecurrentNetwork(
                net.op,
                tuple(_place(np.asarray(s), sh)
                      for s, sh in zip(flat[:k], base_shs[:k])),
                tuple(_place(np.asarray(p), sh)
                      for p, sh in zip(flat[k:], base_shs[k:])), net.arch)
        if opt is not None:
            opt_state = _restore_opt_state(opt_state, r_opt_state, be)
        if verbose:
            print(f"resumed from {state_path} at step {step} "
                  f"({max(total_steps - step, 0)} of {total_steps} steps "
                  f"remaining)")

    # the jitted step donates (states, params); train on working copies
    # so the caller's network survives the first step (see fit)
    if be.name == "jax":
        net = RecurrentNetwork(net.op, _fresh_leaves(net.states, be),
                               _fresh_leaves(net.params, be), net.arch)
        if opt is not None and not offload_opt_state:
            opt_state = _dedupe_donated(opt_state, be)

    # Polyak averaging over states + params (the same recipe as fit's:
    # EMA stored inside the .state file, shared helpers)
    ema_leaves = None
    _ema_step = None
    if ema_decay is not None:
        ema_leaves = _ema_init(
            r_ema, tuple(net.states) + tuple(net.params), be, step,
            "fit_sequences")
        _ema_step = _make_ema_update(net.op._compiled, ema_decay, mesh,
                                     be, "emastep_seq")

    # --- step chaining: one dispatch per observation window (the
    # recurrent analog of fit's; see _seq_train_step(chain=True)) ---
    use_chain = False
    if (be.name == "jax" and mesh is None
            and not offload_opt_state and not offload_activations
            and chain_steps != 1):
        if chain_steps == "auto":
            ds_bytes = (XS.size + TS.size) * be.dtype.itemsize
            use_chain = ds_bytes <= (1 << 30)
        else:
            use_chain = True
    chain_dev = use_chain and chain_shuffle != "host"
    if chain_shuffle != "host" and not use_chain:
        raise ValueError(
            f"chain_shuffle={chain_shuffle!r} needs step chaining to "
            f"engage: jax backend, no mesh/offload, chain_steps != 1, "
            f"and (in auto mode) a dataset small enough for HBM "
            f"residency — this configuration fell back to unchained "
            f"dispatch, where the host stream already owns the shuffle")

    stream = _SeqStream(XS, TS, batch_size, seed, step, steps_per_epoch,
                        shard=(proc_idx, n_proc) if n_proc > 1 else None)
    if prefetch > 1 and be.name == "jax" and n_proc == 1 \
            and not use_chain and step < total_steps:
        from ..utils.native import DevicePrefetcher

        if data_sh is not None:
            import jax

            def _put(xb, tb, _sh=data_sh):
                return (jax.device_put(be.asarray(xb), _sh),
                        jax.device_put(be.asarray(tb), _sh))
        else:
            def _put(xb, tb):
                return be.asarray(xb), be.asarray(tb)

        source = DevicePrefetcher(stream, _put, depth=prefetch)
    else:
        source = None

    n_seq = XS.shape[1]

    def build_step(mp_active: bool):
        return _seq_train_step(net, loss, be, n_seq, opt=opt,
                               clip_norm=clip_norm,
                               remat_every=remat_every,
                               mesh=mesh, accum_steps=accum_steps,
                               mixed_precision=mp_active,
                               zero_constrain=zero_cons,
                               grad_constrain=grad_cons,
                               param_unshard=p_unshard,
                               param_constrain=p_cons,
                               leaf_shardings=z3_shs,
                               offload=offload_opt_state,
                               offload_tape=offload_activations,
                               donate=True)

    # mixed-precision routing — same ladder as fit's: force > recorded
    # in the checkpoint being resumed > in-process cache > measure now
    mp_active = mp_mode == "bf16"
    mp_rec = None
    if mp_mode == "auto":

        def _dummy_args():
            rows = batch_size // n_proc if n_proc > 1 else batch_size
            xb = np.zeros((rows,) + tuple(XS.shape[1:]), dtype=XS.dtype)
            tb = np.zeros((rows,) + tuple(TS.shape[1:]), dtype=TS.dtype)
            if data_sh is not None:
                import jax

                if n_proc > 1:
                    gx = (rows * n_proc,) + xb.shape[1:]
                    gt = (rows * n_proc,) + tb.shape[1:]
                    xb = jax.make_array_from_process_local_data(
                        data_sh, np.asarray(be.asarray(xb)), gx)
                    tb = jax.make_array_from_process_local_data(
                        data_sh, np.asarray(be.asarray(tb)), gt)
                else:
                    xb = jax.device_put(be.asarray(xb), data_sh)
                    tb = jax.device_put(be.asarray(tb), data_sh)
            else:
                xb, tb = be.asarray(xb), be.asarray(tb)
            if opt is None:
                return (rate_state, rate_param, xb, tb,
                        tuple(net.states), tuple(net.params))
            return (rate_state / rate_param, rate_param, xb, tb,
                    opt_state, tuple(net.states), tuple(net.params))

        route_key = ("mproute_seq", loss.struct_key(),
                     opt.struct_key() if opt is not None else None,
                     clip_norm, mesh, int(accum_steps), int(batch_size),
                     remat_every,
                     zstage, zero_cons is not None, grad_cons is not None,
                     p_unshard is not None, bool(offload_opt_state),
                     bool(offload_activations),
                     tuple(XS.shape[1:]),
                     tuple(TS.shape[1:])) + be.cache_key()
        mp_active, mp_rec = _resolve_mp_route(
            net, build_step, _dummy_args, route_key,
            resume=resume, state_path=state_path,
            n_proc=n_proc, carry_from=4, verbose=verbose)
    step_fn = build_step(mp_active)
    chain_fn = XS_dev = TS_dev = None
    if use_chain:
        # be.asarray casts the WHOLE dataset once; gathering rows of
        # the cast copy is bitwise the unchained path's
        # cast-after-gather (elementwise cast commutes with take)
        XS_dev = be.asarray(XS)
        TS_dev = be.asarray(TS)
        if chain_shuffle == "device_fixed":
            import jax

            _p0 = _device_fixed_perm(seed, XS.shape[0])
            XS_dev, TS_dev = jax.jit(
                lambda x, t, p: (x[p], t[p]))(XS_dev, TS_dev, _p0)
        chain_fn = _seq_train_step(
            net, loss, be, n_seq, opt=opt, clip_norm=clip_norm,
            remat_every=remat_every, accum_steps=accum_steps,
            mixed_precision=mp_active, donate=True, chain=True,
            chain_spec=((XS.shape[0], batch_size, steps_per_epoch,
                         seed, "fixed" if chain_shuffle == "device_fixed"
                         else "perm") if chain_dev else None),
            ema_decay=ema_decay)
    state_meta = ({"mp_route": "bf16" if mp_active else "f32"}
                  if mp_mode != "off" else None)
    first_step_of_run = step + 1
    if use_chain:
        # the index window is tiny (k*batch*4B) but bound it anyway
        _kcap = max(1, (1 << 25) // max(batch_size, 1))
        if isinstance(chain_steps, int):
            _kcap = min(_kcap, chain_steps)

        def _window_len(s: int) -> int:
            """Steps until the next observation boundary from step s
            (same absolute-position contract as fit's: resumed runs
            re-derive the identical window sequence).  fit_sequences
            has no ragged batches — the stream drops the tail."""
            nb = total_steps
            if s < first_step_of_run:
                nb = min(nb, first_step_of_run)
            nb = min(nb, (s // log_every + 1) * log_every)
            if checkpoint_path and checkpoint_every:
                nb = min(nb, (s // checkpoint_every + 1) * checkpoint_every)
            return max(1, min(nb - s, _kcap))

    logger = MetricsLogger(metrics_path)
    if mp_mode != "off":
        logger.log(step, mp_route="bf16" if mp_active else "f32",
                   **(mp_rec or {}))
    history = []
    saves = _CheckpointWrites()
    snap = (net, opt_state, ema_leaves, step)
    best_val, evals_since_best = float("-inf"), 0
    try:
        while step < total_steps:
            wlen = _window_len(step) if use_chain else 1
            if wlen > 1 or (chain_dev and use_chain):
                # chained window: wlen sequence steps in one dispatch
                # (see fit's chained branch — same index/lr/donation
                # contract)
                if chain_dev:
                    idx_arg = np.int32(step)
                else:
                    idxw = np.empty((wlen, batch_size), dtype=np.int32)
                    for i in range(wlen):
                        idxw[i] = stream.next_indices()
                    idx_arg = idxw
                # exact f64 schedule values, computed per step exactly
                # as the unchained path computes them
                if lr_schedule is not None:
                    rps = np.asarray([lr_schedule(s)
                                      for s in range(step, step + wlen)],
                                     dtype=np.float64)
                    rss = np.asarray(
                        [rate_state * (lr_schedule(s) / rate_param)
                         for s in range(step, step + wlen)],
                        dtype=np.float64)
                else:
                    rps = np.full(wlen, rate_param, dtype=np.float64)
                    rss = np.full(wlen, rate_state, dtype=np.float64)
                epoch = (step + wlen - 1) // steps_per_epoch
                with _sigint_shield():
                    _e = ema_leaves if ema_leaves is not None else ()
                    if opt is None:
                        v, new_s, new_p, new_ema = chain_fn(
                            rss, rps, idx_arg, XS_dev, TS_dev,
                            tuple(net.states), tuple(net.params), _e)
                        new_opt = opt_state
                    else:
                        v, new_opt, new_s, new_p, new_ema = chain_fn(
                            rate_state / rate_param, rps, idx_arg,
                            XS_dev, TS_dev, opt_state,
                            tuple(net.states), tuple(net.params), _e)
                    if ema_leaves is None:
                        new_ema = None
                    new_net = RecurrentNetwork(net.op, tuple(new_s),
                                               tuple(new_p), net.arch)
                    snap = (new_net, new_opt, new_ema, step + wlen)
                    net, opt_state, ema_leaves = (new_net, new_opt,
                                                  new_ema)
                    step += wlen
                # the shared post-step block below handles logging,
                # val/early-stop, and checkpoints — the window ended on
                # a boundary by construction
                stop_early = False
                if step % log_every == 0 or step == first_step_of_run:
                    v = float(np.asarray(v))
                    rec = {"epoch": epoch, "loss": v}
                    if val is not None:
                        from .training import seq_batch_loss

                        rec["val_loss"] = seq_batch_loss(net, loss, be,
                                                         val[0], val[1])
                        if early_stop_patience:
                            if -rec["val_loss"] > best_val + 1e-12:
                                best_val = -rec["val_loss"]
                                evals_since_best = 0
                            else:
                                evals_since_best += 1
                                stop_early = (evals_since_best
                                              >= early_stop_patience)
                    history.append(logger.log(step, **rec))
                    if verbose:
                        msg = (f"[epoch {epoch}] step {step}: seq loss "
                               f"{rec['loss']:.4f}")
                        if "val_loss" in rec:
                            msg += f"  val_loss {rec['val_loss']:.4f}"
                        print(msg)
                if checkpoint_path and checkpoint_every and \
                        step % checkpoint_every == 0:
                    saves.add(
                        save_recurrent_async(checkpoint_path, net),
                        save_train_state_async(
                            state_path,
                            tuple(net.states) + tuple(net.params),
                            opt_state if opt is not None else (), step,
                            opt_key=opt_key, ema=ema_leaves,
                            extra_meta=state_meta))
                if stop_early:
                    if verbose:
                        print(f"early stop at step {step}: val_loss has "
                              f"not improved over {early_stop_patience} "
                              f"evaluations (best {-best_val:.4f})")
                    break
                continue
            epoch = step // steps_per_epoch
            if lr_schedule is not None:
                rp = lr_schedule(step)
                rs = rate_state * (rp / rate_param)
            else:
                rp, rs = rate_param, rate_state
            if source is not None:
                xb, tb = source.next()
            else:
                xb, tb = stream.next()
                if data_sh is not None:
                    import jax

                    if n_proc > 1:
                        gx = (xb.shape[0] * n_proc,) + xb.shape[1:]
                        gt = (tb.shape[0] * n_proc,) + tb.shape[1:]
                        xb = jax.make_array_from_process_local_data(
                            data_sh, np.asarray(be.asarray(xb)), gx)
                        tb = jax.make_array_from_process_local_data(
                            data_sh, np.asarray(be.asarray(tb)), gt)
                    else:
                        xb = jax.device_put(be.asarray(xb), data_sh)
                        tb = jax.device_put(be.asarray(tb), data_sh)
                else:
                    xb, tb = be.asarray(xb), be.asarray(tb)
            # SIGINT deferred across the donation window (see fit): the
            # step donates the previous (opt_state, states, params) and
            # the EMA update donates the previous average
            with _sigint_shield():
                if opt is None:
                    v, new_s, new_p = step_fn(rs, rp, xb, tb,
                                              tuple(net.states),
                                              tuple(net.params))
                    new_opt = opt_state
                else:
                    # the dual-rate ratio is schedule-invariant (rs and
                    # rp scale together); passing it explicitly keeps a
                    # warmup rp == 0 step finite (rs/rp would be 0/0)
                    v, new_opt, new_s, new_p = step_fn(
                        rate_state / rate_param, rp, xb, tb, opt_state,
                        tuple(net.states), tuple(net.params))
                new_net = RecurrentNetwork(net.op, tuple(new_s),
                                           tuple(new_p), net.arch)
                new_ema = (_ema_step(ema_leaves,
                                     tuple(new_s) + tuple(new_p))
                           if ema_leaves is not None else None)
                # single-assignment snapshot: the Ctrl-C handler reads
                # only this, so an interrupt mid-update can't checkpoint
                # new leaves under the old step (batch replay on resume)
                snap = (new_net, new_opt, new_ema, step + 1)
                net, opt_state, ema_leaves = new_net, new_opt, new_ema
                step += 1
            stop_early = False
            if step % log_every == 0 or step == first_step_of_run:
                v = float(np.asarray(v))
                rec = {"epoch": epoch, "loss": v}
                if val is not None:
                    from .training import seq_batch_loss

                    rec["val_loss"] = seq_batch_loss(net, loss, be,
                                                     val[0], val[1])
                    if early_stop_patience:
                        if -rec["val_loss"] > best_val + 1e-12:
                            best_val = -rec["val_loss"]
                            evals_since_best = 0
                        else:
                            evals_since_best += 1
                            stop_early = (evals_since_best
                                          >= early_stop_patience)
                history.append(logger.log(step, **rec))
                if verbose:
                    msg = f"[epoch {epoch}] step {step}: seq loss {v:.4f}"
                    if "val_loss" in rec:
                        msg += f"  val_loss {rec['val_loss']:.4f}"
                    print(msg)
            if checkpoint_path and checkpoint_every and \
                    step % checkpoint_every == 0:
                if n_proc > 1:
                    # leaves sharded across processes: every rank joins
                    # the replicate-and-fetch collective, rank 0 writes
                    host_leaves, host_opt, host_e = _global_host_tree(
                        (tuple(net.states) + tuple(net.params),
                         opt_state if opt is not None else (),
                         ema_leaves), mesh)
                    if proc_idx == 0:
                        host_net = RecurrentNetwork(
                            net.op, tuple(host_leaves[:k]),
                            tuple(host_leaves[k:]), net.arch)
                        saves.add(
                            save_recurrent_async(checkpoint_path, host_net),
                            save_train_state_async(
                                state_path, host_leaves, host_opt, step,
                                opt_key=opt_key, ema=host_e,
                                extra_meta=state_meta))
                else:
                    saves.add(
                        save_recurrent_async(checkpoint_path, net),
                        save_train_state_async(
                            state_path,
                            tuple(net.states) + tuple(net.params),
                            opt_state if opt is not None else (), step,
                            opt_key=opt_key, ema=ema_leaves,
                            extra_meta=state_meta))
            if stop_early:
                if verbose:
                    print(f"early stop at step {step}: val_loss has not "
                          f"improved over {early_stop_patience} "
                          f"evaluations (best {-best_val:.4f})")
                break
    except KeyboardInterrupt:
        # Ctrl-C leaves an exact-resume artifact (same semantics as
        # fit's handler; single-process only — the multi-host gather is
        # a collective no lone rank may enter)
        s_net, s_opt, s_ema, s_step = snap
        if checkpoint_path and s_step > 0 and n_proc == 1:
            if not _leaves_alive(((tuple(s_net.states), tuple(
                    s_net.params)), s_opt, s_ema)):
                # double-press escaped the shield mid-step (see fit)
                if verbose:
                    print("interrupt landed inside a training step "
                          "(double Ctrl-C): the in-flight step is lost; "
                          "no checkpoint written")
                raise
            from ..utils.checkpoint import save_recurrent, save_train_state

            saves.join()
            save_recurrent(checkpoint_path, s_net)
            save_train_state(
                state_path, tuple(s_net.states) + tuple(s_net.params),
                s_opt if opt is not None else (), s_step,
                opt_key=opt_key, ema=s_ema, extra_meta=state_meta)
            if verbose:
                print(f"interrupted at step {s_step}: checkpoint saved "
                      f"to {checkpoint_path} — fit_sequences("
                      f"resume=True) continues exactly here")
        raise
    finally:
        save_err = saves.join()
        logger.close()
        if save_err is not None and sys.exc_info()[0] is None:
            raise save_err
    ema_net = None
    if ema_leaves is not None:
        ema_net = RecurrentNetwork(net.op, tuple(ema_leaves[:k]),
                                   tuple(ema_leaves[k:]), net.arch)
    return FitSeqResult(net, history, step, ema_net=ema_net)


def _restore_opt_state(template, restored, be: Backend):
    """Rebuild an optimizer state from checkpoint leaves: every restored
    leaf is placed like its template counterpart (same backend array
    type; same device sharding for jax arrays — ``opt.init`` built the
    template from the already-sharded params, so moments resume with
    their training-time placement instead of host numpy).  Container
    semantics mirror ``checkpoint._tree_unflatten``: tuples/lists/
    NamedTuples/dicts recurse, ``None`` passes through."""
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _restore_opt_state(template[k], restored[k], be)
                for k in sorted(template)}
    if isinstance(template, (tuple, list)):
        vals = [_restore_opt_state(t, r, be)
                for t, r in zip(template, restored)]
        if hasattr(template, "_fields"):  # NamedTuple states
            return type(template)(*vals)
        return type(template)(vals)
    if isinstance(template, bool):
        return bool(restored)
    if isinstance(template, int):
        return int(restored)
    if isinstance(template, float):
        return float(restored)
    if be.name == "jax" and not isinstance(template, np.ndarray):
        import jax

        if isinstance(template, jax.Array):
            return _place(np.asarray(restored), template.sharding)
    return be.asarray(restored)
