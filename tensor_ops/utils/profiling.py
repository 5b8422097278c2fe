"""Tracing / profiling helpers (SURVEY.md §5).

The reference's only instrumentation is a wall-clock ``time`` helper with
deepseq forcing (``app/Dots.hs:158-166``).  The rebuild pairs honest
block-until-ready step timing with ``jax.profiler`` device traces for
TensorBoard/xprof."""

from __future__ import annotations

import contextlib
import time
from typing import Iterator, List, Optional


@contextlib.contextmanager
def device_trace(logdir: str) -> Iterator[None]:
    """Capture a jax.profiler trace (view in TensorBoard / xprof)."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class StepTimer:
    """Per-step wall timing with device sync; reports p50/p90/mean.

    Thread-safe for concurrent start/stop pairs (each thread times its
    own request — the serving soak case: N predict threads sharing one
    ``Predictor``): the in-flight start mark is thread-local, and the
    samples append is atomic under the GIL."""

    def __init__(self):
        import threading

        self.samples: List[float] = []
        self._tl = threading.local()

    def start(self):
        self._tl.t0 = time.perf_counter()

    def stop(self, result=None):
        if result is not None:
            try:
                import jax

                jax.block_until_ready(result)
            except Exception:
                pass
        t0 = getattr(self._tl, "t0", None)
        assert t0 is not None, "StepTimer.stop() without start()"
        self.samples.append(time.perf_counter() - t0)
        self._tl.t0 = None

    @contextlib.contextmanager
    def step(self):
        self.start()
        out = {}
        try:
            yield out
        finally:
            self.stop(out.get("result"))

    def summary(self) -> dict:
        if not self.samples:
            return {"n": 0}
        s = sorted(self.samples)
        n = len(s)
        return {
            "n": n,
            "mean_s": sum(s) / n,
            "p50_s": s[n // 2],
            "p90_s": s[min(n - 1, int(0.9 * n))],
            "total_s": sum(s),
        }


def enable_nan_checks(enable: bool = True) -> None:
    """Turn on jax's NaN debugging (``jax_debug_nans``) — the numerical
    analog of the race detection the reference gets for free from purity
    (SURVEY.md §5)."""
    import jax

    jax.config.update("jax_debug_nans", bool(enable))


def cost_analysis(fn, *args) -> dict:
    """XLA's own cost model for ``jit(fn)(*args)``: flops, bytes
    accessed, etc. — the denominator for achieved-vs-peak reporting."""
    import jax

    compiled = jax.jit(fn).lower(*args).compile()
    ca = compiled.cost_analysis()
    if isinstance(ca, (list, tuple)):
        ca = ca[0] if ca else {}
    return dict(ca or {})


def measure_loop(step, init, steps=(50, 250), reps: int = 6,
                 args: tuple = ()) -> dict:
    """Steady-state per-iteration wall time of ``carry = step(carry,
    *args)`` with the repo's differential method: the loop runs inside
    ONE jitted ``lax.fori_loop`` at two step counts; (best wall hi - best wall lo) / (hi - lo) removes the
    constant dispatch cost.  ``step`` must carry its state (a loop whose
    iterations are independent gets hoisted by XLA and measures
    nothing).  Pass large invariant operands (weights!) through ``args``
    — values merely closed over become jit CONSTANTS, inflating the
    compiled program."""
    import jax
    from jax import lax

    lo_n, hi_n = steps

    def _sync(out):
        # fetch one scalar of the result: the wall ends when it arrives
        leaf = jax.tree_util.tree_leaves(out)[0]
        return float(leaf.reshape(-1)[0])

    def make(n):
        @jax.jit
        def loop(c, *a):
            return lax.fori_loop(0, n, lambda i, c: step(c, *a), c)
        return lambda: _sync(loop(init, *args))

    lo, hi = make(lo_n), make(hi_n)
    lo(); hi()  # compile + warm

    def wall(fn):
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
        return best

    per_step = (wall(hi) - wall(lo)) / (hi_n - lo_n)
    return {"per_step_s": per_step, "steps_per_s": 1.0 / per_step}


def profile_step(step, init, steps=(50, 250), reps: int = 6,
                 args: tuple = ()) -> dict:
    """measure_loop + XLA cost analysis of ONE step: reports achieved
    TFLOP/s and GB/s against the compiler's own flop/byte counts.

        stats = profile_step(lambda c: train_step(c), carry0)
        # {'per_step_s', 'steps_per_s', 'flops', 'bytes_accessed',
        #  'tflops_per_s', 'gbytes_per_s', 'compile_s'}
    """
    t0 = time.perf_counter()
    ca = cost_analysis(step, init, *args)
    compile_s = time.perf_counter() - t0
    out = measure_loop(step, init, steps, reps, args=args)
    out["compile_s"] = compile_s
    flops = ca.get("flops", 0.0)
    byts = ca.get("bytes accessed", ca.get("bytes_accessed", 0.0))
    out["flops"] = flops
    out["bytes_accessed"] = byts
    if flops:
        out["tflops_per_s"] = flops / out["per_step_s"] / 1e12
    if byts:
        out["gbytes_per_s"] = byts / out["per_step_s"] / 1e9
    return out


def memory_analysis(fn, *args) -> dict:
    """XLA's compiled memory breakdown for ``jit(fn)(*args)``: argument,
    output, temp (live activations/workspace), and generated-code bytes
    — PER DEVICE when the arguments carry shardings, so this is the
    direct answer to "does this step fit in HBM?".  Pairs with
    :func:`training_memory_report`'s analytic numbers."""
    import jax

    compiled = jax.jit(fn).lower(*args).compile()
    ma = compiled.memory_analysis()
    out = {}
    for k in ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes",
              "alias_size_in_bytes"):
        v = getattr(ma, k, None)
        if v is not None:
            out[k] = int(v)
    out["total_in_bytes"] = (
        out.get("argument_size_in_bytes", 0)
        + out.get("output_size_in_bytes", 0)
        + out.get("temp_size_in_bytes", 0)
        - out.get("alias_size_in_bytes", 0))
    return out


def training_memory_report(net, optimizer=None, batch_size: int = 128,
                           mesh=None, shard_opt_state: bool = False,
                           zero_stage: int = None,
                           mixed_precision: bool = False,
                           offload_opt_state: bool = False) -> dict:
    """Analytic PER-DEVICE training-state bytes for ``fit``'s
    configuration knobs — the operator-facing answer to "what does this
    mesh/optimizer/ZeRO choice buy me?" before committing hardware.

    Counts params, gradients (transient, same sharding as params),
    optimizer moments (0 for sgd, 1 for momentum, 2 for adam — ZeRO-1
    divides each dp-divisible moment by dp when ``shard_opt_state``;
    ``zero_stage=2`` also divides the gradient row by dp — the
    reduce-scattered shard is all a rank holds at the optimizer
    boundary; ``zero_stage=3`` also divides the PARAM row by dp — the
    masters live sharded between steps and gather at use, so the
    transient gathered copy is compute-scoped, not resident),
    and the bf16 compute copies under ``mixed_precision`` (always full:
    the bf16 copy is made of the gathered params inside the step).
    ``offload_opt_state=True`` moves the (possibly ZeRO-divided) moment
    bytes out of the per-device HBM account into an explicit
    ``optimizer_host_bytes`` row — steady-state optimizer HBM is zero;
    the in-step working copy is compute-scoped (like ZeRO-3's gathered
    params) and bounded by the host row.  Activation
    memory is workload-shaped; measure it with
    :func:`memory_analysis` on the real step instead.  Each row counts
    ONE resident copy: ``fit``'s steps donate the previous training
    state, so the update aliases in place — there is no second
    input+output copy of params/moments at the step boundary.  Sizes
    follow the same placement rules ``fit`` uses (``param_specs`` +
    ``zero1_shardings``), so the report matches what actually ships."""
    import numpy as np

    from ..parallel.mesh import DATA_AXIS, MODEL_AXIS

    if zero_stage is None:
        zero_stage = 1 if shard_opt_state else 0
    shard_opt_state = shard_opt_state or zero_stage >= 1
    dtype_bytes = np.dtype(net.params[0].dtype).itemsize
    tp = dp = 1
    if mesh is not None:
        shape = dict(mesh.shape)
        tp = shape.get(MODEL_AXIS, 1)
        dp = shape.get(DATA_AXIS, 1)

    def _sharded(sz_shape, over):
        n = int(np.prod(sz_shape, dtype=np.int64))
        for ax, f in over:
            if sz_shape[ax] % f == 0:
                n //= f
        return n

    from ..models.optim import moment_footprint

    n_moments = 0
    if optimizer is not None and optimizer.name != "sgd":
        n_moments = 1 if optimizer.name == "momentum" else 2
    moment_b_per_elem = moment_footprint(optimizer, dtype_bytes)

    params_b = grads_b = moments_b = 0
    if mesh is not None and tp > 1:
        from ..parallel.mesh import param_specs

        specs = param_specs(net.param_stack, mesh)
    else:
        specs = [None] * len(net.param_stack)
    for shp, spec in zip(net.param_stack, specs):
        spec_l = (list(spec) + [None] * (len(shp) - len(spec))
                  if spec is not None else [None] * len(shp))
        tp_div = [(ax, tp) for ax, s in enumerate(spec_l)
                  if s == MODEL_AXIS]
        n_local = _sharded(shp, tp_div)
        dp_local = n_local
        if dp > 1:
            # the shared ZeRO dim-choice rule: first spec-free
            # dp-divisible dim (zero1/zero2/zero3 all use it)
            for ax, s in enumerate(spec_l):
                if s is None and shp[ax] % dp == 0:
                    dp_local //= dp
                    break
        params_b += (dp_local if zero_stage >= 3 else n_local) * dtype_bytes
        grads_b += (dp_local if zero_stage >= 2 else n_local) * dtype_bytes
        if optimizer is not None and optimizer.name == "adam8bit":
            # adam8bit state is FLAT (n_blocks, block) int8 codes plus
            # (n_blocks, 1) scales per moment — built by raveling the
            # FULL param (the blocks carry no model-axis sharding), so
            # size from the whole param padded to blocks, and ZeRO
            # divides on n_blocks % dp, not the param dims
            blk = optimizer.hyper[3] if optimizer.hyper else 256
            nb = -(-int(np.prod(shp, dtype=np.int64)) // blk)
            m_bytes = 2 * (nb * blk + nb * dtype_bytes)  # codes+scales
            if shard_opt_state and dp > 1 and nb % dp == 0:
                m_bytes //= dp
            moments_b += m_bytes
        else:
            # zero1_shardings: the shared first-free-dim rule above
            m_local = dp_local if shard_opt_state else n_local
            moments_b += int(moment_b_per_elem * m_local)
    # bf16 compute copies: params cast to 2-byte bf16 inside the step
    compute_b = (params_b // dtype_bytes) * 2 if mixed_precision else 0
    in_elems = int(np.prod(net.op.in_stack[0], dtype=np.int64))
    batch_b = (batch_size // max(dp, 1)) * in_elems * dtype_bytes
    moments_host_b = 0
    if offload_opt_state:
        # host-resident between steps: zero steady-state HBM; the
        # per-device host row keeps any ZeRO division (each host holds
        # only its own ranks' shards)
        moments_host_b, moments_b = moments_b, 0
    total = params_b + grads_b + moments_b + compute_b + batch_b
    return {
        "per_device": {
            "params_bytes": params_b,
            "grads_bytes": grads_b,
            "optimizer_bytes": moments_b,
            "optimizer_host_bytes": moments_host_b,
            "bf16_compute_copy_bytes": compute_b,
            "batch_bytes": batch_b,
            "training_state_total_bytes": total,
        },
        "mesh": {"dp": dp, "tp": tp},
        "zero1": bool(shard_opt_state and dp > 1),
        "zero_stage": zero_stage if dp > 1 else 0,
        "offload_opt_state": bool(offload_opt_state),
        "n_moment_buffers": n_moments,
    }
