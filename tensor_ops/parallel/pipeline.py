"""Pipeline parallelism: GPipe-style microbatched stage sharding.

The reference's layer-composition points (`~*~`, ``FeedForward.hs:82-90``)
are natural pipeline cut points (SURVEY.md §2.5).  Here a uniform-width
ffLayer chain is split into S stages sharded over a ``stage`` mesh axis;
microbatches flow through a ``lax.scan`` whose per-step hand-off is a
``lax.ppermute`` ring shift inside ``shard_map`` — the standard
pipeline recipe (XLA overlaps the permute with the next step's
compute).  ``jax.grad`` differentiates straight through the
pipeline (the transpose of ppermute is the reverse ppermute), so the
backward pass is automatically pipelined too — no hand-written schedule.

Input embedding (i -> h) and output projection (h -> o) run replicated
outside the pipeline; the pipelined body is the uniform h -> h chain, so
every stage's parameters stack into arrays with a leading stage axis that
``shard_map`` shards.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as PSpec

# jax >= 0.8 top-level API only: every call site passes check_vma=...,
# which the pre-0.8 experimental shard_map (check_rep era) rejects — a
# fallback import would just fail later with a confusing TypeError
from jax import shard_map

# axis names shared with parallel/mesh.py — one contract for both modules
from .mesh import DATA_AXIS, MODEL_AXIS  # noqa: E402

STAGE_AXIS = "stage"


def make_pipeline_mesh(n_stages: int, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
    if len(devices) < n_stages:
        raise ValueError(f"need {n_stages} devices, have {len(devices)}")
    return Mesh(np.asarray(devices[:n_stages]), (STAGE_AXIS,))


def make_dp_pipeline_mesh(n_data: int, n_stages: int, devices=None) -> Mesh:
    """2D (data, stage) mesh: batch sharded over ``data``, layers over
    ``stage`` — combined dp x pp in one train step."""
    if devices is None:
        devices = jax.devices()
    need = n_data * n_stages
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    return Mesh(
        np.asarray(devices[:need]).reshape(n_data, n_stages),
        (DATA_AXIS, STAGE_AXIS),
    )


def make_3d_pipeline_mesh(n_data: int, n_stages: int, n_model: int,
                          devices=None) -> Mesh:
    """3D (data, stage, model) mesh: batch over ``data``, layer chain over
    ``stage``, hidden width inside each stage over ``model`` — combined
    dp x pp x tp in one train step."""
    if devices is None:
        devices = jax.devices()
    need = n_data * n_stages * n_model
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    return Mesh(
        np.asarray(devices[:need]).reshape(n_data, n_stages, n_model),
        (DATA_AXIS, STAGE_AXIS, MODEL_AXIS),
    )


@dataclass
class PipelineMLP:
    """S pipeline stages x L layers-per-stage of width h, plus replicated
    in/out projections.  ``stage_ws``: (S, L, h, h); ``stage_bs``:
    (S, L, h); logistic hidden activations, softmax output."""

    w_in: Any    # (h, i)
    b_in: Any    # (h,)
    stage_ws: Any  # (S, L, h, h)
    stage_bs: Any  # (S, L, h)
    w_out: Any   # (o, h)
    b_out: Any   # (o,)

    @property
    def n_stages(self) -> int:
        return self.stage_ws.shape[0]

    @classmethod
    def init(cls, i: int, h: int, o: int, n_stages: int,
             layers_per_stage: int, key, scale: float = 0.5) -> "PipelineMLP":
        ks = jax.random.split(key, 4)
        return cls(
            w_in=scale * jax.random.normal(ks[0], (h, i), jnp.float32),
            b_in=jnp.zeros((h,), jnp.float32),
            stage_ws=scale / np.sqrt(h) * jax.random.normal(
                ks[1], (n_stages, layers_per_stage, h, h), jnp.float32),
            stage_bs=jnp.zeros((n_stages, layers_per_stage, h), jnp.float32),
            w_out=scale * jax.random.normal(ks[2], (o, h), jnp.float32),
            b_out=jnp.zeros((o,), jnp.float32),
        )

    def params(self):
        return (self.w_in, self.b_in, self.stage_ws, self.stage_bs,
                self.w_out, self.b_out)

    def replace_params(self, params) -> "PipelineMLP":
        return PipelineMLP(*params)


def _stage_fn(ws, bs, x):
    """One stage: L logistic ffLayers of width h.  ws: (L, h, h)."""
    L = ws.shape[0]
    h = x
    for k in range(L):
        z = lax.dot_general(h, ws[k], (((1,), (1,)), ((), ())),
                            preferred_element_type=jnp.float32) + bs[k]
        h = jax.nn.sigmoid(z)
    return h


def _stage_fn_tp(ws_local, bs_local, x):
    """Tensor-parallel stage: weights row-sharded over ``model``
    (local ws: (L, h/tp, h)), so each model shard computes its slice of
    the pre-activation; an ``all_gather`` over the model axis restores the
    full activation between layers (the simple row-parallel Megatron
    pattern; AD transposes the gather to a reduce-scatter)."""
    L = ws_local.shape[0]
    h = x  # full width, replicated across the model axis
    for k in range(L):
        z_local = lax.dot_general(h, ws_local[k], (((1,), (1,)), ((), ())),
                                  preferred_element_type=jnp.float32) + bs_local[k]
        a_local = jax.nn.sigmoid(z_local)
        h = lax.all_gather(a_local, MODEL_AXIS, axis=1, tiled=True)
    return h


def _spmd_pipeline(stage_ws, stage_bs, mb_inputs, tp: bool = False):
    """Inside shard_map over ``stage``: scan M + S - 1 ticks; stage 0
    injects microbatches, each tick's output ring-shifts to the next
    stage, the last stage collects (GPipe schedule, bubble = S - 1).
    With ``tp`` the per-stage layers are additionally tensor-parallel over
    the ``model`` axis (``_stage_fn_tp``)."""
    s = lax.axis_index(STAGE_AXIS)
    S = lax.axis_size(STAGE_AXIS)
    M = mb_inputs.shape[0]
    T = M + S - 1
    state = jnp.zeros_like(mb_inputs[0])
    outputs = jnp.zeros_like(mb_inputs)
    # shard_map hands each stage its own slice with a leading axis of 1
    ws = stage_ws[0]
    bs = stage_bs[0]
    fn = _stage_fn_tp if tp else _stage_fn

    def step(carry, t):
        state, outputs = carry
        inject = mb_inputs[jnp.minimum(t, M - 1)]
        x_in = jnp.where(s == 0, inject, state)
        y = fn(ws, bs, x_in)
        oidx = t - (S - 1)
        updated = lax.dynamic_update_index_in_dim(
            outputs, y, jnp.maximum(oidx, 0), 0)
        outputs = jnp.where((s == S - 1) & (oidx >= 0), updated, outputs)
        state = lax.ppermute(
            y, STAGE_AXIS, [(i, (i + 1) % S) for i in range(S)])
        return (state, outputs), None

    (state, outputs), _ = lax.scan(step, (state, outputs), jnp.arange(T))
    # outputs are nonzero only on the last stage; psum replicates them
    return lax.psum(outputs, STAGE_AXIS)


def _chain_forward(pipelined, M, params, xb):
    """The full embed -> pipelined body -> project -> softmax chain,
    shared by inference and the training loss so they cannot diverge."""
    w_in, b_in, stage_ws, stage_bs, w_out, b_out = params
    B = xb.shape[0]
    h = jax.nn.sigmoid(
        lax.dot_general(xb, w_in, (((1,), (1,)), ((), ())),
                        preferred_element_type=jnp.float32) + b_in)
    mb = h.reshape(M, B // M, -1)
    out = pipelined(stage_ws, stage_bs, mb).reshape(B, -1)
    z = lax.dot_general(out, w_out, (((1,), (1,)), ((), ())),
                        preferred_element_type=jnp.float32) + b_out
    return jax.nn.softmax(z, axis=-1)


_FWD_CACHE: dict = {}


def pipeline_forward(model: PipelineMLP, mesh: Mesh, xb, n_microbatches: int):
    """Batched forward through the pipeline; xb: (B, i), B divisible by
    n_microbatches.  The jitted callable is cached per (mesh, M) so
    repeated calls don't retrace."""
    key = (mesh, n_microbatches)
    fn = _FWD_CACHE.get(key)
    if fn is None:
        fn = _make_forward(mesh, n_microbatches)
        _FWD_CACHE[key] = fn
    return fn(*model.params(), xb)


def _pipeline_specs(mesh: Mesh):
    """shard_map specs: stage params over the stage axis; when the mesh
    also has a data axis the per-microbatch batch dim shards over it
    (dp x pp); when it also has a model axis the weights' output dim
    shards over it too (dp x pp x tp).  Returns
    ((ws, bs, mb) in_specs, out_spec, tp?)."""
    has_data = DATA_AXIS in mesh.axis_names
    has_model = MODEL_AXIS in mesh.axis_names
    mb_spec = PSpec(None, DATA_AXIS, None) if has_data else PSpec()
    if has_model:
        ws_spec = PSpec(STAGE_AXIS, None, MODEL_AXIS, None)
        bs_spec = PSpec(STAGE_AXIS, None, MODEL_AXIS)
    else:
        ws_spec = PSpec(STAGE_AXIS)
        bs_spec = PSpec(STAGE_AXIS)
    return (ws_spec, bs_spec, mb_spec), mb_spec, has_model


def _make_forward(mesh: Mesh, M: int) -> Callable:
    from functools import partial

    in_specs, out_spec, tp = _pipeline_specs(mesh)
    pipelined = shard_map(
        partial(_spmd_pipeline, tp=tp),
        mesh=mesh,
        in_specs=in_specs,
        out_specs=out_spec,
        check_vma=False,
    )

    @jax.jit
    def forward(w_in, b_in, stage_ws, stage_bs, w_out, b_out, xb):
        return _chain_forward(pipelined, M,
                              (w_in, b_in, stage_ws, stage_bs, w_out, b_out),
                              xb)

    return forward


def pipeline_train_step(model: PipelineMLP, mesh: Mesh, n_microbatches: int) -> Callable:
    """Jitted pipeline-parallel SGD step
    ``fn(lr, xb, yb, *params) -> (loss, new_params)`` — cross-entropy on
    the softmax output, gradients through the pipelined scan (backward is
    pipelined by AD transposition of ppermute)."""
    from functools import partial

    in_specs, out_spec, tp = _pipeline_specs(mesh)
    pipelined = shard_map(
        partial(_spmd_pipeline, tp=tp),
        mesh=mesh,
        in_specs=in_specs,
        out_specs=out_spec,
        check_vma=False,
    )
    M = n_microbatches

    def loss_fn(params, xb, yb):
        p = _chain_forward(pipelined, M, params, xb)
        return -jnp.mean(jnp.sum(yb * jnp.log(p + 1e-30), axis=-1))

    @jax.jit
    def step(lr, xb, yb, *params):
        v, grads = jax.value_and_grad(loss_fn)(tuple(params), xb, yb)
        new_params = tuple(p - lr * g for p, g in zip(params, grads))
        return v, new_params

    return step


def shard_pipeline_model(model: PipelineMLP, mesh: Mesh) -> PipelineMLP:
    """Place stage params over the stage (and model, if present) axes,
    the rest replicated."""
    if MODEL_AXIS in mesh.axis_names:
        ws_sh = NamedSharding(mesh, PSpec(STAGE_AXIS, None, MODEL_AXIS, None))
        bs_sh = NamedSharding(mesh, PSpec(STAGE_AXIS, None, MODEL_AXIS))
    else:
        ws_sh = NamedSharding(mesh, PSpec(STAGE_AXIS))
        bs_sh = NamedSharding(mesh, PSpec(STAGE_AXIS))
    repl = NamedSharding(mesh, PSpec())
    return PipelineMLP(
        jax.device_put(model.w_in, repl),
        jax.device_put(model.b_in, repl),
        jax.device_put(model.stage_ws, ws_sh),
        jax.device_put(model.stage_bs, bs_sh),
        jax.device_put(model.w_out, repl),
        jax.device_put(model.b_out, repl),
    )


# ---------------------------------------------------------------------------
# circular (interleaved) pipeline schedule
# ---------------------------------------------------------------------------


def _spmd_pipeline_circular(stage_ws, stage_bs, mb_inputs, V: int,
                            tp: bool = False):
    """Circular schedule: each device holds V round-robin chunks of the
    global stage chain (chunk c = v*S + d lives on device d as local
    chunk v), so the activation ring wraps V times and the pipeline
    bubble shrinks from (S_total-1)/T to (S-1)/T.

    Device d processes local chunk v's microbatch m at tick
    t = v*M + m + d; total ticks T = V*M + S - 1.  With M ==
    n_devices the wrapped activation arrives at device 0 exactly when
    chunk v+1 needs it; with **M > S** it arrives M-S ticks early and
    waits in a ring-buffer FIFO (the standard interleaved-schedule
    microbatch FIFO — depth M-S, one slot written and read per tick).
    With ``tp`` each chunk's layers are additionally tensor-parallel
    over the ``model`` axis (``_stage_fn_tp``; local ws: (V, L, h/tp,
    h))."""
    d = lax.axis_index(STAGE_AXIS)
    S = lax.axis_size(STAGE_AXIS)
    M = mb_inputs.shape[0]
    T = V * M + S - 1
    F = M - S  # FIFO depth: ticks a wrapped activation waits at device 0
    state = jnp.zeros_like(mb_inputs[0])
    outputs = jnp.zeros_like(mb_inputs)
    ws = stage_ws  # local: (V, L, h, h) — or (V, L, h/tp, h) under tp
    bs = stage_bs
    fn = _stage_fn_tp if tp else _stage_fn

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
            # the wrap value needed NOW entered the FIFO F ticks ago at
            # this same slot; read it before overwriting with the value
            # that just arrived off the ring (chunk output produced at
            # t-1 by device S-1, needed at t + F)
            slot = t % F
            x_wrap = lax.dynamic_index_in_dim(fifo, slot, 0, keepdims=False)
            fifo = lax.dynamic_update_index_in_dim(fifo, state, slot, 0)
        else:
            x_wrap = state
        x_in = jnp.where((d == 0) & (v == 0), inject,
                         jnp.where(d == 0, x_wrap, state))
        w_v = lax.dynamic_index_in_dim(ws, v, axis=0, keepdims=False)
        b_v = lax.dynamic_index_in_dim(bs, v, axis=0, keepdims=False)
        y = fn(w_v, b_v, x_in)
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


def _interleave_chunks(stage_arr, S: int):
    """Permute global chunks (S_total = S*V) so chunk v*S + d lands at
    sharded position d*V + v (device d's local chunk v)."""
    total = stage_arr.shape[0]
    V = total // S
    rest = stage_arr.shape[1:]
    return (stage_arr.reshape((V, S) + rest)
            .swapaxes(0, 1)
            .reshape((total,) + rest))


def shard_circular_model(model: PipelineMLP, mesh: Mesh) -> PipelineMLP:
    """Shard a PipelineMLP for the circular schedule: stage chunks are
    round-robin interleaved across devices before the stage-axis shard."""
    S = mesh.shape[STAGE_AXIS]
    if model.n_stages % S != 0:
        raise ValueError(
            f"circular pipeline needs n_stages ({model.n_stages}) divisible "
            f"by the stage-axis size ({S})")
    ws = _interleave_chunks(jnp.asarray(model.stage_ws), S)
    bs = _interleave_chunks(jnp.asarray(model.stage_bs), S)
    perm = PipelineMLP(model.w_in, model.b_in, ws, bs,
                       model.w_out, model.b_out)
    return shard_pipeline_model(perm, mesh)


def circular_pipeline_train_step(model: PipelineMLP, mesh: Mesh,
                                 n_microbatches: int) -> Callable:
    """Jitted circular-schedule SGD step; ``model`` must be sharded with
    :func:`shard_circular_model`.  ``n_microbatches`` >= the stage-axis
    size S: M == S consumes wrapped activations the tick they arrive,
    M > S buffers them in a depth-(M-S) ring FIFO (more microbatches ->
    smaller bubble (S-1)/(VM+S-1))."""
    from functools import partial

    S = mesh.shape[STAGE_AXIS]
    if n_microbatches < S:
        raise ValueError(
            f"circular schedule requires n_microbatches ({n_microbatches}) "
            f">= stage-axis size ({S}); M > S buffers the wrap in a "
            f"depth-(M-S) FIFO")
    V = model.n_stages // S
    in_specs, out_spec, tp = _pipeline_specs(mesh)
    pipelined = shard_map(
        partial(_spmd_pipeline_circular, V=V, tp=tp),
        mesh=mesh,
        in_specs=in_specs,
        out_specs=out_spec,
        check_vma=False,
    )
    M = n_microbatches

    def loss_fn(params, xb, yb):
        p = _chain_forward(pipelined, M, params, xb)
        return -jnp.mean(jnp.sum(yb * jnp.log(p + 1e-30), axis=-1))

    @jax.jit
    def step(lr, xb, yb, *params):
        v, grads = jax.value_and_grad(loss_fn)(tuple(params), xb, yb)
        new_params = tuple(p - lr * g for p, g in zip(params, grads))
        return v, new_params

    return step


_CIRC_FWD_CACHE: dict = {}


def circular_pipeline_forward(model: PipelineMLP, mesh: Mesh, xb,
                              n_microbatches: int):
    """Circular-schedule inference (see circular_pipeline_train_step).
    The jitted callable is cached per (mesh, V, M) so repeated calls
    don't retrace."""
    from functools import partial

    S = mesh.shape[STAGE_AXIS]
    V = model.n_stages // S
    key = (mesh, V, n_microbatches)
    fn = _CIRC_FWD_CACHE.get(key)
    if fn is None:
        in_specs, out_spec, tp = _pipeline_specs(mesh)
        pipelined = shard_map(
            partial(_spmd_pipeline_circular, V=V, tp=tp),
            mesh=mesh,
            in_specs=in_specs,
            out_specs=out_spec,
            check_vma=False,
        )
        M = n_microbatches

        @jax.jit
        def fwd(w_in, b_in, stage_ws, stage_bs, w_out, b_out, xb):
            return _chain_forward(
                pipelined, M, (w_in, b_in, stage_ws, stage_bs, w_out, b_out),
                xb)

        fn = fwd
        _CIRC_FWD_CACHE[key] = fn
    return fn(*model.params(), xb)
