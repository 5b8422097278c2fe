"""Device meshes and sharded training — the multi-chip story.

The reference is single-process/single-thread with zero distribution
machinery (SURVEY.md §2.5); its only hardware seam is the BLAS typeclass.
The rebuild's seam is ``jax.sharding``: pick a 2D ``(data, model)`` mesh,
annotate the batch with the ``data`` axis and the MLP's hidden dimensions
with the ``model`` axis (Megatron-style row/column alternation so the
activation stays sharded between layers), and let XLA insert the
collectives (NCCL on GPUs).  No hand-rolled communication — the design recipe of
the scaling playbook: mesh -> shardings -> XLA collectives -> profile.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as PSpec

from ..backend.base import Backend
from ..ops import ir
from ..ops.ir import TOp
from ..models.feedforward import Network

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(
    n_devices: Optional[int] = None,
    shape: Optional[Tuple[int, int]] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """A 2D ``(data, model)`` mesh.  With no explicit shape, factor the
    device count as (n // tp, tp) with tp the largest power of two <= 4
    dividing n — dp-heavy, which suits MLP workloads."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"requested {n_devices} devices but only {len(devices)} "
                f"available (for a virtual CPU mesh set JAX_PLATFORMS=cpu "
                f"XLA_FLAGS=--xla_force_host_platform_device_count="
                f"{n_devices} before backend init)"
            )
        devices = devices[:n_devices]
    n = len(devices)
    if shape is None:
        tp = 1
        for cand in (4, 2):
            if n % cand == 0 and n >= cand:
                tp = cand
                break
        shape = (n // tp, tp)
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} != device count {n}")
    dev_array = np.asarray(devices).reshape(shape)
    return Mesh(dev_array, (DATA_AXIS, MODEL_AXIS))


def place_host(host, sharding):
    """Place a host array onto a device sharding — including shardings
    spanning OTHER processes (multi-host training/resume):
    ``device_put`` only accepts fully-addressable targets, so the
    cross-process case builds the global array from this process's
    slices via ``make_array_from_callback`` (every process holds the
    full host copy, so the callback just slices it).  All processes
    must call this together with identical values."""
    if all(d.process_index == jax.process_index()
           for d in sharding.device_set):
        # fully-addressable: keep device arrays on device (no D2H
        # round-trip — shard_pipelined_params passes jnp packed rows)
        return jax.device_put(host, sharding)
    host = np.asarray(host)
    return jax.make_array_from_callback(
        host.shape, sharding, lambda idx: host[idx])


def param_specs(param_stack: Sequence[Tuple[int, ...]], mesh: Mesh) -> Tuple[PSpec, ...]:
    """Megatron-style specs for an alternating ffLayer chain: layer-k
    weight ``(o, i)`` *prefers* row-parallel (``o`` over model) for even k
    and column-parallel (``i`` over model) for odd k; when the preferred
    dim is not divisible by the model-axis size the *other* dim is sharded
    instead (XLA requires divisibility, so e.g. the flagship's (10, 100)
    output layer under tp=4 shards its 100-dim input side).  Only when
    NEITHER dim divides is the weight replicated — with a loud warning,
    never silently.  Biases follow their weight's output sharding."""
    tp = mesh.shape[MODEL_AXIS]
    specs = []
    layer = 0
    for shape in param_stack:
        if len(shape) == 2:
            prefer_row = layer % 2 == 0
            row_ok = shape[0] % tp == 0
            col_ok = shape[1] % tp == 0
            if (prefer_row and row_ok) or (row_ok and not col_ok):
                specs.append(PSpec(MODEL_AXIS, None))
            elif col_ok:
                specs.append(PSpec(None, MODEL_AXIS))
            else:
                import warnings

                warnings.warn(
                    f"tensor parallelism: weight {shape} has no dim "
                    f"divisible by the model-axis size {tp}; replicating "
                    f"it (pad the layer width to a multiple of {tp} to "
                    f"shard it)",
                    stacklevel=2,
                )
                specs.append(PSpec(None, None))
            layer += 1
        elif len(shape) == 1:
            # bias: sharded iff its matching (row-parallel) weight was
            prev = specs[-1] if specs else PSpec()
            if (
                len(prev) >= 1
                and prev[0] == MODEL_AXIS
                and shape[0] % tp == 0
            ):
                specs.append(PSpec(MODEL_AXIS))
            else:
                specs.append(PSpec(None))
        else:
            specs.append(PSpec(*([None] * len(shape))))
    return tuple(specs)


def batch_spec() -> PSpec:
    return PSpec(DATA_AXIS, None)


def _data_extended_sharding(x, mesh: Mesh, dp: int):
    """The shared ZeRO dim-choice rule: extend an array leaf's inherited
    sharding spec by the ``data`` axis on the FIRST spec-free dimension
    the dp size divides.  Returns a ``NamedSharding`` or ``None`` (leave
    untouched — scalars, non-divisible leaves, leaves already sharded
    over ``data``).  ZeRO-1 applies it to optimizer moments and ZeRO-2
    additionally to the mean gradients; using ONE rule guarantees the
    gradient shards and the moment shards coincide dimension-for-
    dimension, so the sharded optimizer update is collective-free."""
    if (dp <= 1 or not isinstance(x, jax.Array) or x.ndim == 0
            or x.size == 0):
        return None
    if isinstance(x.sharding, NamedSharding):
        spec = list(x.sharding.spec)
    else:
        spec = []
    spec += [None] * (x.ndim - len(spec))
    used = set()
    for s in spec:
        if isinstance(s, str):
            used.add(s)
        elif isinstance(s, (tuple, list)):
            used.update(s)
    if DATA_AXIS in used:
        return None
    for ax in range(x.ndim):
        if spec[ax] is None and x.shape[ax] % dp == 0:
            spec[ax] = DATA_AXIS
            return NamedSharding(mesh, PSpec(*spec))
    return None


def zero1_shardings(opt_state, mesh: Mesh):
    """ZeRO-1 shardings for an optimizer-state pytree: each array leaf's
    INHERITED sharding (moments are built by ``opt.init`` as ``p * 0``,
    so they carry their param's spec) extended by the ``data`` axis on
    the first spec-free dimension the dp size divides — optimizer
    memory drops to 1/dp per device, and the param update's all-gather
    comes from XLA's sharding propagation alone (the megatron-paper
    observation that dp replicas waste optimizer memory, solved with an
    annotation, not a hand-rolled partition).

    Returns ``(flat_shardings, treedef)``: one ``NamedSharding`` or
    ``None`` (leave untouched — scalars, non-divisible leaves, leaves
    already sharded over ``data``) per flattened leaf."""
    flat, treedef = jax.tree.flatten(opt_state)
    dp = dict(mesh.shape).get(DATA_AXIS, 1)
    shs = [_data_extended_sharding(x, mesh, dp) for x in flat]
    return shs, treedef


def zero1_place(opt_state, mesh: Mesh):
    """Place an optimizer-state pytree with ZeRO-1 shardings
    (:func:`zero1_shardings`) and return ``(placed_state,
    constrain_fn)``.  ``constrain_fn`` pins the same shardings on the
    UPDATED state inside a jitted step (``with_sharding_constraint``),
    so XLA never silently re-replicates the moments between steps;
    it is ``None`` when nothing sharded (no data axis, dp == 1, or no
    divisible leaf) — the caller treats that as a loud no-op."""
    shs, treedef = zero1_shardings(opt_state, mesh)
    if not any(sh is not None for sh in shs):
        return opt_state, None
    flat = jax.tree.leaves(opt_state)
    placed = [x if sh is None else _reshard_leaf(x, sh)
              for x, sh in zip(flat, shs)]
    state = jax.tree.unflatten(treedef, placed)

    def constrain(new_state):
        leaves, td = jax.tree.flatten(new_state)
        if len(leaves) != len(shs):
            raise ValueError(
                f"optimizer state changed structure across the update "
                f"({len(shs)} leaves at init, {len(leaves)} after) — "
                f"shard_opt_state requires a structure-stable optimizer")
        leaves = [x if sh is None
                  else jax.lax.with_sharding_constraint(x, sh)
                  for x, sh in zip(leaves, shs)]
        return jax.tree.unflatten(td, leaves)

    return state, constrain


def zero2_grad_shardings(leaves, mesh: Mesh):
    """ZeRO-2 gradient shardings: for each PLACED training leaf (param,
    or state+param for the recurrent loop), its sharding spec extended
    by the ``data`` axis under the same dim-choice rule as the ZeRO-1
    moments (:func:`_data_extended_sharding`) — so inside the jitted
    step XLA lowers the batch-gradient reduction to a REDUCE-SCATTER
    (each dp rank materializes only its 1/dp gradient shard) instead of
    an all-reduce, and the sharded moments update collective-free
    against their matching gradient shards.  The param update's
    all-gather is inserted by XLA where the (data-replicated) params
    meet their sharded update term.  Returns one ``NamedSharding`` or
    ``None`` per leaf."""
    dp = dict(mesh.shape).get(DATA_AXIS, 1)
    return tuple(_data_extended_sharding(x, mesh, dp) for x in leaves)


def zero2_grad_constrain(leaves, mesh: Mesh):
    """A function pinning ZeRO-2 gradient shardings
    (:func:`zero2_grad_shardings`, built from the placed ``leaves``)
    on a same-structure gradient tuple INSIDE a jitted step — or
    ``None`` when nothing can shard (no data axis, dp == 1, or no
    divisible dimension), which callers must treat as a loud no-op."""
    shs = zero2_grad_shardings(leaves, mesh)
    return pin_shardings(shs, what="zero_stage=2 gradient shards")


def pin_shardings(shs, what: str = "leaves"):
    """A function pinning a same-length leaf tuple to ``shs`` (one
    ``NamedSharding`` or ``None`` per leaf — ``None`` leaves untouched)
    inside a jitted step, or ``None`` when there is nothing to pin.
    The generic form of :func:`zero2_grad_constrain`, used by the
    ZeRO-3 param/gradient pins."""
    shs = tuple(shs)
    if not any(sh is not None for sh in shs):
        return None

    def constrain(leaves):
        if len(leaves) != len(shs):
            raise ValueError(
                f"{what}: expected {len(shs)} leaves, got {len(leaves)}")
        return tuple(x if sh is None
                     else jax.lax.with_sharding_constraint(x, sh)
                     for x, sh in zip(leaves, shs))

    return constrain


def pin_inherited(tree, what: str = "optimizer state"):
    """A function pinning every array leaf of a same-structure pytree to
    the sharding it holds NOW, or ``None`` when no leaf carries a
    ``NamedSharding``.  Used for the ZeRO-3 optimizer state: moments
    built by ``opt.init`` on data-sharded params INHERIT the extended
    shardings, so there is nothing to extend — only to keep (without
    the in-step pin XLA may re-replicate the updated moments)."""
    flat, _ = jax.tree.flatten(tree)
    shs = [x.sharding if isinstance(x, jax.Array)
           and isinstance(x.sharding, NamedSharding) else None
           for x in flat]
    if not any(sh is not None for sh in shs):
        return None

    def constrain(new):
        leaves, td = jax.tree.flatten(new)
        if len(leaves) != len(shs):
            raise ValueError(
                f"{what} changed structure across the update "
                f"({len(shs)} leaves at init, {len(leaves)} after)")
        leaves = [x if sh is None
                  else jax.lax.with_sharding_constraint(x, sh)
                  for x, sh in zip(leaves, shs)]
        return jax.tree.unflatten(td, leaves)

    return constrain


def zero3_param_place(leaves, mesh: Mesh):
    """ZeRO-3 parameter sharding: each PLACED training leaf's sharding
    extended by the ``data`` axis under the same dim-choice rule as the
    ZeRO-1 moments and ZeRO-2 gradients (:func:`_data_extended_sharding`)
    — between steps every dp rank holds only its 1/dp shard of each
    divisible param.  Inside the jitted step the params are gathered AT
    USE (``unshard``: a ``with_sharding_constraint`` back to the leaf's
    original spec — XLA inserts the all-gather where the sharded master
    meets it), the forward/backward runs on the gathered copy, gradients
    reduce-scatter onto the SAME shards (pin ``shardings`` on them with
    :func:`pin_shardings`), and the optimizer update is collective-free
    shard-local math — the full ZeRO ladder (one all-gather in, one
    reduce-scatter out, 1/dp params+grads+moments resident).

    Returns ``(placed, unshard_fn, constrain_fn, shardings)``:
    ``placed`` the resharded leaves, ``unshard_fn`` the gather-at-use
    pin (on the ORIGINAL specs), ``constrain_fn`` the keep-sharded pin
    for the UPDATED leaves (both for inside the jitted step), and
    ``shardings`` the extended ``NamedSharding``-or-``None`` per leaf
    (also the correct gradient shardings — gradient shard and param
    shard must coincide leaf-for-leaf).  When nothing can shard (no
    data axis, dp == 1, no divisible dim) the leaves come back
    untouched with both fns ``None`` — callers treat that as a loud
    no-op, never a silent one."""
    flat = tuple(leaves)
    dp = dict(mesh.shape).get(DATA_AXIS, 1)
    shs = tuple(_data_extended_sharding(x, mesh, dp) for x in flat)
    if not any(sh is not None for sh in shs):
        return flat, None, None, shs
    orig = tuple(
        None if sh is None
        else (x.sharding if isinstance(x.sharding, NamedSharding)
              else NamedSharding(mesh, PSpec()))
        for x, sh in zip(flat, shs))
    placed = tuple(x if sh is None else _reshard_leaf(x, sh)
                   for x, sh in zip(flat, shs))
    unshard = pin_shardings(orig, what="zero_stage=3 gathered params")
    constrain = pin_shardings(shs, what="zero_stage=3 param shards")
    return placed, unshard, constrain, shs


def _reshard_leaf(x, sh: NamedSharding):
    """Reshard one array onto ``sh`` — ``device_put`` when the target is
    fully addressable, a compiled identity otherwise (multi-host: all
    processes call together, exactly like :func:`place_host`, but the
    source here is a committed device array rather than host numpy)."""
    if all(d.process_index == jax.process_index() for d in sh.device_set):
        return jax.device_put(x, sh)
    return jax.jit(lambda a: a, out_shardings=sh)(x)


def shard_network(net: Network, mesh: Mesh) -> Network:
    """Device-put the parameters with their mesh shardings."""
    specs = param_specs(net.param_stack, mesh)
    params = tuple(
        jax.device_put(p, NamedSharding(mesh, s)) for p, s in zip(net.params, specs)
    )
    return Network(net.op, params, net.act_names)


def shard_fused(fm, mesh: Mesh):
    """Tensor-parallel SERVING: place a FusedMLP's weights with the
    Megatron alternating specs over the mesh's ``model`` axis and return
    the re-built model.  Nothing else changes — the weights are jit
    ARGUMENTS in every forward path, so XLA propagates the shardings and
    inserts the activation all-gathers/reduces by itself (the designed
    no-hand-written-collectives seam).  Use when one model's weights
    exceed one device's memory."""
    from ..models.fast import FusedMLP

    stack = []
    for w, b in zip(fm.weights, fm.biases):
        stack += [tuple(w.shape), tuple(b.shape)]
    specs = param_specs(tuple(stack), mesh)
    ws, bs = [], []
    for k, (w, b) in enumerate(zip(fm.weights, fm.biases)):
        ws.append(jax.device_put(w, NamedSharding(mesh, specs[2 * k])))
        bs.append(jax.device_put(b, NamedSharding(mesh, specs[2 * k + 1])))
    return FusedMLP(tuple(ws), tuple(bs), fm.acts, fm.softmax_out,
                    fm.precision, fm.loss_kind)


def sharded_train_step(
    net: Network, loss: TOp, be: Backend, mesh: Mesh
) -> Callable:
    """Jitted multi-chip minibatch SGD step
    ``fn(rate, xb, yb, *params) -> (mean_loss, new_params)``.

    The per-sample staged graph (framework transposition AD) is vmapped
    over the batch; the batch is sharded over the ``data`` axis and params
    over the ``model`` axis, so XLA emits psum-style gradient reductions
    from the shardings alone."""
    from ..models.training import make_vmapped_grads

    vmapped = make_vmapped_grads(net, loss, be)

    def step(rate, xb, yb, *params):
        import jax.numpy as jnp

        vals, grads = vmapped(xb, yb, *params)
        new_params = tuple(
            p - rate * jnp.mean(g, axis=0) for p, g in zip(params, grads)
        )
        return jnp.mean(vals), new_params

    pspecs = param_specs(net.param_stack, mesh)
    param_sh = tuple(NamedSharding(mesh, s) for s in pspecs)
    data_sh = NamedSharding(mesh, batch_spec())
    repl = NamedSharding(mesh, PSpec())
    return jax.jit(
        step,
        in_shardings=(repl, data_sh, data_sh) + param_sh,
        out_shardings=(repl, param_sh),
    )


def sharded_forward(net: Network, be: Backend, mesh: Mesh) -> Callable:
    """Jitted multi-chip batched inference ``fn(xb, *params) -> yb``."""

    def single(x, *params):
        return net.op.apply(be, (x,) + params)[0]

    fwd = jax.vmap(single, in_axes=(0,) + (None,) * len(net.params))
    pspecs = param_specs(net.param_stack, mesh)
    param_sh = tuple(NamedSharding(mesh, s) for s in pspecs)
    data_sh = NamedSharding(mesh, batch_spec())
    return jax.jit(fwd, in_shardings=(data_sh,) + param_sh, out_shardings=data_sh)
