"""Serving: a warm, latency-tracked predictor over trained networks.

The reference has no inference story beyond calling ``runNetwork`` in a
loop; for production serving this wraps a Network (staged-IR path), a
FusedMLP or its int8 QuantizedMLP with shape-bucketed jitted forwards,
explicit warmup, and latency statistics.
"""

from __future__ import annotations

import bisect
from typing import Any, Optional, Sequence, Union

import numpy as np

from ..backend.base import Backend
from ..utils.profiling import StepTimer
from .fast import FusedMLP, QuantizedMLP
from .feedforward import Network
from .training import batched_run


def _bucket_of(buckets, n: int) -> int:
    """Pad target for a batch of n rows: the next bucket, or beyond the
    largest bucket the next multiple of it (so jit specializations stay
    bounded instead of one per request size)."""
    i = bisect.bisect_left(buckets, n)
    if i < len(buckets):
        return buckets[i]
    top = buckets[-1]
    return ((n + top - 1) // top) * top


class Predictor:
    """Batched prediction with shape bucketing (pad to the next bucket so
    jit compiles once per bucket, not once per request size).

    Accepts a staged-IR ``Network`` (+backend), a ``FusedMLP``, or a
    ``QuantizedMLP`` (int8 serving: a quarter of the f32 weight bytes,
    for deployments bound by weight streaming)."""

    def __init__(
        self,
        model: Union[Network, FusedMLP, QuantizedMLP],
        be: Optional[Backend] = None,
        buckets: Sequence[int] = (1, 8, 32, 128, 512),
        dtype: Optional[str] = None,
    ):
        if dtype is not None:
            # storage-dtype knob (FusedMLP only): "bf16" halves the
            # weight bytes in device memory; int8 via QuantizedMLP
            if not isinstance(model, FusedMLP):
                raise ValueError(
                    "dtype= applies to FusedMLP models (use QuantizedMLP "
                    "for int8; Network predictors follow their backend)")
            import jax.numpy as jnp

            table = {"bf16": jnp.bfloat16, "f32": jnp.float32}
            if dtype not in table:
                raise ValueError(f"dtype must be one of {sorted(table)}")
            model = model.astype(table[dtype])
        self.buckets = sorted(buckets)
        self._dtype = dtype  # remembered so reload() keeps the knob
        self.timer = StepTimer()
        if isinstance(model, Network) and be is None:
            raise ValueError("Network predictor needs a backend")
        # ONE attribute holds everything a request routes on (the
        # backend included — a Network swapped in via reload(be=...)
        # must arrive together with its backend), so a reload() swap is
        # a single atomic assignment — a concurrent request can never
        # see the new model with the old backend
        self._serving = (model, be)

    @property
    def model(self):
        return self._serving[0]

    @property
    def be(self) -> Optional[Backend]:
        return self._serving[1]

    def _bucket(self, n: int) -> int:
        return _bucket_of(self.buckets, n)

    def _forward(self, xb):
        model, be = self._serving  # one consistent read
        if isinstance(model, (FusedMLP, QuantizedMLP)):
            return model.run(xb)
        fn = batched_run(model, be)
        return fn(xb, *model.params)

    def warmup(self) -> None:
        """Compile every bucket ahead of serving."""
        i = self._in_width()
        for b in self.buckets:
            x = np.zeros((b, i), dtype=np.float32)
            np.asarray(self._forward(self._as(x)))

    def _as(self, x):
        if isinstance(self.model, (FusedMLP, QuantizedMLP)):
            import jax.numpy as jnp

            return jnp.asarray(x, dtype=jnp.float32)
        return self.be.asarray(x)

    def predict(self, x: Any) -> np.ndarray:
        """Class probabilities for a batch (any leading size)."""
        x = np.asarray(x, dtype=np.float32)
        squeeze = x.ndim == 1
        if squeeze:
            x = x[None]
        n = x.shape[0]
        b = self._bucket(n)
        if b != n:
            x = np.pad(x, ((0, b - n), (0, 0)))
        self.timer.start()
        out = np.asarray(self._forward(self._as(x)))
        self.timer.stop()
        out = out[:n]
        return out[0] if squeeze else out

    def predict_class(self, x: Any) -> np.ndarray:
        p = self.predict(x)
        return np.argmax(p, axis=-1)

    def latency(self) -> dict:
        return self.timer.summary()

    _KEEP = object()  # reload sentinel: inherit this predictor's knob

    def reload(self, model, dtype=_KEEP, be: Optional[Backend] = None
               ) -> None:
        """Zero-downtime model swap (the rolling-update primitive): the
        replacement's forward is built and WARMED for every bucket
        BEFORE the switch — blue/green inside the process, so no
        request ever waits on a compile — then the serving state swaps
        in ONE atomic assignment (a concurrent request sees wholly-old
        or wholly-new, never a torn mix).  The replacement must serve
        the same interface (input AND output widths); kind may change
        (e.g. a FusedMLP replaced by its int8 QuantizedMLP, or a
        Network — pass ``be=`` if this predictor has none).  ``dtype``
        defaults to the knob this predictor was built with (a bf16
        capacity deployment stays bf16 across reloads); pass None or
        another value to change it.  Latency stats continue across the
        swap."""
        explicit_dtype = dtype is not Predictor._KEEP
        # the remembered knob tracks the last EXPLICIT choice, so the
        # next default reload inherits what the operator last asked for
        remembered = dtype if explicit_dtype else self._dtype
        if not explicit_dtype:
            dtype = self._dtype
        if not isinstance(model, FusedMLP) and not explicit_dtype:
            # the dtype knob is FusedMLP-only; an INHERITED knob must not
            # trip that validation when the replacement is a Network
            # (backend-governed dtype) or a QuantizedMLP (int8 storage) —
            # e.g. a bf16 deployment hot-swapping in its int8 quantization.
            # The remembered knob survives: a later FusedMLP reload goes
            # back to bf16 storage without the operator re-asking.
            dtype = None
        new = Predictor(model, be=be or self.be, buckets=self.buckets,
                        dtype=dtype)
        for what, old_w, new_w in (
                ("input", self._in_width(), new._in_width()),
                ("output", self._out_width(), new._out_width())):
            if old_w != new_w:
                raise ValueError(
                    f"reload would change the serving interface: "
                    f"current model's {what} width is {old_w}, the "
                    f"replacement's is {new_w} — deploy a new Predictor "
                    f"instead")
        new.warmup()  # compile every bucket before anyone sees it
        self._dtype = remembered
        self._serving = new._serving  # the one atomic switch

    def _in_width(self) -> int:
        if isinstance(self.model, QuantizedMLP):
            return self.model.wqs[0].shape[1]
        if isinstance(self.model, FusedMLP):
            return self.model.weights[0].shape[1]
        return self.model.in_shape[0]

    def _out_width(self) -> int:
        if isinstance(self.model, QuantizedMLP):
            return self.model.wqs[-1].shape[0]
        if isinstance(self.model, FusedMLP):
            return self.model.weights[-1].shape[0]
        return self.model.out_shape[0]


class SequencePredictor:
    """Serving for the recurrent family: batched whole-sequence
    prediction with shape bucketing on the BATCH axis (sequence length
    is part of the compiled program; one jit specialization per (bucket,
    length) pair).

    Stateless per request: every sequence starts from the network's
    stored initial states — the deployment analog of the reference's
    per-sequence ``runNetwork`` fold — and runs as ONE compiled scan
    per batch (`RecurrentNetwork.run_seq` vmapped over the batch).
    At the default matmul precision (TF32 on the H100) the batched
    matmuls may differ from single-sequence evaluation; exact agreement
    needs ``JaxBackend(precision="highest")``."""

    def __init__(self, rnet, be: Backend, buckets: Sequence[int] = (1, 8, 32)):
        # one tuple, swapped atomically by reload() — a request racing a
        # swap sees wholly-old or wholly-new (network, backend)
        self._serving = (rnet, be)
        self.buckets = sorted(buckets)
        self.timer = StepTimer()
        self._warmed: set = set()  # lengths warmup compiled (for reload)

    @property
    def rnet(self):
        return self._serving[0]

    @property
    def be(self) -> Backend:
        return self._serving[1]

    def _forward_fn(self, n: int):
        from .recurrent import seq_scan_op

        rnet, be = self._serving  # capture locals, not self: the
        # op._compiled cache must not pin predictors (nor their timers)
        k = len(rnet.states)
        key = ("serve_seq", n) + be.cache_key()
        fn = rnet.op._compiled.get(key)
        if fn is None:
            scan = seq_scan_op(rnet.op, n, k)
            from ..ops import ir as _ir

            if be.name == "jax":
                import jax

                def one(xs, *sp):
                    return _ir.run(scan, be, (xs,) + sp)[0]

                nsp = k + len(rnet.params)
                fn = jax.jit(jax.vmap(one, in_axes=(0,) + (None,) * nsp))
            else:

                def fn(xb, *sp):
                    return np.stack([
                        np.asarray(_ir.run(scan, be, (x,) + sp)[0])
                        for x in xb])

            rnet.op._compiled[key] = fn
        return fn

    def warmup(self, lengths: Sequence[int]) -> None:
        """Compile every (bucket, length) pair ahead of serving, so the
        first production request doesn't pay trace+compile inside the
        timed region (matches ``Predictor.warmup``; sequence length is
        part of the compiled program, so it must be supplied)."""
        rnet, be = self._serving
        in_shape = tuple(rnet.in_shape)
        for n in lengths:
            fn = self._forward_fn(int(n))
            for b in self.buckets:
                x = be.asarray(
                    np.zeros((b, int(n)) + in_shape, np.float32))
                np.asarray(fn(x, *rnet.states, *rnet.params))
            self._warmed.add(int(n))

    def predict(self, xs: Any) -> np.ndarray:
        """``(B, n, *in_shape)`` sequences -> ``(B, n, *out_shape)``
        outputs (a single ``(n, *in_shape)`` sequence is auto-batched)."""
        rnet, be = self._serving  # one consistent read per request
        xs = np.asarray(xs, dtype=np.float32)
        squeeze = xs.ndim == len(rnet.in_shape) + 1
        if squeeze:
            xs = xs[None]
        B = xs.shape[0]
        # bucketing amortizes jit specializations; the numpy fallback is
        # a plain loop, so padding there would just scan zeros
        b = _bucket_of(self.buckets, B) if be.name == "jax" else B
        if b != B:
            xs = np.pad(xs, ((0, b - B),) + ((0, 0),) * (xs.ndim - 1))
        fn = self._forward_fn(int(xs.shape[1]))
        self.timer.start()
        out = np.asarray(fn(be.asarray(xs), *rnet.states, *rnet.params))
        self.timer.stop()
        out = out[:B]
        return out[0] if squeeze else out

    def latency(self) -> dict:
        return self.timer.summary()

    def reload(self, rnet, be: Optional[Backend] = None,
               warm_lengths: Optional[Sequence[int]] = None) -> None:
        """Zero-downtime recurrent model swap (``Predictor.reload``'s
        semantics): the replacement is compiled and warmed for every
        previously-warmed sequence length plus any extra
        ``warm_lengths``, for every bucket, BEFORE the (rnet, be) pair
        swaps in one atomic assignment.  The replacement must serve the
        same interface (in/out shapes)."""
        be = be or self.be
        for what, old_s, new_s in (
                ("input", tuple(self.rnet.in_shape), tuple(rnet.in_shape)),
                ("output", tuple(self.rnet.out_shape),
                 tuple(rnet.out_shape))):
            if old_s != new_s:
                raise ValueError(
                    f"reload would change the serving interface: "
                    f"current model's {what} shape is {old_s}, the "
                    f"replacement's is {new_s} — deploy a new "
                    f"SequencePredictor instead")
        # warm the UNION of previously-warmed lengths and any extras the
        # caller names — every length that was warm stays warm across the
        # swap, so _warmed never overstates what is actually compiled
        lengths = sorted(self._warmed
                         | set(int(n) for n in (warm_lengths or ())))
        staging = SequencePredictor(rnet, be, buckets=self.buckets)
        staging.warmup(lengths)  # compile before anyone sees it
        self._warmed = set(lengths)
        self._serving = (rnet, be)  # the one atomic switch
