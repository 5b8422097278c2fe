"""The staged tensor-operation IR: shape-indexed op graphs with built-in
reverse-mode AD by graph transposition.

This is the rebuild of the reference's central object ``TOp ns ms``
(``src/TensorOps/Types.hs:122-125``): an operation from a *stack* of input
tensors (tuple of shapes) to a stack of outputs, composing via ``>>`` (the
``Category`` instance, ``Types.hs:135-157``) and the arrow-ish structure
combinators ``first``/``second``/``par``/``fanout``
(``Types.hs:165-264``).  Where the reference stores each op as a pair of
opaque closures (forward + VJP) and its composition *recomputes the forward
inside every backward* (``Types.hs:151-156`` — O(depth^2) for deep chains),
here ops are explicit graph nodes evaluated once with a tape of residuals,
then transposed — O(depth), realizing the author's abandoned ``OpPipe``
staged-IR idea (``Types.hs:267-322``).

Every node validates shapes eagerly at construction (:class:`ShapeError`),
recreating the reference's type-level guarantee ("composition of mismatched
ops does not typecheck", README.md:140-142) at trace time.  Evaluation is a
pure function of input arrays, so the whole graph traces into a single
jitted XLA program (see :mod:`tensor_ops.engine`).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Optional, Sequence, Tuple

if TYPE_CHECKING:  # circular only at type-check time
    from ..backend.base import Backend
else:
    Backend = Any

from .shapes import (
    SCALAR,
    Shape,
    Stack,
    ShapeError,
    as_shape,
    as_stack,
    check_prefix,
    check_stack_eq,
    fmt_stack,
)
from .vfunc import VFunc

Arrays = Tuple[Any, ...]


class CompiledCache(dict):
    """The per-op compiled-artifact cache (jitted steps, composed loss
    graphs, serving forwards), bounded as a small LRU.

    Long-lived processes cycle many cache keys through one op object — a
    ``SequencePredictor`` sees a key per sequence length, ``fit`` a key
    per (loss, optimizer, mesh, ...) combination — and an unbounded dict
    grows monotonically, each entry pinning a jitted executable.  A hit
    refreshes recency, so hot keys never recompile; only keys untouched
    for ``maxsize`` distinct insertions fall out (eviction is always
    safe: the artifact is rebuilt from the op on the next miss).

    Reads mutate recency order, so unlike a plain dict they need a lock:
    concurrent serving threads sharing one op (two
    ``SequencePredictor.predict`` calls) would otherwise race a pop
    against a reinsert and spuriously recompile — or crash eviction's
    ``next(iter(...))`` mid-resize."""

    __slots__ = ("maxsize", "_lock")
    DEFAULT_MAXSIZE = 128

    def __init__(self, maxsize: int = DEFAULT_MAXSIZE):
        super().__init__()
        import threading

        self.maxsize = int(maxsize)
        self._lock = threading.Lock()

    def get(self, key, default=None):
        with self._lock:
            if key in self:
                val = super().pop(key)
                # refresh recency (move to end)
                super().__setitem__(key, val)
                return val
            return default

    def __setitem__(self, key, val):
        with self._lock:
            if key in self:
                super().pop(key)
            elif len(self) >= self.maxsize:
                super().pop(next(iter(self)))  # evict least-recently-used
            super().__setitem__(key, val)


class TOp:
    """A tensor operation from stack ``in_stack`` to stack ``out_stack``."""

    __slots__ = ("in_stack", "out_stack", "_compiled", "_skey")

    def __init__(self, in_stack: Stack, out_stack: Stack):
        self.in_stack: Stack = as_stack(in_stack)
        self.out_stack: Stack = as_stack(out_stack)
        self._compiled: dict = CompiledCache()

    def struct_key(self) -> tuple:
        """Structural identity: two ops with equal keys compute the same
        function, so jit caches keyed on it survive reconstruction (the
        ``fit(net, cross_entropy(o), optimizer=adam())``-in-a-loop pattern
        would otherwise recompile per call).  Node classes without a
        structural description fall back to ``id`` — cache values must
        then pin the op object so the id cannot be recycled."""
        k = getattr(self, "_skey", None)
        if k is None:
            k = (type(self).__name__,) + self._skey_parts()
            self._skey = k
        return k

    def _skey_parts(self) -> tuple:
        return ("id", id(self))

    # -- evaluation -----------------------------------------------------
    def apply(self, be: Backend, xs: Arrays) -> Arrays:
        """Forward evaluation (the reference's ``runTOp``)."""
        ys, _ = self.apply_tape(be, xs, with_tape=False)
        return ys

    def apply_tape(self, be: Backend, xs: Arrays, with_tape: bool = True):
        """Forward evaluation, returning ``(ys, tape)`` where ``tape``
        holds the residuals :meth:`transpose` needs."""
        raise NotImplementedError

    def transpose(self, be: Backend, tape: Any, cts: Arrays) -> Arrays:
        """Pull cotangents ``cts`` (one per output slot) back to input
        cotangents (the reference's ``gradTOp'``)."""
        raise NotImplementedError

    # -- combinators ----------------------------------------------------
    def __rshift__(self, other: "TOp") -> "TOp":
        return Compose(self, other)

    def then(self, other: "TOp") -> "TOp":
        """``self`` then ``other`` (Haskell ``>>>``)."""
        return Compose(self, other)

    def first(self, rest: Sequence) -> "TOp":
        """Act on a stack prefix, passing ``rest`` through unchanged
        (``firstOp``, ``Types.hs:165-182``)."""
        return First(self, rest)

    def second(self, front: Sequence) -> "TOp":
        """Act on a stack suffix (``secondOp``, ``Types.hs:184-201``)."""
        return Second(self, front)

    def par(self, other: "TOp") -> "TOp":
        """Parallel composition ``(***)`` (``Types.hs:222-240``)."""
        return Par(self, other)

    def fanout(self, other: "TOp") -> "TOp":
        """Fan-out ``(&&&)``: both ops consume the same inputs; gradient
        sums the two cotangent contributions (``Types.hs:242-264``)."""
        return Fanout(self, other)

    def lead(self, other: "TOp") -> "TOp":
        """``self *>> other``: run self on a prefix of other's inputs
        (``Types.hs:204-211``); the pass-through suffix is inferred."""
        rest = check_prefix(
            f"{self!r} *>> {other!r}", other.in_stack, self.out_stack
        )
        return First(self, rest) >> other

    def __repr__(self):
        return f"{type(self).__name__}({fmt_stack(self.in_stack)} -> {fmt_stack(self.out_stack)})"

    # -- convenience ----------------------------------------------------
    def __call__(self, be: Backend, *xs):
        ys = run(self, be, xs)  # validates arity AND array shapes
        return ys[0] if len(ys) == 1 else ys


def _check_args(op: TOp, be: Backend, xs: Arrays) -> None:
    """Validate argument count AND array shapes against the declared input
    stack.  Shapes are static even under jit tracing, so this check is
    free inside compiled code and turns deep backend errors (or silent
    broadcasts) into immediate ShapeErrors at the call site."""
    if len(xs) != len(op.in_stack):
        raise ShapeError(f"{op!r}: expected {len(op.in_stack)} args, got {len(xs)}")
    for i, (x, want) in enumerate(zip(xs, op.in_stack)):
        got = tuple(getattr(x, "shape", ()))
        if got != tuple(want):
            raise ShapeError(
                f"{op!r}: input slot {i} has shape {got}, expected {tuple(want)}"
            )


# ---------------------------------------------------------------------------
# structure nodes
# ---------------------------------------------------------------------------


class Identity(TOp):
    """``idOp`` (``Types.hs:135-138,159-163``)."""

    __slots__ = ()

    def __init__(self, stack: Sequence):
        st = as_stack(stack)
        super().__init__(st, st)

    def _skey_parts(self):
        return (self.in_stack,)

    def apply_tape(self, be, xs, with_tape=True):
        return xs, None

    def transpose(self, be, tape, cts):
        return cts


class Compose(TOp):
    """``f >>> g`` — the Category instance / chain rule
    (``Types.hs:140-157``), but with the forward evaluated once and taped
    instead of recomputed inside the backward."""

    __slots__ = ("f", "g")

    def __init__(self, f: TOp, g: TOp):
        check_stack_eq(f"compose {f!r} >> {g!r}", f.out_stack, g.in_stack)
        super().__init__(f.in_stack, g.out_stack)
        self.f = f
        self.g = g

    def _skey_parts(self):
        return (self.f.struct_key(), self.g.struct_key())

    def apply_tape(self, be, xs, with_tape=True):
        mid, tf = self.f.apply_tape(be, xs, with_tape)
        ys, tg = self.g.apply_tape(be, mid, with_tape)
        return ys, ((tf, tg) if with_tape else None)

    def transpose(self, be, tape, cts):
        tf, tg = tape
        mid_cts = self.g.transpose(be, tg, cts)
        return self.f.transpose(be, tf, mid_cts)


class First(TOp):
    """Apply ``op`` to the first ``len(op.in_stack)`` slots, pass the rest
    through (``firstOp``, ``Types.hs:165-182``)."""

    __slots__ = ("op", "rest")

    def __init__(self, op: TOp, rest: Sequence):
        self.op = op
        self.rest = as_stack(rest)
        super().__init__(op.in_stack + self.rest, op.out_stack + self.rest)

    def _skey_parts(self):
        return (self.op.struct_key(), self.rest)

    def apply_tape(self, be, xs, with_tape=True):
        k = len(self.op.in_stack)
        ys, t = self.op.apply_tape(be, xs[:k], with_tape)
        return ys + xs[k:], t

    def transpose(self, be, tape, cts):
        k = len(self.op.out_stack)
        return self.op.transpose(be, tape, cts[:k]) + cts[k:]


class Second(TOp):
    """Apply ``op`` to the trailing slots after ``front`` pass-throughs
    (``secondOp``, ``Types.hs:184-201``)."""

    __slots__ = ("op", "front")

    def __init__(self, op: TOp, front: Sequence):
        self.op = op
        self.front = as_stack(front)
        super().__init__(self.front + op.in_stack, self.front + op.out_stack)

    def _skey_parts(self):
        return (self.op.struct_key(), self.front)

    def apply_tape(self, be, xs, with_tape=True):
        k = len(self.front)
        ys, t = self.op.apply_tape(be, xs[k:], with_tape)
        return xs[:k] + ys, t

    def transpose(self, be, tape, cts):
        k = len(self.front)
        return cts[:k] + self.op.transpose(be, tape, cts[k:])


class Par(TOp):
    """``f *** g`` (``Types.hs:222-240``)."""

    __slots__ = ("f", "g")

    def __init__(self, f: TOp, g: TOp):
        super().__init__(f.in_stack + g.in_stack, f.out_stack + g.out_stack)
        self.f = f
        self.g = g

    def _skey_parts(self):
        return (self.f.struct_key(), self.g.struct_key())

    def apply_tape(self, be, xs, with_tape=True):
        k = len(self.f.in_stack)
        ys1, t1 = self.f.apply_tape(be, xs[:k], with_tape)
        ys2, t2 = self.g.apply_tape(be, xs[k:], with_tape)
        return ys1 + ys2, ((t1, t2) if with_tape else None)

    def transpose(self, be, tape, cts):
        t1, t2 = tape
        k = len(self.f.out_stack)
        return self.f.transpose(be, t1, cts[:k]) + self.g.transpose(be, t2, cts[k:])


class Fanout(TOp):
    """``f &&& g``: duplicate the input stack to both ops; the gradient is
    the elementwise *sum* of the two pulled-back cotangent stacks
    (``Types.hs:242-264``)."""

    __slots__ = ("f", "g")

    def __init__(self, f: TOp, g: TOp):
        check_stack_eq(f"fanout {f!r} &&& {g!r}", f.in_stack, g.in_stack)
        super().__init__(f.in_stack, f.out_stack + g.out_stack)
        self.f = f
        self.g = g

    def _skey_parts(self):
        return (self.f.struct_key(), self.g.struct_key())

    def apply_tape(self, be, xs, with_tape=True):
        ys1, t1 = self.f.apply_tape(be, xs, with_tape)
        ys2, t2 = self.g.apply_tape(be, xs, with_tape)
        return ys1 + ys2, ((t1, t2) if with_tape else None)

    def transpose(self, be, tape, cts):
        t1, t2 = tape
        k = len(self.f.out_stack)
        d1 = self.f.transpose(be, t1, cts[:k])
        d2 = self.g.transpose(be, t2, cts[k:])
        return tuple(
            be.sum_list([a, b], sh) for a, b, sh in zip(d1, d2, self.in_stack)
        )


class Shuffle(TOp):
    """Arbitrary reorder/duplicate/drop of the stack by input indices:
    ``out[j] = in[idxs[j]]``.  The gradient routes each cotangent back to
    its source slot, summing fan-ins and zero-filling unused inputs
    (``shuffle``, ``src/TensorOps/TOp.hs:106-131``; also covers
    ``shuffleF``/``shuffleF'``/``swap``/``swap'``/``drop``/``take``,
    ``TOp.hs:133-149,346-381``)."""

    __slots__ = ("idxs",)

    def __init__(self, in_stack: Sequence, idxs: Sequence[int]):
        st = as_stack(in_stack)
        idxs = tuple(int(i) for i in idxs)
        for i in idxs:
            if not (0 <= i < len(st)):
                raise ShapeError(
                    f"shuffle: index {i} out of range for stack {fmt_stack(st)}"
                )
        super().__init__(st, tuple(st[i] for i in idxs))
        self.idxs = idxs

    def _skey_parts(self):
        return (self.in_stack, self.idxs)

    def apply_tape(self, be, xs, with_tape=True):
        return tuple(xs[i] for i in self.idxs), None

    def transpose(self, be, tape, cts):
        outs = []
        for i, sh in enumerate(self.in_stack):
            contrib = [ct for j, ct in zip(self.idxs, cts) if j == i]
            outs.append(be.sum_list(contrib, sh))
        return tuple(outs)


# ---------------------------------------------------------------------------
# primitive nodes
# ---------------------------------------------------------------------------


class GMul(TOp):
    """Generalized contraction ``t(ms++os) x t(Reverse os++ns) -> t(ms++ns)``
    (``TO.gmul``, ``src/TensorOps/TOp.hs:56-94``).  VJPs follow the
    reference exactly:

    * ``dx = gmul lM lN lO dtdz (transp y)``
    * ``dy = gmul (Reverse lO) (Reverse lM) lN (transp x) dtdz``
    """

    __slots__ = ("ms", "os", "ns")

    def __init__(self, ms: Sequence[int], os: Sequence[int], ns: Sequence[int]):
        self.ms = as_shape(tuple(ms))
        self.os = as_shape(tuple(os))
        self.ns = as_shape(tuple(ns))
        x_shape = self.ms + self.os
        y_shape = tuple(reversed(self.os)) + self.ns
        super().__init__((x_shape, y_shape), (self.ms + self.ns,))

    def _skey_parts(self):
        return (self.ms, self.os, self.ns)

    def apply_tape(self, be, xs, with_tape=True):
        x, y = xs
        z = be.gmul(len(self.ms), len(self.os), len(self.ns), x, y)
        return (z,), ((x, y) if with_tape else None)

    def transpose(self, be, tape, cts):
        x, y = tape
        (dtdz,) = cts
        lm, lo, ln = len(self.ms), len(self.os), len(self.ns)
        dx = be.gmul(lm, ln, lo, dtdz, be.transp(y))
        dy = be.gmul(lo, lm, ln, be.transp(x), dtdz)
        return (dx, dy)


class LiftOp(TOp):
    """Pointwise lift of an n-ary scalar function over n same-shape tensors
    (``liftOp``, ``src/TensorOps/TOp.hs:42-54``); VJP via the backend's
    ``gradLift`` analog (``src/TensorOps/Tensor.hs:119-129``)."""

    __slots__ = ("vf", "shape")

    def __init__(self, vf: VFunc, shape: Sequence[int], n: Optional[int] = None):
        n = vf.n_args if n is None else n
        if n != vf.n_args:
            raise ShapeError(f"liftOp: VFunc arity {vf.n_args} != stack width {n}")
        if n < 1:
            raise ShapeError("liftOp requires >=1 input; use Konst for 0-ary")
        self.vf = vf
        self.shape = as_shape(shape)
        super().__init__((self.shape,) * n, (self.shape,))

    def _skey_parts(self):
        return (self.shape, self.vf.struct_key())

    def apply_tape(self, be, xs, with_tape=True):
        y = be.lift(self.vf, xs)
        return (y,), (xs if with_tape else None)

    def transpose(self, be, tape, cts):
        return tuple(be.lift_vjp(self.vf, tape, cts[0]))


class Transp(TOp):
    """Full index reversal; self-adjoint (``transpOp``,
    ``src/TensorOps/TOp.hs:97-104``)."""

    __slots__ = ("shape",)

    def __init__(self, shape: Sequence[int]):
        self.shape = as_shape(shape)
        super().__init__((self.shape,), (tuple(reversed(self.shape)),))

    def _skey_parts(self):
        return (self.shape,)

    def apply_tape(self, be, xs, with_tape=True):
        return (be.transp(xs[0]),), None

    def transpose(self, be, tape, cts):
        return (be.transp(cts[0]),)


class SumRows(TOp):
    """Sum over the leading axis; gradient broadcasts the cotangent to
    every row (``sumRows``, ``src/TensorOps/TOp.hs:151-159``)."""

    __slots__ = ("shape",)

    def __init__(self, shape: Sequence[int]):
        self.shape = as_shape(shape)
        if len(self.shape) < 1:
            raise ShapeError("sumRows needs rank >= 1")
        super().__init__((self.shape,), (self.shape[1:],))

    def _skey_parts(self):
        return (self.shape,)

    def apply_tape(self, be, xs, with_tape=True):
        return (be.sum_rows(xs[0]),), None

    def transpose(self, be, tape, cts):
        return (be.broadcast_to(cts[0], self.shape),)


class BroadcastRows(TOp):
    """Broadcast a tensor to ``n`` stacked rows — the adjoint of
    :class:`SumRows` (its gradient sums over the new axis; ``SumRows``'s
    gradient is exactly this op).  The batched-lowering primitive: a
    per-sample bias add becomes ``BroadcastRows`` + ``add`` on the
    batched activation, whose transpose contracts the batch axis into
    the bias gradient as one reduction instead of per-sample slices."""

    __slots__ = ("shape", "n")

    def __init__(self, shape: Sequence[int], n: int):
        self.shape = as_shape(shape)
        self.n = int(n)
        if self.n < 1:
            raise ShapeError("broadcastRows needs n >= 1")
        super().__init__((self.shape,), ((self.n,) + self.shape,))

    def _skey_parts(self):
        return (self.shape, self.n)

    def apply_tape(self, be, xs, with_tape=True):
        return (be.broadcast_to(xs[0], (self.n,) + self.shape),), None

    def transpose(self, be, tape, cts):
        return (be.sum_rows(cts[0]),)


class SumOp(TOp):
    """N-ary elementwise sum; gradient replicates the cotangent
    (``sumOp``, ``src/TensorOps/TOp.hs:161-169``; ``add``/``add3`` are the
    n=2,3 cases, ``TOp.hs:215-229``)."""

    __slots__ = ("n", "shape")

    def __init__(self, n: int, shape: Sequence[int]):
        self.n = int(n)
        self.shape = as_shape(shape)
        super().__init__((self.shape,) * self.n, (self.shape,))

    def _skey_parts(self):
        return (self.n, self.shape)

    def apply_tape(self, be, xs, with_tape=True):
        return (be.sum_list(list(xs), self.shape),), None

    def transpose(self, be, tape, cts):
        return (cts[0],) * self.n


class Scale(TOp):
    """Scalar multiple; self-adjoint up to the same scalar (``scale``,
    ``src/TensorOps/TOp.hs:171-177``)."""

    __slots__ = ("alpha", "shape")

    def __init__(self, shape: Sequence[int], alpha: float):
        self.shape = as_shape(shape)
        self.alpha = float(alpha)
        super().__init__((self.shape,), (self.shape,))

    def _skey_parts(self):
        return (self.alpha, self.shape)

    def apply_tape(self, be, xs, with_tape=True):
        return (be.scale(self.alpha, xs[0]),), None

    def transpose(self, be, tape, cts):
        return (be.scale(self.alpha, cts[0]),)


class Konst(TOp):
    """Constant tensors from nothing; the gradient drops all cotangents
    (``konst``, ``src/TensorOps/TOp.hs:185-192``)."""

    __slots__ = ("value", "shape", "n")

    def __init__(self, value: float, shape: Sequence[int], n: int = 1):
        self.value = float(value)
        self.shape = as_shape(shape)
        self.n = int(n)
        super().__init__((), (self.shape,) * self.n)

    def _skey_parts(self):
        return (self.value, self.shape, self.n)

    def apply_tape(self, be, xs, with_tape=True):
        k = be.konst(self.value, self.shape)
        return (k,) * self.n, None

    def transpose(self, be, tape, cts):
        return ()


class Replicate(TOp):
    """One tensor fanned out n times; gradient sums the cotangents
    (``replicate``, ``src/TensorOps/TOp.hs:287-293``; ``duplicate`` is
    n=2, ``TOp.hs:295-302``)."""

    __slots__ = ("n", "shape")

    def __init__(self, shape: Sequence[int], n: int):
        self.shape = as_shape(shape)
        self.n = int(n)
        super().__init__((self.shape,), (self.shape,) * self.n)

    def _skey_parts(self):
        return (self.shape, self.n)

    def apply_tape(self, be, xs, with_tape=True):
        return (xs[0],) * self.n, None

    def transpose(self, be, tape, cts):
        return (be.sum_list(list(cts), self.shape),)


class Diag(TOp):
    """Embed a vector as the diagonal of a uniform rank-k tensor (Tensor
    primitive ``diag``, ``src/TensorOps/Types.hs:85-88``)."""

    __slots__ = ("n", "k")

    def __init__(self, n: int, k: int):
        self.n, self.k = int(n), int(k)
        if self.k < 1:
            raise ShapeError("diag needs k >= 1")
        super().__init__(((self.n,),), ((self.n,) * self.k,))

    def _skey_parts(self):
        return (self.n, self.k)

    def apply_tape(self, be, xs, with_tape=True):
        return (be.diag(self.k, xs[0]),), None

    def transpose(self, be, tape, cts):
        return (be.get_diag(self.k, cts[0]),)


class GetDiag(TOp):
    """Extract the main diagonal of a uniform rank-k tensor (Tensor
    primitive ``getDiag``, ``src/TensorOps/Types.hs:89-92``)."""

    __slots__ = ("n", "k")

    def __init__(self, n: int, k: int):
        self.n, self.k = int(n), int(k)
        if self.k < 2:
            raise ShapeError("getDiag needs k >= 2")
        super().__init__(((self.n,) * self.k,), ((self.n,),))

    def _skey_parts(self):
        return (self.n, self.k)

    def apply_tape(self, be, xs, with_tape=True):
        return (be.get_diag(self.k, xs[0]),), None

    def transpose(self, be, tape, cts):
        return (be.diag(self.k, cts[0]),)


# ---------------------------------------------------------------------------
# running and differentiating
# ---------------------------------------------------------------------------


def run(op: TOp, be: Backend, xs: Sequence[Any]) -> Arrays:
    """Forward-run an op graph (``runTOp``)."""
    xs = tuple(xs)
    _check_args(op, be, xs)
    return op.apply(be, xs)


def grad(op: TOp, be: Backend, xs: Sequence[Any]) -> Arrays:
    """Gradient of a scalar-output op w.r.t. every input slot, seeding the
    cotangent with a ones scalar (``gradTOp``, ``Types.hs:127-132``)."""
    return value_and_grad(op, be, xs)[1]


def value_and_grad(op: TOp, be: Backend, xs: Sequence[Any]):
    if op.out_stack != (SCALAR,):
        raise ShapeError(
            f"grad requires a single scalar output, got {fmt_stack(op.out_stack)}"
        )
    xs = tuple(xs)
    _check_args(op, be, xs)
    ys, tape = op.apply_tape(be, xs, with_tape=True)
    seed = (be.ones(SCALAR),)
    return ys[0], op.transpose(be, tape, seed)


def vjp(op: TOp, be: Backend, xs: Sequence[Any], cts: Sequence[Any]) -> Arrays:
    """General VJP: pull arbitrary output cotangents back to the inputs
    (``gradTOp'``)."""
    xs, cts = tuple(xs), tuple(cts)
    _check_args(op, be, xs)
    if len(cts) != len(op.out_stack):
        raise ShapeError(f"{op!r}: expected {len(op.out_stack)} cotangents")
    _, tape = op.apply_tape(be, xs, with_tape=True)
    return op.transpose(be, tape, cts)
