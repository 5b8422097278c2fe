"""FusedMLP: ffLayer chains as plain XLA programs, and their int8 serving
form.

Bridges the staged-IR :class:`~tensor_ops.models.feedforward.Network`
(built by ``gen_net`` with the reference's exact composition) to a direct
``jax.numpy`` executor: each layer is ``act(h @ w.T + b)``, which XLA
compiles to a GEMM with the bias and activation fused into its epilogue,
and the training step (softmax + cross-entropy + SGD update) is one jitted
program differentiated by ``jax.grad``.  Numerics parity with the IR path
is tested at ``precision="highest"``; ``"default"`` lets XLA pick the
matmul precision (TF32 on the H100).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ..ops import int8
from .feedforward import Network


def _logistic(z):
    return 1.0 / (1.0 + jnp.exp(-z))


def _relu(z):
    return jnp.maximum(z, 0.0)


def _identity(z):
    return z


#: Elementwise activations by name.
ACTS = {"logistic": _logistic, "relu": _relu, "tanh": jnp.tanh,
        "identity": _identity}

_PRECISION = {"default": lax.Precision.DEFAULT,
              "highest": lax.Precision.HIGHEST}


def act_fn(name: str) -> Callable:
    try:
        return ACTS[name]
    except KeyError:
        raise ValueError(f"unknown activation {name!r}") from None


@dataclass
class FusedMLP:
    """weights[k]: (o_k, i_k) — the reference ffLayer layout; acts[k] in
    {logistic, relu, tanh, identity}; final softmax applied in-graph."""

    weights: Tuple[Any, ...]
    biases: Tuple[Any, ...]
    acts: Tuple[str, ...]
    softmax_out: bool = True
    precision: str = "default"
    loss_kind: str = "ce"  # "ce" (cross-entropy) or "mse" (squared error)

    _cache: dict = None

    def __post_init__(self):
        self.weights = tuple(jnp.asarray(w) for w in self.weights)
        self.biases = tuple(jnp.asarray(b) for b in self.biases)
        self.acts = tuple(self.acts)
        if self._cache is None:
            object.__setattr__(self, "_cache", {})

    # -- conversion ------------------------------------------------------
    @classmethod
    def from_network(cls, net: Network, acts: Optional[Sequence[str]] = None,
                     softmax_out: Optional[bool] = None,
                     precision: str = "default") -> "FusedMLP":
        """From a gen_net-built Network: params alternate (w, b) per layer
        (``ff_layer``; the softmax layer contributes no params).  When the
        Network carries ``act_names`` (set by gen_net) the activations
        are inferred: a softmax output layer sets ``softmax_out``,
        elementwise names pass through."""
        if acts is None:
            if net.act_names is None:
                raise ValueError("acts not given and net has no act_names")
            names = list(net.act_names)
            if softmax_out is None:
                softmax_out = names[-1] == "softmax"
            if names[-1] == "softmax":
                names[-1] = "identity"
            acts = names
        if softmax_out is None:
            softmax_out = True
        ps = net.params
        ws = tuple(ps[i] for i in range(0, len(ps), 2))
        bs = tuple(ps[i] for i in range(1, len(ps), 2))
        return cls(ws, bs, tuple(acts), softmax_out, precision)

    def astype(self, dtype) -> "FusedMLP":
        """Serving-precision variant: weights/biases stored in ``dtype``
        (e.g. ``jnp.bfloat16`` — half the weight bytes in device memory;
        int8 (``QuantizedMLP``) is the quarter).  Activations still
        compute in f32 at the model's ``precision``."""
        ws = tuple(w.astype(dtype) for w in self.weights)
        bs = tuple(b.astype(dtype) for b in self.biases)
        return FusedMLP(ws, bs, self.acts, self.softmax_out,
                        self.precision, self.loss_kind)

    def to_params(self) -> Tuple[Any, ...]:
        out: List[Any] = []
        for w, b in zip(self.weights, self.biases):
            out += [w, b]
        return tuple(out)

    # -- forward -----------------------------------------------------------
    def _layers_forward(self, x, weights, biases):
        prec = _PRECISION[self.precision]
        h = x
        n = len(weights)
        for k in range(n):
            z = jnp.matmul(h, weights[k].T, precision=prec) + biases[k]
            if k == n - 1 and self.softmax_out:
                h = jax.nn.softmax(z, axis=-1)
            else:
                h = act_fn(self.acts[k])(z)
        return h

    def forward_fn(self) -> Callable:
        """Jitted forward (differentiable)."""
        fn = self._cache.get("fwd")
        if fn is None:
            fn = jax.jit(lambda x, ws, bs: self._layers_forward(x, ws, bs))
            self._cache["fwd"] = fn
        return fn

    def run(self, x) -> Any:
        return self.forward_fn()(x, self.weights, self.biases)

    # -- training -----------------------------------------------------------
    def _loss(self, x, y, weights, biases):
        p = self._layers_forward(x, weights, biases)
        if self.loss_kind == "mse":
            return jnp.mean(jnp.sum((y - p) ** 2, axis=-1))
        eps = jnp.asarray(1e-30, p.dtype)  # match crossEntropy = -<log p, y>
        return -jnp.mean(jnp.sum(y * jnp.log(p + eps), axis=-1))

    def step_fn(self) -> Callable:
        """Jitted fused minibatch SGD step
        ``fn(rate, xb, yb, ws, bs) -> (loss, ws', bs')``."""
        fn = self._cache.get("step")
        if fn is None:

            def step(rate, xb, yb, ws, bs):
                v, (gw, gb) = jax.value_and_grad(
                    lambda ws, bs: self._loss(xb, yb, ws, bs), argnums=(0, 1)
                )(ws, bs)
                ws = tuple(w - rate * g for w, g in zip(ws, gw))
                bs = tuple(b - rate * g for b, g in zip(bs, gb))
                return v, ws, bs

            fn = jax.jit(step)
            self._cache["step"] = fn
        return fn

    def train(self, rate: float, xb, yb) -> Tuple[float, "FusedMLP"]:
        v, ws, bs = self.step_fn()(rate, xb, yb, self.weights, self.biases)
        m = FusedMLP(ws, bs, self.acts, self.softmax_out, self.precision,
                     self.loss_kind, self._cache)
        return v, m


@dataclass
class FusedAutoencoder:
    """Fused autoencoder: the encoder>>decoder ffLayer chain as one
    FusedMLP trained on reconstruction (target = input, squared error)
    — the direct executor for ``Encoder``/``trainEncoder``
    (``AutoEncoder.hs:87-110``).

    ``n_enc`` records where the encoder's layer stack ends so the model
    converts back to the staged-IR ``Encoder`` for parity checks."""

    mlp: FusedMLP
    n_enc: int

    @classmethod
    def from_encoder(cls, enc, precision: str = "default"
                     ) -> "FusedAutoencoder":
        fe = FusedMLP.from_network(enc.encoder, softmax_out=False,
                                   precision=precision)
        fd = FusedMLP.from_network(enc.decoder, softmax_out=False,
                                   precision=precision)
        mlp = FusedMLP(fe.weights + fd.weights, fe.biases + fd.biases,
                       fe.acts + fd.acts, softmax_out=False,
                       precision=precision, loss_kind="mse")
        return cls(mlp, len(fe.weights))

    def to_encoder(self, enc):
        """Write trained params back into a template staged-IR Encoder."""
        ps = self.mlp.to_params()
        ne = 2 * self.n_enc
        return type(enc)(
            Network(enc.encoder.op, ps[:ne], enc.encoder.act_names),
            Network(enc.decoder.op, ps[ne:], enc.decoder.act_names),
        )

    def encode_decode(self, x):
        return self.mlp.run(x)

    def train(self, rate: float, xb) -> Tuple[float, "FusedAutoencoder"]:
        """One joint SGD step on reconstruction loss."""
        v, m = self.mlp.train(rate, xb, xb)
        return float(v), FusedAutoencoder(m, self.n_enc)


@dataclass
class QuantizedMLP:
    """int8 serving model: per-channel symmetric quantization of every
    ffLayer weight, with two layer forms:

    - ``mode="w8a8"`` (default): activations quantized per row at every
      call, int8 x int8 -> int32 products (``int8.w8a8_linear``) — a
      quarter of the f32 weight bytes.
    - ``mode="w8"``: weight-only int8, bf16 products with f32
      accumulation (``int8.w8_linear``) — f32-grade activations.
    """

    wqs: Tuple[Any, ...]
    scales: Tuple[Any, ...]
    biases: Tuple[Any, ...]
    acts: Tuple[str, ...]
    softmax_out: bool = True
    mode: str = "w8a8"

    _cache: dict = None

    def __post_init__(self):
        if self._cache is None:
            object.__setattr__(self, "_cache", {})
        if self.mode not in ("w8", "w8a8"):
            raise ValueError(f"unknown QuantizedMLP mode {self.mode!r}")

    @classmethod
    def from_fused(cls, fm: FusedMLP, mode: str = "w8a8") -> "QuantizedMLP":
        qs, ss = zip(*(int8.quantize_weights_int8(w) for w in fm.weights))
        return cls(tuple(qs), tuple(ss), fm.biases, fm.acts, fm.softmax_out,
                   mode)

    def run(self, x) -> Any:
        fn = self._cache.get(("fwd", self.mode))
        if fn is None:
            layer = int8.w8_linear if self.mode == "w8" else int8.w8a8_linear

            def forward(x, wqs, scales, biases):
                h = x
                n = len(wqs)
                for k in range(n):
                    if k == n - 1 and self.softmax_out:
                        z = layer(h, wqs[k], scales[k], biases[k], _identity)
                        h = jax.nn.softmax(z, axis=-1)
                    else:
                        h = layer(h, wqs[k], scales[k], biases[k],
                                  act_fn(self.acts[k]))
                return h

            fn = jax.jit(forward)
            self._cache[("fwd", self.mode)] = fn
        return fn(x, self.wqs, self.scales, self.biases)


@dataclass
class FusedRNN:
    """Elman recurrent layer (the ``fullyConnected`` cell,
    ``Recurrent.hs:97-125``) as one ``lax.scan`` whose step XLA fuses (two
    mat-vecs, bias, activation).  Parameters follow the reference layout:
    wS (o, o), wX (o, i), b (o,)."""

    wX: Any
    wS: Any
    b: Any
    s0: Any            # initial state (o,)
    act: str = "logistic"
    precision: str = "default"

    _cache: dict = None

    def __post_init__(self):
        if self._cache is None:
            object.__setattr__(self, "_cache", {})

    @classmethod
    def from_recurrent(cls, net, act: str = "logistic",
                       precision: str = "default") -> "FusedRNN":
        """From a single-layer ``fully_connected`` RecurrentNetwork."""
        wS, wX, b = (jnp.asarray(p, jnp.float32) for p in net.params)
        (s0,) = net.states
        return cls(wX, wS, jnp.asarray(b, jnp.float32),
                   jnp.asarray(s0, jnp.float32), act, precision)

    def _step(self, wX, wS, b):
        """Scan step ``(s, xt) -> (s', y)`` with y = z pre-activation and
        s' = act(z)."""
        act = act_fn(self.act)

        def step(s, xt):
            z = wX @ xt + wS @ s + b
            return act(z), z
        return step

    def seq_forward(self, xs):
        """xs: (n, i) -> (ys: (n, o) pre-activations, final state)."""
        fn = self._cache.get("seq")
        if fn is None:

            def run(xs, wX, wS, b, s0):
                s_final, ys = jax.lax.scan(self._step(wX, wS, b), s0, xs)
                return ys, s_final

            fn = jax.jit(run)
            self._cache["seq"] = fn
        return fn(jnp.asarray(xs, jnp.float32), self.wX, self.wS, self.b, self.s0)

    def train(self, rate_state: float, rate_param: float, xs, targets
              ) -> Tuple[float, "FusedRNN"]:
        """One SGD step on the summed squared sequence loss with the
        reference's dual state/param rates (``trainNetwork'``)."""
        fn = self._cache.get("train")
        if fn is None:

            def loss(wX, wS, b, s0, xs, tg):
                _, ys = jax.lax.scan(self._step(wX, wS, b), s0, xs)
                return jnp.sum((tg - ys) ** 2)

            def stepfn(rS, rP, wX, wS, b, s0, xs, tg):
                v, g = jax.value_and_grad(loss, argnums=(0, 1, 2, 3))(
                    wX, wS, b, s0, xs, tg)
                return v, wX - rP * g[0], wS - rP * g[1], b - rP * g[2], \
                    s0 - rS * g[3]

            fn = jax.jit(stepfn)
            self._cache["train"] = fn
        v, wX, wS, b, s0 = fn(rate_state, rate_param, self.wX, self.wS,
                              self.b, self.s0,
                              jnp.asarray(xs, jnp.float32),
                              jnp.asarray(targets, jnp.float32))
        return float(v), FusedRNN(wX, wS, b, s0, self.act, self.precision,
                                  _cache=self._cache)
