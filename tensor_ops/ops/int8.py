"""int8 serving arithmetic: the quantizers and the two int8 layer forms.

A weight ``w: (o, i)`` (the reference ffLayer layout,
``FeedForward.hs:209-213``) is quantized once per output channel.  The
w8a8 layer also quantizes its activation batch per row at every call and
accumulates int8 x int8 -> int32; the w8 layer keeps f32 activations and
multiplies in bf16.  Both are plain ``jax.numpy``: on the GPU, XLA turns
the w8a8 layer into a row-absmax reduction, a quantize pass, an s8 GEMM
and a dequant epilogue.
"""

from __future__ import annotations

from typing import Callable, Tuple

import jax
import jax.numpy as jnp
from jax import lax


def quantize_weights_int8(w) -> Tuple[jax.Array, jax.Array]:
    """Per-output-channel symmetric int8 quantization of an ffLayer weight
    ``w: (o, i)``: returns (int8 values (o, i), f32 scales (o, 1)) with
    ``w ~= values * scales``."""
    w = jnp.asarray(w, jnp.float32)
    amax = jnp.max(jnp.abs(w), axis=1, keepdims=True)
    scale = jnp.where(amax > 0, amax / 127.0, 1.0)
    q = jnp.clip(jnp.round(w / scale), -127, 127).astype(jnp.int8)
    return q, scale.astype(jnp.float32)


def quantize_acts_int8(x) -> Tuple[jax.Array, jax.Array]:
    """Per-row (per-token) symmetric dynamic int8 quantization of an
    activation batch ``x: (B, i)``: returns (int8 values, f32 scales
    (B, 1)) with ``x ~= values * scales``."""
    x = jnp.asarray(x, jnp.float32)
    amax = jnp.max(jnp.abs(x), axis=1, keepdims=True)
    scale = jnp.where(amax > 0, amax / 127.0, 1.0)
    q = jnp.clip(jnp.round(x / scale), -127, 127).astype(jnp.int8)
    return q, scale.astype(jnp.float32)


def w8_linear(x, wq, scale, b, act: Callable):
    """Weight-only int8 layer: ``act((x @ wq.T) * scale.T + b)`` with both
    operands in bf16 (int8 values are exact in bf16) and f32
    accumulation."""
    z = lax.dot_general(x.astype(jnp.bfloat16), wq.astype(jnp.bfloat16),
                        (((1,), (1,)), ((), ())),
                        preferred_element_type=jnp.float32)
    return act(z * scale.reshape(1, -1) + b)


def w8a8_linear(x, wq, scale, b, act: Callable):
    """w8a8 layer: ``act((xq @ wq.T) * sx * scale.T + b)`` with ``xq, sx``
    from :func:`quantize_acts_int8` and int32 accumulation."""
    xq, sx = quantize_acts_int8(x)
    acc = lax.dot_general(xq, wq, (((1,), (1,)), ((), ())),
                          preferred_element_type=jnp.int32)
    return act(acc.astype(jnp.float32) * sx * scale.reshape(1, -1) + b)
