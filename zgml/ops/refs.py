"""Pure-jnp reference semantics for every hot op (the conformance oracle).

The analog of the reference executor (src/backend/reference.zig): simple,
obviously-correct implementations that the kernels and the XLA tier are
tested against (SURVEY.md §4.4's "fake backend" pattern). Every contraction
runs in float32 at Precision.HIGHEST, so on a GPU the oracle does not drop
to TF32. The fast paths live in ops/dispatch.py; only force_ref() routes a
model through this module.

Conventions:
  - activations x: [..., K] f32 (or bf16); weights are [N, K] "out-major" like the
    GGUF layout, so a projection is x @ w.T.
  - RoPE uses HF half-split pairing (rotate-half): pairs (i, i + d/2)
    (ref: src/nn.zig:286-311).
  - attention is causal, scores scaled by 1/sqrt(d_head), online-softmax semantics
    equal to plain softmax (ref: src/tensor/forward.zig:1687-1818).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from zgml.quant.blocks import QK


# -- quantized matmul ---------------------------------------------------------

_HI = jax.lax.Precision.HIGHEST


def dequant_q8_0_jnp(qvals: jax.Array, scales: jax.Array) -> jax.Array:
    """K-major planar layout: int8 [K, N], f16 [K//32, N] -> f32 [K, N]."""
    s = jnp.repeat(scales.astype(jnp.float32), QK, axis=0)
    return qvals.astype(jnp.float32) * s


def dequant_q4_0_jnp(qvals_packed: jax.Array, scales: jax.Array) -> jax.Array:
    """Half-split K-major layout: packed int8 [K//2, N], f16 [K//32, N] -> f32 [K, N].

    Byte row j holds (w[j + K/2, :] << 4) | w[j, :], nibbles unsigned 0..15,
    value = nibble - 8 (see zgml/quant/repack.py).
    """
    v = qvals_packed.astype(jnp.int32)
    lo = (v & 15) - 8
    hi = ((v >> 4) & 15) - 8
    w = jnp.concatenate([lo, hi], axis=0).astype(jnp.float32)
    return w * jnp.repeat(scales.astype(jnp.float32), QK, axis=0)


def dequant_jnp(qvals: jax.Array, scales: jax.Array, kind: str) -> jax.Array:
    """Either planar layout -> f32 [K_pad, N_pad]."""
    if kind == "q8_0":
        return dequant_q8_0_jnp(qvals, scales)
    if kind == "q4_0":
        return dequant_q4_0_jnp(qvals, scales)
    raise ValueError(kind)


def qmatmul_ref(x: jax.Array, qvals: jax.Array, scales: jax.Array,
                kind: str) -> jax.Array:
    """x [M, K] @ dequant(W)[K, N] -> [M, N] (weight may be K-padded;
    x is zero-padded to match)."""
    w = dequant_jnp(qvals, scales, kind)
    k_pad = w.shape[0]
    if x.shape[-1] < k_pad:
        x = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, k_pad - x.shape[-1])])
    return jnp.dot(x.astype(jnp.float32), w, preferred_element_type=jnp.float32,
                   precision=_HI)


# -- normalization ------------------------------------------------------------

def rmsnorm_ref(x: jax.Array, gamma: jax.Array, eps: float = 1e-5) -> jax.Array:
    """RMSNorm * gamma over the last axis (ref: src/tensor/forward.zig:1413-1509)."""
    dt = x.dtype
    xf = x.astype(jnp.float32)
    ms = jnp.mean(xf * xf, axis=-1, keepdims=True)
    return (xf * jax.lax.rsqrt(ms + eps) * gamma.astype(jnp.float32)).astype(dt)


def layernorm_ref(x: jax.Array, gamma: jax.Array, beta: jax.Array,
                  eps: float = 1e-5) -> jax.Array:
    xf = x.astype(jnp.float32)
    mu = jnp.mean(xf, axis=-1, keepdims=True)
    var = jnp.mean((xf - mu) ** 2, axis=-1, keepdims=True)
    y = (xf - mu) * jax.lax.rsqrt(var + eps)
    return (y * gamma + beta).astype(x.dtype)


# -- RoPE ---------------------------------------------------------------------

def rope_cos_sin(positions: jax.Array, head_dim: int,
                 base: float = 10000.0) -> tuple[jax.Array, jax.Array]:
    """cos/sin tables for given positions: [T, head_dim//2] each.

    freq_i = base^(-2i/d), matching the reference's precomputed tables
    (src/nn.zig:273-311) and llama.cpp.
    """
    half = head_dim // 2
    inv_freq = 1.0 / (base ** (jnp.arange(half, dtype=jnp.float32) * 2.0 / head_dim))
    ang = positions.astype(jnp.float32)[:, None] * inv_freq[None, :]
    return jnp.cos(ang), jnp.sin(ang)


def rope_apply_ref(x: jax.Array, cos: jax.Array, sin: jax.Array) -> jax.Array:
    """Apply rotary embedding with half-split pairing.

    x: [..., T, head_dim]; cos/sin: [T, head_dim//2].
    out[..., i]        = x[i]*cos - x[i+half]*sin
    out[..., i+half]   = x[i+half]*cos + x[i]*sin
    """
    half = x.shape[-1] // 2
    x1 = x[..., :half]
    x2 = x[..., half:]
    dt = x.dtype
    x1f, x2f = x1.astype(jnp.float32), x2.astype(jnp.float32)
    o1 = x1f * cos - x2f * sin
    o2 = x2f * cos + x1f * sin
    return jnp.concatenate([o1, o2], axis=-1).astype(dt)


# -- attention ----------------------------------------------------------------

def attention_ref(q: jax.Array, k: jax.Array, v: jax.Array,
                  mask: jax.Array | None = None,
                  scale: float | None = None) -> jax.Array:
    """Plain softmax attention. q: [..., Tq, d], k/v: [..., Tk, d].

    mask: broadcastable to [..., Tq, Tk], True = attend (or additive f32).
    """
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    s = jnp.einsum("...qd,...kd->...qk", q.astype(jnp.float32),
                   k.astype(jnp.float32), precision=_HI) * scale
    if mask is not None:
        if mask.dtype == jnp.bool_:
            s = jnp.where(mask, s, -jnp.inf)
        else:
            s = s + mask
    p = jax.nn.softmax(s, axis=-1)
    # fully-masked rows produce NaN via softmax(-inf row); zero them like the
    # reference's mask-first skip (forward.zig:1744-1749)
    p = jnp.where(jnp.isnan(p), 0.0, p)
    return jnp.einsum("...qk,...kd->...qd", p, v.astype(jnp.float32),
                      precision=_HI).astype(q.dtype)


def causal_mask(t_q: int, t_k: int, offset: int = 0) -> jax.Array:
    """Boolean causal mask [t_q, t_k]: query i attends keys j <= i + offset."""
    qi = jnp.arange(t_q)[:, None]
    kj = jnp.arange(t_k)[None, :]
    return kj <= qi + offset


def gqa_attention_ref(q: jax.Array, k: jax.Array, v: jax.Array,
                      mask: jax.Array | None = None) -> jax.Array:
    """Grouped-query attention. q: [B, Hq, Tq, d], k/v: [B, Hkv, Tk, d],
    Hq = n_rep * Hkv (ref: src/models/llama_transformer.zig:49-51). mask:
    bool, broadcastable to [B, Hq, Tq, Tk]."""
    b, hq, tq, d = q.shape
    hkv = k.shape[1]
    n_rep = hq // hkv
    qg = q.reshape(b, hkv, n_rep, tq, d)
    if mask is not None and mask.ndim == 4:
        # [B|1, Hq|1, Tq, S] -> [B|1, Hkv|1, n_rep|1, Tq, S]
        mask = (mask[:, :, None] if mask.shape[1] == 1 else
                mask.reshape(mask.shape[0], hkv, n_rep, *mask.shape[2:]))
    out = attention_ref(qg, k[:, :, None], v[:, :, None], mask)
    return out.reshape(b, hq, tq, d)


# -- misc fused epilogues -----------------------------------------------------

def silu_ref(x: jax.Array) -> jax.Array:
    return x * jax.nn.sigmoid(x.astype(jnp.float32)).astype(x.dtype)


def swiglu_ref(gate: jax.Array, up: jax.Array) -> jax.Array:
    """silu(gate) * up (ref: llama_transformer.zig:129-133)."""
    return silu_ref(gate) * up


def softmax_ref(x: jax.Array, axis: int = -1) -> jax.Array:
    return jax.nn.softmax(x.astype(jnp.float32), axis=axis).astype(x.dtype)
