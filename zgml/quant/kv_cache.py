"""Int8 quantized KV cache (ref: QuantizedKVCache, src/quant.zig:645-910).

The reference stores column-major int8 K/V with f32 scales per 32-element
block along d_head. Here there is **one scale per cached position per head**
(absmax over the whole head_dim vector), so a scale factors out of the
score/value contractions:

    score_j = q . k_j = k_scale_j * (q . k_i8_j)
    out     = Sum_j p_j * v_scale_j * v_i8_j

Attention dequantizes the cache next to its dot in plain XLA
(ops/dispatch.decode_attention_q8); an int8 decode kernel is a ROADMAP item.

Accuracy: absmax over head_dim (64-128) instead of 32 raises roundtrip RMSE
~25% (still ~0.4% relative; engine-level cosine vs dense stays >=0.99,
test-gated).

Layout:
  k_q / v_q : int8 [B, Hkv, d, S]   (d-major values)
  k_s / v_s : f32  [B, Hkv, S]      (per-position scales)
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def init_quant_cache(n_layers: int, batch: int, n_kv_heads: int, max_seq: int,
                     head_dim: int) -> dict:
    qs = (batch, n_kv_heads, head_dim, max_seq)
    ss = (batch, n_kv_heads, max_seq)
    mk = lambda: [jnp.zeros(qs, jnp.int8) for _ in range(n_layers)]  # noqa: E731
    ms = lambda: [jnp.ones(ss, jnp.float32) for _ in range(n_layers)]  # noqa: E731
    return {"k_q": mk(), "k_s": ms(), "v_q": mk(), "v_s": ms(), "int8": True}


def quantize_columns(x: jax.Array) -> tuple[jax.Array, jax.Array]:
    """[B, H, T, d] -> (int8 [B, H, d, T], scales f32 [B, H, T]).

    Per-position absmax/127 quantization over the head vector (the analog of
    the reference's storeColumn, quant.zig:687-699, with the block widened to
    head_dim so scales factor out of the attention contractions)."""
    xf = x.astype(jnp.float32)
    amax = jnp.max(jnp.abs(xf), axis=-1)                    # [B,H,T]
    scale = amax / 127.0
    inv = jnp.where(scale > 0, 1.0 / jnp.where(scale > 0, scale, 1.0), 0.0)
    q = jnp.clip(jnp.round(xf * inv[..., None]), -127, 127).astype(jnp.int8)
    return q.transpose(0, 1, 3, 2), scale                    # d-major vals


def write_columns(cache_q: jax.Array, cache_s: jax.Array, q: jax.Array,
                  s: jax.Array, pos) -> tuple[jax.Array, jax.Array]:
    """Insert T quantized columns at position pos (lane-axis DUS)."""
    cache_q = jax.lax.dynamic_update_slice(cache_q, q, (0, 0, 0, pos))
    cache_s = jax.lax.dynamic_update_slice(cache_s, s, (0, 0, pos))
    return cache_q, cache_s


def dequantize_cache(cache_q: jax.Array, cache_s: jax.Array,
                     dtype=jnp.float32) -> jax.Array:
    """Oracle / prefill path: [B,H,d,S] int8 + [B,H,S] scales -> [B,H,S,d]."""
    full = cache_q.astype(jnp.float32) * cache_s[:, :, None, :]
    return full.transpose(0, 1, 3, 2).astype(dtype)
