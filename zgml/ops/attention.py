"""Attention over the KV cache on the GPU.

Three implementations, chosen per call by ops/dispatch.py:

- decode (one query token per sequence) over a bf16 cache: the installed
  JAX library kernel `jax.experimental.pallas.ops.gpu.decode_attention.gqa`
  (a Pallas kernel on the Triton route; not written in this repository). It
  takes a per-sequence `kv_seq_len`, so each step reads only the live
  prefix of the cache instead of all `max_seq_len` rows. The library wants
  K/V as [B, S, Hkv, d] and swaps them straight back to [B, Hkv, S, d]; the
  cache here is [B, Hkv, S, d], so the call passes `swapaxes(cache, 1, 2)`
  and XLA folds the two transposes away. No copy of the cache is made.
- prefill with a static `q_offset` of 0 over keys [0, Tq): cuDNN's fused
  attention (`jax.nn.dot_product_attention(implementation="cudnn")`), whose
  causal mask is aligned at the top left. A chunk at a later offset needs
  the mask aligned at the bottom right, which that call cannot express, so
  chunked prefill (`q_offset` traced or > 0) takes the XLA form.
- everything else: `xla_attention`, a masked softmax attention in plain jnp
  with bf16 operands and f32 accumulation, for XLA to fuse.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

_NEG = -1e30


def xla_attention(q: jax.Array, k: jax.Array, v: jax.Array,
                  mask: jax.Array) -> jax.Array:
    """GQA attention in plain jnp. q [B, Hq, T, d]; k/v [B, Hkv, S, d];
    mask bool, broadcastable to [B, 1, T, S]. Returns f32 [B, Hq, T, d]."""
    b, hq, t, d = q.shape
    hkv = k.shape[1]
    qg = q.reshape(b, hkv, hq // hkv, t, d).astype(k.dtype)
    s = jnp.einsum("bhrtd,bhsd->bhrts", qg, k,
                   preferred_element_type=jnp.float32) * (d ** -0.5)
    s = jnp.where(mask[:, :, None], s, _NEG)
    p = jax.nn.softmax(s, axis=-1)
    o = jnp.einsum("bhrts,bhsd->bhrtd", p.astype(v.dtype), v,
                   preferred_element_type=jnp.float32)
    return o.reshape(b, hq, t, d)


def decode_splits(s: int) -> tuple[int, int] | None:
    """(k_splits, block_k) for the library decode kernel over a cache of s
    rows, or None when s admits none: every split must hold a power-of-two
    multiple of block_k, and block_k must be a power of two >= 16."""
    for splits in (16, 8, 4, 2, 1):
        if s % splits:
            continue
        per = s // splits
        for bk in (128, 64, 32, 16):
            if per % bk == 0:
                return splits, bk
    return None


def decode_kernel_ok(q: jax.Array, k: jax.Array) -> bool:
    """Shapes the library decode kernel takes: a power-of-two head_dim of at
    least 16 (one [block_h, d] tile) and a cache length decode_splits can
    cut."""
    d = q.shape[-1]
    return d >= 16 and d & (d - 1) == 0 and decode_splits(k.shape[2]) is not None


def decode_attention_kernel(q: jax.Array, k: jax.Array, v: jax.Array,
                            kv_len, *, interpret: bool) -> jax.Array:
    """q [B, Hq, 1, d] over k/v [B, Hkv, S, d] with kv_len [] or [B] live
    rows per sequence. Returns [B, Hq, 1, d] in k's dtype."""
    from jax.experimental.pallas.ops.gpu import decode_attention as lib
    b = q.shape[0]
    splits, bk = decode_splits(k.shape[2])
    lens = jnp.broadcast_to(jnp.asarray(kv_len, jnp.int32).reshape(-1), (b,))
    o = lib.gqa(q[:, :, 0].astype(k.dtype), jnp.swapaxes(k, 1, 2),
                jnp.swapaxes(v, 1, 2), kv_seq_len=lens, k_splits=splits,
                block_k=bk, interpret=interpret)
    return o[:, :, None]


def cudnn_ok(q: jax.Array, k: jax.Array, kv_len, q_offset) -> bool:
    """The prefill calls cuDNN's fused attention serves: a static q_offset
    of 0 with kv_len == Tq (square causal over the keys just written), and
    a head_dim that is a multiple of 8 up to 256."""
    t, d = q.shape[2], q.shape[3]
    return (isinstance(q_offset, int) and q_offset == 0
            and isinstance(kv_len, int) and kv_len == t
            and d % 8 == 0 and d <= 256 and k.shape[2] >= t)


def prefill_attention_cudnn(q: jax.Array, k: jax.Array,
                            v: jax.Array) -> jax.Array:
    """Causal attention of q [B, Hq, T, d] over keys [0, T) of k/v
    [B, Hkv, S, d] through cuDNN (bf16 operands). Returns [B, Hq, T, d]."""
    t = q.shape[2]
    to_btnh = lambda a: a.transpose(0, 2, 1, 3).astype(jnp.bfloat16)  # noqa: E731
    out = jax.nn.dot_product_attention(
        to_btnh(q), to_btnh(k[:, :, :t]), to_btnh(v[:, :, :t]),
        is_causal=True, implementation="cudnn")
    return out.transpose(0, 2, 1, 3)
