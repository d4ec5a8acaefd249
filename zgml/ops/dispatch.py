"""Op dispatch: one API per op; the implementation follows the platform.

The analog of the reference's backend vtable + capabilities gating
(src/backend.zig:330-382). The platform is `jax.default_backend()`:

  "gpu"  hand-written kernels compiled for the card (never interpreted),
         cuDNN where its constraints hold, XLA for the rest;
  "cpu"  the same code, with every Pallas kernel run by the interpreter —
         how the tests reach the kernels without a card;
  other  an error.

`force_ref()` (or ZGML_KERNELS=ref) routes every op to the float32
oracle in ops/refs.py; ZGML_KERNELS_DISABLE=op,... sends the named ops
to their plain-XLA form, which is how a kernel is timed against XLA. The
"no silent fallback" rule (perf-targets of the reference, profile.zig) is
kept by zgml.runtime.profile: every call records at trace time which
implementation served it — "triton" (compiled kernel), "interpret",
"cudnn", "xla" or "ref".
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Any

import jax
import jax.numpy as jnp

from zgml import config
from zgml.ops import attention as attn
from zgml.ops import refs
from zgml.ops.qmatmul import qmatmul_kernel, qmatmul_xla
from zgml.quant.repack import PackedWeight

_force_ref: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "zgml_force_ref", default=False)

# Rows up to which the Triton matmul kernel beats XLA end to end: on an
# H100 at TinyLlama-1.1B Q4_0 widths the kernel won decode (M = 1, 8) and
# prefill chunks of 128, and XLA's GEMM won chunks of 512 (PERF.md,
# "Kernel decisions").
KERNEL_MAX_ROWS = 128


@contextlib.contextmanager
def force_ref():
    """Route all ops to the float32 jnp oracle inside this trace context
    (conformance checks, teacher-forced logit comparisons)."""
    tok = _force_ref.set(True)
    try:
        yield
    finally:
        _force_ref.reset(tok)


def platform() -> str:
    """'gpu' or 'cpu'; any other backend is refused."""
    p = jax.default_backend()
    if p not in ("gpu", "cpu"):
        raise RuntimeError(
            f"zgml runs on an NVIDIA GPU or, for tests, the CPU; "
            f"jax.default_backend() is {p!r}")
    return p


def interpret() -> bool:
    """Pallas kernels run interpreted exactly when the platform is the CPU."""
    return platform() == "cpu"


def route(op: str) -> str:
    """'ref', 'xla' or 'kernel' for one op (see the module docstring)."""
    if _force_ref.get() or config.kernels_ref():
        return "ref"
    if op in config.kernels_disabled():
        return "xla"
    return "kernel"


def _kernel_tier() -> str:
    return "interpret" if interpret() else "triton"


def _count(name: str, tier: str):
    from zgml.runtime.profile import global_profile
    global_profile.count_op(name, tier)


# -- quantized matmul ---------------------------------------------------------

def qmatmul(x: jax.Array, w: Any, out_dtype=jnp.float32) -> jax.Array:
    """x [..., K] @ W -> [..., N].

    W is a PackedWeight (weight-only Q8_0/Q4_0) or a plain [K, N] array.
    Up to KERNEL_MAX_ROWS rows of x the Triton kernel serves the call; above
    it, XLA's GEMM over the dequantized weight.
    """
    if not isinstance(w, PackedWeight):
        _count("matmul", "xla")
        return jnp.dot(x, w, preferred_element_type=jnp.float32).astype(out_dtype)
    r = route("qmatmul")
    if r == "kernel" and math.prod(x.shape[:-1]) <= KERNEL_MAX_ROWS:
        _count("qmatmul", _kernel_tier())
        return qmatmul_kernel(x, w, interpret=interpret(), out_dtype=out_dtype)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if r == "ref":
        _count("qmatmul", "ref")
        out = refs.qmatmul_ref(x2, w.qvals, w.scales, w.kind)
    else:
        _count("qmatmul", "xla")
        out = qmatmul_xla(jnp.pad(x2, ((0, 0), (0, w.k_pad - x2.shape[1]))), w)
    return out[:, : w.n].reshape(*lead, w.n).astype(out_dtype)


# -- normalization / rope -----------------------------------------------------

def rmsnorm(x: jax.Array, gamma: jax.Array, eps: float = 1e-5) -> jax.Array:
    # XLA fuses the norm into its elementwise neighbours; a separate kernel
    # launch would only add dispatch cost.
    _count("rmsnorm", "xla")
    return refs.rmsnorm_ref(x, gamma, eps)


def rope_apply(x: jax.Array, cos: jax.Array, sin: jax.Array) -> jax.Array:
    _count("rope", "xla")
    return refs.rope_apply_ref(x, cos, sin)


# -- attention ----------------------------------------------------------------

def _slot(k, v, kv_row, b):
    """Batch rows kv_row..kv_row+b-1 of a larger cache (serving slots)."""
    if kv_row is None:
        return k, v
    return (jax.lax.dynamic_slice_in_dim(k, kv_row, b, axis=0),
            jax.lax.dynamic_slice_in_dim(v, kv_row, b, axis=0))


def _live_rows(kv_len, s: int) -> jax.Array:
    """[B|1, 1, 1, S] bool: cache rows below each sequence's kv_len."""
    valid = jnp.arange(s)[None, :] < jnp.reshape(kv_len, (-1, 1))
    return valid[:, None, None, :]


def flash_attention(q: jax.Array, k: jax.Array, v: jax.Array,
                    kv_len=None, q_offset=0, kv_row=None) -> jax.Array:
    """Prefill attention, GQA-aware and causal: q [B,Hq,Tq,d], k/v [B,Hkv,S,d].

    Query row i has absolute position q_offset + i; keys with absolute position
    < kv_len and <= the query's position contribute. kv_row: read batch entry
    kv_row of a larger cache (serving prefill-into-slot; q must be batch 1).
    Returns f32 [B, Hq, Tq, d].
    """
    k, v = _slot(k, v, kv_row, q.shape[0])
    s, tq = k.shape[2], q.shape[2]
    kv_len = s if kv_len is None else kv_len
    r = route("attention")
    if r != "ref" and platform() == "gpu" and attn.cudnn_ok(q, k, kv_len,
                                                             q_offset):
        _count("attention", "cudnn")
        return attn.prefill_attention_cudnn(q, k, v).astype(jnp.float32)
    ki = jnp.arange(s)[None, :]
    qi = jnp.arange(tq)[:, None] + q_offset
    mask = ((ki < kv_len) & (ki <= qi))[None, None]     # [1, 1, Tq, S]
    if r == "ref":
        _count("attention", "ref")
        return refs.gqa_attention_ref(q, k, v, mask).astype(jnp.float32)
    _count("attention", "xla")
    return attn.xla_attention(q, k, v, mask)


def decode_attention(q: jax.Array, k: jax.Array, v: jax.Array,
                     kv_len: jax.Array, kv_row=None) -> jax.Array:
    """Single-step attention over a KV cache prefix.

    q: [B, Hq, 1, d]; k/v: [B, Hkv, S, d] (S = max_seq); kv_len: [] or [B]
    number of valid cache positions (ref: seq_kv patching,
    src/device_inference.zig:252-256 — kernels never scan invalid cache).
    kv_row: k/v are a larger [B',Hkv,S,d] cache; queries read batch rows
    kv_row..kv_row+B-1. Returns f32 [B, Hq, 1, d]. The library kernel
    serves every batch size its shapes allow, so a sequence's numerics do
    not depend on how many others share the step (PERF.md, "Kernel
    decisions").
    """
    k, v = _slot(k, v, kv_row, q.shape[0])
    r = route("decode_attention")
    if r == "kernel" and attn.decode_kernel_ok(q, k):
        _count("decode_attention", _kernel_tier())
        return attn.decode_attention_kernel(
            q, k, v, kv_len, interpret=interpret()).astype(jnp.float32)
    mask = _live_rows(kv_len, k.shape[2])
    if r == "ref":
        _count("decode_attention", "ref")
        return refs.gqa_attention_ref(q, k, v, mask).astype(jnp.float32)
    _count("decode_attention", "xla")
    return attn.xla_attention(q, k, v, mask)


def flash_attention_q8(q: jax.Array, kq, ks, vq, vs, kv_len=None,
                       q_offset=0, kv_row=None) -> jax.Array:
    """Prefill attention over the int8 d-major KV cache (ref:
    attentionQuantized, quant.zig:925-1091): the cache is dequantized next
    to the attention dot. q [B,Hq,Tq,d]; kq/vq int8 [B',Hkv,d,S]."""
    from zgml.quant.kv_cache import dequantize_cache
    if kv_row is not None:
        kq, ks, vq, vs = (jax.lax.dynamic_slice_in_dim(a, kv_row, q.shape[0],
                                                       axis=0)
                          for a in (kq, ks, vq, vs))
    dt = jnp.float32 if route("attention") == "ref" else jnp.bfloat16
    k = dequantize_cache(kq, ks, dt)
    v = dequantize_cache(vq, vs, dt)
    return flash_attention(q, k, v, kv_len=kv_len, q_offset=q_offset)


def decode_attention_q8(q: jax.Array, kq, ks, vq, vs, kv_len) -> jax.Array:
    """Decode attention over the int8 KV cache (d-major layout, see
    zgml/quant/kv_cache.py), dequantized next to the dot in plain XLA.
    ref: attentionQuantized, quant.zig:925."""
    from zgml.quant.kv_cache import dequantize_cache
    r = route("decode_attention")
    k = dequantize_cache(kq, ks, jnp.float32 if r == "ref" else jnp.bfloat16)
    v = dequantize_cache(vq, vs, jnp.float32 if r == "ref" else jnp.bfloat16)
    mask = _live_rows(kv_len, k.shape[2])
    if r == "ref":
        _count("decode_attention_q8", "ref")
        return refs.gqa_attention_ref(q, k, v, mask).astype(jnp.float32)
    _count("decode_attention_q8", "xla")
    return attn.xla_attention(q, k, v, mask)
