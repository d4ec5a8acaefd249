"""Repack ggml block-quantized weights into the planar layout the matmul uses.

The analog of the reference's `prepareTransposed` GEMV re-blocking
(src/quant.zig:274-317): a one-time load-time layout transform so the hot kernel
streams memory in its natural order.

Layout ("planar K-major blocks"): split packed integer values from scales and
transpose to K-major so that the matmul is ``x[M, K] @ w[K, N]`` with no
transposition, and a [32, BN] tile of one 32-row block is BN contiguous bytes
per row with one scale row beside it:

  Q8_0  -> qvals  int8 [Kp, Np]          (one int8 per element)
           scales f16  [Kp//32, Np]      (per-block absmax/127 scale)
  Q4_0  -> qvals  int8 [Kp//2, Np]       packed nibbles, *global half-split along K*:
                                         byte row j = (w[j + Kp//2, :] << 4) | w[j, :]
                                         where w holds unsigned nibbles 0..15
           scales f16  [Kp//32, Np]

Scales stay f16, GGUF's own format, so the repack is exact. `Np`/`Kp` are the
logical (N=out_features, K=in_features) dims padded to tile multiples with
zeros (zero blocks contribute nothing to the matmul).

Why the half-split for Q4_0: unpacking is then branch-free elementwise bit math
(lo = (b&15)-8 covers k in [0, Kp/2), hi = ((b>>4)&15)-8 covers k in [Kp/2, Kp)),
with no interleave inside a tile. The matmul consumes the activation K-axis
in two halves, see zgml/ops/qmatmul.py.

GGUF stores a 2-D tensor as ne=[K, N] row-major with each output row contiguous
along K, and blocks quantize along K — i.e. a raw GGUF tensor is [N, K] in numpy
terms; repack transposes once on the host.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from zgml.quant.blocks import QK, Q4_0_BLOCK_BYTES, Q8_0_BLOCK_BYTES


@dataclasses.dataclass
class PackedWeight:
    """A repacked weight for the fused dequant-matmul kernels.

    qvals/scales are numpy (host) or jax arrays; n/k record the logical
    (unpadded) out/in-feature dims so wrappers can slice outputs.
    """
    kind: str          # 'q4_0' | 'q8_0'
    n: int             # logical out_features
    k: int             # logical in_features
    n_pad: int         # padded N (lane axis of qvals/scales)
    k_pad: int         # padded K
    qvals: Any         # int8 [k_pad, n_pad] (q8) or [k_pad//2, n_pad] (q4)
    scales: Any        # f16 [k_pad//32, n_pad] (ggml's own scale format,
    #                    src/quant.zig:18: lossless vs the source)

    @property
    def nbytes(self) -> int:
        return int(self.qvals.nbytes + self.scales.nbytes)

    def to_device(self, sharding=None):
        """Upload qvals/scales as jax arrays (optionally with a NamedSharding)."""
        import jax
        put = (lambda a: jax.device_put(a, sharding)) if sharding is not None \
            else jax.numpy.asarray
        return dataclasses.replace(self, qvals=put(self.qvals),
                                   scales=put(self.scales))


def _pw_flatten(pw: PackedWeight):
    return (pw.qvals, pw.scales), (pw.kind, pw.n, pw.k, pw.n_pad, pw.k_pad)


def _pw_unflatten(aux, children):
    kind, n, k, n_pad, k_pad = aux
    qvals, scales = children
    return PackedWeight(kind, n, k, n_pad, k_pad, qvals, scales)


import jax.tree_util as _jtu  # noqa: E402

_jtu.register_pytree_node(PackedWeight, _pw_flatten, _pw_unflatten)


def scales_store(s: np.ndarray) -> np.ndarray:
    """Block scales as stored: f16, exactly the GGUF source's values."""
    return np.ascontiguousarray(s.astype(np.float16))


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _tile_friendly_pad(x: int, max_waste_frac: float = 0.08) -> int:
    """Pad a dim so it divides cleanly by a large kernel tile.

    Prefers 1024-multiples (best DMA/tile shape), falling back to 512/256/128
    when 1024 would waste more than ~max_waste_frac of the dim. E.g.
    11008 -> 11264 (bn=1024, +2.3%), 576 -> 640 (bn=640? no — 768, bn=768),
    49152 -> 49152.
    """
    for align in (1024, 512, 256, 128):
        p = _round_up(x, align)
        if p - x <= max(align // 4, max_waste_frac * x):
            return p
    return _round_up(x, 128)


def _pad_nk(a: np.ndarray, k_pad: int, n_pad: int, fill=0) -> np.ndarray:
    """Pad a [K-like, N] array up to [k_pad, n_pad]."""
    kk, nn = a.shape
    if kk == k_pad and nn == n_pad:
        return a
    out = np.full((k_pad, n_pad), fill, dtype=a.dtype)
    out[:kk, :nn] = a
    return out


def repack_q8_0(raw: bytes | np.ndarray, n: int, k: int,
                n_align: int | None = None, k_align: int | None = None
                ) -> PackedWeight:
    """Raw GGUF Q8_0 bytes for an [N, K] weight -> planar K-major layout.

    Default padding is tile-friendly (see _tile_friendly_pad) so the kernel can
    run its preferred large tiles.
    """
    if k % QK != 0:
        raise ValueError(f"K={k} not divisible by {QK}")
    buf = np.frombuffer(bytes(raw) if not isinstance(raw, np.ndarray) else raw.tobytes(),
                        dtype=np.uint8)
    n_blocks = n * k // QK
    n_pad = _tile_friendly_pad(n) if n_align is None else _round_up(n, n_align)
    k_pad = _round_up(_tile_friendly_pad(k) if k_align is None
                      else _round_up(k, k_align), QK)
    from zgml import native
    lib = native.get_lib()
    if lib is not None:
        qvals = np.zeros((k_pad, n_pad), np.int8)
        scales = np.zeros((k_pad // QK, n_pad), np.float32)
        lib.q8_repack(np.ascontiguousarray(buf[: n_blocks * Q8_0_BLOCK_BYTES]),
                      n, k, n_pad, k_pad, qvals, scales)
        return PackedWeight("q8_0", n, k, n_pad, k_pad, qvals,
                            scales_store(scales))
    blk = buf[: n_blocks * Q8_0_BLOCK_BYTES].reshape(n_blocks, Q8_0_BLOCK_BYTES)
    scales = blk[:, :2].copy().view(np.float16).astype(np.float32).reshape(n, k // QK)
    qvals = blk[:, 2:].copy().view(np.int8).reshape(n, k)
    return PackedWeight(
        "q8_0", n, k, n_pad, k_pad,
        _pad_nk(np.ascontiguousarray(qvals.T), k_pad, n_pad),
        scales_store(_pad_nk(np.ascontiguousarray(scales.T),
                             k_pad // QK, n_pad)))


def repack_q4_0(raw: bytes | np.ndarray, n: int, k: int,
                n_align: int | None = None, k_align: int | None = None
                ) -> PackedWeight:
    """Raw GGUF Q4_0 bytes for an [N, K] weight -> planar half-split K-major layout.

    k_pad is forced to a multiple of 2*QK so both K-halves stay 32-block-aligned.
    """
    if k % QK != 0:
        raise ValueError(f"K={k} not divisible by {QK}")
    buf = np.frombuffer(bytes(raw) if not isinstance(raw, np.ndarray) else raw.tobytes(),
                        dtype=np.uint8)
    n_blocks = n * k // QK
    n_pad = _tile_friendly_pad(n) if n_align is None else _round_up(n, n_align)
    # 512-multiple K so each half is a whole number of 32-row blocks with
    # room for any K split
    k_pad = _round_up(_tile_friendly_pad(k) if k_align is None
                      else _round_up(k, k_align), 512)
    from zgml import native
    lib = native.get_lib()
    if lib is not None:
        packed = np.full((k_pad // 2, n_pad), 0x88, np.uint8).view(np.int8)
        scales = np.zeros((k_pad // QK, n_pad), np.float32)
        lib.q4_repack(np.ascontiguousarray(buf[: n_blocks * Q4_0_BLOCK_BYTES]),
                      n, k, n_pad, k_pad, packed, scales)
        return PackedWeight("q4_0", n, k, n_pad, k_pad, packed,
                            scales_store(scales))
    blk = buf[: n_blocks * Q4_0_BLOCK_BYTES].reshape(n_blocks, Q4_0_BLOCK_BYTES)
    scales = blk[:, :2].copy().view(np.float16).astype(np.float32).reshape(n, k // QK)
    nib = blk[:, 2:]  # ggml order: byte j of a block = elements (j, j+16)
    # unpack to unsigned nibbles [n, k] in natural element order
    w = np.empty((n_blocks, QK), dtype=np.uint8)
    w[:, :16] = nib & 0x0F
    w[:, 16:] = nib >> 4
    w = w.reshape(n, k)
    wp = _pad_nk(np.ascontiguousarray(w.T), k_pad, n_pad, fill=8)  # nibble 8 == 0
    half = k_pad // 2
    packed = (wp[:half] | (wp[half:] << 4)).astype(np.uint8).view(np.int8)
    return PackedWeight(
        "q4_0", n, k, n_pad, k_pad, packed,
        scales_store(_pad_nk(np.ascontiguousarray(scales.T),
                             k_pad // QK, n_pad)))


def concat_packed(pws: list[PackedWeight]) -> PackedWeight:
    """Fuse weights that share an input (e.g. Q/K/V, gate/up) into one
    PackedWeight along the out-feature axis, so one kernel launch serves all
    (the analog of zgml-GPT's packed w_qkv single GEMM, src/models/gpt.zig,
    and the Metal projection-group batching, program.zig:980-1485).

    Requires same kind and K. Each input must be unpadded along N
    (n == n_pad), i.e. repacked with n_align=1; the result is re-padded
    tile-friendly. Output columns [sum n_i] keep the input order, so callers
    split activations at the logical boundaries.
    """
    first = pws[0]
    for pw in pws:
        if pw.kind != first.kind or pw.k_pad != first.k_pad:
            raise ValueError("concat_packed: mismatched kind/K")
        if pw.n != pw.n_pad:
            raise ValueError("concat_packed: inputs must be N-unpadded "
                             "(repack with n_align=1)")
    qvals = np.concatenate([np.asarray(p.qvals) for p in pws], axis=1)
    scales = np.concatenate([np.asarray(p.scales) for p in pws], axis=1)
    n = qvals.shape[1]
    n_pad = _tile_friendly_pad(n)
    return PackedWeight(first.kind, n, first.k, n_pad, first.k_pad,
                        _pad_nk(qvals, qvals.shape[0], n_pad),
                        _pad_nk(scales, scales.shape[0], n_pad))


def repack_gguf_tensor(kind: str, raw: bytes | np.ndarray, n: int, k: int,
                       **kw) -> PackedWeight:
    if kind == "q8_0":
        return repack_q8_0(raw, n, k, **kw)
    if kind == "q4_0":
        return repack_q4_0(raw, n, k, **kw)
    raise ValueError(f"unsupported quant kind {kind!r}")


def quantize_weight(w: np.ndarray, kind: str, **kw) -> PackedWeight:
    """Quantize an f32 [N, K] weight directly into the planar layout (the post-hoc
    `quantize()` path of the reference, llama_inference.zig:189-231)."""
    from zgml.quant.blocks import quantize_q4_0, quantize_q8_0
    n, k = w.shape
    raw = quantize_q4_0(w) if kind == "q4_0" else quantize_q8_0(w)
    return repack_gguf_tensor(kind, raw, n, k, **kw)


def dequant_packed(pw: PackedWeight) -> np.ndarray:
    """Host-side oracle: PackedWeight -> f32 [n, k] (logical, unpadded, N-major
    to match the GGUF orientation)."""
    scales = np.asarray(pw.scales, np.float32)
    if pw.kind == "q8_0":
        q = np.asarray(pw.qvals, dtype=np.float32)
        w = q * np.repeat(scales, QK, axis=0)
    elif pw.kind == "q4_0":
        b = np.asarray(pw.qvals).view(np.uint8)
        w = np.empty((pw.k_pad, pw.n_pad), dtype=np.float32)
        half = pw.k_pad // 2
        w[:half] = (b & 0x0F).astype(np.int8) - 8
        w[half:] = (b >> 4).astype(np.int8) - 8
        w *= np.repeat(scales, QK, axis=0)
    else:
        raise ValueError(pw.kind)
    return np.ascontiguousarray(w[: pw.k, : pw.n].T)
