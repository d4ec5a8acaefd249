"""ggml-style block quantization codecs (Q4_0 / Q8_0), bit-exact with the GGUF layouts.

Layouts (ref: src/models/gguf_loader.zig:30-71, src/gguf.zig:65-110):
  Q4_0: 32 elements / 18-byte block = [f16 scale][16 bytes of nibbles].
        Element i of the block lives in byte 2 + i%16; i<16 -> low nibble,
        i>=16 -> high nibble (ggml packs element i and i+16 in one byte).
        value = (nibble - 8) * scale, scale = absmax/-8 chosen so the absmax
        element maps to -8 (ggml convention: d = max/-8 where max is the
        signed value with largest magnitude).
  Q8_0: 32 elements / 34-byte block = [f16 scale][32 int8].
        value = int8 * scale, scale = absmax/127.

All functions are vectorized numpy on the host (load/save path). Dequant also has a
jnp twin in zgml.ops.refs for use as an on-device conformance oracle.

NOTE on the Q4_0 nibble order: llama.cpp/ggml packs element pairs (i, i+16) into one
byte (lo, hi). The reference loader (gguf_loader.zig:44-47) instead reads pairs
(2j, 2j+1) from byte j — a deviation from ggml that only matters for files produced
by ggml tools. We implement the *ggml* convention (files in the wild, incl. the ones
`scripts/download_smollm.py` fetches, use it) and test roundtrip against our own
writer plus hand-built byte patterns.
"""
from __future__ import annotations

import numpy as np

QK = 32  # elements per block, both formats (ref: src/quant.zig:18)
Q4_0_BLOCK_BYTES = 18
Q8_0_BLOCK_BYTES = 34


def _as_blocks(x: np.ndarray) -> np.ndarray:
    """Flatten to [n_blocks, QK]; n must be divisible by QK (ggml requires this
    for matmul weights; row length ne0 % 32 == 0)."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    n = x.size
    if n % QK != 0:
        raise ValueError(f"element count {n} not divisible by block size {QK}")
    return x.reshape(-1, QK)


def quantize_q8_0(x: np.ndarray) -> np.ndarray:
    """f32 array -> raw Q8_0 bytes (uint8 array [n_blocks*34])."""
    b = _as_blocks(x)
    from zgml import native
    lib = native.get_lib()
    if lib is not None:
        out = np.empty(b.shape[0] * Q8_0_BLOCK_BYTES, np.uint8)
        lib.quantize_q8_0(np.ascontiguousarray(b.reshape(-1)), b.shape[0], out)
        return out
    amax = np.max(np.abs(b), axis=1)
    d = (amax / 127.0).astype(np.float16)
    df = d.astype(np.float32)
    inv = np.where(df > 0, 1.0 / np.where(df > 0, df, 1.0), 0.0)
    q = np.clip(np.round(b * inv[:, None]), -128, 127).astype(np.int8)
    out = np.empty((b.shape[0], Q8_0_BLOCK_BYTES), dtype=np.uint8)
    out[:, :2] = d.view(np.uint8).reshape(-1, 2)
    out[:, 2:] = q.view(np.uint8)
    return out.reshape(-1)


def dequantize_q8_0(raw: np.ndarray | bytes, n_elems: int) -> np.ndarray:
    """Raw Q8_0 bytes -> f32 array of n_elems."""
    buf = np.frombuffer(bytes(raw) if not isinstance(raw, np.ndarray) else raw.tobytes(),
                        dtype=np.uint8)
    n_blocks = (n_elems + QK - 1) // QK
    blk = buf[: n_blocks * Q8_0_BLOCK_BYTES].reshape(n_blocks, Q8_0_BLOCK_BYTES)
    d = blk[:, :2].copy().view(np.float16).astype(np.float32).reshape(-1)
    q = blk[:, 2:].copy().view(np.int8).astype(np.float32)
    return (q * d[:, None]).reshape(-1)[:n_elems]


def quantize_q4_0(x: np.ndarray) -> np.ndarray:
    """f32 array -> raw Q4_0 bytes (ggml nibble order: byte j holds elements j & j+16)."""
    b = _as_blocks(x)
    from zgml import native
    lib = native.get_lib()
    if lib is not None:
        out = np.empty(b.shape[0] * Q4_0_BLOCK_BYTES, np.uint8)
        lib.quantize_q4_0(np.ascontiguousarray(b.reshape(-1)), b.shape[0], out)
        return out
    # ggml: pick the signed value with max |.|, scale d = that_value / -8 so it
    # quantizes exactly to nibble 0 (value -8). This preserves sign information.
    idx = np.argmax(np.abs(b), axis=1)
    maxv = b[np.arange(b.shape[0]), idx]
    d = (maxv / -8.0).astype(np.float16)
    df = d.astype(np.float32)
    inv = np.where(df != 0, 1.0 / np.where(df != 0, df, 1.0), 0.0)
    q = b * inv[:, None] + 8.5  # ggml rounds via (x*inv + 8.5) floor-to-int
    q = np.clip(q.astype(np.int32), 0, 15).astype(np.uint8)  # unsigned nibbles
    lo = q[:, :16]
    hi = q[:, 16:]
    out = np.empty((b.shape[0], Q4_0_BLOCK_BYTES), dtype=np.uint8)
    out[:, :2] = d.view(np.uint8).reshape(-1, 2)
    out[:, 2:] = (lo | (hi << 4))
    return out.reshape(-1)


def dequantize_q4_0(raw: np.ndarray | bytes, n_elems: int) -> np.ndarray:
    """Raw Q4_0 bytes -> f32 array of n_elems (ggml nibble order)."""
    buf = np.frombuffer(bytes(raw) if not isinstance(raw, np.ndarray) else raw.tobytes(),
                        dtype=np.uint8)
    n_blocks = (n_elems + QK - 1) // QK
    blk = buf[: n_blocks * Q4_0_BLOCK_BYTES].reshape(n_blocks, Q4_0_BLOCK_BYTES)
    d = blk[:, :2].copy().view(np.float16).astype(np.float32).reshape(-1)
    nib = blk[:, 2:]
    vals = np.empty((n_blocks, QK), dtype=np.float32)
    vals[:, :16] = (nib & 0x0F).astype(np.int8) - 8
    vals[:, 16:] = (nib >> 4).astype(np.int8) - 8
    return (vals * d[:, None]).reshape(-1)[:n_elems]


def f16_bytes_to_f32(raw: np.ndarray | bytes, n_elems: int) -> np.ndarray:
    buf = np.frombuffer(bytes(raw) if not isinstance(raw, np.ndarray) else raw.tobytes(),
                        dtype=np.uint8)
    return buf[: n_elems * 2].copy().view(np.float16).astype(np.float32)


def quantization_error(x: np.ndarray, kind: str) -> float:
    """RMSE of quantize->dequantize roundtrip (ref: src/quant.zig:621-628)."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    if kind == "q8_0":
        y = dequantize_q8_0(quantize_q8_0(x), x.size)
    elif kind == "q4_0":
        y = dequantize_q4_0(quantize_q4_0(x), x.size)
    else:
        raise ValueError(kind)
    return float(np.sqrt(np.mean((x.reshape(-1) - y) ** 2)))
