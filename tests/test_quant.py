"""Quant codec tests: bit-exact layouts, roundtrip error bounds, repack oracle.

Mirrors the reference's quantization test strategy (SURVEY.md §4.7:
block-size-vs-error monotonicity, GEMV-vs-matmul agreement, roundtrip tolerances).
"""
import numpy as np
import pytest

from zgml.quant import (
    QK, quantize_q4_0, quantize_q8_0, dequantize_q4_0, dequantize_q8_0,
    quantization_error, repack_q4_0, repack_q8_0, dequant_packed, PackedWeight,
)
from zgml.quant.repack import quantize_weight


def test_q8_0_layout_hand_built():
    # one block: scale=1.0 (f16 0x3C00), values 0..31
    import struct
    raw = struct.pack("<e", 1.0) + bytes((np.arange(32, dtype=np.int8)).tobytes())
    out = dequantize_q8_0(np.frombuffer(raw, np.uint8), 32)
    np.testing.assert_allclose(out, np.arange(32, dtype=np.float32))


def test_q4_0_layout_hand_built():
    # one block, scale 2.0; byte j holds elements (j, j+16): lo nibble=j elem, hi=j+16
    import struct
    nib = bytes([(3 | (9 << 4))] * 16)  # lo=3 -> val -5, hi=9 -> val 1
    raw = struct.pack("<e", 2.0) + nib
    out = dequantize_q4_0(np.frombuffer(raw, np.uint8), 32)
    np.testing.assert_allclose(out[:16], np.full(16, -10.0))
    np.testing.assert_allclose(out[16:], np.full(16, 2.0))


def test_q8_0_roundtrip_accuracy():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(1024).astype(np.float32)
    y = dequantize_q8_0(quantize_q8_0(x), x.size)
    # int8 with per-32 absmax scale: relative error bounded by scale/2
    assert np.abs(x - y).max() < np.abs(x).max() / 127
    assert quantization_error(x, "q8_0") < 0.01


def test_q4_0_roundtrip_accuracy():
    rng = np.random.default_rng(1)
    x = rng.standard_normal(4096).astype(np.float32)
    err = quantization_error(x, "q4_0")
    assert err < 0.2  # 4-bit on unit-variance data
    # absmax element must be exactly representable (maps to nibble 0 or 15)
    b = x[:QK]
    y = dequantize_q4_0(quantize_q4_0(b), QK)
    i = np.argmax(np.abs(b))
    assert abs(y[i] - b[i]) < abs(b[i]) * 0.1


def test_error_monotonic_q8_better_than_q4():
    rng = np.random.default_rng(2)
    x = rng.standard_normal(8192).astype(np.float32)
    assert quantization_error(x, "q8_0") < quantization_error(x, "q4_0")


@pytest.mark.parametrize("kind", ["q8_0", "q4_0"])
def test_repack_dequant_matches_block_dequant(kind):
    """f16 scale storage round-trips the GGUF blocks BIT-EXACTLY (the
    source scales are f16, src/quant.zig:18)."""
    rng = np.random.default_rng(3)
    n, k = 96, 160  # deliberately unaligned -> exercises padding
    w = rng.standard_normal((n, k)).astype(np.float32)
    if kind == "q8_0":
        raw = quantize_q8_0(w)
        ref = dequantize_q8_0(raw, n * k).reshape(n, k)
        pw = repack_q8_0(raw, n, k)
    else:
        raw = quantize_q4_0(w)
        ref = dequantize_q4_0(raw, n * k).reshape(n, k)
        pw = repack_q4_0(raw, n, k)
    got = dequant_packed(pw)
    assert pw.scales.dtype == np.float16
    np.testing.assert_allclose(got, ref, rtol=0, atol=0)  # bit-exact
    # padding must be all-zero contribution
    full = dequant_packed(
        PackedWeight(pw.kind, pw.n_pad, pw.k_pad, pw.n_pad, pw.k_pad,
                     pw.qvals, pw.scales))
    assert np.all(full[n:] == 0) and np.all(full[:, k:] == 0)


def test_quantize_weight_direct():
    rng = np.random.default_rng(4)
    w = rng.standard_normal((64, 64)).astype(np.float32)
    pw = quantize_weight(w, "q8_0")
    got = dequant_packed(pw)
    assert np.sqrt(np.mean((got - w) ** 2)) < 0.01
