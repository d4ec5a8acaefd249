"""Dispatch-API conformance vs the jnp oracle (kernels interpreted on CPU).

The analog of the reference's backend conformance suite
(src/backend/conformance.zig): identical inputs through the reference executor
(zgml.ops.refs) and the op's fast path, compared within tolerance.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from zgml.ops import dispatch as ops
from zgml.ops import refs
from zgml.quant.repack import quantize_weight, dequant_packed


def qmatmul_pallas(x, pw, out_dtype=jnp.float32):
    return ops.qmatmul(x, pw, out_dtype=out_dtype)


def flash_attention_pallas(q, k, v, kv_len=None, q_offset=0, kv_row=None):
    return ops.flash_attention(q, k, v, kv_len=kv_len, q_offset=q_offset,
                               kv_row=kv_row)


def decode_attention_pallas(q, k, v, kv_len):
    return ops.decode_attention(q, k, v, kv_len)


def _to_jax(pw):
    import dataclasses
    return dataclasses.replace(pw, qvals=jnp.asarray(pw.qvals),
                               scales=jnp.asarray(pw.scales))


@pytest.mark.parametrize("kind", ["q8_0", "q4_0"])
@pytest.mark.parametrize("m,n,k", [(1, 256, 256), (8, 512, 1024), (5, 300, 576)])
def test_qmatmul_matches_oracle(kind, m, n, k):
    rng = np.random.default_rng(hash((kind, m, n, k)) % 2**32)
    w = rng.standard_normal((n, k)).astype(np.float32)
    x = rng.standard_normal((m, k)).astype(np.float32)
    pw = _to_jax(quantize_weight(w, kind))
    got = np.asarray(qmatmul_pallas(jnp.asarray(x), pw))
    want = x @ dequant_packed(
        quantize_weight(w, kind)).T  # exact dequantized weights
    assert got.shape == (m, n)
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=5e-2 * np.sqrt(k))


@pytest.mark.parametrize("kind", ["q8_0", "q4_0"])
def test_qmatmul_matches_jnp_ref(kind):
    rng = np.random.default_rng(7)
    n, k, m = 384, 512, 4
    w = rng.standard_normal((n, k)).astype(np.float32)
    x = rng.standard_normal((m, k)).astype(np.float32)
    pw = _to_jax(quantize_weight(w, kind))
    got = np.asarray(qmatmul_pallas(jnp.asarray(x), pw))
    want = np.asarray(refs.qmatmul_ref(jnp.asarray(x), pw.qvals, pw.scales, kind))
    np.testing.assert_allclose(got, want[:, :n], rtol=1e-2, atol=5e-2 * np.sqrt(k))


@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
def test_flash_attention_full_causal(hq, hkv):
    rng = np.random.default_rng(1)
    b, tq, s, d = 2, 64, 64, 64
    q = jnp.asarray(rng.standard_normal((b, hq, tq, d)).astype(np.float32))
    k = jnp.asarray(rng.standard_normal((b, hkv, s, d)).astype(np.float32))
    v = jnp.asarray(rng.standard_normal((b, hkv, s, d)).astype(np.float32))
    got = flash_attention_pallas(q, k, v, kv_len=s, q_offset=0)
    mask = refs.causal_mask(tq, s)
    want = refs.gqa_attention_ref(q, k, v, mask[None, None])
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-2, atol=2e-2)


def test_flash_attention_chunked_prefill_offset():
    """Chunk 2 of a prefill: cache holds 32 old + 32 new keys; queries offset 32."""
    rng = np.random.default_rng(2)
    b, hq, hkv, tq, s, d = 1, 4, 2, 32, 128, 64
    kv_len, q_off = 64, 32
    q = jnp.asarray(rng.standard_normal((b, hq, tq, d)).astype(np.float32))
    k = jnp.asarray(rng.standard_normal((b, hkv, s, d)).astype(np.float32))
    v = jnp.asarray(rng.standard_normal((b, hkv, s, d)).astype(np.float32))
    got = flash_attention_pallas(q, k, v, kv_len=kv_len, q_offset=q_off)
    ki = np.arange(s)[None, :]
    qi = np.arange(tq)[:, None] + q_off
    mask = jnp.asarray((ki < kv_len) & (ki <= qi))
    want = refs.gqa_attention_ref(q, k, v, mask[None, None])
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("hq,hkv,kv_len", [(4, 4, 17), (8, 2, 100), (9, 3, 1)])
def test_decode_attention_matches_oracle(hq, hkv, kv_len):
    rng = np.random.default_rng(3)
    b, s, d = 2, 128, 64
    q = jnp.asarray(rng.standard_normal((b, hq, 1, d)).astype(np.float32))
    k = jnp.asarray(rng.standard_normal((b, hkv, s, d)).astype(np.float32))
    v = jnp.asarray(rng.standard_normal((b, hkv, s, d)).astype(np.float32))
    got = decode_attention_pallas(q, k, v, kv_len)
    valid = (np.arange(s) < kv_len)[None, None, None, :]
    want = refs.gqa_attention_ref(q, k, v, jnp.asarray(valid))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-2, atol=2e-2)


def test_flash_attention_odd_tq():
    """Odd query lengths (ppl windows of W+1 tokens) pad internally."""
    rng = np.random.default_rng(14)
    b, hq, hkv, tq, s, d = 1, 3, 3, 37, 128, 64
    q = jnp.asarray(rng.standard_normal((b, hq, tq, d)).astype(np.float32))
    k = jnp.asarray(rng.standard_normal((b, hkv, s, d)).astype(np.float32))
    v = jnp.asarray(rng.standard_normal((b, hkv, s, d)).astype(np.float32))
    got = flash_attention_pallas(q, k, v, kv_len=tq, q_offset=0)
    ki = np.arange(s)[None, :]
    qi = np.arange(tq)[:, None]
    mask = jnp.asarray((ki < tq) & (ki <= qi))
    want = refs.gqa_attention_ref(q, k, v, mask[None, None])
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-2, atol=2e-2)


def test_flash_attention_kv_row_offset():
    """kv_row offset: a batch-1 query over row r of a larger batched cache
    == slicing row r (the serving prefill-into-slot path)."""
    rng = np.random.default_rng(31)
    B, hq, hkv, tq, s, d = 3, 4, 2, 8, 64, 16
    q = jnp.asarray(rng.standard_normal((1, hq, tq, d)), jnp.float32)
    k = jnp.asarray(rng.standard_normal((B, hkv, s, d)), jnp.float32)
    v = jnp.asarray(rng.standard_normal((B, hkv, s, d)), jnp.float32)
    for row in (0, 1, 2):
        for pos in (0, 4):
            got = flash_attention_pallas(q, k, v, kv_len=pos + tq,
                                         q_offset=pos, kv_row=row)
            want = flash_attention_pallas(q, k[row:row + 1], v[row:row + 1],
                                          kv_len=pos + tq, q_offset=pos)
            np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                       rtol=1e-5, atol=1e-5)


# -- edge-case sweeps (the analog of the reference's 11-size x 4-transpose
#    sweeps, tensor.zig:999-1140) ---------------------------------------------

@pytest.mark.parametrize("kind", ["q8_0", "q4_0"])
@pytest.mark.parametrize("m,n,k", [
    (1, 32, 32),       # minimum block-size weight
    (1, 16, 64),       # n below one lane tile
    (3, 100, 96),      # nothing aligned
    (33, 384, 160),    # m crosses the 8-sublane pad, odd K blocks
    (2, 544, 544),     # k not a power-of-two multiple of 256
])
def test_qmatmul_size_sweep(kind, m, n, k):
    rng = np.random.default_rng(hash((kind, m, n, k, 1)) % 2**32)
    w = rng.standard_normal((n, k)).astype(np.float32)
    x = rng.standard_normal((m, k)).astype(np.float32)
    pw = _to_jax(quantize_weight(w, kind))
    got = np.asarray(qmatmul_pallas(jnp.asarray(x), pw))
    want = x @ dequant_packed(quantize_weight(w, kind)).T
    assert got.shape == (m, n)
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=5e-2 * np.sqrt(k))


@pytest.mark.parametrize("b,hq,hkv,d,s,kv_len", [
    (1, 4, 4, 80, 128, 77),     # n_rep=1, head_dim not a lane multiple
    (2, 8, 1, 64, 256, 256),    # MQA (n_rep=8), full cache
    (1, 2, 2, 16, 512, 500),    # multi-block kv_len, small d
    (3, 6, 3, 48, 64, 1),       # kv_len=1 (first decode step)
])
def test_decode_attention_edge_sweep(b, hq, hkv, d, s, kv_len):
    rng = np.random.default_rng(hash((b, hq, hkv, d, s, kv_len)) % 2**32)
    q = jnp.asarray(rng.standard_normal((b, hq, 1, d)), jnp.float32)
    k = jnp.asarray(rng.standard_normal((b, hkv, s, d)), jnp.float32)
    v = jnp.asarray(rng.standard_normal((b, hkv, s, d)), jnp.float32)
    lens = jnp.full((b,), kv_len, jnp.int32)
    got = decode_attention_pallas(q, k, v, lens)
    mask = (np.arange(s)[None, :] < kv_len)
    want = refs.gqa_attention_ref(q, k, v,
                                  jnp.asarray(mask)[None, None])
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("hq,hkv,tq,s,kv_len,q_off", [
    (4, 4, 8, 64, 64, 56),      # n_rep=1, tiny odd Tq
    (6, 2, 40, 96, 90, 50),     # nothing tile-aligned
    (2, 1, 256, 256, 1, 0),     # kv_len=1
    (8, 2, 5, 64, 60, 50),      # GQA (n_rep=4) + odd Tq: bq must pad to 8
])
def test_flash_attention_edge_sweep(hq, hkv, tq, s, kv_len, q_off):
    d = 80                      # head_dim not a lane multiple
    rng = np.random.default_rng(hash((hq, hkv, tq, s, kv_len)) % 2**32)
    q = jnp.asarray(rng.standard_normal((1, hq, tq, d)), jnp.float32)
    k = jnp.asarray(rng.standard_normal((1, hkv, s, d)), jnp.float32)
    v = jnp.asarray(rng.standard_normal((1, hkv, s, d)), jnp.float32)
    got = flash_attention_pallas(q, k, v, kv_len=kv_len, q_offset=q_off)
    ki = np.arange(s)[None, :]
    qi = q_off + np.arange(tq)[:, None]
    mask = jnp.asarray((ki < kv_len) & (ki <= qi))
    want = refs.gqa_attention_ref(q, k, v, mask[None, None])
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-2, atol=2e-2)
