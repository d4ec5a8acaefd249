"""Quantized KV cache tests: roundtrip accuracy, kernel conformance,
engine-level cosine similarity (ref: quantized-KV cosine >= 0.99 vs f32,
llama_inference.zig:911-954; roundtrip tolerances quant.zig:1259-1344)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from zgml.quant.kv_cache import (dequantize_cache, init_quant_cache,
                                     quantize_columns, write_columns)
from zgml.ops import dispatch as ops
from zgml.ops import refs


def test_quantize_columns_roundtrip():
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((2, 3, 5, 64)).astype(np.float32))
    q, s = quantize_columns(x)
    assert q.shape == (2, 3, 64, 5) and s.shape == (2, 3, 5)
    back = dequantize_cache(q, s)
    err = np.abs(np.asarray(back) - np.asarray(x))
    amax = np.abs(np.asarray(x)).max()
    assert err.max() < amax / 127 * 1.01


def test_write_columns_at_position():
    cache = init_quant_cache(1, 1, 2, 16, 32)
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal((1, 2, 3, 32)).astype(np.float32))
    q, s = quantize_columns(x)
    kq, ks = write_columns(cache["k_q"][0], cache["k_s"][0], q, s, 4)
    back = np.asarray(dequantize_cache(kq, ks))
    np.testing.assert_allclose(back[:, :, 4:7], np.asarray(x), atol=0.05,
                               rtol=0.02)
    assert np.all(back[:, :, :4] == 0)


@pytest.mark.parametrize("hq,hkv,kv_len,s", [
    (4, 4, 17, 128), (8, 2, 100, 128),
    # longer caches: kv_len well past the first few hundred positions
    (8, 2, 500, 512), (4, 4, 512, 1024),
])
def test_decode_q8_kernel_matches_oracle(hq, hkv, kv_len, s):
    rng = np.random.default_rng(2)
    b, d = 2, 64
    q = jnp.asarray(rng.standard_normal((b, hq, 1, d)).astype(np.float32))
    k = jnp.asarray(rng.standard_normal((b, hkv, s, d)).astype(np.float32))
    v = jnp.asarray(rng.standard_normal((b, hkv, s, d)).astype(np.float32))
    kq, ks = quantize_columns(k)
    vq, vs = quantize_columns(v)
    got = ops.decode_attention_q8(q, kq, ks, vq, vs, kv_len)
    # oracle: same quantized values through the reference attention
    kf, vf = dequantize_cache(kq, ks), dequantize_cache(vq, vs)
    valid = (np.arange(s) < kv_len)[None, None, None, :]
    want = refs.gqa_attention_ref(q, kf, vf, jnp.asarray(valid))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-2, atol=2e-2)


def test_engine_int8_cache_cosine_vs_dense(tmp_path):
    from zgml.io.gguf import GGMLType
    from zgml.io.llama_loader import load_llama
    from zgml.runtime.engine import LlamaEngine
    from zgml.utils.synthetic import TINY_TEST, write_synthetic_llama_gguf
    path = tmp_path / "t.gguf"
    write_synthetic_llama_gguf(str(path), TINY_TEST, GGMLType.Q8_0, seed=5)
    model, _ = load_llama(str(path), mode="dense")
    toks = [3, 1, 4, 1, 5, 9, 2, 6]

    eng_f = LlamaEngine(model, donate_cache=False)
    lf = eng_f.prefill(toks)
    eng_q = LlamaEngine(model, cache_dtype="int8", donate_cache=False)
    lq = eng_q.prefill(toks)
    a, b = np.asarray(lf).ravel(), np.asarray(lq).ravel()
    cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-9))
    assert cos >= 0.99, cos

    # decode steps agree too (greedy token path)
    tf, _ = eng_f.step(np.array([7]))
    tq, _ = eng_q.step(np.array([7]))
    s1, s2 = [int(tf[0])], [int(tq[0])]
    for _ in range(4):
        tf, _ = eng_f.step(tf)
        tq, _ = eng_q.step(tq)
        s1.append(int(tf[0]))
        s2.append(int(tq[0]))
    assert s1 == s2, (s1, s2)


@pytest.mark.parametrize("hq,hkv,tq,kv_len,q_off", [
    (4, 4, 16, 40, 24), (8, 2, 24, 24, 0), (4, 2, 8, 72, 64)])
def test_flash_q8_prefill_matches_oracle(hq, hkv, tq, kv_len, q_off):
    """Prefill attention over the int8 d-major cache == dequant + dense
    oracle."""
    from zgml.ops import dispatch as ops
    from zgml.ops.dispatch import force_ref
    from zgml.quant.kv_cache import quantize_columns
    d, s = 64, 128
    rng = np.random.default_rng(3)
    q = jnp.asarray(rng.standard_normal((1, hq, tq, d)) * 0.4, jnp.float32)
    k = jnp.asarray(rng.standard_normal((1, hkv, s, d)) * 0.4, jnp.float32)
    v = jnp.asarray(rng.standard_normal((1, hkv, s, d)) * 0.4, jnp.float32)
    kq, ks = quantize_columns(k)
    vq, vs = quantize_columns(v)
    got = ops.flash_attention_q8(q, kq, ks, vq, vs, kv_len=kv_len,
                                 q_offset=q_off)
    with force_ref():
        want = ops.flash_attention_q8(q, kq, ks, vq, vs, kv_len=kv_len,
                                      q_offset=q_off)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=3e-2, atol=3e-2)


def test_flash_q8_kv_row_offset():
    """Serving prefill-into-slot over the int8 cache reads the right row."""
    from zgml.ops import dispatch as ops
    from zgml.ops.dispatch import force_ref
    from zgml.quant.kv_cache import quantize_columns
    hq = hkv = 2
    d, s, tq = 64, 64, 8
    rng = np.random.default_rng(4)
    q = jnp.asarray(rng.standard_normal((1, hq, tq, d)) * 0.4, jnp.float32)
    k = jnp.asarray(rng.standard_normal((3, hkv, s, d)) * 0.4, jnp.float32)
    v = jnp.asarray(rng.standard_normal((3, hkv, s, d)) * 0.4, jnp.float32)
    kq, ks = quantize_columns(k)
    vq, vs = quantize_columns(v)
    got = ops.flash_attention_q8(q, kq, ks, vq, vs, kv_len=32, q_offset=24,
                                 kv_row=2)
    with force_ref():
        want = ops.flash_attention_q8(q, kq, ks, vq, vs, kv_len=32,
                                      q_offset=24, kv_row=2)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=3e-2, atol=3e-2)


def test_scan_layout_int8_cache_matches_unrolled():
    """Stacked (lax.scan) layers with the stacked int8 tuple cache ==
    unrolled layers with per-layer int8 caches."""
    from zgml.models.llama import LlamaConfig, LlamaModel, init_params
    cfg = LlamaConfig(vocab_size=128, d_model=64, n_heads=4, n_kv_heads=2,
                      d_ff=128, n_layers=3, max_seq_len=32)
    stacked = LlamaModel(cfg, init_params(cfg, seed=6))
    # unrolled view of the same params
    unrolled_layers = [
        {k: v[i] for k, v in stacked.params["layers"].items()}
        for i in range(cfg.n_layers)]
    unrolled = LlamaModel(cfg, {**stacked.params, "layers": unrolled_layers})

    toks = jnp.asarray([[5, 9, 2, 6, 5, 3]], jnp.int32)
    c_s = stacked.init_cache(1, "int8")
    assert isinstance(c_s["k"], tuple) and c_s["k"][0].ndim == 5
    l_s, c_s = stacked.forward(stacked.params, toks, c_s, 0)
    c_u = unrolled.init_cache(1, "int8")
    assert isinstance(c_u["k"], list)
    l_u, c_u = unrolled.forward(unrolled.params, toks, c_u, 0)
    np.testing.assert_allclose(np.asarray(l_s), np.asarray(l_u),
                               rtol=2e-2, atol=2e-2)
    # decode step over the scan int8 cache
    d_s, c_s = stacked.forward(stacked.params, jnp.asarray([[7]]), c_s, 6)
    d_u, _ = unrolled.forward(unrolled.params, jnp.asarray([[7]]), c_u, 6)
    np.testing.assert_allclose(np.asarray(d_s), np.asarray(d_u),
                               rtol=2e-2, atol=2e-2)


def test_prefill_cp_int8_cache():
    """Context-parallel prefill into an int8 cache: the gathered K/V are
    quantized per position; decode continues over the quantized cache."""
    import jax as _jax
    from zgml.models.llama import LlamaConfig, LlamaModel, init_params
    from zgml.parallel import make_mesh
    from zgml.runtime.engine import LlamaEngine
    cfg = LlamaConfig(vocab_size=128, d_model=64, n_heads=4, n_kv_heads=2,
                      d_ff=128, n_layers=2, max_seq_len=128)
    model = LlamaModel(cfg, init_params(cfg, seed=11))
    rng = np.random.default_rng(12)
    prompt = rng.integers(0, 128, 96).astype(np.int32)
    mesh = make_mesh(tp=8, dp=1, axis_names=("dp", "cp"))

    eng = LlamaEngine(model, batch=1, cache_dtype="int8", donate_cache=False)
    last = eng.prefill_cp(prompt, mesh)

    ref = LlamaEngine(model, batch=1, cache_dtype="int8", donate_cache=False)
    ref_last = ref.prefill(prompt)
    a, b = np.asarray(last).ravel(), np.asarray(ref_last).ravel()
    cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-9))
    assert cos >= 0.99, cos
    # decode agreement from the cp-filled int8 cache
    t1, _ = eng.step(np.array([3]))
    t2, _ = ref.step(np.array([3]))
    assert int(t1[0]) == int(t2[0])
