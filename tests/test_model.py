"""Llama model + engine tests (CPU, interpret-mode kernels).

Mirrors the reference's equivalence/metamorphic strategy (SURVEY.md §4.3):
prefill vs sequential step, reset determinism, quantized-vs-dense cosine
similarity, loader roundtrip.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from zgml.io.llama_loader import load_llama, config_from_gguf
from zgml.models.llama import LlamaConfig, LlamaModel, init_params
from zgml.runtime.engine import LlamaEngine
from zgml.utils.synthetic import TINY_TEST, write_synthetic_llama_gguf
from zgml.io.gguf import GGMLType


@pytest.fixture(scope="module")
def tiny_gguf(tmp_path_factory):
    path = tmp_path_factory.mktemp("models") / "tiny.gguf"
    write_synthetic_llama_gguf(str(path), TINY_TEST, GGMLType.Q8_0, seed=3)
    return str(path)


@pytest.fixture(scope="module")
def dense_model(tiny_gguf):
    model, _ = load_llama(tiny_gguf, mode="dense")
    return model


def test_config_from_gguf(tiny_gguf):
    from zgml.io.gguf import GGUFFile
    with GGUFFile(tiny_gguf) as gf:
        cfg = config_from_gguf(gf)
    assert cfg.d_model == TINY_TEST.d_model
    assert cfg.n_kv_heads == TINY_TEST.n_kv_heads
    assert cfg.n_layers == TINY_TEST.n_layers
    assert not cfg.tied_lm_head
    assert cfg.vocab_size == TINY_TEST.vocab_size


def test_forward_shapes(dense_model):
    model = dense_model
    cache = model.init_cache(1)
    tokens = jnp.asarray([[1, 2, 3, 4]], jnp.int32)
    logits, cache2 = model.forward(model.params, tokens, cache, 0)
    assert logits.shape == (1, 4, model.cfg.vocab_size)
    assert not np.any(np.isnan(np.asarray(logits)))
    assert len(cache2["k"]) == len(cache["k"])
    assert cache2["k"][0].shape == cache["k"][0].shape


def test_prefill_matches_sequential_decode(dense_model):
    """ref: 'prefill vs sequential step', llama_inference.zig:983-1034."""
    toks = [5, 17, 9, 120, 33, 7, 64, 2, 90]
    # sequential: step one token at a time
    eng1 = LlamaEngine(dense_model, prefill_chunk=4, donate_cache=False)
    logits_seq = None
    for i, t in enumerate(toks):
        model = dense_model
        logits, eng1.cache = model.forward(
            model.params, jnp.asarray([[t]], jnp.int32), eng1.cache, i)
        logits_seq = logits[:, -1]
    # chunked prefill (chunk=4 over 9 tokens => 4+4+1 with padded tail)
    eng2 = LlamaEngine(dense_model, prefill_chunk=4, donate_cache=False)
    logits_pf = eng2.prefill(toks)
    np.testing.assert_allclose(np.asarray(logits_pf), np.asarray(logits_seq),
                               rtol=2e-2, atol=2e-2)


def test_reset_determinism(dense_model):
    """ref: reset determinism, llama_inference.zig:797-827."""
    eng = LlamaEngine(dense_model, donate_cache=False)
    out1 = eng.generate([1, 2, 3], 5)
    eng.reset()
    out2 = eng.generate([1, 2, 3], 5)
    assert out1 == out2


def test_quantized_close_to_dense(tiny_gguf, dense_model):
    """ref: quantized cosine-similarity >= 0.99, llama_inference.zig:911-954."""
    qmodel, _ = load_llama(tiny_gguf, mode="quantized")
    # quantized path must actually use PackedWeight
    from zgml.quant.repack import PackedWeight
    assert isinstance(qmodel.params["layers"][0]["wqkv"], PackedWeight)
    toks = jnp.asarray([[3, 1, 4, 1, 5, 9, 2, 6]], jnp.int32)
    ld, _ = dense_model.forward(dense_model.params, toks,
                                dense_model.init_cache(1), 0)
    lq, _ = qmodel.forward(qmodel.params, toks, qmodel.init_cache(1), 0)
    a = np.asarray(ld[:, -1]).ravel()
    b = np.asarray(lq[:, -1]).ravel()
    cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-9))
    assert cos >= 0.99, cos


def test_generate_greedy_deterministic(dense_model):
    eng = LlamaEngine(dense_model, donate_cache=False)
    out = eng.generate([10, 20, 30], 8)
    assert len(out) == 8
    assert all(0 <= t < dense_model.cfg.vocab_size for t in out)


def test_generate_burst_matches_step_loop(dense_model):
    """generate's default path is the decode_n on-device scan; at greedy it
    must emit the same tokens as the per-token step loop, and a stop id
    mid-burst truncates the output at its first occurrence."""
    eng = LlamaEngine(dense_model, donate_cache=False)
    out_burst = eng.generate([10, 20, 30], 12, burst=4)
    eng2 = LlamaEngine(dense_model, donate_cache=False)
    out_step = eng2.generate([10, 20, 30], 12, burst=1)
    assert out_burst == out_step
    stop = out_burst[5]
    first = out_burst.index(stop)
    eng3 = LlamaEngine(dense_model, donate_cache=False)
    out_stop = eng3.generate([10, 20, 30], 12, stop_ids=(stop,), burst=4)
    assert out_stop == out_burst[:first + 1]


def test_init_params_forward():
    cfg = LlamaConfig(vocab_size=128, d_model=32, n_heads=2, n_kv_heads=1,
                      d_ff=64, n_layers=2, max_seq_len=32, tied_lm_head=True)
    model = LlamaModel(cfg, init_params(cfg, seed=0))
    logits, _ = model.forward(model.params, jnp.asarray([[1, 2]], jnp.int32),
                              model.init_cache(1), 0)
    assert logits.shape == (1, 2, 128)
    assert np.isfinite(np.asarray(logits)).all()


def test_mixed_quant_kinds_load(tmp_path):
    """Real GGUFs mix quant types (e.g. Q8_0 attn_v in a Q4_0 model); the
    loader must fall back to unfused projections for mixed groups."""
    import numpy as np
    from zgml.io.gguf import GGUFWriter, GGMLType
    from zgml.utils.synthetic import TINY_TEST
    cfg = TINY_TEST
    rng = np.random.default_rng(0)
    d, hd = cfg.d_model, cfg.head_dim
    nq, nkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    w = GGUFWriter()
    w.add_metadata("general.architecture", "llama")
    w.add_metadata("llama.embedding_length", d)
    w.add_metadata("llama.block_count", cfg.n_layers)
    w.add_metadata("llama.attention.head_count", cfg.n_heads)
    w.add_metadata("llama.attention.head_count_kv", cfg.n_kv_heads)
    w.add_metadata("llama.feed_forward_length", cfg.d_ff)
    w.add_metadata("llama.context_length", cfg.max_seq_len)
    rand = lambda *s: (rng.standard_normal(s) * 0.05).astype(np.float32)
    w.add_tensor("token_embd.weight", rand(cfg.vocab_size, d))
    w.add_tensor("output_norm.weight", np.ones(d, np.float32))
    w.add_tensor("output.weight", rand(cfg.vocab_size, d), GGMLType.Q8_0)
    for i in range(cfg.n_layers):
        w.add_tensor(f"blk.{i}.attn_norm.weight", np.ones(d, np.float32))
        w.add_tensor(f"blk.{i}.ffn_norm.weight", np.ones(d, np.float32))
        w.add_tensor(f"blk.{i}.attn_q.weight", rand(nq, d), GGMLType.Q4_0)
        w.add_tensor(f"blk.{i}.attn_k.weight", rand(nkv, d), GGMLType.Q4_0)
        w.add_tensor(f"blk.{i}.attn_v.weight", rand(nkv, d), GGMLType.Q8_0)
        w.add_tensor(f"blk.{i}.attn_output.weight", rand(d, nq), GGMLType.Q4_0)
        w.add_tensor(f"blk.{i}.ffn_gate.weight", rand(cfg.d_ff, d), GGMLType.Q4_0)
        w.add_tensor(f"blk.{i}.ffn_up.weight", rand(cfg.d_ff, d), GGMLType.Q4_0)
        w.add_tensor(f"blk.{i}.ffn_down.weight", rand(d, cfg.d_ff), GGMLType.Q4_0)
    path = tmp_path / "mixed.gguf"
    w.write(path)
    model, _ = load_llama(str(path), mode="quantized")
    lyr = model.params["layers"][0]
    assert "wqkv" not in lyr and "wq" in lyr          # mixed group unfused
    assert "w_gate_up" in lyr                          # uniform group fused
    logits, _ = model.forward(model.params, jnp.asarray([[1, 2, 3]], jnp.int32),
                              model.init_cache(1), 0)
    assert np.isfinite(np.asarray(logits)).all()


def test_quantized_q4_close_to_dense(tmp_path):
    """Q4_0 end-to-end (incl. part-padded fused gate_up) vs its dequantized
    dense twin."""
    path = tmp_path / "t4.gguf"
    write_synthetic_llama_gguf(str(path), TINY_TEST, GGMLType.Q4_0, seed=6)
    dmodel, _ = load_llama(str(path), mode="dense")
    qmodel, _ = load_llama(str(path), mode="quantized")
    toks = jnp.asarray([[3, 1, 4, 1, 5, 9, 2, 6]], jnp.int32)
    ld, _ = dmodel.forward(dmodel.params, toks, dmodel.init_cache(1), 0)
    lq, _ = qmodel.forward(qmodel.params, toks, qmodel.init_cache(1), 0)
    a = np.asarray(ld[:, -1]).ravel()
    b = np.asarray(lq[:, -1]).ravel()
    cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-9))
    assert cos >= 0.999, cos  # dense is the dequantized q4 -> near-exact


def test_post_hoc_quantize_matches_dense():
    """model.quantize() (ref: session.quantize, llama_inference.zig:189-231):
    dense-loaded model quantized in place tracks the dense outputs."""
    import tempfile, os
    import numpy as np
    from zgml.io.gguf import GGMLType
    from zgml.io.llama_loader import load_llama
    from zgml.runtime.engine import LlamaEngine
    from zgml.utils.synthetic import TINY_TEST, write_synthetic_llama_gguf
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "m.gguf")
        write_synthetic_llama_gguf(path, TINY_TEST, GGMLType.F32, seed=21)
        dense, _ = load_llama(path, mode="dense")
        toks = [3, 1, 4, 1, 5]
        ed = LlamaEngine(dense, donate_cache=False)
        ld = np.asarray(ed.prefill(toks)).ravel()

        qmodel, _ = load_llama(path, mode="dense")
        qmodel.quantize("q8_0")
        from zgml.quant.repack import PackedWeight
        l0 = qmodel.params["layers"][0]
        assert any(isinstance(v, PackedWeight) for v in l0.values())
        eq = LlamaEngine(qmodel, donate_cache=False)
        lq = np.asarray(eq.prefill(toks)).ravel()
        cos = float(ld @ lq / (np.linalg.norm(ld) * np.linalg.norm(lq) + 1e-9))
        assert cos > 0.99, cos
