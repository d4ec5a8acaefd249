"""safetensors roundtrip, HF loaders, GPT-2 model + engine, tokenizer."""
import numpy as np
import jax.numpy as jnp
import pytest

from zgml.io.safetensors import SafetensorsFile, save_safetensors
from zgml.models.gpt import GPTConfig, GPTModel, init_params


def test_safetensors_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    tensors = {
        "a": rng.standard_normal((3, 4)).astype(np.float32),
        "b": (rng.standard_normal(8) * 10).astype(np.float16),
        "c": np.arange(6, dtype=np.int32).reshape(2, 3),
    }
    p = tmp_path / "t.safetensors"
    save_safetensors(p, tensors, {"origin": "test"})
    with SafetensorsFile(p) as st:
        assert st.metadata["origin"] == "test"
        assert set(st.keys()) == {"a", "b", "c"}
        for k in tensors:
            np.testing.assert_array_equal(st.tensor(k), tensors[k])


def test_safetensors_bf16(tmp_path):
    """bf16 payloads decode via bit-expansion."""
    import struct, json
    vals = np.asarray([1.0, -2.5, 0.15625], np.float32)
    u16 = (vals.view(np.uint32) >> 16).astype(np.uint16)
    header = {"x": {"dtype": "BF16", "shape": [3], "data_offsets": [0, 6]}}
    hjson = json.dumps(header).encode()
    with open(tmp_path / "b.safetensors", "wb") as f:
        f.write(struct.pack("<Q", len(hjson)))
        f.write(hjson)
        f.write(u16.tobytes())
    with SafetensorsFile(tmp_path / "b.safetensors") as st:
        out = st.tensor("x")
        np.testing.assert_allclose(out, [1.0, -2.5, 0.15625], rtol=1e-2)


CFG = GPTConfig(vocab_size=128, d_model=32, n_heads=4, n_layers=2,
                max_seq_len=32)


def test_gpt2_forward_and_engine():
    from zgml.runtime.engine import LlamaEngine
    model = GPTModel(CFG, init_params(CFG, seed=0))
    eng = LlamaEngine(model, donate_cache=False)
    out = eng.generate([1, 2, 3], 6)
    assert len(out) == 6
    eng.reset()
    assert eng.generate([1, 2, 3], 6) == out


def test_gpt2_prefill_matches_steps():
    model = GPTModel(CFG, init_params(CFG, seed=1))
    toks = [5, 9, 2, 7, 11]
    cache = model.init_cache(1)
    for i, t in enumerate(toks):
        logits, cache = model.forward(model.params,
                                      jnp.asarray([[t]], jnp.int32), cache, i)
    l_seq = np.asarray(logits[:, -1])
    logits2, _ = model.forward(model.params, jnp.asarray([toks], jnp.int32),
                               model.init_cache(1), 0)
    np.testing.assert_allclose(np.asarray(logits2[:, -1]), l_seq,
                               rtol=2e-2, atol=2e-2)


def test_gpt2_hf_loader_roundtrip(tmp_path):
    """Save HF-convention tensors, load, compare forward with direct params."""
    from zgml.io.hf_loaders import load_gpt2_hf
    model = GPTModel(CFG, init_params(CFG, seed=2))
    p = model.params
    tensors = {
        "wte.weight": np.asarray(p["wte"]),
        "wpe.weight": np.asarray(p["wpe"]),
        "ln_f.weight": np.asarray(p["ln_f"]["g"]),
        "ln_f.bias": np.asarray(p["ln_f"]["b"]),
    }
    for i, lyr in enumerate(p["layers"]):
        pre = f"h.{i}."
        tensors.update({
            pre + "ln_1.weight": np.asarray(lyr["ln_1"]["g"]),
            pre + "ln_1.bias": np.asarray(lyr["ln_1"]["b"]),
            pre + "ln_2.weight": np.asarray(lyr["ln_2"]["g"]),
            pre + "ln_2.bias": np.asarray(lyr["ln_2"]["b"]),
            pre + "attn.c_attn.weight": np.asarray(lyr["w_qkv"]),
            pre + "attn.c_attn.bias": np.asarray(lyr["b_qkv"]),
            pre + "attn.c_proj.weight": np.asarray(lyr["wo"]),
            pre + "attn.c_proj.bias": np.asarray(lyr["bo"]),
            pre + "mlp.c_fc.weight": np.asarray(lyr["w_fc"]),
            pre + "mlp.c_fc.bias": np.asarray(lyr["b_fc"]),
            pre + "mlp.c_proj.weight": np.asarray(lyr["w_proj"]),
            pre + "mlp.c_proj.bias": np.asarray(lyr["b_proj"]),
        })
    path = tmp_path / "gpt2.safetensors"
    save_safetensors(path, tensors)
    loaded = load_gpt2_hf(str(path), CFG)
    toks = jnp.asarray([[3, 1, 4]], jnp.int32)
    a, _ = model.forward(model.params, toks, model.init_cache(1), 0)
    b, _ = loaded.forward(loaded.params, toks, loaded.init_cache(1), 0)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4,
                               atol=1e-4)


def test_llama_hf_loader_roundtrip(tmp_path):
    from zgml.io.hf_loaders import load_llama_hf
    from zgml.models.llama import LlamaConfig, LlamaModel
    from zgml.models.llama import init_params as llama_init
    cfg = LlamaConfig(vocab_size=64, d_model=32, n_heads=4, n_kv_heads=2,
                      d_ff=48, n_layers=2, max_seq_len=16, tied_lm_head=True)
    # build unstacked dense params, then emit HF-named safetensors
    stacked = llama_init(cfg, seed=3)
    tensors = {"model.embed_tokens.weight": np.asarray(stacked["tok_embd"]),
               "model.norm.weight": np.asarray(stacked["out_norm"])}
    hf_names = {"wq": "self_attn.q_proj", "wk": "self_attn.k_proj",
                "wv": "self_attn.v_proj", "wo": "self_attn.o_proj",
                "w_gate": "mlp.gate_proj", "w_up": "mlp.up_proj",
                "w_down": "mlp.down_proj"}
    for i in range(cfg.n_layers):
        tensors[f"model.layers.{i}.input_layernorm.weight"] = \
            np.asarray(stacked["layers"]["attn_norm"][i])
        tensors[f"model.layers.{i}.post_attention_layernorm.weight"] = \
            np.asarray(stacked["layers"]["ffn_norm"][i])
        for key, hf in hf_names.items():
            w = np.asarray(stacked["layers"][key][i])   # K-major [in, out]
            tensors[f"model.layers.{i}.{hf}.weight"] = \
                np.ascontiguousarray(w.T)               # HF [out, in]
    path = tmp_path / "llama.safetensors"
    save_safetensors(path, tensors)
    loaded = load_llama_hf(str(path), cfg)

    ref_model = LlamaModel(cfg, stacked)
    toks = jnp.asarray([[3, 1, 4, 1]], jnp.int32)
    a, _ = ref_model.forward(ref_model.params, toks, ref_model.init_cache(1), 0)
    b, _ = loaded.forward(loaded.params, toks, loaded.init_cache(1), 0)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=2e-4,
                               atol=2e-4)


def test_tokenizer_roundtrip():
    from zgml.io.tokenizer import BPETokenizer, _bytes_to_unicode
    # tiny vocab: all byte-level singletons + a merge
    b2u = _bytes_to_unicode()
    vocab = {ch: i for i, ch in enumerate(b2u.values())}
    vocab["he"] = len(vocab)
    vocab["hel"] = len(vocab)
    tok = BPETokenizer(vocab, [("h", "e"), ("he", "l")])
    ids = tok.encode("hello world")
    assert tok.decode(ids) == "hello world"
    assert vocab["hel"] in ids  # merges applied


def test_pretokenizer_matches_gpt2_regex_golden():
    """Byte-exact pretokenization vs the canonical GPT-2 pattern (`regex`
    module as golden oracle) over contractions, Unicode classes, whitespace
    edge cases. """
    import regex
    from zgml.io.tokenizer import BPETokenizer
    pat = regex.compile(
        r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+""")
    tok = BPETokenizer.__new__(BPETokenizer)   # pretok needs no vocab

    cases = [
        "Hello world",
        "I'm sure they're won't we've y'all'll i'd 'S 'x",
        "  leading and   multiple   spaces  ",
        "tabs\tand\nnewlines \t mixed\r\n end",
        "numbers 123 mixed42text 3.14 1,000,000",
        "punct!!! ...---... #hashtag @user (parens) [brackets]",
        "unicode: café naïve Ångström 北京 русский مرحبا",
        "roman numerals Ⅷ Ⅻ and fractions ½ ¾",
        "emoji 🙂🙂 and symbols €100 £50 ¥",
        "trailing space ",
        " ",
        "\n\n\n",
        "a",
        "don't stop believin' — hold on to that feelin'",
        "CamelCase and snake_case and kebab-case",
        "x y nbsp  double",
    ]
    for text in cases:
        want = pat.findall(text)
        got = tok._split_pretok(text)
        assert got == want, (text, got, want)
        assert "".join(got) == text


def test_pretokenizer_fuzz_vs_regex():
    import random
    import regex
    from zgml.io.tokenizer import BPETokenizer
    pat = regex.compile(
        r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+""")
    tok = BPETokenizer.__new__(BPETokenizer)
    rng = random.Random(0)
    alphabet = ("abcXYZ019' \t\n.,-—Ⅷ½北водé🙂  "
                + "".join(chr(c) for c in range(0x20, 0x7f, 7)))
    for _ in range(300):
        text = "".join(rng.choice(alphabet)
                       for _ in range(rng.randrange(0, 40)))
        assert tok._split_pretok(text) == pat.findall(text), repr(text)


def test_packed_checkpoint_roundtrip(tmp_path):
    """GGUF -> repacked safetensors checkpoint -> identical logits, no
    repack on reload (the mmap fast-load path for bench/serving)."""
    import jax.numpy as jnp
    from zgml.io.gguf import GGMLType
    from zgml.io.llama_loader import load_llama
    from zgml.io.packed_ckpt import load_packed_llama, save_packed_llama
    from zgml.utils.synthetic import TINY_TEST, write_synthetic_llama_gguf

    g = str(tmp_path / "m.gguf")
    write_synthetic_llama_gguf(g, TINY_TEST, GGMLType.Q4_0, seed=5)
    model, _ = load_llama(g, mode="quantized")
    p = str(tmp_path / "m.packed.safetensors")
    save_packed_llama(p, model)
    loaded = load_packed_llama(p)
    assert loaded.cfg == model.cfg

    toks = jnp.asarray([[1, 2, 3, 4]], jnp.int32)
    want, _ = model.forward(model.params, toks, model.init_cache(1), 0)
    got, _ = loaded.forward(loaded.params, toks, loaded.init_cache(1), 0)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
