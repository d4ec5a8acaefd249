"""Synthetic llama-architecture GGUF generator.

No network egress exists in this environment, so tests and benchmarks build
models with the same shapes/format as real ones (the reference's in-memory
GGUF-buffer test strategy, src/gguf.zig:507-660, scaled up to whole models).
"""
from __future__ import annotations

import numpy as np

from zgml.io.gguf import GGUFWriter, GGMLType
from zgml.models.llama import LlamaConfig


# Real-model shape presets (for honest benchmarks)
SMOLLM_135M = LlamaConfig(vocab_size=49152, d_model=576, n_heads=9, n_kv_heads=3,
                          d_ff=1536, n_layers=30, max_seq_len=2048,
                          rope_base=10000.0, tied_lm_head=True)
TINYLLAMA_1_1B = LlamaConfig(vocab_size=32000, d_model=2048, n_heads=32,
                             n_kv_heads=4, d_ff=5632, n_layers=22,
                             max_seq_len=2048, rope_base=10000.0)
LLAMA2_7B = LlamaConfig(vocab_size=32000, d_model=4096, n_heads=32, n_kv_heads=32,
                        d_ff=11008, n_layers=32, max_seq_len=4096,
                        rope_base=10000.0)
LLAMA3_8B = LlamaConfig(vocab_size=128256, d_model=4096, n_heads=32, n_kv_heads=8,
                        d_ff=14336, n_layers=32, max_seq_len=8192,
                        rope_base=500000.0)

TINY_TEST = LlamaConfig(vocab_size=256, d_model=64, n_heads=4, n_kv_heads=2,
                        d_ff=128, n_layers=2, max_seq_len=64)


def write_synthetic_llama_gguf(path: str, cfg: LlamaConfig,
                               quant: int = GGMLType.Q8_0, seed: int = 0,
                               scale: float = 0.05):
    """Write a random llama GGUF with llama.cpp tensor names and metadata."""
    rng = np.random.default_rng(seed)
    d, hd = cfg.d_model, cfg.head_dim
    nq, nkv = cfg.n_heads * hd, cfg.n_kv_heads * hd

    w = GGUFWriter()
    w.add_metadata("general.architecture", "llama")
    w.add_metadata("general.name", "synthetic")
    w.add_metadata("llama.embedding_length", cfg.d_model)
    w.add_metadata("llama.block_count", cfg.n_layers)
    w.add_metadata("llama.attention.head_count", cfg.n_heads)
    w.add_metadata("llama.attention.head_count_kv", cfg.n_kv_heads)
    w.add_metadata("llama.feed_forward_length", cfg.d_ff)
    w.add_metadata("llama.context_length", cfg.max_seq_len)
    w.add_metadata("llama.rope.freq_base", cfg.rope_base)
    w.add_metadata("llama.attention.layer_norm_rms_epsilon", cfg.rms_norm_eps)

    def rand(*shape):
        # f32 RNG directly: the f64 default doubles both RNG time and peak
        # memory, which matters at 7B (~27 GB of draws)
        out = rng.standard_normal(shape, dtype=np.float32)
        out *= scale
        return out

    # norms/embeddings stay f32 (the reference also dequantizes these,
    # gguf_loader.zig:171-204)
    w.add_tensor("token_embd.weight", rand(cfg.vocab_size, d), GGMLType.F32)
    w.add_tensor("output_norm.weight", np.ones(d, np.float32), GGMLType.F32)
    if not cfg.tied_lm_head:
        w.add_tensor("output.weight", rand(cfg.vocab_size, d), quant)
    for i in range(cfg.n_layers):
        w.add_tensor(f"blk.{i}.attn_norm.weight", np.ones(d, np.float32))
        w.add_tensor(f"blk.{i}.ffn_norm.weight", np.ones(d, np.float32))
        w.add_tensor(f"blk.{i}.attn_q.weight", rand(nq, d), quant)
        w.add_tensor(f"blk.{i}.attn_k.weight", rand(nkv, d), quant)
        w.add_tensor(f"blk.{i}.attn_v.weight", rand(nkv, d), quant)
        w.add_tensor(f"blk.{i}.attn_output.weight", rand(d, nq), quant)
        w.add_tensor(f"blk.{i}.ffn_gate.weight", rand(cfg.d_ff, d), quant)
        w.add_tensor(f"blk.{i}.ffn_up.weight", rand(cfg.d_ff, d), quant)
        w.add_tensor(f"blk.{i}.ffn_down.weight", rand(d, cfg.d_ff), quant)
    w.write(path)
