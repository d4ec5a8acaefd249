"""GGUF -> LlamaModel loader (llama.cpp tensor-name convention).

Parity target: src/models/gguf_loader.zig — the name map (token_embd.weight,
blk.{i}.attn_{q,k,v,output}.weight, ffn_{gate,up,down}, norms, output.weight;
documented at gguf_loader.zig:397-411), `configFromGGUF` metadata keys with
fallbacks (:214-234), and both load modes:

  - `mode="quantized"` (analog of loadDirectQuantized, :340-391): Q4_0/Q8_0
    matmul weights stay compressed as PackedWeight (repacked to the planar
    layout); norms/embeddings dequantize to f32.
  - `mode="dense"` (analog of loadDequantized, :412-476): everything dequantized
    to a dense dtype.

Layer tensors are *stacked* along a leading layer axis so the model's lax.scan
consumes them directly.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from zgml.io.gguf import GGUFFile, GGMLType
from zgml.models.llama import LlamaConfig, LlamaModel
from zgml.quant.repack import PackedWeight, repack_gguf_tensor

_QUANT_KINDS = {GGMLType.Q4_0: "q4_0", GGMLType.Q8_0: "q8_0"}

# per-layer matmul weights: model key -> gguf suffix
_LAYER_MATMULS = {
    "wq": "attn_q.weight",
    "wk": "attn_k.weight",
    "wv": "attn_v.weight",
    "wo": "attn_output.weight",
    "w_gate": "ffn_gate.weight",
    "w_up": "ffn_up.weight",
    "w_down": "ffn_down.weight",
}
_LAYER_NORMS = {
    "attn_norm": "attn_norm.weight",
    "ffn_norm": "ffn_norm.weight",
}


def config_from_gguf(gf: GGUFFile) -> LlamaConfig:
    md = gf.metadata
    arch = md.get("general.architecture", "llama")

    def get(key, default=None):
        return md.get(f"{arch}.{key}", default)

    n_heads = int(get("attention.head_count", 32))
    d_model = int(get("embedding_length", 4096))
    vocab = md.get("tokenizer.ggml.tokens")
    if vocab is not None:
        vocab_size = len(vocab)
    else:
        vocab_size = int(gf.tensors["token_embd.weight"].np_shape[0])
    tied = "output.weight" not in gf.tensors
    return LlamaConfig(
        vocab_size=vocab_size,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=int(get("attention.head_count_kv", n_heads)),
        d_ff=int(get("feed_forward_length", 4 * d_model)),
        n_layers=int(get("block_count", 32)),
        max_seq_len=int(get("context_length", 2048)),
        rope_base=float(get("rope.freq_base", 10000.0)),
        rms_norm_eps=float(get("attention.layer_norm_rms_epsilon", 1e-5)),
        tied_lm_head=tied,
    )


def _stack_packed(pws: list[PackedWeight]) -> PackedWeight:
    """Stack per-layer PackedWeights into [L, ...] leaves for lax.scan."""
    first = pws[0]
    for pw in pws[1:]:
        if (pw.kind, pw.n_pad, pw.k_pad) != (first.kind, first.n_pad, first.k_pad):
            raise ValueError("cannot stack heterogeneous PackedWeights")
    return dataclasses.replace(
        first,
        qvals=jnp.asarray(np.stack([np.asarray(p.qvals) for p in pws])),
        scales=jnp.asarray(np.stack([np.asarray(p.scales) for p in pws])))


def _load_matmul(gf: GGUFFile, name: str, mode: str, dtype, **repack_kw):
    """Load one [N, K] matmul weight as PackedWeight or dense K-major [K, N]."""
    info = gf.tensors[name]
    kind = _QUANT_KINDS.get(info.ggml_type)
    if mode == "quantized" and kind is not None:
        n, k = info.np_shape
        return repack_gguf_tensor(kind, gf.tensor_raw(name), n, k, **repack_kw)
    w = gf.tensor_f32(name)                      # [N, K]
    return jnp.asarray(np.ascontiguousarray(w.T), dtype)  # K-major [K, N]


def _load_fused(gf: GGUFFile, names: list[str], mode: str, dtype):
    """Load several same-input weights fused along the out axis (one launch).

    Returns None when the group cannot fuse (mixed quant kinds — real GGUF
    files often keep e.g. attn_v at Q8_0 inside a Q4_0 model); the caller then
    loads them separately.
    """
    from zgml.quant.repack import concat_packed
    kinds = {gf.tensors[nm].ggml_type for nm in names}
    if mode == "quantized" and len(kinds) > 1:
        return None
    parts = [_load_matmul(gf, nm, mode, dtype, n_align=1) for nm in names]
    if isinstance(parts[0], PackedWeight):
        return concat_packed(parts)
    return jnp.concatenate(parts, axis=1)


def load_llama(path: str, mode: str = "quantized",
               dtype=jnp.float32, max_seq_len: int | None = None,
               stack_layers: bool = False,
               fuse: bool = True) -> tuple[LlamaModel, GGUFFile]:
    """Load a llama-architecture GGUF. Returns (model, parsed file).

    stack_layers=False (default) keeps per-layer dicts in a list — the unrolled
    inference layout where weights feed the matmul kernel with no per-layer
    gather. stack_layers=True stacks leaves along a leading layer axis for the
    lax.scan / tensor-parallel path (training, dryrun).

    The parsed GGUFFile is returned so callers can build the tokenizer from its
    metadata (BPETokenizer.from_gguf).
    """
    gf = GGUFFile(path)
    cfg = config_from_gguf(gf)
    if max_seq_len is not None:
        cfg = dataclasses.replace(cfg, max_seq_len=max_seq_len)
    L = cfg.n_layers

    per_layer: list[dict] = []
    for i in range(L):
        layer: dict[str, object] = {}
        for key, suffix in _LAYER_NORMS.items():
            layer[key] = jnp.asarray(gf.tensor_f32(f"blk.{i}.{suffix}"), dtype)
        if fuse and not stack_layers:
            # fused projections: fewer, larger kernel launches per token
            wqkv = _load_fused(
                gf, [f"blk.{i}.attn_q.weight", f"blk.{i}.attn_k.weight",
                     f"blk.{i}.attn_v.weight"], mode, dtype)
            if wqkv is not None:
                layer["wqkv"] = wqkv
            else:
                for key in ("wq", "wk", "wv"):
                    layer[key] = _load_matmul(
                        gf, f"blk.{i}.{_LAYER_MATMULS[key]}", mode, dtype)
            layer["wo"] = _load_matmul(gf, f"blk.{i}.attn_output.weight",
                                       mode, dtype)
            layer["w_down"] = _load_matmul(gf, f"blk.{i}.ffn_down.weight",
                                           mode, dtype)
            wgu = _load_fused(
                gf, [f"blk.{i}.ffn_gate.weight", f"blk.{i}.ffn_up.weight"],
                mode, dtype)
            if wgu is not None:
                layer["w_gate_up"] = wgu
            else:
                for key in ("w_gate", "w_up"):
                    layer[key] = _load_matmul(
                        gf, f"blk.{i}.{_LAYER_MATMULS[key]}", mode, dtype)
        else:
            for key, suffix in _LAYER_MATMULS.items():
                layer[key] = _load_matmul(gf, f"blk.{i}.{suffix}", mode, dtype)
        per_layer.append(layer)

    if stack_layers:
        layers: object = {}
        for key in per_layer[0]:
            leaves = [lyr[key] for lyr in per_layer]
            if isinstance(leaves[0], PackedWeight):
                layers[key] = _stack_packed(leaves)
            else:
                layers[key] = jnp.stack(leaves)
    else:
        layers = per_layer

    params = {
        "tok_embd": jnp.asarray(gf.tensor_f32("token_embd.weight"), dtype),
        "out_norm": jnp.asarray(gf.tensor_f32("output_norm.weight"), dtype),
        "layers": layers,
    }
    if not cfg.tied_lm_head:
        params["lm_head"] = _load_matmul(gf, "output.weight", mode, dtype)
    return LlamaModel(cfg, params), gf


def quantize_llama_params(params: dict, kind: str = "q8_0") -> dict:
    """Post-hoc weight quantization of a dense-loaded llama (the reference's
    `session.quantize(block)`, llama_inference.zig:189-231): every matmul
    weight becomes a PackedWeight in the planar layout; norms, embeddings
    and biases stay f32 (the reference also keeps those dense,
    gguf_loader.zig:171-204). Fused QKV/gate-up stay fused: the dense fused
    [K, N] leaf quantizes with unpadded columns, so the packed result keeps
    the concat_packed layout contract.

    Works on host (numpy); device params are fetched once. Returns a NEW
    params dict (unrolled per-layer list layout only).
    """
    from zgml.quant.repack import quantize_weight

    def q(leaf, n_align=None):
        w = np.asarray(leaf).T  # dense leaves are K-major [K, N] -> [N, K]
        kw = {"n_align": 1} if n_align else {}
        return quantize_weight(np.ascontiguousarray(w), kind, **kw)

    layers = params.get("layers")
    if not isinstance(layers, (list, tuple)):
        raise ValueError("quantize_llama_params expects unrolled layers")
    out = dict(params)
    new_layers = []
    for layer in layers:
        nl = dict(layer)
        for key in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
            if key in nl and not hasattr(nl[key], "qvals"):
                nl[key] = q(nl[key])
        for key in ("wqkv", "w_gate_up"):
            if key in nl and not hasattr(nl[key], "qvals"):
                # one block with unpadded columns: layout-equivalent to the
                # loader's concat of unpadded sections
                nl[key] = q(nl[key], n_align=True)
        new_layers.append(nl)
    out["layers"] = new_layers
    if "lm_head" in out and not hasattr(out["lm_head"], "qvals"):
        out["lm_head"] = q(out["lm_head"])
    return out
