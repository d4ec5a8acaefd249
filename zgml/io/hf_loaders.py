"""HuggingFace safetensors -> model params (ref: src/models/llama_loader.zig,
gpt_loader.zig, loader_utils.zig).

Name maps follow the HF conventions; weights transpose from HF's [out, in]
row-major to this framework's K-major [in, out] (the reference does the same
transpose, llama_loader.zig). GPT-2's separate c_attn already packs QKV; llama's
separate q/k/v projections are concatenated into the fused wqkv layout.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from zgml.io.safetensors import SafetensorsFile
from zgml.models.gpt import GPTConfig, GPTModel
from zgml.models.llama import LlamaConfig, LlamaModel


def _t(arr) -> jnp.ndarray:
    """HF [out, in] -> K-major [in, out]."""
    return jnp.asarray(np.ascontiguousarray(np.asarray(arr, np.float32).T))


def load_llama_hf(path: str, cfg: LlamaConfig, fuse: bool = True,
                  prefix: str = "model.") -> LlamaModel:
    """Load a llama-family HF safetensors file. cfg must match the checkpoint
    (HF config.json is not parsed here — zero-egress environment)."""
    st = SafetensorsFile(path)

    def get(name):
        return st.tensor(prefix + name)

    layers = []
    for i in range(cfg.n_layers):
        p = f"layers.{i}."
        layer = {
            "attn_norm": jnp.asarray(get(p + "input_layernorm.weight"),
                                     jnp.float32),
            "ffn_norm": jnp.asarray(get(p + "post_attention_layernorm.weight"),
                                    jnp.float32),
        }
        wq = _t(get(p + "self_attn.q_proj.weight"))
        wk = _t(get(p + "self_attn.k_proj.weight"))
        wv = _t(get(p + "self_attn.v_proj.weight"))
        if fuse:
            layer["wqkv"] = jnp.concatenate([wq, wk, wv], axis=1)
        else:
            layer.update(wq=wq, wk=wk, wv=wv)
        layer["wo"] = _t(get(p + "self_attn.o_proj.weight"))
        wg = _t(get(p + "mlp.gate_proj.weight"))
        wu = _t(get(p + "mlp.up_proj.weight"))
        if fuse:
            layer["w_gate_up"] = jnp.concatenate([wg, wu], axis=1)
        else:
            layer.update(w_gate=wg, w_up=wu)
        layer["w_down"] = _t(get(p + "mlp.down_proj.weight"))
        layers.append(layer)

    params = {
        "tok_embd": jnp.asarray(get("embed_tokens.weight"), jnp.float32),
        "out_norm": jnp.asarray(get("norm.weight"), jnp.float32),
        "layers": layers,
    }
    if not cfg.tied_lm_head:
        params["lm_head"] = _t(st.tensor("lm_head.weight"))
    st.close()
    return LlamaModel(cfg, params)


def load_gpt2_hf(path: str, cfg: GPTConfig, prefix: str = "") -> GPTModel:
    """GPT-2 HF safetensors. Note: HF GPT-2 Conv1D stores c_attn/c_fc weights
    already as [in, out] (not transposed)."""
    st = SafetensorsFile(path)

    def get(name):
        return st.tensor(prefix + name)

    layers = []
    for i in range(cfg.n_layers):
        p = f"h.{i}."
        layers.append({
            "ln_1": {"g": jnp.asarray(get(p + "ln_1.weight"), jnp.float32),
                     "b": jnp.asarray(get(p + "ln_1.bias"), jnp.float32)},
            "ln_2": {"g": jnp.asarray(get(p + "ln_2.weight"), jnp.float32),
                     "b": jnp.asarray(get(p + "ln_2.bias"), jnp.float32)},
            "w_qkv": jnp.asarray(get(p + "attn.c_attn.weight"), jnp.float32),
            "b_qkv": jnp.asarray(get(p + "attn.c_attn.bias"), jnp.float32),
            "wo": jnp.asarray(get(p + "attn.c_proj.weight"), jnp.float32),
            "bo": jnp.asarray(get(p + "attn.c_proj.bias"), jnp.float32),
            "w_fc": jnp.asarray(get(p + "mlp.c_fc.weight"), jnp.float32),
            "b_fc": jnp.asarray(get(p + "mlp.c_fc.bias"), jnp.float32),
            "w_proj": jnp.asarray(get(p + "mlp.c_proj.weight"), jnp.float32),
            "b_proj": jnp.asarray(get(p + "mlp.c_proj.bias"), jnp.float32),
        })
    params = {
        "wte": jnp.asarray(get("wte.weight"), jnp.float32),
        "wpe": jnp.asarray(get("wpe.weight"), jnp.float32),
        "ln_f": {"g": jnp.asarray(get("ln_f.weight"), jnp.float32),
                 "b": jnp.asarray(get("ln_f.bias"), jnp.float32)},
        "layers": layers,
    }
    st.close()
    return GPTModel(cfg, params)


def load_whisper_hf(path: str, cfg=None):
    """Load a HuggingFace Whisper safetensors checkpoint
    (ref: src/models/whisper_loader.zig:1-117 — same name map; 2D weights
    transpose from HF [out, in] to this framework's [in, out]).

    cfg: WhisperConfig; if None it is inferred from tensor shapes.
    """
    from zgml.models.whisper import WhisperConfig, WhisperModel

    st = SafetensorsFile(path)
    names = set(st.keys())

    def get(name):
        return st.tensor(name)

    def ln(prefix):
        return {"g": jnp.asarray(get(prefix + ".weight"), jnp.float32),
                "b": jnp.asarray(get(prefix + ".bias"), jnp.float32)}

    def attn(prefix):
        # HF whisper: q/v have biases, k does not (matches _attn_params)
        return {
            "wq": _t(get(prefix + ".q_proj.weight")),
            "bq": jnp.asarray(get(prefix + ".q_proj.bias"), jnp.float32),
            "wk": _t(get(prefix + ".k_proj.weight")),
            "wv": _t(get(prefix + ".v_proj.weight")),
            "bv": jnp.asarray(get(prefix + ".v_proj.bias"), jnp.float32),
            "wo": _t(get(prefix + ".out_proj.weight")),
            "bo": jnp.asarray(get(prefix + ".out_proj.bias"), jnp.float32),
        }

    def block(prefix, cross: bool):
        lyr = {
            "ln_1": ln(prefix + ".self_attn_layer_norm"),
            "attn": attn(prefix + ".self_attn"),
            "ln_2": ln(prefix + ".final_layer_norm"),
            "w_fc": _t(get(prefix + ".fc1.weight")),
            "b_fc": jnp.asarray(get(prefix + ".fc1.bias"), jnp.float32),
            "w_proj": _t(get(prefix + ".fc2.weight")),
            "b_proj": jnp.asarray(get(prefix + ".fc2.bias"), jnp.float32),
        }
        if cross:
            lyr["ln_x"] = ln(prefix + ".encoder_attn_layer_norm")
            lyr["cross"] = attn(prefix + ".encoder_attn")
        return lyr

    n_enc = len({n.split(".")[3] for n in names
                 if n.startswith("model.encoder.layers.")})
    n_dec = len({n.split(".")[3] for n in names
                 if n.startswith("model.decoder.layers.")})
    conv1_w = np.asarray(get("model.encoder.conv1.weight"), np.float32)
    tok = np.asarray(get("model.decoder.embed_tokens.weight"), np.float32)
    pos_dec = np.asarray(get("model.decoder.embed_positions.weight"),
                         np.float32)
    pos_enc = np.asarray(get("model.encoder.embed_positions.weight"),
                         np.float32)
    d_model, n_mels = conv1_w.shape[0], conv1_w.shape[1]
    if cfg is None:
        # head counts live in HF config.json (not derivable from shapes)
        import json
        import os
        heads_enc = heads_dec = max(1, d_model // 64)
        cfg_path = os.path.join(os.path.dirname(os.path.abspath(path)),
                                "config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                hf = json.load(f)
            heads_enc = hf.get("encoder_attention_heads", heads_enc)
            heads_dec = hf.get("decoder_attention_heads", heads_dec)
        cfg = WhisperConfig(
            n_mels=n_mels, n_audio_ctx=pos_enc.shape[0],
            n_audio_state=d_model, n_audio_heads=heads_enc,
            n_audio_layers=n_enc,
            vocab_size=tok.shape[0], n_text_ctx=pos_dec.shape[0],
            n_text_state=d_model, n_text_heads=heads_dec,
            n_text_layers=n_dec)

    params = {
        # HF conv [out, in, k] -> lax "WIO" [k, in, out]
        "conv1_w": jnp.asarray(conv1_w.transpose(2, 1, 0)),
        "conv1_b": jnp.asarray(get("model.encoder.conv1.bias"), jnp.float32),
        "conv2_w": jnp.asarray(np.asarray(get("model.encoder.conv2.weight"),
                                          np.float32).transpose(2, 1, 0)),
        "conv2_b": jnp.asarray(get("model.encoder.conv2.bias"), jnp.float32),
        "enc_pos_embd": jnp.asarray(pos_enc),
        "enc_ln_post": ln("model.encoder.layer_norm"),
        "enc_layers": [block(f"model.encoder.layers.{i}", cross=False)
                       for i in range(cfg.n_audio_layers)],
        "tok_embd": jnp.asarray(tok),
        "pos_embd": jnp.asarray(pos_dec),
        "dec_ln": ln("model.decoder.layer_norm"),
        "dec_layers": [block(f"model.decoder.layers.{i}", cross=True)
                       for i in range(cfg.n_text_layers)],
    }
    st.close()
    return WhisperModel(cfg, params)
