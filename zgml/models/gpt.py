"""GPT-2-style decoder model (ref: src/models/gpt.zig, src/models/transformer.zig).

Pre-LN blocks with a packed w_qkv [D, 3D] single-launch projection (the
reference's packed-QKV design, gpt.zig), GeLU FFN, LayerNorm (gamma+beta),
token + positional embeddings, tied LM head. Same functional interface as
LlamaModel (forward(params, tokens, cache, pos) + init_cache), so LlamaEngine
serves GPT too.

Positional embeddings: learned wpe (HF GPT-2) when present in params,
sinusoidal otherwise (the reference's choice, models/embedding.zig).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from zgml.ops import dispatch as ops
from zgml.ops import refs


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int
    d_model: int
    n_heads: int
    n_layers: int
    max_seq_len: int = 1024
    d_ff: int | None = None          # default 4*d_model
    layer_norm_eps: float = 1e-5
    learned_pos: bool = True

    @property
    def head_dim(self):
        return self.d_model // self.n_heads

    @property
    def ff(self):
        return self.d_ff or 4 * self.d_model


def sinusoidal_positions(max_seq: int, d: int) -> np.ndarray:
    """ref: models/embedding.zig sinusoidal table."""
    pos = np.arange(max_seq)[:, None]
    i = np.arange(d)[None, :]
    angle = pos / np.power(10000.0, (2 * (i // 2)) / d)
    out = np.zeros((max_seq, d), np.float32)
    out[:, 0::2] = np.sin(angle[:, 0::2])
    out[:, 1::2] = np.cos(angle[:, 1::2])
    return out


def init_params(cfg: GPTConfig, seed: int = 0, scale: float = 0.02) -> dict:
    rng = np.random.default_rng(seed)
    d, f, L = cfg.d_model, cfg.ff, cfg.n_layers

    def w(*shape):
        return jnp.asarray(rng.standard_normal(shape).astype(np.float32) * scale)

    params = {
        "wte": w(cfg.vocab_size, d),
        "ln_f": {"g": jnp.ones((d,)), "b": jnp.zeros((d,))},
        "layers": [
            {
                "ln_1": {"g": jnp.ones((d,)), "b": jnp.zeros((d,))},
                "ln_2": {"g": jnp.ones((d,)), "b": jnp.zeros((d,))},
                "w_qkv": w(d, 3 * d),      # packed single GEMM (ref: gpt.zig)
                "b_qkv": jnp.zeros((3 * d,)),
                "wo": w(d, d),
                "bo": jnp.zeros((d,)),
                "w_fc": w(d, f),
                "b_fc": jnp.zeros((f,)),
                "w_proj": w(f, d),
                "b_proj": jnp.zeros((d,)),
            }
            for _ in range(L)
        ],
    }
    if cfg.learned_pos:
        params["wpe"] = w(cfg.max_seq_len, d)
    return params


class GPTModel:
    def __init__(self, cfg: GPTConfig, params: dict):
        self.cfg = cfg
        self.params = params
        if not cfg.learned_pos:
            self._sin_pos = jnp.asarray(
                sinusoidal_positions(cfg.max_seq_len, cfg.d_model))

    def init_cache(self, batch: int, dtype=jnp.bfloat16) -> dict:
        c = self.cfg
        shape = (batch, c.n_heads, c.max_seq_len, c.head_dim)
        return {"k": [jnp.zeros(shape, dtype) for _ in range(c.n_layers)],
                "v": [jnp.zeros(shape, dtype) for _ in range(c.n_layers)]}

    def forward(self, params, tokens, cache, pos):
        cfg = self.cfg
        b, t = tokens.shape
        h = cfg.n_heads
        hd = cfg.head_dim
        x = jnp.take(params["wte"], tokens, axis=0)
        positions = pos + jnp.arange(t)
        if cfg.learned_pos:
            x = x + jnp.take(params["wpe"], positions, axis=0)
        else:
            x = x + jnp.take(self._sin_pos, positions, axis=0)
        kv_len = pos + t
        decode = t == 1

        new_k, new_v = [], []
        for i, layer in enumerate(params["layers"]):
            hn = refs.layernorm_ref(x, layer["ln_1"]["g"], layer["ln_1"]["b"],
                                    cfg.layer_norm_eps)
            qkv = ops.qmatmul(hn, layer["w_qkv"]) + layer["b_qkv"]
            q, k, v = jnp.split(qkv, 3, axis=-1)
            q = q.reshape(b, t, h, hd).transpose(0, 2, 1, 3)
            k = k.reshape(b, t, h, hd).transpose(0, 2, 1, 3)
            v = v.reshape(b, t, h, hd).transpose(0, 2, 1, 3)
            ck = jax.lax.dynamic_update_slice(
                cache["k"][i], k.astype(cache["k"][i].dtype), (0, 0, pos, 0))
            cv = jax.lax.dynamic_update_slice(
                cache["v"][i], v.astype(cache["v"][i].dtype), (0, 0, pos, 0))
            new_k.append(ck)
            new_v.append(cv)
            if decode:
                att = ops.decode_attention(q, ck, cv, kv_len)
            else:
                att = ops.flash_attention(q, ck, cv, kv_len=kv_len,
                                          q_offset=pos)
            att = att.astype(x.dtype).transpose(0, 2, 1, 3).reshape(b, t, h * hd)
            x = x + ops.qmatmul(att, layer["wo"]) + layer["bo"]

            hn = refs.layernorm_ref(x, layer["ln_2"]["g"], layer["ln_2"]["b"],
                                    cfg.layer_norm_eps)
            ff = jax.nn.gelu(ops.qmatmul(hn, layer["w_fc"]) + layer["b_fc"])
            x = x + ops.qmatmul(ff, layer["w_proj"]) + layer["b_proj"]

        x = refs.layernorm_ref(x, params["ln_f"]["g"], params["ln_f"]["b"],
                               cfg.layer_norm_eps)
        logits = jnp.einsum("btd,vd->btv", x.astype(jnp.float32),
                            params["wte"].astype(jnp.float32))
        return logits, {"k": new_k, "v": new_v}
