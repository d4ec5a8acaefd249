"""Whisper-style encoder-decoder (ref: src/models/whisper.zig:38-615).

Capability parity: conv1d feature extraction (two GeLU convs, stride 2 on the
second) -> sinusoidal positions -> non-causal pre-LN encoder; decoder with
causal self-attention + cross-attention over encoder output; encode_features /
decode_step API mirroring the reference's encodeFeatures/decode.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from zgml.models.gpt import sinusoidal_positions
from zgml.ops import refs


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    n_mels: int = 80
    n_audio_ctx: int = 1500      # encoder positions after stride-2 conv
    n_audio_state: int = 384
    n_audio_heads: int = 6
    n_audio_layers: int = 4
    vocab_size: int = 51865
    n_text_ctx: int = 448
    n_text_state: int = 384
    n_text_heads: int = 6
    n_text_layers: int = 4
    eps: float = 1e-5

    @property
    def audio_head_dim(self):
        return self.n_audio_state // self.n_audio_heads

    @property
    def text_head_dim(self):
        return self.n_text_state // self.n_text_heads


def _ln(d):
    return {"g": jnp.ones((d,)), "b": jnp.zeros((d,))}


def _attn_params(rng, d, scale):
    w = lambda *s: jnp.asarray(rng.standard_normal(s).astype(np.float32) * scale)  # noqa: E731
    return {"wq": w(d, d), "bq": jnp.zeros((d,)), "wk": w(d, d),
            "wv": w(d, d), "bv": jnp.zeros((d,)),
            "wo": w(d, d), "bo": jnp.zeros((d,))}


def init_params(cfg: WhisperConfig, seed: int = 0, scale: float = 0.02) -> dict:
    rng = np.random.default_rng(seed)
    w = lambda *s: jnp.asarray(rng.standard_normal(s).astype(np.float32) * scale)  # noqa: E731
    da, dt = cfg.n_audio_state, cfg.n_text_state

    enc_layers = [{
        "ln_1": _ln(da), "attn": _attn_params(rng, da, scale),
        "ln_2": _ln(da), "w_fc": w(da, 4 * da), "b_fc": jnp.zeros((4 * da,)),
        "w_proj": w(4 * da, da), "b_proj": jnp.zeros((da,)),
    } for _ in range(cfg.n_audio_layers)]
    dec_layers = [{
        "ln_1": _ln(dt), "attn": _attn_params(rng, dt, scale),
        "ln_x": _ln(dt), "cross": _attn_params(rng, dt, scale),
        "ln_2": _ln(dt), "w_fc": w(dt, 4 * dt), "b_fc": jnp.zeros((4 * dt,)),
        "w_proj": w(4 * dt, dt), "b_proj": jnp.zeros((dt,)),
    } for _ in range(cfg.n_text_layers)]

    return {
        "conv1_w": w(3, cfg.n_mels, da), "conv1_b": jnp.zeros((da,)),
        "conv2_w": w(3, da, da), "conv2_b": jnp.zeros((da,)),
        "enc_ln_post": _ln(da),
        "enc_layers": enc_layers,
        "tok_embd": w(cfg.vocab_size, dt),
        "pos_embd": w(cfg.n_text_ctx, dt),
        "dec_ln": _ln(dt),
        "dec_layers": dec_layers,
    }


def _mha(p, x_q, x_kv, heads, causal=False):
    b, tq, d = x_q.shape
    hd = d // heads
    q = (x_q @ p["wq"] + p["bq"]).reshape(b, tq, heads, hd).transpose(0, 2, 1, 3)
    k = (x_kv @ p["wk"]).reshape(b, -1, heads, hd).transpose(0, 2, 1, 3)
    v = (x_kv @ p["wv"] + p["bv"]).reshape(b, -1, heads, hd).transpose(0, 2, 1, 3)
    mask = refs.causal_mask(tq, k.shape[2]) if causal else None
    att = refs.attention_ref(q, k, v, None if mask is None else mask[None, None])
    att = att.transpose(0, 2, 1, 3).reshape(b, tq, d)
    return att @ p["wo"] + p["bo"]


class WhisperModel:
    def __init__(self, cfg: WhisperConfig, params: dict):
        self.cfg = cfg
        self.params = params
        self._audio_pos = jnp.asarray(
            sinusoidal_positions(cfg.n_audio_ctx, cfg.n_audio_state))

    # -- encoder (ref: encodeFeatures) --------------------------------------
    def encode_features(self, mel: jax.Array) -> jax.Array:
        """mel: [B, T_mel, n_mels] -> encoder states [B, T_mel//2, d_audio]."""
        cfg = self.cfg
        p = self.params
        x = jax.lax.conv_general_dilated(
            mel, p["conv1_w"], (1,), "SAME",
            dimension_numbers=("NWC", "WIO", "NWC")) + p["conv1_b"]
        x = jax.nn.gelu(x)
        x = jax.lax.conv_general_dilated(
            x, p["conv2_w"], (2,), "SAME",
            dimension_numbers=("NWC", "WIO", "NWC")) + p["conv2_b"]
        x = jax.nn.gelu(x)
        t = x.shape[1]
        # HF checkpoints carry the (sinusoidal) encoder positions explicitly;
        # synthesized params fall back to the generated table
        pos = p.get("enc_pos_embd", self._audio_pos)
        x = x + pos[:t]
        for lyr in p["enc_layers"]:
            h = refs.layernorm_ref(x, lyr["ln_1"]["g"], lyr["ln_1"]["b"], cfg.eps)
            x = x + _mha(lyr["attn"], h, h, cfg.n_audio_heads, causal=False)
            h = refs.layernorm_ref(x, lyr["ln_2"]["g"], lyr["ln_2"]["b"], cfg.eps)
            x = x + jax.nn.gelu(h @ lyr["w_fc"] + lyr["b_fc"]) @ lyr["w_proj"] \
                + lyr["b_proj"]
        return refs.layernorm_ref(x, p["enc_ln_post"]["g"],
                                  p["enc_ln_post"]["b"], cfg.eps)

    # -- decoder (ref: decode) ----------------------------------------------
    def decode(self, tokens: jax.Array, enc_states: jax.Array) -> jax.Array:
        """tokens [B, T], enc_states [B, Ta, d] -> logits [B, T, vocab].

        Full-sequence decode (the reference's decoder is stateless per call,
        whisper.zig decode — this is the oracle; generation uses the cached
        decode_step below, which the reference lacks)."""
        cfg = self.cfg
        p = self.params
        b, t = tokens.shape
        x = jnp.take(p["tok_embd"], tokens, axis=0) + p["pos_embd"][:t]
        for lyr in p["dec_layers"]:
            h = refs.layernorm_ref(x, lyr["ln_1"]["g"], lyr["ln_1"]["b"], cfg.eps)
            x = x + _mha(lyr["attn"], h, h, cfg.n_text_heads, causal=True)
            h = refs.layernorm_ref(x, lyr["ln_x"]["g"], lyr["ln_x"]["b"], cfg.eps)
            x = x + _mha(lyr["cross"], h, enc_states, cfg.n_text_heads)
            h = refs.layernorm_ref(x, lyr["ln_2"]["g"], lyr["ln_2"]["b"], cfg.eps)
            x = x + jax.nn.gelu(h @ lyr["w_fc"] + lyr["b_fc"]) @ lyr["w_proj"] \
                + lyr["b_proj"]
        x = refs.layernorm_ref(x, p["dec_ln"]["g"], p["dec_ln"]["b"], cfg.eps)
        return jnp.einsum("btd,vd->btv", x, p["tok_embd"])

    # -- cached decoding (beyond the reference: whisper.zig re-runs the full
    #    sequence per generated token; here self-attention K/V cache + one-time
    #    cross-attention K/V precompute make each step O(1) in sequence) ------
    def init_cache(self, batch: int, dtype=jnp.float32) -> dict:
        cfg = self.cfg
        h, hd = cfg.n_text_heads, cfg.text_head_dim
        shape = (batch, h, cfg.n_text_ctx, hd)
        L = cfg.n_text_layers
        return {"k": [jnp.zeros(shape, dtype) for _ in range(L)],
                "v": [jnp.zeros(shape, dtype) for _ in range(L)]}

    def precompute_cross_kv(self, enc_states: jax.Array) -> list:
        """Per decoder layer: (K, V) over the encoder states [B, H, Ta, hd] —
        computed once per utterance instead of once per generated token."""
        cfg = self.cfg
        b, ta, _ = enc_states.shape
        h, hd = cfg.n_text_heads, cfg.text_head_dim
        out = []
        for lyr in self.params["dec_layers"]:
            p = lyr["cross"]
            k = (enc_states @ p["wk"]).reshape(b, ta, h, hd).transpose(0, 2, 1, 3)
            v = (enc_states @ p["wv"] + p["bv"]).reshape(b, ta, h, hd) \
                .transpose(0, 2, 1, 3)
            out.append((k, v))
        return out

    def decode_step(self, tokens: jax.Array, cross_kv: list, cache: dict,
                    pos) -> tuple[jax.Array, dict]:
        """One cached decode step. tokens [B, 1] -> (logits [B, vocab], cache).

        Self-attention reads the cache prefix through ops.decode_attention,
        as does cross-attention over the precomputed encoder K/V — the
        whisper decoder rides the same decode path as the llama engine."""
        from zgml.ops import dispatch as ops
        cfg = self.cfg
        p = self.params
        b = tokens.shape[0]
        h, hd = cfg.n_text_heads, cfg.text_head_dim
        x = jnp.take(p["tok_embd"], tokens, axis=0) \
            + jax.lax.dynamic_slice_in_dim(p["pos_embd"], pos, 1, axis=0)
        kv_len = pos + 1
        for li, lyr in enumerate(p["dec_layers"]):
            a = lyr["attn"]
            hh = refs.layernorm_ref(x, lyr["ln_1"]["g"], lyr["ln_1"]["b"],
                                    cfg.eps)
            q = (hh @ a["wq"] + a["bq"]).reshape(b, 1, h, hd) \
                .transpose(0, 2, 1, 3)
            k = (hh @ a["wk"]).reshape(b, 1, h, hd).transpose(0, 2, 1, 3)
            v = (hh @ a["wv"] + a["bv"]).reshape(b, 1, h, hd) \
                .transpose(0, 2, 1, 3)
            ck = jax.lax.dynamic_update_slice(
                cache["k"][li], k.astype(cache["k"][li].dtype), (0, 0, pos, 0))
            cv = jax.lax.dynamic_update_slice(
                cache["v"][li], v.astype(cache["v"][li].dtype), (0, 0, pos, 0))
            cache["k"][li], cache["v"][li] = ck, cv
            att = ops.decode_attention(q, ck, cv, kv_len)
            att = att.transpose(0, 2, 1, 3).reshape(b, 1, h * hd)
            x = x + (att @ a["wo"] + a["bo"])

            c = lyr["cross"]
            hh = refs.layernorm_ref(x, lyr["ln_x"]["g"], lyr["ln_x"]["b"],
                                    cfg.eps)
            qx = (hh @ c["wq"] + c["bq"]).reshape(b, 1, h, hd) \
                .transpose(0, 2, 1, 3)
            ek, ev = cross_kv[li]
            xatt = ops.decode_attention(qx, ek, ev, ek.shape[2])
            xatt = xatt.transpose(0, 2, 1, 3).reshape(b, 1, h * hd)
            x = x + (xatt @ c["wo"] + c["bo"])

            hh = refs.layernorm_ref(x, lyr["ln_2"]["g"], lyr["ln_2"]["b"],
                                    cfg.eps)
            x = x + jax.nn.gelu(hh @ lyr["w_fc"] + lyr["b_fc"]) \
                @ lyr["w_proj"] + lyr["b_proj"]
        x = refs.layernorm_ref(x, p["dec_ln"]["g"], p["dec_ln"]["b"], cfg.eps)
        return jnp.einsum("btd,vd->btv", x, p["tok_embd"])[:, 0], cache

    def transcribe_greedy(self, mel: jax.Array, bos: int, eos: int,
                          max_tokens: int = 32) -> list[int]:
        """Greedy transcription on the cached decode path (jitted step)."""
        enc = self.encode_features(mel)
        cross_kv = self.precompute_cross_kv(enc)
        cache = self.init_cache(mel.shape[0])
        if not hasattr(self, "_step_jit"):
            self._step_jit = jax.jit(self.decode_step, donate_argnums=(2,))
        toks = [bos]
        for i in range(max_tokens):
            logits, cache = self._step_jit(
                jnp.asarray([[toks[-1]]], jnp.int32), cross_kv, cache, i)
            nxt = int(jnp.argmax(logits[0]))
            toks.append(nxt)
            if nxt == eos:
                break
        return toks
