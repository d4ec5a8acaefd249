"""Context parallelism: one-shot prefill of a long prompt sharded over a
'cp' mesh axis, with ring attention between the devices.

The engine's chunked prefill (runtime/engine.py) is bounded by one chip's
memory: flash attention needs the full KV prefix resident. Here the prompt's
sequence axis shards across cp devices — each device embeds and projects its
T/cp-token chunk and attends over the whole prefix via ring attention
(parallel/ring.py: KV shards rotate via ppermute while each device folds
visiting blocks into an online-softmax accumulator). Peak per-device memory is
O(T/cp); prefill FLOPs (the T² term) split cp ways.

No reference counterpart (SURVEY.md §5: sequence scaling "must come from
KV-cache sharding, blockwise flash attention, and optionally ring-attention
— new components").
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from zgml.models.llama import LlamaModel, _project
from zgml.parallel.ring import _ring_attention_local
from zgml.parallel.tp import shard_map


def make_cp_prefill(model: LlamaModel, mesh: Mesh, axis: str = "cp"):
    """jit(shard_map) context-parallel prefill.

    Returns fn(params, tokens [B, T]) -> (logits [B, T, V],
    k [L, B, Hkv, T, hd], v [L, B, Hkv, T, hd]) with T sharded over `axis`
    inside (T % cp == 0); outputs re-assemble to global arrays ready to be
    written into an engine KV cache.
    """
    from zgml.ops import dispatch as ops
    from zgml.ops import refs

    cfg = model.cfg
    cp = mesh.shape[axis]
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def fn(params, tokens):
        idx = jax.lax.axis_index(axis)
        b, t_loc = tokens.shape
        x = jnp.take(params["tok_embd"], tokens, axis=0)
        positions = idx * t_loc + jnp.arange(t_loc)
        cos, sin = refs.rope_cos_sin(positions, cfg.head_dim, cfg.rope_base)

        # the cp variant of models/llama._layer_step: identical projections,
        # but attention is the ring over the cp axis and K/V are returned for
        # the caller's cache instead of updating one in place
        def body(x, layer):
            h = ops.rmsnorm(x, layer["attn_norm"], cfg.rms_norm_eps)
            if "wqkv" in layer:
                nq, nkv = hq * hd, hkv * hd
                qkv = _project(h, layer["wqkv"])
                q = qkv[..., :nq].reshape(b, t_loc, hq, hd)
                k = qkv[..., nq:nq + nkv].reshape(b, t_loc, hkv, hd)
                v = qkv[..., nq + nkv:].reshape(b, t_loc, hkv, hd)
            else:
                q = _project(h, layer["wq"]).reshape(b, t_loc, hq, hd)
                k = _project(h, layer["wk"]).reshape(b, t_loc, hkv, hd)
                v = _project(h, layer["wv"]).reshape(b, t_loc, hkv, hd)
            q = q.transpose(0, 2, 1, 3)
            k = k.transpose(0, 2, 1, 3)
            v = v.transpose(0, 2, 1, 3)
            q = ops.rope_apply(q, cos, sin)
            k = ops.rope_apply(k, cos, sin)

            att = _ring_attention_local(q.astype(jnp.float32),
                                        k.astype(jnp.float32),
                                        v.astype(jnp.float32), axis)
            att = att.astype(x.dtype).transpose(0, 2, 1, 3) \
                     .reshape(b, t_loc, hq * hd)
            x = x + _project(att, layer["wo"]).astype(x.dtype)

            h = ops.rmsnorm(x, layer["ffn_norm"], cfg.rms_norm_eps)
            if "w_gate_up" in layer:
                gu = _project(h, layer["w_gate_up"])
                f = gu.shape[-1] // 2
                gate, up = gu[..., :f], gu[..., f:]
            else:
                gate = _project(h, layer["w_gate"])
                up = _project(h, layer["w_up"])
            ff = refs.swiglu_ref(gate, up)
            x = x + _project(ff, layer["w_down"]).astype(x.dtype)
            return x, (k, v)

        layers = params["layers"]
        if isinstance(layers, (list, tuple)):        # unrolled layout
            kl, vl = [], []
            for layer in layers:
                x, (k, v) = body(x, layer)
                kl.append(k)
                vl.append(v)
            ks, vs = jnp.stack(kl), jnp.stack(vl)
        else:
            x, (ks, vs) = jax.lax.scan(body, x, layers)
        h = ops.rmsnorm(x, params["out_norm"], cfg.rms_norm_eps)
        lm_head = params.get("lm_head")
        if lm_head is None:
            logits = jnp.einsum("btd,vd->btv", h.astype(jnp.float32),
                                params["tok_embd"].astype(jnp.float32))
        else:
            logits = ops.qmatmul(h, lm_head)
        return logits.astype(jnp.float32), ks, vs

    pspec = jax.tree.map(lambda _: P(), model.params)
    kv_spec = P(None, None, None, axis, None)        # [L, B, Hkv, T, hd]
    sm = shard_map(fn, mesh=mesh,
                   in_specs=(pspec, P(None, axis)),
                   out_specs=(P(None, axis, None), kv_spec, kv_spec))
    return jax.jit(sm)
