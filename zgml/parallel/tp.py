"""Tensor + data parallel execution of the Llama model via shard_map.

Megatron-style TP over the 'tp' mesh axis (the scaling-book recipe — pick a
mesh, annotate shardings, let XLA hand the collectives to NCCL):

  - wq/wk/wv, w_gate/w_up: column-sharded (out-features local) -> no comm
  - wo, w_down: row-sharded (in-features local) -> psum after the projection
  - KV cache: sharded over kv heads (each device owns its heads' cache slab —
    the multi-chip generalization of the reference's per-head cache slabs,
    llama_transformer.zig:216-219)
  - lm_head: vocab-sharded -> all_gather of logits
  - batch: sharded over 'dp'

Requires n_heads % tp == 0 and n_kv_heads % tp == 0 (standard TP constraint).

shard_map (not bare pjit) because the hot path calls a Pallas kernel, which
XLA cannot partition, and because it makes every collective explicit and
overlappable by the XLA latency-hiding scheduler.
"""
from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
import inspect


def shard_map(f, *, mesh, in_specs, out_specs, check_rep=False):
    """Compat wrapper: jax.shard_map (check_vma) vs experimental (check_rep)."""
    try:
        sm = jax.shard_map
    except AttributeError:
        from jax.experimental.shard_map import shard_map as sm
    kw = ("check_vma" if "check_vma" in inspect.signature(sm).parameters
          else "check_rep")
    return sm(f, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
              **{kw: check_rep})

import dataclasses

import numpy as np

from zgml.models.llama import LlamaModel
from zgml.quant.blocks import QK
from zgml.quant.repack import (PackedWeight, _round_up,
                                   _tile_friendly_pad)

_COL_SHARDED = {"wq", "wk", "wv", "w_gate", "w_up"}   # out-features over tp
_ROW_SHARDED = {"wo", "w_down"}                       # in-features over tp


def shard_packed(pw: PackedWeight, tp: int, axis: str) -> PackedWeight:
    """Exact per-shard re-layout of a PackedWeight for tensor parallelism.

    axis='n' splits out-features (column-parallel), axis='k' splits
    in-features (row-parallel). Each shard is re-padded independently so all
    shards have identical local padded dims; the returned PackedWeight holds
    GLOBAL host arrays (tp shards concatenated along the split axis) with
    LOCAL aux dims (n/k/n_pad/k_pad describe ONE shard) — exactly the form
    shard_map's in_specs split back into self-consistent local PackedWeights.
    No re-quantization happens: quantized values and scales are moved, never
    recomputed (padding regions dequantize to zero).

    Handles both [K', N] and layer-stacked [L, K', N] qvals/scales.
    """
    qv = np.asarray(pw.qvals)
    sc = np.asarray(pw.scales)   # dtype-preserving (int16 f16-bits or f32)
    stacked = qv.ndim == 3
    if not stacked:
        qv, sc = qv[None], sc[None]
    L = qv.shape[0]

    if axis == "n":
        if pw.n % tp:
            raise ValueError(f"n={pw.n} not divisible by tp={tp}")
        n_loc = pw.n // tp
        n_pad_loc = _tile_friendly_pad(n_loc)
        q_fill = 0x88 if pw.kind == "q4_0" else 0
        qs, ss = [], []
        for t in range(tp):
            q_t = qv[:, :, t * n_loc:(t + 1) * n_loc]
            s_t = sc[:, :, t * n_loc:(t + 1) * n_loc]
            q_p = np.full((L, qv.shape[1], n_pad_loc), q_fill,
                          np.uint8).view(np.int8)
            q_p[:, :, :n_loc] = q_t
            s_p = np.zeros((L, sc.shape[1], n_pad_loc), sc.dtype)
            s_p[:, :, :n_loc] = s_t
            qs.append(q_p)
            ss.append(s_p)
        qvg, scg = np.concatenate(qs, axis=2), np.concatenate(ss, axis=2)
        out = dataclasses.replace(pw, n=n_loc, n_pad=n_pad_loc,
                                  qvals=qvg if stacked else qvg[0],
                                  scales=scg if stacked else scg[0])
        return out

    if axis != "k":
        raise ValueError(f"axis must be 'n' or 'k', got {axis!r}")
    if pw.k % tp:
        raise ValueError(f"k={pw.k} not divisible by tp={tp}")
    k_loc = pw.k // tp
    if k_loc % QK:
        raise ValueError(f"local K={k_loc} not a multiple of {QK}")
    n_pad = qv.shape[2]
    if pw.kind == "q4_0":
        # unpack the global K half-split to natural-order nibbles, slice,
        # re-split per shard (see repack.py for the layout)
        b = qv.view(np.uint8)
        w = np.concatenate([b & 0x0F, b >> 4], axis=1)      # [L, k_pad, N]
        k_pad_loc = _round_up(_tile_friendly_pad(k_loc), 512)
        qs, ss = [], []
        for t in range(tp):
            w_p = np.full((L, k_pad_loc, n_pad), 8, np.uint8)
            w_p[:, :k_loc] = w[:, t * k_loc:(t + 1) * k_loc]
            h = k_pad_loc // 2
            qs.append((w_p[:, :h] | (w_p[:, h:] << 4)).astype(np.uint8)
                      .view(np.int8))
            s_p = np.zeros((L, k_pad_loc // QK, n_pad), sc.dtype)
            s_p[:, :k_loc // QK] = sc[:, t * (k_loc // QK):
                                      (t + 1) * (k_loc // QK)]
            ss.append(s_p)
    else:
        k_pad_loc = _round_up(_tile_friendly_pad(k_loc), QK)
        qs, ss = [], []
        for t in range(tp):
            q_p = np.zeros((L, k_pad_loc, n_pad), np.int8)
            q_p[:, :k_loc] = qv[:, t * k_loc:(t + 1) * k_loc]
            s_p = np.zeros((L, k_pad_loc // QK, n_pad), sc.dtype)
            s_p[:, :k_loc // QK] = sc[:, t * (k_loc // QK):
                                      (t + 1) * (k_loc // QK)]
            qs.append(q_p)
            ss.append(s_p)
    qvg, scg = np.concatenate(qs, axis=1), np.concatenate(ss, axis=1)
    return dataclasses.replace(pw, k=k_loc, k_pad=k_pad_loc,
                               qvals=qvg if stacked else qvg[0],
                               scales=scg if stacked else scg[0])


def _pw_take_cols(pw: PackedWeight, ranges) -> PackedWeight:
    """Local PackedWeight from logical out-feature column ranges of a planar
    weight (Q/K/V head segments of a fused wqkv; gate/up halves of w_gate_up).

    Column slicing is exact for both kinds: the q4 nibble pack pairs along K
    (rows), so the N axis is plain columns for qvals and scales alike. The
    concatenated columns get one tile-friendly tail pad.
    """
    qv = np.asarray(pw.qvals)
    sc = np.asarray(pw.scales)
    fill = 0x88 if pw.kind == "q4_0" else 0
    qvg = np.concatenate([qv[..., a:a + n] for a, n in ranges], axis=-1)
    scg = np.concatenate([sc[..., a:a + n] for a, n in ranges], axis=-1)
    n_loc = qvg.shape[-1]
    pad = _tile_friendly_pad(n_loc) - n_loc
    if pad:
        qvg = np.concatenate(
            [qvg, np.full(qvg.shape[:-1] + (pad,), fill,
                          np.uint8).view(np.int8)], axis=-1)
        scg = np.concatenate(
            [scg, np.zeros(scg.shape[:-1] + (pad,), scg.dtype)], axis=-1)
    return dataclasses.replace(pw, n=n_loc, n_pad=qvg.shape[-1],
                               qvals=np.ascontiguousarray(qvg),
                               scales=np.ascontiguousarray(scg))


def shard_unrolled_layer(layer: dict, cfg, tp: int) -> dict:
    """TP-shard one unrolled (per-layer dict) layer.

    Fused projections regroup per shard: shard t's wqkv holds its own Q, K
    and V head segments, and its w_gate_up its own gate and up columns, so
    the model splits each local output at the same boundaries as on one
    device. Row-parallel wo/w_down split along K (shard_packed). The result
    holds global arrays (tp shards concatenated along the sharded axis) with
    local aux dims — the form shard_map in_specs split back. No weight is
    re-quantized: quantized values and scales are moved, never recomputed.
    """
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if hq % tp or hkv % tp:
        raise ValueError(f"heads {hq}/{hkv} not divisible by tp={tp}")
    hq_l, hkv_l = hq // tp, hkv // tp
    nq, nkv = hq * hd, hkv * hd

    def qkv_ranges(t):
        return [(t * hq_l * hd, hq_l * hd), (nq + t * hkv_l * hd, hkv_l * hd),
                (nq + nkv + t * hkv_l * hd, hkv_l * hd)]

    def gu_ranges(t, f):
        f_l = f // tp
        return [(t * f_l, f_l), (f + t * f_l, f_l)]

    out = {"attn_norm": np.asarray(layer["attn_norm"]),
           "ffn_norm": np.asarray(layer["ffn_norm"])}
    for name, w in layer.items():
        if name in out:
            continue
        if name in ("wqkv", "w_gate_up"):
            f = w.n // 2 if isinstance(w, PackedWeight) else w.shape[1] // 2
            ranges = ([qkv_ranges(t) for t in range(tp)] if name == "wqkv"
                      else [gu_ranges(t, f) for t in range(tp)])
            if isinstance(w, PackedWeight):
                parts = [_pw_take_cols(w, r) for r in ranges]
                out[name] = dataclasses.replace(
                    parts[0],
                    qvals=np.concatenate([p.qvals for p in parts], -1),
                    scales=np.concatenate([p.scales for p in parts], -1))
            else:
                w = np.asarray(w)
                out[name] = np.concatenate(
                    [w[:, a:a + n] for r in ranges for a, n in r], 1)
        elif isinstance(w, PackedWeight):
            out[name] = shard_packed(w, tp, "n" if name in _COL_SHARDED
                                     else "k")
        else:
            out[name] = np.asarray(w)   # dense: contiguous column/row split
    return out


_UNROLLED_LEAF_SPECS = {
    "attn_norm": P(None), "ffn_norm": P(None),
    "wq": P(None, "tp"), "wk": P(None, "tp"), "wv": P(None, "tp"),
    "wqkv": P(None, "tp"), "w_gate": P(None, "tp"), "w_up": P(None, "tp"),
    "w_gate_up": P(None, "tp"),
    "wo": P("tp", None), "w_down": P("tp", None),
}


def _unrolled_layer_specs(layer: dict) -> dict:
    specs = {}
    for name, leaf in layer.items():
        spec = _UNROLLED_LEAF_SPECS[name]
        specs[name] = (jax.tree.map(lambda _: spec, leaf)
                       if hasattr(leaf, "qvals") else spec)
    return specs


def llama_param_specs(params: dict) -> dict:
    """PartitionSpec pytree matching a LlamaModel params pytree.

    Handles both the stacked ([L, ...]-leaf dict) layout used for training/
    scan and the unrolled (list of per-layer dicts, incl. fused wqkv and
    w_gate_up) inference layout."""
    if isinstance(params["layers"], (list, tuple)):
        specs: dict[str, Any] = {
            "tok_embd": P(None, None),
            "out_norm": P(None),
            "layers": [_unrolled_layer_specs(la) for la in params["layers"]],
        }
        if "lm_head" in params:
            lm = params["lm_head"]
            spec = P(None, "tp")
            specs["lm_head"] = (jax.tree.map(lambda _: spec, lm)
                                if isinstance(lm, PackedWeight) else spec)
        return specs
    layer_specs = {}
    for name, leaf in params["layers"].items():
        if name in _COL_SHARDED:
            spec = P(None, None, "tp")
        elif name in _ROW_SHARDED:
            spec = P(None, "tp", None)
        else:                       # norms: replicated
            spec = P(None, None)
        if isinstance(leaf, PackedWeight):
            # qvals and scales shard along the same (K or N) axis
            layer_specs[name] = jax.tree.map(lambda _: spec, leaf)
        else:
            layer_specs[name] = spec
    specs: dict[str, Any] = {
        "tok_embd": P(None, None),
        "out_norm": P(None),
        "layers": layer_specs,
    }
    if "lm_head" in params:
        lm = params["lm_head"]
        spec = P(None, "tp")
        specs["lm_head"] = jax.tree.map(lambda _: spec, lm) \
            if isinstance(lm, PackedWeight) else spec
    return specs


def cache_specs() -> dict:
    return {"k": P(None, "dp", "tp", None, None),
            "v": P(None, "dp", "tp", None, None)}


def shard_llama_params(params: dict, mesh: Mesh, cfg=None) -> dict:
    """device_put the params with their TP shardings.

    PackedWeight leaves are first re-laid-out per shard (shard_packed), so the
    quantized layout stays self-consistent inside shard_map: each device's
    shard is a complete local PackedWeight with matching aux dims. Unrolled
    (per-layer list) params go through shard_unrolled_layer, which needs the
    model's `cfg` to find the head segments of a fused wqkv."""
    tp = int(mesh.shape.get("tp", 1))
    out = dict(params)
    if tp > 1 and isinstance(params["layers"], (list, tuple)):
        if cfg is None:
            raise ValueError("unrolled params need cfg to shard")
        out["layers"] = [shard_unrolled_layer(la, cfg, tp)
                         for la in params["layers"]]
    elif tp > 1:
        layers = dict(params["layers"])
        for name, leaf in layers.items():
            if not isinstance(leaf, PackedWeight):
                continue
            if name in _COL_SHARDED:
                layers[name] = shard_packed(leaf, tp, "n")
            elif name in _ROW_SHARDED:
                layers[name] = shard_packed(leaf, tp, "k")
        out["layers"] = layers
    if tp > 1 and isinstance(params.get("lm_head"), PackedWeight):
        out["lm_head"] = shard_packed(params["lm_head"], tp, "n")
    specs = llama_param_specs(out)

    def put(leaf, spec):
        return jax.device_put(jnp.asarray(leaf), NamedSharding(mesh, spec))

    return jax.tree.map(put, out, specs)


def cache_specs_like(cache) -> dict:
    """Cache PartitionSpecs matching the cache pytree layout: stacked
    [L, B, Hkv, S, d] arrays or per-layer lists of [B, Hkv, S, d]."""
    if isinstance(cache["k"], (list, tuple)):
        n = len(cache["k"])
        return {"k": [P("dp", "tp", None, None)] * n,
                "v": [P("dp", "tp", None, None)] * n}
    return cache_specs()


def make_sharded_forward(model: LlamaModel, mesh: Mesh):
    """jit(shard_map(forward)): (params, tokens, cache, pos) -> (logits, cache).

    tokens [B, T] with B sharded over dp; logits [B, T, V] full-vocab per dp
    shard; cache sharded (dp, tp).
    """
    tp = mesh.shape["tp"]
    cfg = model.cfg
    if cfg.n_heads % tp or cfg.n_kv_heads % tp:
        raise ValueError(f"n_heads={cfg.n_heads}/n_kv_heads={cfg.n_kv_heads} "
                         f"not divisible by tp={tp}")
    unrolled = isinstance(model.params["layers"], (list, tuple))
    if tp > 1 and unrolled:
        # a quick shape check catches unsharded params
        la0 = model.params["layers"][0]
        w = la0.get("wqkv") or la0.get("wq")
        if isinstance(w, PackedWeight) and w.qvals.shape[-1] != w.n_pad * tp:
            raise ValueError("unrolled quantized params not TP-sharded — "
                             "run shard_llama_params(params, mesh, cfg) first")
    if tp > 1 and not unrolled:
        # PackedWeight params must already be per-shard repacked (local aux
        # dims): slicing a global-layout PackedWeight inside shard_map would
        # mismatch its static n/k/n_pad/k_pad
        for name, leaf in model.params["layers"].items():
            if not isinstance(leaf, PackedWeight):
                continue
            q = leaf.qvals
            if name in _COL_SHARDED and q.shape[-1] != leaf.n_pad * tp:
                raise ValueError(
                    f"{name}: quantized params not TP-sharded — run "
                    f"shard_llama_params(params, mesh) first")
            rows = leaf.k_pad // 2 if leaf.kind == "q4_0" else leaf.k_pad
            if name in _ROW_SHARDED and q.shape[-2] != rows * tp:
                raise ValueError(
                    f"{name}: quantized params not TP-sharded — run "
                    f"shard_llama_params(params, mesh) first")
    pspecs = llama_param_specs(model.params)

    def fwd(params, tokens, cache, pos):
        return model.forward(params, tokens, cache, pos,
                             tp_axis="tp", tp_size=tp)

    if unrolled:
        n_l = len(model.params["layers"])
        cspecs = {"k": [P("dp", "tp", None, None)] * n_l,
                  "v": [P("dp", "tp", None, None)] * n_l}
    else:
        cspecs = cache_specs()
    sm = shard_map(fwd, mesh=mesh,
                   in_specs=(pspecs, P("dp", None), cspecs, P()),
                   out_specs=(P("dp", None, None), cspecs),
                   check_rep=False)
    jitted = jax.jit(sm, donate_argnums=(2,))

    def call(params, tokens, cache, pos):
        # layout guard: TP over unrolled params needs the per-layer list
        # cache
        if unrolled and not isinstance(cache["k"], (list, tuple)):
            raise ValueError(
                "TP forward over unrolled params needs the per-layer list "
                "cache; build it with model.init_cache(batch, "
                "layout='unrolled') (see ARCHITECTURE.md 'KV-cache layouts')")
        return jitted(params, tokens, cache, pos)

    return call


def make_sharded_train_step(model: LlamaModel, mesh: Mesh, optimizer=None):
    """jit(shard_map(train_step)): full dp+tp training step.

    Next-token LM loss over a [B, T] batch; grads psum'ed over dp (and over tp
    for replicated leaves); SGD update by default. The quantized matmul
    kernel carries a custom VJP and attention differentiates as plain XLA
    (the reference's attention backward panics, backward.zig:393-404).
    """
    from zgml.optim.sgd import sgd_update

    tp = mesh.shape["tp"]
    cfg = model.cfg
    pspecs = llama_param_specs(model.params)

    def loss_fn(params, tokens, cache):
        logits, _ = model.forward(params, tokens[:, :-1], cache, 0,
                                  tp_axis="tp", tp_size=tp)
        targets = tokens[:, 1:]
        logp = jax.nn.log_softmax(logits, axis=-1)
        nll = -jnp.take_along_axis(logp, targets[..., None], axis=-1)
        return jnp.mean(nll)

    def step(params, tokens, cache, lr):
        # TP gradient exactness comes from the model's _tp_copy (Megatron 'f')
        # operators: replicated leaves get full identical grads on every tp
        # member, sharded leaves get exact local grads — only dp averaging here.
        loss, grads = jax.value_and_grad(loss_fn)(params, tokens, cache)
        loss = jax.lax.pmean(loss, "dp")
        grads = jax.tree.map(lambda g: jax.lax.pmean(g, "dp"), grads)
        new_params = sgd_update(params, grads, lr)
        return loss, new_params

    sm = shard_map(step, mesh=mesh,
                   in_specs=(pspecs, P("dp", None), cache_specs(), P()),
                   out_specs=(P(), pspecs),
                   check_rep=False)
    return jax.jit(sm)
