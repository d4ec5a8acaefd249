"""Llama-family decoder-only model: functional, pytree params, scan over layers.

Capability parity with the reference's LLaMA (src/models/llama.zig,
src/models/llama_transformer.zig): GQA (n_kv_heads <= n_heads), RMSNorm-gamma,
separate Q/K/V projections, RoPE with HF half-split pairing, SwiGLU FFN
(silu(x Wg) * (x Wu)) Wd, optional tied LM head — re-designed for JAX:

  - layers are either a per-layer list (the inference layout: each layer's
    weights feed the matmul directly) or a *stacked* pytree ([L, ...] leaves)
    consumed by lax.scan (training, pipeline and scan-layout loads);
  - the KV cache is fixed-shape and updated in place via dynamic_update_slice
    (the analog of the reference's per-layer KV slabs with storage_offset
    patching, llama_transformer.zig:211-220);
  - every projection dispatches through zgml.ops (the weight-only quantized
    matmul kernel when the weight is a PackedWeight, XLA matmul when dense).

Weights in a projection position are either a dense [K, N] jax array (K-major so
the matmul is x @ w) or a zgml.quant.PackedWeight.
"""
from __future__ import annotations

import dataclasses
import enum
import functools

import jax
import jax.numpy as jnp
import numpy as np

from zgml.ops import dispatch as ops
from zgml.ops import refs


class CacheLayout(enum.Enum):
    """The four KV-cache layouts (decision table: ARCHITECTURE.md).

    UNROLLED      bf16/f32 per-layer list of [B, Hkv, S, d] (inference
                  default: donation aliases each leaf, weights feed the
                  matmuls with no per-step gather)
    STACKED       bf16 [L, B, Hkv, S, d] array (scan-layout params, or the
                  layout="stacked" override)
    UNROLLED_INT8 per-layer list of (q [B,Hkv,d,S] i8, scales [B,Hkv,S])
    STACKED_INT8  ([L,B,Hkv,d,S] i8, [L,B,Hkv,S]) leaf pair (scan params)
    """
    UNROLLED = "unrolled"
    STACKED = "stacked"
    UNROLLED_INT8 = "unrolled_int8"
    STACKED_INT8 = "stacked_int8"


def cache_layout_of(cache: dict) -> CacheLayout:
    """Classify an existing cache dict (the inverse of init_cache)."""
    ck = cache["k"]
    if isinstance(ck, list):
        return (CacheLayout.UNROLLED_INT8 if isinstance(ck[0], tuple)
                else CacheLayout.UNROLLED)
    if isinstance(ck, tuple):
        return CacheLayout.STACKED_INT8
    return CacheLayout.STACKED


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """ref: src/models/llama.zig:34-45."""
    vocab_size: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    n_layers: int
    max_seq_len: int = 2048
    rope_base: float = 10000.0
    rms_norm_eps: float = 1e-5
    tied_lm_head: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def n_rep(self) -> int:
        return self.n_heads // self.n_kv_heads


# Per-layer params (leaves stacked along axis 0 = layer):
#   attn_norm [L, D], wq [L, D, Hq*dh], wk/wv [L, D, Hkv*dh], wo [L, Hq*dh, D],
#   ffn_norm [L, D], w_gate/w_up [L, D, F], w_down [L, F, D]
# (or PackedWeight with [L, ...] qvals/scales for the matmul positions)


def init_params(cfg: LlamaConfig, seed: int = 0, dtype=jnp.float32,
                scale: float = 0.02) -> dict:
    """Random-init params (synthetic models for tests/benches)."""
    rng = np.random.default_rng(seed)
    d, hd = cfg.d_model, cfg.head_dim
    nq, nkv, f, L = cfg.n_heads * hd, cfg.n_kv_heads * hd, cfg.d_ff, cfg.n_layers

    def w(*shape):
        return jnp.asarray(rng.standard_normal(shape).astype(np.float32) * scale,
                           dtype=dtype)

    params = {
        "tok_embd": w(cfg.vocab_size, d),
        "out_norm": jnp.ones((d,), dtype),
        "layers": {
            "attn_norm": jnp.ones((L, d), dtype),
            "ffn_norm": jnp.ones((L, d), dtype),
            "wq": w(L, d, nq),
            "wk": w(L, d, nkv),
            "wv": w(L, d, nkv),
            "wo": w(L, nq, d),
            "w_gate": w(L, d, f),
            "w_up": w(L, d, f),
            "w_down": w(L, f, d),
        },
    }
    if not cfg.tied_lm_head:
        params["lm_head"] = w(d, cfg.vocab_size)
    return params


def _project(x, w):
    """x [..., K] @ w -> [..., N]; w dense [K, N] or [.., K, N]-sliced PackedWeight."""
    return ops.qmatmul(x, w)


@functools.partial(jax.custom_vjp, nondiff_argnums=(1,))
def _tp_copy(x, axis_name):
    """Megatron 'f' operator: identity forward, psum backward.

    Placed at the input of every column-parallel projection so the replicated
    residual-stream cotangent stays replicated and TP gradients are exact
    (each device otherwise backpropagates only its shard's partial cotangent).
    """
    return x


def _tp_copy_fwd(x, axis_name):
    return x, None


def _tp_copy_bwd(axis_name, _, g):
    return (jax.lax.psum(g, axis_name),)


_tp_copy.defvjp(_tp_copy_fwd, _tp_copy_bwd)


@functools.partial(jax.custom_vjp, nondiff_argnums=(1,))
def _tp_reduce(x, axis_name):
    """Megatron 'g' operator: psum forward, identity backward.

    A raw lax.psum under shard_map(check_rep=False) transposes to another psum,
    which double-counts the (replicated) cotangent; the correct backward for a
    row-parallel projection output is the identity."""
    return _psum_maybe_barrier(x, axis_name)


def _psum_maybe_barrier(x, axis_name):
    """psum, optionally fenced by optimization_barriers (ZGML_TP_BARRIER)
    so the collective cannot overlap surrounding compute — the serialized
    side of the collective/compute-overlap A/B (tools/bench_overlap.py)."""
    from zgml import config
    if config.tp_barrier():
        x = jax.lax.optimization_barrier(x)
        return jax.lax.optimization_barrier(jax.lax.psum(x, axis_name))
    return jax.lax.psum(x, axis_name)


def _tp_reduce_fwd(x, axis_name):
    return _psum_maybe_barrier(x, axis_name), None


def _tp_reduce_bwd(axis_name, _, g):
    return (g,)


_tp_reduce.defvjp(_tp_reduce_fwd, _tp_reduce_bwd)


@functools.partial(jax.custom_vjp, nondiff_argnums=(1,))
def _tp_gather(x, axis_name):
    """all_gather along the last axis with the replicated-cotangent-correct
    backward: each device takes its own slice (the default transpose,
    psum_scatter, overcounts a replicated cotangent by tp under
    check_rep=False)."""
    return jax.lax.all_gather(x, axis_name, axis=x.ndim - 1, tiled=True)


def _tp_gather_fwd(x, axis_name):
    return _tp_gather(x, axis_name), x.shape[-1]


def _tp_gather_bwd(axis_name, shard, g):
    idx = jax.lax.axis_index(axis_name) * shard
    return (jax.lax.dynamic_slice_in_dim(g, idx, shard, axis=g.ndim - 1),)


_tp_gather.defvjp(_tp_gather_fwd, _tp_gather_bwd)


def _layer_step(cfg: LlamaConfig, x, layer, cache_k, cache_v, pos, kv_len,
                cos, sin, decode: bool, tp_axis: str | None = None,
                tp_size: int = 1, cache_row=None, write_pos=None):
    """One transformer block. x: [B, T, D]; cache_k/v: [B, Hkv_local, S, dh]
    (or the int8 (values, scales) pairs of quant/kv_cache.py).

    Returns (x_out, new_cache_k, new_cache_v).
    ref: llama_transformer.zig:139-253 (training + cached forward).

    Tensor parallelism (Megatron-style, a new capability vs the reference —
    SURVEY.md §2.7): when `tp_axis` is set, this runs inside shard_map with
    wq/wk/wv/w_gate/w_up column-sharded (local out-features), wo/w_down
    row-sharded (local in-features), and the attention-output / FFN-down
    projections partial-summed over the axis.
    """
    b, t, d = x.shape
    hd = cfg.head_dim
    hq, hkv = cfg.n_heads // tp_size, cfg.n_kv_heads // tp_size

    h = ops.rmsnorm(x, layer["attn_norm"], cfg.rms_norm_eps)
    if tp_axis is not None:
        h = _tp_copy(h, tp_axis)
    if "wqkv" in layer:
        # fused single-launch QKV projection (ref: GPT packed w_qkv,
        # src/models/gpt.zig; Metal projection groups, program.zig:980-1485)
        nq, nkv = hq * hd, hkv * hd
        qkv = _project(h, layer["wqkv"])
        q = qkv[..., :nq].reshape(b, t, hq, hd).transpose(0, 2, 1, 3)
        k = qkv[..., nq:nq + nkv].reshape(b, t, hkv, hd).transpose(0, 2, 1, 3)
        v = qkv[..., nq + nkv:nq + 2 * nkv].reshape(b, t, hkv, hd
                                                    ).transpose(0, 2, 1, 3)
    else:
        q = _project(h, layer["wq"]).reshape(b, t, hq, hd).transpose(0, 2, 1, 3)
        k = _project(h, layer["wk"]).reshape(b, t, hkv, hd).transpose(0, 2, 1, 3)
        v = _project(h, layer["wv"]).reshape(b, t, hkv, hd).transpose(0, 2, 1, 3)

    q = ops.rope_apply(q, cos, sin)
    k = ops.rope_apply(k, cos, sin)

    per_row = getattr(pos, "ndim", 0) == 1   # [B] positions (continuous batching)
    # where K/V land in the cache; serving decouples this from `pos` so an
    # inactive slot's garbage decode write goes to the dead last position
    # instead of clobbering a mid-prefill slot's row (position max_seq-1 is
    # never live: requests finish at pos+1 >= max_seq)
    wp = pos if write_pos is None else write_pos

    if isinstance(cache_k, tuple):
        # int8 quantized KV cache: (k_q, k_s) / (v_q, v_s) d-major slabs
        from zgml.quant.kv_cache import quantize_columns, write_columns
        kq_new, ks_new = quantize_columns(k)
        vq_new, vs_new = quantize_columns(v)
        if cache_row is not None:
            # serving prefill-into-slot over the int8 cache: write this
            # batch-1 chunk's quantized columns at (slot, pos), then attend
            # over the slot's dequantized row
            dus4 = lambda c, u: jax.lax.dynamic_update_slice(   # noqa: E731
                c, u, (cache_row, 0, 0, pos) if u.ndim == 4
                else (cache_row, 0, pos))     # scales are [B, H, S]
            cache_k = (dus4(cache_k[0], kq_new), dus4(cache_k[1], ks_new))
            cache_v = (dus4(cache_v[0], vq_new), dus4(cache_v[1], vs_new))
            att = ops.flash_attention_q8(q, cache_k[0], cache_k[1],
                                         cache_v[0], cache_v[1],
                                         kv_len=kv_len, q_offset=pos,
                                         kv_row=cache_row)
        else:
            if per_row:
                dus = jax.vmap(lambda c, u, p: jax.lax.dynamic_update_slice(
                    c, u, (0, 0, p) if u.ndim == 3 else (0, p)))
                cache_k = (dus(cache_k[0], kq_new, wp),
                           dus(cache_k[1], ks_new, wp))
                cache_v = (dus(cache_v[0], vq_new, wp),
                           dus(cache_v[1], vs_new, wp))
            else:
                cache_k = write_columns(cache_k[0], cache_k[1], kq_new,
                                        ks_new, pos)
                cache_v = write_columns(cache_v[0], cache_v[1], vq_new,
                                        vs_new, pos)
            if decode:
                att = ops.decode_attention_q8(q, cache_k[0], cache_k[1],
                                              cache_v[0], cache_v[1], kv_len)
            else:
                att = ops.flash_attention_q8(q, cache_k[0], cache_k[1],
                                             cache_v[0], cache_v[1],
                                             kv_len=kv_len, q_offset=pos)
    elif cache_row is not None:
        # serving prefill-into-slot: x is batch-1 but the cache is the full
        # [B', Hkv, S, d] shared slab; write this request's K/V at its slot
        # row and attend over that row (kv_row) — no staging cache
        cache_k = jax.lax.dynamic_update_slice(
            cache_k, k.astype(cache_k.dtype), (cache_row, 0, pos, 0))
        cache_v = jax.lax.dynamic_update_slice(
            cache_v, v.astype(cache_v.dtype), (cache_row, 0, pos, 0))
        att = ops.flash_attention(q, cache_k, cache_v, kv_len=kv_len,
                                  q_offset=pos, kv_row=cache_row)
    else:
        # write K/V into the cache at position `pos` (analog of sliceAssign
        # with storage_offset patching, llama_inference.zig:450-453)
        if per_row:
            dus = jax.vmap(lambda c, u, p: jax.lax.dynamic_update_slice(
                c, u, (0, p, 0)))
            cache_k = dus(cache_k, k.astype(cache_k.dtype), wp)
            cache_v = dus(cache_v, v.astype(cache_v.dtype), wp)
        else:
            cache_k = jax.lax.dynamic_update_slice(
                cache_k, k.astype(cache_k.dtype), (0, 0, pos, 0))
            cache_v = jax.lax.dynamic_update_slice(
                cache_v, v.astype(cache_v.dtype), (0, 0, pos, 0))
        if decode:
            att = ops.decode_attention(q, cache_k, cache_v, kv_len)
        else:
            att = ops.flash_attention(q, cache_k, cache_v, kv_len=kv_len,
                                      q_offset=pos)
    att = att.astype(x.dtype).transpose(0, 2, 1, 3).reshape(b, t, hq * hd)
    attn_out = _project(att, layer["wo"])
    if tp_axis is not None:
        attn_out = _tp_reduce(attn_out, tp_axis)
    x = x + attn_out.astype(x.dtype)

    h = ops.rmsnorm(x, layer["ffn_norm"], cfg.rms_norm_eps)
    if tp_axis is not None:
        h = _tp_copy(h, tp_axis)
    if "w_gate_up" in layer:
        gu = _project(h, layer["w_gate_up"])
        f = gu.shape[-1] // 2
        gate, up = gu[..., :f], gu[..., f:]
    else:
        gate = _project(h, layer["w_gate"])
        up = _project(h, layer["w_up"])
    ff_out = _project(refs.swiglu_ref(gate, up), layer["w_down"])
    if tp_axis is not None:
        ff_out = _tp_reduce(ff_out, tp_axis)
    x = x + ff_out.astype(x.dtype)
    return x, cache_k, cache_v


def _head_out(cfg, params, x, tp_axis, greedy):
    """Decode tail: out_norm + lm_head. greedy=True returns next-token ids
    [B] int32 (argmax over the last position's logits; XLA fuses the argmax
    into the logits' consumer) instead of logits."""
    x = ops.rmsnorm(x, params["out_norm"], cfg.rms_norm_eps)
    if tp_axis is not None:
        x = _tp_copy(x, tp_axis)
    lm_head = params.get("lm_head")
    if lm_head is None:   # tied embeddings: logits = x @ embd.T
        logits = jnp.einsum("btd,vd->btv", x.astype(jnp.float32),
                            params["tok_embd"].astype(jnp.float32))
    else:
        logits = _project(x, lm_head)
    if tp_axis is not None and lm_head is not None:
        # lm_head is column(vocab)-sharded: gather shards -> full vocab
        logits = _tp_gather(logits, tp_axis)
    logits = logits.astype(jnp.float32)
    if greedy:
        return jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
    return logits


class LlamaModel:
    """Functional model wrapper: holds config + params, exposes pure forward fns.

    The "plan" discipline of the reference (frozen graph + patched inputs,
    llama_inference.zig:51-149) maps to jit-compiled `forward` with static
    (B, T) shapes and donated caches — compiled once per shape bucket.
    """

    def __init__(self, cfg: LlamaConfig, params: dict):
        self.cfg = cfg
        self.params = params

    def quantize(self, kind: str = "q8_0") -> "LlamaModel":
        """Post-hoc weight quantization in place (the reference's
        `session.quantize(block)`, llama_inference.zig:189-231): every dense
        matmul weight becomes a planar PackedWeight; norms/embeddings stay
        f32. Returns self."""
        from zgml.io.llama_loader import quantize_llama_params
        self.params = quantize_llama_params(self.params, kind)
        return self

    # -- cache --------------------------------------------------------------
    def cache_layout(self, dtype=jnp.bfloat16,
                     layout: str | None = None) -> "CacheLayout":
        """THE cache-layout decision — the one place the layout matrix is
        resolved (decision table: ARCHITECTURE.md "KV-cache layouts").

        Signals, in order: an explicit `layout` override ("unrolled" /
        "stacked") wins; int8 dtype picks the quantized variant of the
        params-implied layout; otherwise scan-layout (stacked-dict) params
        imply STACKED and unrolled list params imply UNROLLED.
        """
        int8 = dtype == "int8" or dtype is jnp.int8
        if layout == "unrolled":
            return CacheLayout.UNROLLED_INT8 if int8 else CacheLayout.UNROLLED
        if layout == "stacked":
            if int8:
                raise ValueError("stacked layout override is bf16-only")
            return CacheLayout.STACKED
        if layout is not None:
            raise ValueError(f"unknown cache layout {layout!r}")
        unrolled_params = isinstance(self.params.get("layers"), (list, tuple))
        if int8:
            return (CacheLayout.UNROLLED_INT8 if unrolled_params
                    else CacheLayout.STACKED_INT8)
        return CacheLayout.UNROLLED if unrolled_params else CacheLayout.STACKED

    def init_cache(self, batch: int, dtype=jnp.bfloat16,
                   layout: str | None = None) -> dict:
        """KV cache in the layout chosen by `cache_layout` (the single
        chooser; see ARCHITECTURE.md decision table).

        dtype="int8" builds the block-quantized cache (~3.6x smaller;
        ref: QuantizedKVCache, quant.zig:645-910). layout overrides:
        "unrolled" forces the per-layer list (serving/cp paths), "stacked"
        forces the [L, ...] array (bf16 only).
        """
        c = self.cfg
        lay = self.cache_layout(dtype, layout)
        if lay is CacheLayout.STACKED:
            full = (c.n_layers, batch, c.n_kv_heads, c.max_seq_len,
                    c.head_dim)
            dt = jnp.bfloat16 if dtype in ("int8", jnp.int8) else dtype
            return {"k": jnp.zeros(full, dt), "v": jnp.zeros(full, dt)}
        if lay is CacheLayout.UNROLLED:
            shape = (batch, c.n_kv_heads, c.max_seq_len, c.head_dim)
            return {"k": [jnp.zeros(shape, dtype) for _ in range(c.n_layers)],
                    "v": [jnp.zeros(shape, dtype) for _ in range(c.n_layers)]}
        if lay is CacheLayout.STACKED_INT8:
            # one stacked [L, ...] leaf pair per cache; the lax.scan over
            # layers slices each layer's (q, scales) tuple
            qs = (c.n_layers, batch, c.n_kv_heads, c.head_dim, c.max_seq_len)
            ss = (c.n_layers, batch, c.n_kv_heads, c.max_seq_len)
            return {"k": (jnp.zeros(qs, jnp.int8), jnp.ones(ss, jnp.float32)),
                    "v": (jnp.zeros(qs, jnp.int8), jnp.ones(ss, jnp.float32))}
        from zgml.quant.kv_cache import init_quant_cache
        qc = init_quant_cache(c.n_layers, batch, c.n_kv_heads,
                              c.max_seq_len, c.head_dim)
        return {"k": [(kq, ks) for kq, ks in zip(qc["k_q"], qc["k_s"])],
                "v": [(vq, vs) for vq, vs in zip(qc["v_q"], qc["v_s"])]}

    # -- forward ------------------------------------------------------------
    def forward(self, params, tokens, cache, pos, tp_axis: str | None = None,
                tp_size: int = 1, cache_row=None, write_pos=None,
                greedy_head: bool = False):
        """tokens [B, T] int32, pos: scalar int32 start position.

        Returns (logits [B, T, V] f32, new_cache). kv_len = pos + T.
        With tp_axis set (inside shard_map) params' projection weights and the
        cache hold per-device shards; logits come back full (lm_head
        column-sharded + all_gather over vocab shards).
        cache_row: tokens are batch-1 but `cache` is a larger shared slab;
        read/write only batch entry cache_row (serving prefill-into-slot).
        greedy_head: return (next_token [B] int32, cache) instead of logits
        (_head_out).
        """
        cfg = self.cfg
        b, t = tokens.shape
        # layout compatibility gate (clear error instead of a shape crash
        # deep inside scan/DUS — the round-4 regression class)
        lay = cache_layout_of(cache)
        unrolled_params = isinstance(params.get("layers"), (list, tuple))
        if (lay in (CacheLayout.UNROLLED, CacheLayout.UNROLLED_INT8)
                and not unrolled_params):
            raise ValueError(
                f"cache layout {lay.value} requires unrolled (per-layer "
                "list) params, but params use the stacked scan layout; "
                "rebuild with model.init_cache() (see ARCHITECTURE.md "
                "'KV-cache layouts')")
        if lay is CacheLayout.STACKED_INT8 and unrolled_params:
            raise ValueError(
                "stacked int8 cache requires scan-layout params; unrolled "
                "models use the per-layer int8 list — rebuild with "
                "model.init_cache(batch, 'int8') (see ARCHITECTURE.md)")
        x = jnp.take(params["tok_embd"], tokens, axis=0)   # [B, T, D]
        if getattr(pos, "ndim", 0) == 1:
            # per-row positions (continuous batching; decode only, T == 1)
            assert t == 1, "per-row pos requires single-token decode"
            cos, sin = refs.rope_cos_sin(pos, cfg.head_dim, cfg.rope_base)
            cos = cos[:, None, None, :]     # [B,1,1,half] vs q [B,H,1,d]
            sin = sin[:, None, None, :]
        else:
            positions = pos + jnp.arange(t)
            cos, sin = refs.rope_cos_sin(positions, cfg.head_dim, cfg.rope_base)
        kv_len = pos + t
        decode = t == 1

        layers = params["layers"]
        if (isinstance(layers, (list, tuple))
                and not isinstance(cache["k"], (list, tuple))):
            # unrolled weights over the stacked [L, ...] cache (the
            # layout="stacked" override): each layer works on its static
            # slice, written back in place
            ck, cv = cache["k"], cache["v"]
            for i, layer in enumerate(layers):
                x, k_i, v_i = _layer_step(cfg, x, layer, ck[i], cv[i], pos,
                                          kv_len, cos, sin, decode, tp_axis,
                                          tp_size, cache_row, write_pos)
                ck, cv = ck.at[i].set(k_i), cv.at[i].set(v_i)
            out = _head_out(cfg, params, x, tp_axis, greedy_head)
            return out, {"k": ck, "v": cv}

        layers = params["layers"]
        if isinstance(layers, (list, tuple)):
            # unrolled: weights feed the matmul kernel directly with no
            # per-step gather/copy (a scan would dynamic-slice each layer's
            # weights, and a slice feeding a custom call materializes a
            # copy). Cache is per-layer lists so donation aliases each leaf
            # with no re-stack copies. Inference default.
            ks, vs = [], []
            for i, layer in enumerate(layers):
                x, ck, cv = _layer_step(cfg, x, layer, cache["k"][i],
                                        cache["v"][i], pos, kv_len, cos, sin,
                                        decode, tp_axis, tp_size, cache_row,
                                        write_pos)
                ks.append(ck)
                vs.append(cv)
            new_k, new_v = ks, vs
        else:
            # stacked + lax.scan: one compiled block regardless of depth.
            # Training/dryrun default (compile time over per-step perf).
            def body(x_carry, layer_and_cache):
                layer, ck, cv = layer_and_cache
                x_out, ck, cv = _layer_step(cfg, x_carry, layer, ck, cv, pos,
                                            kv_len, cos, sin, decode,
                                            tp_axis, tp_size, cache_row,
                                            write_pos)
                return x_out, (ck, cv)

            x, (new_k, new_v) = jax.lax.scan(
                body, x, (layers, cache["k"], cache["v"]))

        out = _head_out(cfg, params, x, tp_axis, greedy_head)
        return out, {"k": new_k, "v": new_v}
