"""Pipeline parallelism: llama layers sharded across a 'pp' mesh axis.

The stacked-layer pytree ([L, ...] leaves) shards naturally along its layer
axis: stage s owns layers [s*L/pp, (s+1)*L/pp) and their KV-cache slabs —
distributing parameter and cache MEMORY across the pipeline. Activations hand
off stage-to-stage via ppermute.

Schedule: GPipe-style microbatching under SPMD. The batch is split into M
microbatches and the pipeline runs M + pp - 1 ticks of a lax.scan; at tick t,
stage s computes its local layer block on microbatch t - s (one microbatch per
stage per tick — each device does REAL work each tick, unlike an
everyone-computes-the-full-batch selection loop). Per-device FLOPs are
(M + pp - 1) / (M * pp) of the sequential forward -> 1/pp as M grows; the
(pp - 1)-tick bubble is the standard GPipe cost. Training differentiates
straight through the scan: jax.grad reverses the ticks and ppermutes, giving
the mirrored backward pipeline (the reference has no pipeline or attention
backward at all — src/tensor/backward.zig:393-404).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from zgml.models.llama import LlamaModel
from zgml.parallel.tp import shard_map


def pp_param_specs(params: dict) -> dict:
    """Shard every stacked layer leaf along its leading (layer) axis."""
    def leaf_spec(leaf):
        return P("pp")          # leading axis only; rest replicated
    specs = {
        "tok_embd": P(None, None),
        "out_norm": P(None),
        "layers": jax.tree.map(leaf_spec, params["layers"]),
    }
    if "lm_head" in params:
        specs["lm_head"] = jax.tree.map(lambda _: P(None, None),
                                        params["lm_head"])
    return specs


# -- exact-gradient SPMD boundary ops (the PP analog of tp.py's Megatron
#    _tp_copy/_tp_reduce f/g operators) -----------------------------------
#
# With a replicated loss, differentiating through a bare psum scales grads by
# pp (psum's transpose is psum). These two custom-VJP ops route cotangents so
# per-device grads equal the single-device gradient exactly, with replicas
# staying bit-identical — verified by test_pp_train_step_matches_single_device.

@jax.custom_vjp
def _pp_collect(x):
    """Last stage's value, replicated to every stage (fwd: masked psum)."""
    stage = jax.lax.axis_index("pp")
    pp = jax.lax.psum(1, "pp")
    return jax.lax.psum(jnp.where(stage == pp - 1, x, jnp.zeros_like(x)),
                        "pp")


def _pp_collect_fwd(x):
    return _pp_collect(x), None


def _pp_collect_bwd(_, g):
    # the replicated cotangent is ONE logical value; deliver it to the last
    # stage only (no psum — that would multiply by pp)
    stage = jax.lax.axis_index("pp")
    pp = jax.lax.psum(1, "pp")
    return (jnp.where(stage == pp - 1, g, jnp.zeros_like(g)),)


_pp_collect.defvjp(_pp_collect_fwd, _pp_collect_bwd)


@jax.custom_vjp
def _pp_ingest(x_in, act):
    """Stage 0 takes the embedded input; later stages keep their activation."""
    stage = jax.lax.axis_index("pp")
    return jnp.where(stage == 0, x_in, act)


def _pp_ingest_fwd(x_in, act):
    return _pp_ingest(x_in, act), None


def _pp_ingest_bwd(_, g):
    # embedding-path cotangent exists only on stage 0; broadcast it so every
    # stage's (replicated) tok_embd grad replica stays identical
    stage = jax.lax.axis_index("pp")
    gx = jax.lax.psum(jnp.where(stage == 0, g, jnp.zeros_like(g)), "pp")
    return gx, jnp.where(stage == 0, jnp.zeros_like(g), g)


_pp_ingest.defvjp(_pp_ingest_fwd, _pp_ingest_bwd)


def _choose_micro(batch: int, pp: int) -> int:
    """Largest divisor of `batch` at most 4*pp (bubble fraction <= ~20%)."""
    best = 1
    for m in range(1, min(batch, 4 * pp) + 1):
        if batch % m == 0:
            best = m
    return best


def _pipeline_forward(cfg, params, tokens, cache, pos, *, pp: int,
                      n_micro: int):
    """SPMD pipeline body (runs inside shard_map over the 'pp' axis).

    Returns (hidden [B, T, D] — replicated final hidden states, cache).
    """
    from zgml.models.llama import _layer_step
    from zgml.ops import refs

    stage = jax.lax.axis_index("pp")
    b, t = tokens.shape
    mbs = b // n_micro
    x = jnp.take(params["tok_embd"], tokens, axis=0)          # [B, T, D]
    positions = pos + jnp.arange(t)
    cos, sin = refs.rope_cos_sin(positions, cfg.head_dim, cfg.rope_base)
    kv_len = pos + t
    decode = t == 1

    def local_scan(x_in, ck_all, cv_all):
        def body(x_c, layer_and_cache):
            layer, ck, cv = layer_and_cache
            x_o, ck, cv = _layer_step(cfg, x_c, layer, ck, cv, pos,
                                      kv_len, cos, sin, decode)
            return x_o, (ck, cv)
        return jax.lax.scan(body, x_in, (params["layers"], ck_all, cv_all))

    perm = [(i, (i + 1) % pp) for i in range(pp)]
    act0 = jnp.zeros((mbs, t, x.shape[-1]), x.dtype)
    out0 = jnp.zeros_like(x)

    def tick(carry, tk):
        act, ck, cv, out_buf = carry
        my_mb = tk - stage                       # microbatch this stage holds
        valid = jnp.logical_and(my_mb >= 0, my_mb < n_micro)
        start = jnp.clip(my_mb, 0, n_micro - 1) * mbs
        # stage 0 ingests its microbatch from the embedded input
        x_in = jax.lax.dynamic_slice_in_dim(x, start, mbs, axis=0)
        act_in = _pp_ingest(x_in, act)
        ck_mb = jax.lax.dynamic_slice_in_dim(ck, start, mbs, axis=1)
        cv_mb = jax.lax.dynamic_slice_in_dim(cv, start, mbs, axis=1)
        out, (ck_new, cv_new) = local_scan(act_in, ck_mb, cv_mb)
        # bubble ticks compute garbage on a clamped microbatch; only the
        # writebacks are masked (standard GPipe bubble cost)
        ck = jax.lax.dynamic_update_slice_in_dim(
            ck, jnp.where(valid, ck_new, ck_mb), start, axis=1)
        cv = jax.lax.dynamic_update_slice_in_dim(
            cv, jnp.where(valid, cv_new, cv_mb), start, axis=1)
        done = jnp.logical_and(valid, stage == pp - 1)
        cur = jax.lax.dynamic_slice_in_dim(out_buf, start, mbs, axis=0)
        out_buf = jax.lax.dynamic_update_slice_in_dim(
            out_buf, jnp.where(done, out, cur), start, axis=0)
        act = jax.lax.ppermute(out, "pp", perm)
        return (act, ck, cv, out_buf), None

    (_, ck, cv, out_buf), _ = jax.lax.scan(
        tick, (act0, cache["k"], cache["v"], out0),
        jnp.arange(n_micro + pp - 1))
    # collect the last stage's output buffer on every device (exact-grad op)
    final = _pp_collect(out_buf)
    return final, {"k": ck, "v": cv}


def _lm_head(cfg, params, h):
    from zgml.ops import dispatch as ops
    h = ops.rmsnorm(h, params["out_norm"], cfg.rms_norm_eps)
    lm_head = params.get("lm_head")
    if lm_head is None:
        logits = jnp.einsum("btd,vd->btv", h.astype(jnp.float32),
                            params["tok_embd"].astype(jnp.float32))
    else:
        logits = ops.qmatmul(h, lm_head)
    return logits.astype(jnp.float32)


def make_pp_forward(model: LlamaModel, mesh: Mesh, n_micro: int | None = None):
    """jit(shard_map) pipeline forward: (params, tokens, cache, pos) ->
    (logits, cache). Requires stacked layers with n_layers % pp == 0 and
    batch % n_micro == 0 (n_micro defaults per-call to a divisor <= 4*pp)."""
    pp = mesh.shape["pp"]
    cfg = model.cfg
    if cfg.n_layers % pp:
        raise ValueError(f"n_layers={cfg.n_layers} not divisible by pp={pp}")
    pspecs = pp_param_specs(model.params)
    cache_spec = {"k": P("pp"), "v": P("pp")}

    def fn(params, tokens, cache, pos):
        m = n_micro or _choose_micro(tokens.shape[0], pp)
        h, cache = _pipeline_forward(cfg, params, tokens, cache, pos,
                                     pp=pp, n_micro=m)
        return _lm_head(cfg, params, h), cache

    sm = shard_map(fn, mesh=mesh,
                   in_specs=(pspecs, P(None, None), cache_spec, P()),
                   out_specs=(P(None, None, None), cache_spec))
    return jax.jit(sm, donate_argnums=(2,))


def make_pp_train_step(model: LlamaModel, mesh: Mesh,
                       n_micro: int | None = None):
    """jit(shard_map) pipelined training step: (params, tokens, cache, lr) ->
    (loss, new_params). Next-token LM loss; jax.grad reverses the tick scan,
    so the backward is the mirrored pipeline (GPipe). Grad leaves replicated
    across pp are averaged via pmean (layer leaves stay stage-local)."""
    from zgml.optim.sgd import sgd_update

    pp = mesh.shape["pp"]
    cfg = model.cfg
    if cfg.n_layers % pp:
        raise ValueError(f"n_layers={cfg.n_layers} not divisible by pp={pp}")
    pspecs = pp_param_specs(model.params)
    cache_spec = {"k": P("pp"), "v": P("pp")}

    def loss_fn(params, tokens, cache):
        m = n_micro or _choose_micro(tokens.shape[0], pp)
        h, _ = _pipeline_forward(cfg, params, tokens[:, :-1], cache, 0,
                                 pp=pp, n_micro=m)
        logits = _lm_head(cfg, params, h)
        targets = tokens[:, 1:]
        logp = jax.nn.log_softmax(logits, axis=-1)
        nll = -jnp.take_along_axis(logp, targets[..., None], axis=-1)
        return jnp.mean(nll)

    def step(params, tokens, cache, lr):
        # grads are exact per-device thanks to the _pp_ingest/_pp_collect
        # boundary ops: layer leaves get stage-local grads, replicated leaves
        # get identical full grads on every stage — no pmean fixups
        loss, grads = jax.value_and_grad(loss_fn)(params, tokens, cache)
        return loss, sgd_update(params, grads, lr)

    sm = shard_map(step, mesh=mesh,
                   in_specs=(pspecs, P(None, None), cache_spec, P()),
                   out_specs=(P(), pspecs))
    return jax.jit(sm)


def shard_pp_params(params: dict, mesh: Mesh) -> dict:
    specs = pp_param_specs(params)
    return jax.tree.map(
        lambda leaf, spec: jax.device_put(leaf, NamedSharding(mesh, spec)),
        params, specs)
