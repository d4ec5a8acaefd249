"""Multi-chip sharding tests on the 8-virtual-CPU-device mesh.

The distributed layer has no reference counterpart (SURVEY.md §2.7) — the oracle
is the single-device model itself: TP+DP execution must be numerically
equivalent to unsharded execution.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from zgml.models.llama import LlamaConfig, LlamaModel, init_params
from zgml.parallel import (make_mesh, make_sharded_forward,
                               make_sharded_train_step, shard_llama_params)

CFG = LlamaConfig(vocab_size=256, d_model=64, n_heads=8, n_kv_heads=4,
                  d_ff=128, n_layers=2, max_seq_len=32)


@pytest.fixture(scope="module")
def model():
    return LlamaModel(CFG, init_params(CFG, seed=0))


def test_mesh_shape():
    mesh = make_mesh(tp=4, dp=2)
    assert mesh.shape == {"dp": 2, "tp": 4}
    assert len(jax.devices()) == 8


def test_tp_forward_matches_single_device(model):
    mesh = make_mesh(tp=4, dp=2)
    tokens = jnp.asarray(np.random.default_rng(0).integers(0, 256, (2, 8)),
                         jnp.int32)
    ref_logits, _ = model.forward(model.params, tokens, model.init_cache(2), 0)

    fwd = make_sharded_forward(model, mesh)
    params = shard_llama_params(model.params, mesh)
    cache = model.init_cache(2)
    logits, new_cache = fwd(params, tokens, cache, 0)
    np.testing.assert_allclose(np.asarray(logits), np.asarray(ref_logits),
                               rtol=2e-2, atol=2e-2)
    assert new_cache["k"].shape == (CFG.n_layers, 2, CFG.n_kv_heads,
                                    CFG.max_seq_len, CFG.head_dim)
    # ref tier: both sides run exact-f32 oracle math, so only the psum
    # reduction order differs — a TP wiring bug smaller than the kernel
    # tier's bf16-class 2e-2 tolerance cannot hide here
    from zgml.ops.dispatch import force_ref
    with force_ref():
        ref_logits2, _ = model.forward(model.params, tokens,
                                       model.init_cache(2), 0)
        # REBUILD the sharded fn inside the context: the earlier `fwd` jit
        # cached the kernel-tier executable and would ignore force_ref
        logits2, _ = make_sharded_forward(model, mesh)(
            params, tokens, model.init_cache(2), 0)
    # bound ABSOLUTE error against the logit magnitude (per-element rtol
    # explodes on near-zero logits); psum reduction-order noise is ~1e-6
    scale = float(np.abs(np.asarray(ref_logits2)).max())
    np.testing.assert_allclose(np.asarray(logits2), np.asarray(ref_logits2),
                               rtol=0, atol=1e-4 * scale)


def test_tp_decode_matches_single_device(model):
    mesh = make_mesh(tp=2, dp=4)
    b = 4
    tokens = jnp.asarray(np.random.default_rng(1).integers(0, 256, (b, 1)),
                         jnp.int32)
    cache0 = model.init_cache(b)
    ref_logits, _ = model.forward(model.params, tokens, cache0, 0)
    fwd = make_sharded_forward(model, mesh)
    params = shard_llama_params(model.params, mesh)
    logits, _ = fwd(params, tokens, model.init_cache(b), 0)
    np.testing.assert_allclose(np.asarray(logits), np.asarray(ref_logits),
                               rtol=2e-2, atol=2e-2)
    from zgml.ops.dispatch import force_ref
    with force_ref():
        ref_logits2, _ = model.forward(model.params, tokens,
                                       model.init_cache(b), 0)
        logits2, _ = make_sharded_forward(model, mesh)(
            params, tokens, model.init_cache(b), 0)
    scale = float(np.abs(np.asarray(ref_logits2)).max())
    np.testing.assert_allclose(np.asarray(logits2), np.asarray(ref_logits2),
                               rtol=0, atol=1e-4 * scale)


def test_tp_train_step_matches_single_device(model):
    """Sharded grads/update must equal the unsharded train step (Megatron
    _tp_copy exactness)."""
    from zgml.optim.sgd import sgd_update

    mesh = make_mesh(tp=4, dp=2)
    rng = np.random.default_rng(2)
    tokens = jnp.asarray(rng.integers(0, 256, (2, 9)), jnp.int32)

    # single-device reference step (same kernel tier as the sharded step, so
    # any mismatch is a *sharding* bug, not kernel-vs-oracle numerics)
    def loss_fn(params):
        logits, _ = model.forward(params, tokens[:, :-1],
                                  model.init_cache(2), 0)
        logp = jax.nn.log_softmax(logits, axis=-1)
        nll = -jnp.take_along_axis(logp, tokens[:, 1:][..., None], axis=-1)
        return jnp.mean(nll)

    ref_loss, ref_grads = jax.value_and_grad(loss_fn)(model.params)
    ref_params = sgd_update(model.params, ref_grads, 0.1)

    step = make_sharded_train_step(model, mesh)
    params = shard_llama_params(model.params, mesh)
    loss, new_params = step(params, tokens, model.init_cache(2), 0.1)

    assert abs(float(loss) - float(ref_loss)) < 1e-4
    for name in ("tok_embd", "out_norm"):
        np.testing.assert_allclose(np.asarray(new_params[name]),
                                   np.asarray(ref_params[name]),
                                   rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(new_params["layers"]["wq"]),
                               np.asarray(ref_params["layers"]["wq"]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(new_params["layers"]["w_down"]),
                               np.asarray(ref_params["layers"]["w_down"]),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kind", ["q8_0", "q4_0"])
@pytest.mark.parametrize("axis,tp", [("n", 2), ("n", 4), ("k", 2), ("k", 4)])
def test_shard_packed_exact(kind, axis, tp):
    """shard_packed must be an exact re-layout: each local shard dequantizes
    to the corresponding slice of the global dequantized weight."""
    import dataclasses
    from zgml.parallel.tp import shard_packed
    from zgml.quant.repack import dequant_packed, quantize_weight
    rng = np.random.default_rng(3)
    n, k = 96, 256
    w = rng.standard_normal((n, k)).astype(np.float32)
    pw = quantize_weight(w, kind)
    full = dequant_packed(pw)                      # [n, k]
    spw = shard_packed(pw, tp, axis)
    for t in range(tp):
        if axis == "n":
            qv = np.asarray(spw.qvals)[:, t * spw.n_pad:(t + 1) * spw.n_pad]
            sc = np.asarray(spw.scales)[:, t * spw.n_pad:(t + 1) * spw.n_pad]
            local = dataclasses.replace(spw, qvals=qv, scales=sc)
            want = full[t * spw.n:(t + 1) * spw.n, :]
        else:
            rows = spw.k_pad // 2 if kind == "q4_0" else spw.k_pad
            qv = np.asarray(spw.qvals)[t * rows:(t + 1) * rows]
            sb = spw.k_pad // 32
            sc = np.asarray(spw.scales)[t * sb:(t + 1) * sb]
            local = dataclasses.replace(spw, qvals=qv, scales=sc)
            want = full[:, t * spw.k:(t + 1) * spw.k]
        np.testing.assert_array_equal(dequant_packed(local), want)


def _quantize_stacked_params(params, kind):
    """Dense stacked params -> PackedWeight (stacked) for every matmul leaf."""
    from zgml.io.llama_loader import _stack_packed
    from zgml.quant.repack import quantize_weight
    out = {"tok_embd": params["tok_embd"], "out_norm": params["out_norm"]}
    layers = {}
    for name, leaf in params["layers"].items():
        if name in ("attn_norm", "ffn_norm"):
            layers[name] = leaf
            continue
        pws = [quantize_weight(np.asarray(leaf[i]).T, kind)
               for i in range(leaf.shape[0])]
        layers[name] = _stack_packed(pws)
    out["layers"] = layers
    if "lm_head" in params:
        out["lm_head"] = quantize_weight(np.asarray(params["lm_head"]).T, kind)
    return out


@pytest.mark.parametrize("kind", ["q8_0", "q4_0"])
def test_tp_forward_quantized_matches_single_device(model, kind):
    """TP over PackedWeight params == single-device quantized forward
    (per-shard repack keeps the quantized layout self-consistent)."""
    qparams = _quantize_stacked_params(model.params, kind)
    qmodel = LlamaModel(CFG, qparams)
    tokens = jnp.asarray(np.random.default_rng(4).integers(0, 256, (4, 8)),
                         jnp.int32)
    ref_logits, _ = qmodel.forward(qparams, tokens, qmodel.init_cache(4), 0)

    mesh = make_mesh(tp=2, dp=4)
    sharded = shard_llama_params(qparams, mesh)
    qmodel_sh = LlamaModel(CFG, sharded)
    fwd = make_sharded_forward(qmodel_sh, mesh)
    logits, _ = fwd(sharded, tokens, qmodel.init_cache(4), 0)
    np.testing.assert_allclose(np.asarray(logits), np.asarray(ref_logits),
                               rtol=2e-2, atol=2e-2)
    # ref tier: dequant is exact f32 on both sides -> tight bound
    from zgml.ops.dispatch import force_ref
    with force_ref():
        ref_logits2, _ = qmodel.forward(qparams, tokens,
                                        qmodel.init_cache(4), 0)
        logits2, _ = make_sharded_forward(qmodel_sh, mesh)(
            sharded, tokens, qmodel.init_cache(4), 0)
    scale = float(np.abs(np.asarray(ref_logits2)).max())
    np.testing.assert_allclose(np.asarray(logits2), np.asarray(ref_logits2),
                               rtol=0, atol=1e-4 * scale)


def test_tp_unsharded_packedweight_rejected(model):
    """Global-layout PackedWeight params must be rejected by
    make_sharded_forward (silent wrong-math guard)."""
    qparams = _quantize_stacked_params(model.params, "q8_0")
    qmodel = LlamaModel(CFG, qparams)
    mesh = make_mesh(tp=2, dp=4)
    with pytest.raises(ValueError, match="not TP-sharded"):
        make_sharded_forward(qmodel, mesh)


def test_ring_attention_matches_single_device():
    """Context-parallel ring attention == dense causal attention, under the
    default dispatch and under force_ref (the ring is one einsum path)."""
    from zgml.ops.dispatch import force_ref
    from zgml.parallel.ring import make_ring_attention
    from zgml.ops import refs
    import jax.numpy as jnp
    mesh = make_mesh(tp=4, dp=2)
    rng = np.random.default_rng(7)
    b, h, t, d = 1, 2, 64, 32   # t sharded 4-ways -> 16 per device
    q = jnp.asarray(rng.standard_normal((b, h, t, d)).astype(np.float32))
    k = jnp.asarray(rng.standard_normal((b, h, t, d)).astype(np.float32))
    v = jnp.asarray(rng.standard_normal((b, h, t, d)).astype(np.float32))
    mask = refs.causal_mask(t, t)
    want = refs.attention_ref(q, k, v, mask[None, None])
    got = make_ring_attention(mesh, axis="tp")(q, k, v)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-4, atol=2e-4)
    with force_ref():
        got_ref = make_ring_attention(mesh, axis="tp")(q, k, v)
    np.testing.assert_allclose(np.asarray(got_ref), np.asarray(want),
                               rtol=2e-4, atol=2e-4)


def test_ring_attention_flash_gqa():
    """The ring with GQA (n_rep=2): the un-repeated KV rotates and each
    query head folds its own KV head's blocks."""
    from zgml.parallel.ring import make_ring_attention
    from zgml.ops import refs
    import jax.numpy as jnp
    mesh = make_mesh(tp=8, dp=1)
    rng = np.random.default_rng(9)
    b, hq, hkv, t, d = 2, 4, 2, 96, 32    # t_loc = 12 (odd sublane pad)
    q = jnp.asarray(rng.standard_normal((b, hq, t, d)).astype(np.float32))
    k = jnp.asarray(rng.standard_normal((b, hkv, t, d)).astype(np.float32))
    v = jnp.asarray(rng.standard_normal((b, hkv, t, d)).astype(np.float32))
    got = make_ring_attention(mesh, axis="tp")(q, k, v)
    mask = refs.causal_mask(t, t)
    want = refs.gqa_attention_ref(q, k, v, mask[None, None])
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-4, atol=2e-4)


def test_ring_attention_noncausal():
    from zgml.parallel.ring import make_ring_attention
    from zgml.ops import refs
    import jax.numpy as jnp
    mesh = make_mesh(tp=8, dp=1)
    rng = np.random.default_rng(8)
    q = jnp.asarray(rng.standard_normal((2, 2, 32, 16)).astype(np.float32))
    k = jnp.asarray(rng.standard_normal((2, 2, 32, 16)).astype(np.float32))
    v = jnp.asarray(rng.standard_normal((2, 2, 32, 16)).astype(np.float32))
    ring = make_ring_attention(mesh, axis="tp", causal=False)
    got = ring(q, k, v)
    want = refs.attention_ref(q, k, v, None)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-4, atol=2e-4)


def test_pp_forward_matches_single_device():
    """Pipeline-parallel forward (layer-sharded stages) == unsharded."""
    from zgml.parallel.pp import make_pp_forward, shard_pp_params
    import jax.numpy as jnp
    cfg = LlamaConfig(vocab_size=128, d_model=64, n_heads=4, n_kv_heads=2,
                      d_ff=128, n_layers=8, max_seq_len=32)
    model = LlamaModel(cfg, init_params(cfg, seed=4))
    tokens = jnp.asarray(np.random.default_rng(5).integers(0, 128, (2, 6)),
                         jnp.int32)
    want, want_cache = model.forward(model.params, tokens,
                                     model.init_cache(2), 0)
    mesh = make_mesh(tp=4, dp=2, axis_names=("dp", "pp"))
    fwd = make_pp_forward(model, mesh)
    params = shard_pp_params(model.params, mesh)
    got, got_cache = fwd(params, tokens, model.init_cache(2), 0)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(np.asarray(got_cache["k"]),
                               np.asarray(want_cache["k"]),
                               rtol=2e-2, atol=2e-2)


def test_pp_microbatch_flops_scale_down():
    """GPipe schedule: per-device FLOPs ~= (M+pp-1)/(M*pp) of sequential —
    the schedule does REAL pipelining, not everyone-computes-every-cycle
    (which would be ~1.0 here)."""
    from zgml.parallel.pp import make_pp_forward, shard_pp_params
    cfg = LlamaConfig(vocab_size=128, d_model=64, n_heads=4, n_kv_heads=2,
                      d_ff=128, n_layers=8, max_seq_len=32)
    model = LlamaModel(cfg, init_params(cfg, seed=4))
    b, t, m = 8, 16, 8
    tokens = jnp.asarray(np.random.default_rng(6).integers(0, 128, (b, t)),
                         jnp.int32)
    mesh = make_mesh(tp=4, dp=2, axis_names=("dp", "pp"))
    pp = 4

    fwd = make_pp_forward(model, mesh, n_micro=m)
    params = shard_pp_params(model.params, mesh)
    pp_cost = fwd.lower(params, tokens, model.init_cache(b), 0) \
                 .compile().cost_analysis()
    seq_cost = jax.jit(model.forward).lower(
        model.params, tokens, model.init_cache(b), 0) \
        .compile().cost_analysis()
    ratio = pp_cost["flops"] / seq_cost["flops"]
    ideal = (m + pp - 1) / (m * pp)             # 0.34 for M=8, pp=4
    # allow for replicated embed/lm_head compute on every stage
    assert ratio < 0.6, (ratio, ideal)
    # and the outputs still match the unsharded model
    got, _ = fwd(params, tokens, model.init_cache(b), 0)
    want, _ = model.forward(model.params, tokens, model.init_cache(b), 0)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-2, atol=2e-2)


def test_pp_train_step_matches_single_device():
    """Pipelined GPipe training step == single-device step (exact grads via
    the _pp_ingest/_pp_collect boundary ops, incl. the tied-embedding path)."""
    from zgml.parallel.pp import make_pp_train_step, shard_pp_params
    from zgml.optim.sgd import sgd_update
    cfg = LlamaConfig(vocab_size=128, d_model=64, n_heads=4, n_kv_heads=2,
                      d_ff=128, n_layers=4, max_seq_len=32, tied_lm_head=True)
    model = LlamaModel(cfg, init_params(cfg, seed=7))
    b = 8
    tokens = jnp.asarray(np.random.default_rng(9).integers(0, 128, (b, 10)),
                         jnp.int32)
    mesh = make_mesh(tp=4, dp=2, axis_names=("dp", "pp"))

    def loss_fn(params):
        logits, _ = model.forward(params, tokens[:, :-1],
                                  model.init_cache(b), 0)
        logp = jax.nn.log_softmax(logits, axis=-1)
        nll = -jnp.take_along_axis(logp, tokens[:, 1:][..., None], axis=-1)
        return jnp.mean(nll)

    ref_loss, ref_grads = jax.value_and_grad(loss_fn)(model.params)
    ref_params = sgd_update(model.params, ref_grads, 0.1)

    step = make_pp_train_step(model, mesh, n_micro=4)
    params = shard_pp_params(model.params, mesh)
    loss, new_params = step(params, tokens, model.init_cache(b), 0.1)

    assert abs(float(loss) - float(ref_loss)) < 1e-4
    # atol covers bf16-dot rounding: the PP microbatch split changes the
    # attention accumulation order (ops use bf16 operands)
    for name in ("tok_embd", "out_norm"):
        np.testing.assert_allclose(np.asarray(new_params[name]),
                                   np.asarray(ref_params[name]),
                                   rtol=1e-3, atol=1e-4)
    for leaf_name in ("wq", "w_down", "attn_norm"):
        np.testing.assert_allclose(
            np.asarray(new_params["layers"][leaf_name]),
            np.asarray(ref_params["layers"][leaf_name]),
            rtol=1e-3, atol=1e-4, err_msg=leaf_name)


def test_cp_prefill_2048_matches_single_device():
    """Engine context-parallel prefill: a 2048-token prompt sharded 8 ways
    (ring attention over 'cp') == single-device forward, and decode continues
    on the engine's normal path afterwards."""
    from zgml.ops.dispatch import force_ref
    from zgml.runtime.engine import LlamaEngine
    cfg = LlamaConfig(vocab_size=128, d_model=64, n_heads=4, n_kv_heads=2,
                      d_ff=128, n_layers=2, max_seq_len=2056)
    model = LlamaModel(cfg, init_params(cfg, seed=11))
    rng = np.random.default_rng(12)
    prompt = rng.integers(0, 128, 2048).astype(np.int32)
    mesh = make_mesh(tp=8, dp=1, axis_names=("dp", "cp"))

    eng = LlamaEngine(model, batch=1)
    last = eng.prefill_cp(prompt, mesh)

    with force_ref():
        ref_logits, ref_cache = model.forward(
            model.params, jnp.asarray(prompt)[None], model.init_cache(1), 0)
    np.testing.assert_allclose(np.asarray(last), np.asarray(ref_logits[:, -1]),
                               rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(
        np.asarray(eng.cache["k"][:, :, :, :2048]).astype(np.float32),
        np.asarray(ref_cache["k"][:, :, :, :2048]).astype(np.float32),
        rtol=2e-2, atol=2e-2)

    # decode continues from the cp-prefilled cache
    nxt_tok = int(np.argmax(np.asarray(last[0])))
    _, step_logits = eng.step(np.array([nxt_tok]))
    with force_ref():
        ref_step, _ = model.forward(model.params,
                                    jnp.asarray([[nxt_tok]], jnp.int32),
                                    ref_cache, 2048)
    np.testing.assert_allclose(np.asarray(step_logits),
                               np.asarray(ref_step[:, -1]),
                               rtol=2e-2, atol=2e-2)


# -- TP over the unrolled quantized inference layout --------------------------

@pytest.fixture(scope="module")
def fused_q4_model(tmp_path_factory):
    """Small q4_0 model with fused projections (wqkv, w_gate_up) —
    unrolled layers, exactly the flagship decode layout."""
    from zgml.io.gguf import GGMLType
    from zgml.io.llama_loader import load_llama
    from zgml.utils.synthetic import write_synthetic_llama_gguf
    cfg = LlamaConfig(vocab_size=256, d_model=256, n_heads=4, n_kv_heads=2,
                      d_ff=512, n_layers=2, max_seq_len=64)
    path = str(tmp_path_factory.mktemp("tpq4") / "tp_fused_q4.gguf")
    write_synthetic_llama_gguf(path, cfg, GGMLType.Q4_0, seed=5)
    model, _ = load_llama(path, mode="quantized")
    return model


def test_tp_fused_decode_matches_single_device(fused_q4_model):
    """TP decode through the matmul kernel: per-shard regrouped wqkv and
    w_gate_up + local-head attention + psum'd residuals == the
    single-device path."""
    from zgml.parallel.tp import shard_llama_params
    from zgml.runtime.profile import global_profile
    model = fused_q4_model
    cfg = model.cfg
    assert "wqkv" in model.params["layers"][0]

    # single-device fused reference: prefill a short context then decode
    prompt = np.random.default_rng(7).integers(0, 256, (1, 6)).astype(np.int32)
    cache = model.init_cache(1)
    _, cache = model.forward(model.params, jnp.asarray(prompt), cache, 0)
    tok = jnp.asarray([[11]], jnp.int32)
    ref_logits, ref_cache = model.forward(model.params, tok, cache, 6)

    mesh = make_mesh(tp=2, dp=1, devices=jax.devices()[:2])
    params = shard_llama_params(model.params, mesh, cfg)
    model_sh = LlamaModel(cfg, params)
    fwd = make_sharded_forward(model_sh, mesh)
    cache2 = model.init_cache(1, layout="unrolled")   # TP: per-layer list
    _, cache2 = fwd(params, jnp.asarray(prompt), cache2, 0)
    global_profile.reset()
    logits, new_cache = fwd(params, tok, cache2, 6)
    np.testing.assert_allclose(np.asarray(logits), np.asarray(ref_logits),
                               rtol=2e-2, atol=2e-2)
    # the matmul kernel actually ran (placement counter, no silent fallback)
    assert global_profile.op_tiers.get(("qmatmul", "interpret"), 0) > 0
    # cache row equivalence at the decode position
    ref_k = np.concatenate([np.asarray(k[:, :, 6]) for k in ref_cache["k"]], 1)
    new_k = np.concatenate([np.asarray(k[:, :, 6]) for k in new_cache["k"]], 1)
    np.testing.assert_allclose(new_k.astype(np.float32),
                               ref_k.astype(np.float32), rtol=2e-2, atol=2e-2)


def test_shard_layer_fused_views_exact(fused_q4_model):
    """Each shard's regrouped wqkv dequantizes exactly to the matching
    head-segment columns of the global weight (no re-quantization)."""
    from zgml.parallel.tp import shard_unrolled_layer
    from zgml.quant.repack import dequant_packed
    model = fused_q4_model
    cfg = model.cfg
    layer = model.params["layers"][0]
    tp = 2
    stacked = shard_unrolled_layer(layer, cfg, tp)
    hq_l = cfg.n_heads // tp
    hkv_l = cfg.n_kv_heads // tp
    hd = cfg.head_dim
    nq, nkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    w_global = dequant_packed(layer["wqkv"])      # [N, K] logical
    pw = stacked["wqkv"]
    n_pad_l = pw.n_pad
    import dataclasses as dc
    for t in range(tp):
        local = dc.replace(pw, qvals=pw.qvals[:, t*n_pad_l:(t+1)*n_pad_l],
                           scales=pw.scales[:, t*n_pad_l:(t+1)*n_pad_l])
        w_local = dequant_packed(local)
        expect = np.concatenate([
            w_global[t*hq_l*hd:(t+1)*hq_l*hd],
            w_global[nq + t*hkv_l*hd: nq + (t+1)*hkv_l*hd],
            w_global[nq + nkv + t*hkv_l*hd: nq + nkv + (t+1)*hkv_l*hd]], 0)
        np.testing.assert_array_equal(w_local, expect)
