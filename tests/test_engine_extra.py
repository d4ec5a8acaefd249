"""On-device decode loop and sampling tests."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from zgml.io.llama_loader import load_llama
from zgml.runtime.engine import LlamaEngine
from zgml.runtime.sampling import SamplingParams, sample
from zgml.utils.synthetic import TINY_TEST, write_synthetic_llama_gguf
from zgml.io.gguf import GGMLType


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    path = tmp_path_factory.mktemp("m") / "t.gguf"
    write_synthetic_llama_gguf(str(path), TINY_TEST, GGMLType.Q8_0, seed=3)
    m, _ = load_llama(str(path), mode="dense")
    return m


def test_decode_n_matches_step_loop(model):
    """decode_n (one on-device scan) must produce the same tokens as the
    per-step host loop (greedy)."""
    eng1 = LlamaEngine(model, donate_cache=False)
    eng1.prefill([1, 2, 3])
    tok, _ = eng1.step(np.array([7]))
    seq = [int(tok[0])]
    for _ in range(5):
        tok, _ = eng1.step(tok)
        seq.append(int(tok[0]))

    eng2 = LlamaEngine(model, donate_cache=False)
    eng2.prefill([1, 2, 3])
    tok, _ = eng2.step(np.array([7]))
    toks = eng2.decode_n(tok, 5)
    seq2 = [int(tok[0])] + [int(t) for t in np.asarray(toks)[:, 0]]
    assert seq == seq2
    assert eng1.pos == eng2.pos


def test_sampling_modes():
    key = jax.random.PRNGKey(0)
    logits = jnp.asarray([[1.0, 5.0, 2.0, 0.1]])
    assert int(sample(logits, SamplingParams(), key)[0]) == 1  # greedy
    t = sample(logits, SamplingParams(temperature=0.7, top_k=2), key)
    assert int(t[0]) in (1, 2)
    t = sample(logits, SamplingParams(temperature=0.5, top_p=0.5), key)
    assert int(t[0]) == 1  # top-p 0.5 keeps only the argmax here


def test_sampling_top_p_distribution():
    key = jax.random.PRNGKey(1)
    logits = jnp.tile(jnp.asarray([[3.0, 3.0, -10.0, -10.0]]), (256, 1))
    toks = np.asarray(sample(logits, SamplingParams(temperature=1.0, top_p=0.9),
                             key))
    assert set(np.unique(toks)) <= {0, 1}


def test_profile_program_census(model):
    """Static program profile (analog of profileProgram, profile.zig:72-167)."""
    from zgml.runtime.profile import profile_program
    import jax.numpy as jnp
    cache = model.init_cache(2)
    prof = profile_program(
        lambda t, c: model.forward(model.params, t, c, 0),
        jnp.zeros((2, 1), jnp.int32), cache)
    assert prof["n_eqns"] > 10
    # the decode-attention kernel of every layer is visible
    assert prof["custom_calls"] >= model.cfg.n_layers
    assert prof["input_bytes"] > 0


def test_no_silent_fallback_placement(model):
    """Acceptance rule 3 as a CI assert: an engine prefill + decode is served
    by the platform's fast paths (interpreted kernels on the CPU), never by
    the jnp oracle."""
    from zgml.runtime.profile import global_profile
    global_profile.reset()
    eng = LlamaEngine(model, batch=1)
    eng.prefill(np.arange(8, dtype=np.int32))
    eng.step(np.array([1]))
    tiers = global_profile.tier_summary()
    assert tiers.get("attention", {}).get("xla", 0) >= 1, tiers
    assert set(tiers["decode_attention"]) == {"interpret"}, tiers
    assert not any("ref" in t for t in tiers.values()), tiers


def test_cache_layout_decision_table():
    """The ONE chooser (ARCHITECTURE.md decision table) resolves every
    (params layout, dtype, override) combination predictably."""
    import jax.numpy as jnp
    from zgml.models.llama import (CacheLayout, LlamaConfig, LlamaModel,
                                       cache_layout_of, init_params)
    cfg = LlamaConfig(vocab_size=64, d_model=32, n_heads=2, n_kv_heads=1,
                      d_ff=64, n_layers=2, max_seq_len=16, tied_lm_head=True)
    scan = LlamaModel(cfg, init_params(cfg, seed=0))        # stacked dict
    unrolled = LlamaModel(cfg, dict(
        init_params(cfg, seed=0),
        layers=[{k: v[i] for k, v in init_params(cfg, 0)["layers"].items()}
                for i in range(2)]))

    # scan params -> stacked
    assert scan.cache_layout() is CacheLayout.STACKED
    assert scan.cache_layout("int8") is CacheLayout.STACKED_INT8
    # unrolled params: the per-layer list unless overridden
    assert unrolled.cache_layout() is CacheLayout.UNROLLED
    assert unrolled.cache_layout("int8") is CacheLayout.UNROLLED_INT8
    assert unrolled.cache_layout(layout="unrolled") is CacheLayout.UNROLLED
    assert unrolled.cache_layout(layout="stacked") is CacheLayout.STACKED
    # the inspector inverts init_cache for every layout
    for m, dt, lay in ((scan, jnp.bfloat16, None),
                       (scan, "int8", None),
                       (unrolled, jnp.bfloat16, "unrolled"),
                       (unrolled, "int8", None)):
        c = m.init_cache(1, dt, layout=lay)
        assert cache_layout_of(c) is m.cache_layout(dt, lay)

    # incompatible pairs rejected with a clear error at forward entry
    import pytest
    toks = jnp.zeros((1, 1), jnp.int32)
    with pytest.raises(ValueError, match="unrolled"):
        scan.forward(scan.params, toks,
                     unrolled.init_cache(1, layout="unrolled"), 0)
    with pytest.raises(ValueError, match="scan-layout"):
        unrolled.forward(unrolled.params, toks, scan.init_cache(1, "int8"), 0)
