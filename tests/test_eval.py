"""Perplexity harness tests: quantized-vs-dense deltas within north-star gates
(ppl Δ <= 0.05 Q8_0 / <= 0.1 Q4_0, scaled for the tiny synthetic model)."""
import dataclasses
import os

import numpy as np
import pytest

from zgml.io.gguf import GGMLType
from zgml.io.llama_loader import load_llama
from zgml.runtime.eval import perplexity, ppl_delta
from zgml.utils.synthetic import TINY_TEST, write_synthetic_llama_gguf

CORPUS = os.path.join(os.path.dirname(__file__), "data", "corpus_tokens.npy")


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = tmp_path_factory.mktemp("ppl")
    p8 = d / "m8.gguf"
    p4 = d / "m4.gguf"
    write_synthetic_llama_gguf(str(p8), TINY_TEST, GGMLType.Q8_0, seed=11)
    write_synthetic_llama_gguf(str(p4), TINY_TEST, GGMLType.Q4_0, seed=11)
    dense, _ = load_llama(str(p8), mode="dense")     # dequantized q8 as "fp"
    q8, _ = load_llama(str(p8), mode="quantized")
    q4, _ = load_llama(str(p4), mode="quantized")
    return dense, q8, q4


def test_ppl_finite_and_reasonable(models):
    dense, _, _ = models
    rng = np.random.default_rng(0)
    toks = rng.integers(0, TINY_TEST.vocab_size, 100).astype(np.int32)
    ppl = perplexity(dense, toks, window=32)
    # untrained model on random tokens: ppl ~ vocab_size
    assert 10 < ppl < TINY_TEST.vocab_size * 4


def test_q8_delta_small(models):
    dense, q8, _ = models
    rng = np.random.default_rng(1)
    toks = rng.integers(0, TINY_TEST.vocab_size, 96).astype(np.int32)
    pa, pb, delta = ppl_delta(dense, q8, toks, window=32)
    # q8 weights vs their exact dequantized copies: kernel-precision only
    assert delta / pa < 0.01, (pa, pb)


def test_q4_delta_bounded(models):
    dense, _, q4 = models
    rng = np.random.default_rng(1)
    toks = rng.integers(0, TINY_TEST.vocab_size, 96).astype(np.int32)
    pa, pb, delta = ppl_delta(dense, q4, toks, window=32)
    # q4 carries real quantization error vs the q8-dequantized baseline;
    # bound it loosely (untrained tiny model amplifies relative error)
    assert delta / pa < 0.25, (pa, pb)


def test_windowing_consistency(models):
    dense, _, _ = models
    rng = np.random.default_rng(2)
    toks = rng.integers(0, TINY_TEST.vocab_size, 64).astype(np.int32)
    p1 = perplexity(dense, toks, window=63)
    p2 = perplexity(dense, toks, window=63)
    assert abs(p1 - p2) < 1e-6


@pytest.fixture(scope="module")
def corpus_models(tmp_path_factory):
    """Models whose vocab covers the checked-in natural-language corpus
    (repo docs through the repo-trained BPE, tools/make_corpus.py)."""
    cfg = dataclasses.replace(TINY_TEST, vocab_size=4608)
    d = tmp_path_factory.mktemp("ppl_corpus")
    p8, p4 = d / "m8.gguf", d / "m4.gguf"
    write_synthetic_llama_gguf(str(p8), cfg, GGMLType.Q8_0, seed=13)
    write_synthetic_llama_gguf(str(p4), cfg, GGMLType.Q4_0, seed=13)
    dense, _ = load_llama(str(p8), mode="dense")
    q8, _ = load_llama(str(p8), mode="quantized")
    q4, _ = load_llama(str(p4), mode="quantized")
    return dense, q8, q4


def test_corpus_is_natural_language():
    """The checked-in token stream must look like language, not noise:
    zipfian head, subword-scale compression, enough volume for windows."""
    toks = np.load(CORPUS)
    assert len(toks) >= 20000
    vals, counts = np.unique(toks, return_counts=True)
    assert len(vals) >= 1000
    # zipf head: the most frequent token covers >1% of the stream (uniform
    # random over 4k ids would give ~0.025%)
    assert counts.max() / len(toks) > 0.01


def test_corpus_q8_delta_small(corpus_models):
    """North-star drift gate on NON-RANDOM text: Q8_0
    weights within 1% relative ppl of their dequantized copies."""
    dense, q8, _ = corpus_models
    toks = np.load(CORPUS)[:1024]
    pa, pb, delta = ppl_delta(dense, q8, toks, window=64)
    assert delta / pa < 0.01, (pa, pb)


def test_corpus_q4_delta_bounded(corpus_models):
    dense, _, q4 = corpus_models
    toks = np.load(CORPUS)[:1024]
    pa, pb, delta = ppl_delta(dense, q4, toks, window=64)
    assert delta / pa < 0.25, (pa, pb)


def test_int8_kv_ppl_drift_bounded(models):
    """Model-level int8-KV accuracy gate (ADVICE r2): perplexity over the
    int8 per-position-scale cache within a tight delta of the bf16 cache on
    the SAME weights — bounds the widened-scale RMSE end-to-end."""
    dense, _, _ = models
    rng = np.random.default_rng(7)
    toks = rng.integers(0, TINY_TEST.vocab_size, 200).astype(np.int32)
    pa, pb, delta = ppl_delta(dense, dense, toks, window=32,
                              cache_dtype_b="int8")
    # relative gate: the synthetic model's ppl ~ vocab; int8 KV noise must
    # stay within 1% of it (the Q8_0 weight gate is 0.05 on ~5-10 ppl real
    # models ~ 0.5-1%)
    assert delta / pa <= 0.01, (pa, pb, delta)
