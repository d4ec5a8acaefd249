"""Perplexity evaluation harness.

The north-star accuracy gate (BASELINE.json): WikiText-2 ppl of the quantized
model within Δ <= 0.05 (Q8_0) / <= 0.1 (Q4_0) of the FP16 reference. This
environment has no network egress, so the harness takes any token array; the
*delta* between two weight formats on identical data is the metric that
matters and is dataset-agnostic.

llama.cpp-style windowed evaluation: the token stream is split into
`window`-sized chunks, each scored independently with a fresh context
(teacher-forced next-token NLL over the whole window).
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np


_window_jit: dict = {}


def window_nll(model, tokens: jax.Array,
               cache_dtype=jnp.bfloat16) -> tuple[float, int]:
    """Sum NLL (nats) + count over one [T] window, scored with full context.

    The scoring forward is jit-compiled per (model, T, cache dtype): an
    eager forward would dispatch every op of every window separately."""
    toks = jnp.asarray(tokens, jnp.int32)[None, :]
    key = (id(model), toks.shape[1], str(cache_dtype))
    fn = _window_jit.get(key)
    if fn is None:
        @jax.jit
        def fn(params, toks):
            cache = model.init_cache(1, cache_dtype)
            logits, _ = model.forward(params, toks, cache, 0)
            logp = jax.nn.log_softmax(logits[0, :-1].astype(jnp.float32),
                                      axis=-1)
            tgt = toks[0, 1:]
            return jnp.sum(-jnp.take_along_axis(logp, tgt[:, None],
                                                axis=-1)[:, 0])
        _window_jit[key] = fn
    return float(fn(model.params, toks)), int(toks.shape[1] - 1)


def perplexity(model, tokens: np.ndarray, window: int = 256,
               cache_dtype=jnp.bfloat16) -> float:
    """ppl = exp(mean nll) over non-overlapping windows."""
    tokens = np.asarray(tokens)
    total, count = 0.0, 0
    # each chunk forwards window+1 tokens (targets are shifted), so the
    # window must leave one cache slot of headroom
    window = min(window, model.cfg.max_seq_len - 1)
    for i in range(0, len(tokens) - 1, window):
        chunk = tokens[i:i + window + 1]
        if len(chunk) < 2:
            break
        nll, n = window_nll(model, chunk, cache_dtype)
        total += nll
        count += n
    return math.exp(total / max(1, count))


def ppl_delta(model_a, model_b, tokens: np.ndarray, window: int = 256,
              cache_dtype_a=jnp.bfloat16, cache_dtype_b=jnp.bfloat16
              ) -> tuple[float, float, float]:
    """Returns (ppl_a, ppl_b, |delta|). cache_dtype_b="int8" gates the
    int8-KV drift at the model level (ADVICE r2: the per-position-scale
    widening must be bounded end-to-end, not just per-op)."""
    pa = perplexity(model_a, tokens, window, cache_dtype_a)
    pb = perplexity(model_b, tokens, window, cache_dtype_b)
    return pa, pb, abs(pa - pb)
