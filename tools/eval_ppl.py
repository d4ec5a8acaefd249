#!/usr/bin/env python
"""Perplexity-delta evaluation CLI: quantized vs dense on identical tokens.

The north-star accuracy gate (BASELINE.json: ppl within 0.05/0.1 of fp for
Q8_0/Q4_0 on WikiText-2). Zero-egress environment -> tokens default to the
checked-in natural-language corpus (tests/data/corpus_tokens.npy: the repo's
docs through a repo-trained GPT-2-style BPE, tools/make_corpus.py) — random
tokens give ppl ~= vocab and hide quantization deltas structurally. --tokens
overrides; --random forces the old synthetic stream.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("model", help="GGUF path (quantized)")
    ap.add_argument("--tokens", default=None, help=".npy int token file")
    ap.add_argument("--random", action="store_true",
                    help="synthetic uniform-random tokens (legacy)")
    ap.add_argument("--n-tokens", type=int, default=2048)
    ap.add_argument("--window", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    corpus = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tests", "data", "corpus_tokens.npy")
    if args.tokens is None and not args.random and os.path.exists(corpus):
        args.tokens = corpus

    import jax
    from zgml.io.llama_loader import load_llama
    from zgml.runtime.eval import perplexity

    qmodel, _ = load_llama(args.model, mode="quantized")
    dmodel, _ = load_llama(args.model, mode="dense")
    cfg = qmodel.cfg
    if args.tokens:
        toks = np.load(args.tokens).astype(np.int32)
        if args.n_tokens and len(toks) > args.n_tokens:
            toks = toks[:args.n_tokens]
    else:
        toks = np.random.default_rng(args.seed).integers(
            0, cfg.vocab_size, args.n_tokens).astype(np.int32)

    pd = perplexity(dmodel, toks, args.window)
    pq = perplexity(qmodel, toks, args.window)
    print(f"dense ppl {pd:.4f}  quantized ppl {pq:.4f}  "
          f"delta {abs(pq-pd):.4f} ({abs(pq-pd)/pd:.2%})", file=sys.stderr)
    print(json.dumps({"metric": "ppl delta quantized vs dense",
                      "ppl_dense": round(pd, 4), "ppl_quant": round(pq, 4),
                      "delta": round(abs(pq - pd), 4),
                      "rel_delta": round(abs(pq - pd) / pd, 5)}))


if __name__ == "__main__":
    main()
