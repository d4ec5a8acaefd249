#!/usr/bin/env python
"""Long-context decode: int8-KV vs bf16-KV, and decode-rate-vs-max_seq
flatness (decode memory traffic should scale with kv_len, not max_seq).

What it checks:
  - decode tok/s as max_seq grows 2k -> 8k at fixed kv_len
  - int8-KV vs bf16-KV at >= 2k context / bs >= 8
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def rate(eng, ctx: int, tg: int, reps: int = 3) -> float:
    """Aggregate decode tok/s from a kv_len=ctx start, best-of-reps."""
    import jax
    best = 0.0
    for _ in range(reps):
        eng.reset()
        eng.pos = ctx                      # decode from a ctx-token prefix
        toks = np.zeros(eng.batch, np.int32)
        eng.decode_n(toks, 8)              # warm the plan at this shape
        eng.reset(); eng.pos = ctx
        t0 = time.time()
        out = eng.decode_n(toks, tg)
        float(np.asarray(out)[-1, 0])      # value fetch = true barrier
        best = max(best, tg * eng.batch / (time.time() - t0))
    return best


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ctx", type=int, default=2048)
    ap.add_argument("--tg", type=int, default=64)
    ap.add_argument("--max-seqs", default="2560,4096,8192")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from zgml.io.gguf import GGMLType
    from zgml.io.llama_loader import load_llama
    from zgml.runtime.engine import LlamaEngine
    from zgml.utils import synthetic
    from zgml.utils.synthetic import write_synthetic_llama_gguf

    cache_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), ".bench_cache")
    os.makedirs(cache_dir, exist_ok=True)
    max_seqs = [int(s) for s in args.max_seqs.split(",")]
    cfg = dataclasses.replace(synthetic.SMOLLM_135M, tied_lm_head=False,
                              max_seq_len=max(max_seqs))
    path = os.path.join(cache_dir, "smollm_q8_0_long.gguf")
    if not os.path.exists(path):
        write_synthetic_llama_gguf(path, cfg, GGMLType.Q8_0, seed=0)
    model, _ = load_llama(path, mode="quantized")
    model.params = jax.device_put(model.params)

    out = {"ctx": args.ctx, "batch": args.batch}

    # -- flatness vs max_seq at fixed kv_len ---------------------------------
    flat = {}
    for ms in max_seqs:
        m2 = dataclasses.replace(model.cfg, max_seq_len=ms)
        from zgml.models.llama import LlamaModel
        mdl = LlamaModel(m2, model.params)
        eng = LlamaEngine(mdl, batch=args.batch)
        flat[ms] = round(rate(eng, args.ctx, args.tg), 1)
        print(f"max_seq={ms}: {flat[ms]} tok/s (kv_len={args.ctx}, "
              f"bs={args.batch}, bf16 KV)", file=sys.stderr)
    out["flatness_bf16"] = flat

    # -- int8 vs bf16 at this context ----------------------------------------
    ms = max_seqs[0]
    m2 = dataclasses.replace(model.cfg, max_seq_len=ms)
    from zgml.models.llama import LlamaModel
    mdl = LlamaModel(m2, model.params)
    r_bf16 = flat[ms]
    eng8 = LlamaEngine(mdl, batch=args.batch, cache_dtype="int8")
    r_int8 = round(rate(eng8, args.ctx, args.tg), 1)
    print(f"int8-KV: {r_int8} tok/s vs bf16 {r_bf16} "
          f"({r_int8 / r_bf16:.2f}x)", file=sys.stderr)
    out["int8_tok_s"] = r_int8
    out["bf16_tok_s"] = r_bf16
    out["int8_vs_bf16"] = round(r_int8 / r_bf16, 3)
    mn, mx = min(flat.values()), max(flat.values())
    out["flatness_ratio"] = round(mn / mx, 3)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
