#!/usr/bin/env python
"""Batched decode throughput sweep (BASELINE config: continuous batching
bs=1-32, roofline-vs-achieved tokens/s).

Each batch size gets its own compiled decode plan (the engine's shape-bucket
discipline); throughput is aggregate generated tokens/s over an on-device
decode_n scan.
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="smollm")
    ap.add_argument("--quant", default="q8_0")
    ap.add_argument("--batches", default="1,4,8,16,32")
    ap.add_argument("--tg", type=int, default=100)
    ap.add_argument("--kv", default="bf16", choices=["bf16", "int8"])
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from zgml.io.gguf import GGMLType
    from zgml.io.llama_loader import load_llama
    from zgml.runtime.engine import LlamaEngine
    from zgml.utils import synthetic
    from zgml.utils.synthetic import write_synthetic_llama_gguf

    cfg = dataclasses.replace(synthetic.SMOLLM_135M, tied_lm_head=False,
                              max_seq_len=1024)
    quant = GGMLType.Q8_0 if args.quant == "q8_0" else GGMLType.Q4_0
    cache_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), ".bench_cache")
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, f"{args.preset}_{args.quant}_serv.gguf")
    if not os.path.exists(path):
        write_synthetic_llama_gguf(path, cfg, quant, seed=0)
    model, _ = load_llama(path, mode="quantized")
    model.params = jax.device_put(model.params)

    results = {}
    for bs in [int(b) for b in args.batches.split(",")]:
        cache_dtype = "int8" if args.kv == "int8" else jnp.bfloat16
        eng = LlamaEngine(model, batch=bs, cache_dtype=cache_dtype)
        prompt = np.tile(np.arange(16, dtype=np.int32), (bs, 1)) + 1
        eng.prefill(prompt)
        tok, _ = eng.step(np.ones(bs, np.int32))
        chunk = min(50, args.tg)
        toks = eng.decode_n(tok, chunk)           # warm the measured shape
        _ = int(np.asarray(toks[-1])[0])
        eng.reset()
        eng.pos = prompt.shape[1] + 1
        t0 = time.time()
        done = 0
        while done < args.tg:
            n = min(chunk, args.tg - done)
            if n < chunk:
                break
            toks = eng.decode_n(tok, n)
            tok = toks[-1]
            done += n
        _ = int(np.asarray(tok)[0])
        rate = bs * done / (time.time() - t0)
        results[bs] = rate
        print(f"bs={bs:<3} aggregate {rate:8.1f} tok/s "
              f"({rate/bs:7.1f} tok/s/seq)", file=sys.stderr, flush=True)

    print(json.dumps({"metric": "batched decode aggregate tok/s",
                      "per_batch": results}))


if __name__ == "__main__":
    main()
