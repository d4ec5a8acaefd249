#!/usr/bin/env python
"""Per-op device-timeline profile of the compiled decode step.

The analog of the reference's per-step execution profile with layout
annotations (src/graph.zig:911-1112): captures a jax.profiler trace of an
N-step decode burst on the GPU, parses the xplane dump directly
(zgml/runtime/xplane.py — the stock parsers are version-locked and break
against the installed protobuf), and renders

  - per-op aggregate: device time by normalized kernel name (the Pallas
    matmul kernel, fusions, copies, cache writes), count, us/step
  - the module window vs sum-of-ops — the residue is gaps between kernels

Usage:
  python tools/profile_trace.py [packed.safetensors] [--kv 192] [--steps 8]
                                [--outdir /tmp/zgml_trace] [--top 25]
"""
from __future__ import annotations

import argparse
import collections
import glob
import os
import re
import shutil
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("ckpt", nargs="?",
                    default=".bench_cache/llama2-7b_q4_0.gguf"
                            ".packed.safetensors")
    ap.add_argument("--kv", type=int, default=192)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--outdir", default="/tmp/zgml_trace")
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from zgml.io.packed_ckpt import load_packed_llama

    print("devices:", jax.devices(), flush=True)
    model = load_packed_llama(args.ckpt)
    model.params = jax.device_put(model.params)
    jax.block_until_ready(jax.tree.leaves(model.params)[0])
    cfg = model.cfg
    cache = model.init_cache(1)

    @jax.jit
    def burst(params, tok0, cache, pos):
        def body(carry, _):
            tok, cache, pos = carry
            nxt, cache = model.forward(params, tok[:, None], cache, pos,
                                       greedy_head=True)
            return (nxt, cache, pos + 1), nxt

        (tok, cache, pos), toks = jax.lax.scan(
            body, (tok0, cache, pos), length=args.steps)
        return toks, cache

    tok0 = jnp.asarray([7], jnp.int32)
    toks, _ = burst(model.params, tok0, cache, jnp.int32(args.kv))
    jax.block_until_ready(toks)                       # compile + warm
    shutil.rmtree(args.outdir, ignore_errors=True)
    with jax.profiler.trace(args.outdir):
        toks, _ = burst(model.params, tok0, cache, jnp.int32(args.kv))
        jax.block_until_ready(toks)

    files = glob.glob(args.outdir + "/**/*.xplane.pb", recursive=True)
    if not files:
        print("no xplane dump found under", args.outdir)
        return 1
    from zgml.runtime.xplane import device_planes, parse_xspace, window_stats
    dev = device_planes(parse_xspace(files[0]))[0]
    # the GPU plane's lines are CUDA streams; the trace holds only the burst
    evs = [e for ln in dev.lines if ln.name.startswith("Stream")
           for e in ln.events]
    window, busy = window_stats(evs)
    agg = collections.defaultdict(lambda: [0, 0])
    for e in evs:
        key = re.sub(r"[.\d]+", "#", e.name.split(" = ")[0])
        agg[key][0] += 1
        agg[key][1] += e.duration_ps
    n = args.steps
    total = sum(v[1] for v in agg.values())
    print(f"\nwindow {window / 1e9 / n:.3f} ms/step ({n} steps), device "
          f"busy {busy / window:.3f}, idle {1 - busy / window:.3f}")
    print(f"{'us/step':>9s} {'x/step':>7s}  op")
    for key, (cnt, dur) in sorted(agg.items(), key=lambda kv: -kv[1][1])[
            : args.top]:
        print(f"{dur / 1e6 / n:9.1f} {cnt / n:7.1f}  {key[:80]}")
    print(f"{'-' * 40}\n{total / 1e6 / n:9.1f}         sum of ops "
          f"(> busy means overlapped events)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
