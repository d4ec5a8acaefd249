"""CLI: inspect / generate / bench (ref: scripts/zgml.zig `inspect` prints
arch/params/format census, scripts/generate_llama.zig).

Usage: python -m zgml inspect model.gguf
       python -m zgml generate model.gguf --prompt-ids 1,2,3 -n 32
"""
from __future__ import annotations

import argparse
import collections
import sys


def cmd_inspect(args):
    from zgml.io.gguf import GGUFFile
    with GGUFFile(args.model) as gf:
        print(f"file: {args.model}")
        print(f"gguf version: {gf.version}, alignment: {gf.alignment}")
        arch = gf.metadata.get("general.architecture", "?")
        print(f"architecture: {arch}")
        interesting = [k for k in gf.metadata
                       if k.startswith((arch + ".", "general."))
                       and not isinstance(gf.metadata[k], list)]
        for k in sorted(interesting):
            print(f"  {k} = {gf.metadata[k]}")
        census = collections.Counter(
            info.ggml_type.name for info in gf.tensors.values())
        total_params = sum(info.n_elems for info in gf.tensors.values())
        total_bytes = sum(info.nbytes for info in gf.tensors.values())
        print(f"tensors: {len(gf.tensors)}  params: {total_params/1e6:.1f}M  "
              f"size: {total_bytes/1e6:.1f} MB")
        for name, cnt in census.most_common():
            print(f"  {name}: {cnt} tensors")
        if args.verbose:
            for name, info in gf.tensors.items():
                print(f"  {name:<40} {info.ggml_type.name:<6} {info.np_shape}")


def cmd_generate(args):
    import numpy as np
    from zgml.io.llama_loader import load_llama
    from zgml.runtime.engine import LlamaEngine
    from zgml.runtime.sampling import SamplingParams
    import jax.numpy as jnp
    model, gf = load_llama(args.model, mode=args.mode)
    sampling = SamplingParams(temperature=args.temperature, top_k=args.top_k,
                              top_p=args.top_p)
    cache_dtype = "int8" if args.kv == "int8" else jnp.bfloat16
    eng = LlamaEngine(model, sampling=sampling, cache_dtype=cache_dtype)
    if args.prompt_ids:
        ids = [int(t) for t in args.prompt_ids.split(",")]
    elif args.prompt is not None:
        from zgml.io.tokenizer import BPETokenizer
        tok = BPETokenizer.from_gguf(gf)
        ids = tok.encode(args.prompt)
    else:
        ids = [1]
    out = eng.generate(ids, args.n)
    print("prompt ids:", ids)
    print("output ids:", out)


def cmd_report(args):
    """Placement/profile report after a short run (perf-targets.md:224
    discipline: fallbacks must be visible)."""
    from zgml.runtime.profile import global_profile
    cmd_generate(args)
    print(global_profile.render())


def main(argv=None):
    ap = argparse.ArgumentParser(prog="zgml")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("inspect", help="print GGUF metadata/tensor census")
    p.add_argument("model")
    p.add_argument("-v", "--verbose", action="store_true")
    p.set_defaults(fn=cmd_inspect)

    for name, fn in (("generate", cmd_generate), ("report", cmd_report)):
        p = sub.add_parser(name)
        p.add_argument("model")
        p.add_argument("--prompt", default=None)
        p.add_argument("--prompt-ids", default=None)
        p.add_argument("-n", type=int, default=32)
        p.add_argument("--mode", default="quantized",
                       choices=["quantized", "dense"])
        p.add_argument("--kv", default="bf16", choices=["bf16", "int8"])
        p.add_argument("--temperature", type=float, default=0.0)
        p.add_argument("--top-k", type=int, default=0)
        p.add_argument("--top-p", type=float, default=1.0)
        p.set_defaults(fn=fn)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
