#!/usr/bin/env python
"""Multi-chip scaling-efficiency harness (BASELINE configs: tokens/s scaling
efficiency at 1 chip / 1 host / N hosts).

Runs the tp-sharded decode forward on a ('dp','tp') mesh over however many
devices exist and reports tokens/s and efficiency vs the single-device rate.
On the GPUs of one host it runs as-is; --force-cpu-devices N validates the
structure on a virtual CPU mesh (no timing meaning there).
"""
from __future__ import annotations

import argparse
import os
import json
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--force-cpu-devices", type=int, default=0)
    ap.add_argument("--tg", type=int, default=32)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--layers", type=int, default=4)
    args = ap.parse_args()

    import os
    if args.force_cpu_devices:
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                                   f" --xla_force_host_platform_device_count="
                                   f"{args.force_cpu_devices}").strip()
        os.environ["ZGML_KERNELS"] = "ref"
        import jax
        jax.config.update("jax_platforms", "cpu")
    else:
        import jax

    import jax.numpy as jnp
    from zgml.models.llama import LlamaConfig, LlamaModel, init_params
    from zgml.parallel import (make_mesh, make_sharded_forward,
                                   shard_llama_params)

    n_dev = len(jax.devices())
    cfg = LlamaConfig(vocab_size=2048, d_model=args.d_model, n_heads=8,
                      n_kv_heads=8, d_ff=2 * args.d_model,
                      n_layers=args.layers, max_seq_len=256)
    model = LlamaModel(cfg, init_params(cfg, seed=0))  # stacked layer pytree
    toks = jnp.asarray(np.ones((1, 1), np.int32))

    def run(mesh_devices):
        mesh = make_mesh(tp=len(mesh_devices), dp=1, devices=mesh_devices)
        fwd = make_sharded_forward(model, mesh)
        params = shard_llama_params(model.params, mesh)
        cache = model.init_cache(1)
        logits, cache = fwd(params, toks, cache, 0)
        _ = float(np.asarray(logits[0, 0, 0]))
        t0 = time.time()
        for i in range(args.tg):
            logits, cache = fwd(params, toks, cache, i + 1)
        _ = float(np.asarray(logits[0, 0, 0]))
        return args.tg / (time.time() - t0)

    r1 = run(jax.devices()[:1])
    rn = run(jax.devices())
    eff = rn / (r1 * n_dev) if n_dev > 1 else 1.0
    speedup = rn / r1
    print(f"1 device: {r1:.1f} tok/s; {n_dev} devices: {rn:.1f} tok/s "
          f"(speedup {speedup:.2f}x, per-chip efficiency {eff:.1%})",
          file=sys.stderr)
    print(json.dumps({"metric": "tp scaling", "devices": n_dev,
                      "tok_s_1dev": round(r1, 2), "tok_s_ndev": round(rn, 2),
                      "speedup": round(speedup, 3)}))


if __name__ == "__main__":
    main()
