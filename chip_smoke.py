#!/usr/bin/env python
"""Smoke test of the quantized inference path on one NVIDIA GPU.

Runs in one process, through the entry points a user calls, on TinyLlama-1.1B
at full width and depth (d 2048, 22 layers, 32 query / 4 KV heads, d_ff 5632,
vocab 32000) with seeded random Q4_0 weights written as a GGUF file:

  1. device     the platform is "gpu"; prints its kind, count and the
                card's name and power limit (nvidia-smi)
  2. kernels    every fast path vs the float32 oracle at TinyLlama widths,
                Q4_0 and Q8_0, with the fast path's and XLA's median times
  3. engine     load_llama -> LlamaEngine: a 300-token prompt prefilled in
                chunks of 128, decode_n(64), with bf16 and int8 caches; the
                prefill and step logits vs force_ref() under teacher forcing
  4. serving    ContinuousBatchingEngine(max_batch=8) answers 6 requests,
                two admitted while the others decode; each request's prefill
                logits vs a lone LlamaEngine run
  5. gpu tests  the tests marked `gpu`, in this process
  6. placement  no op of phases 3-4 was served by the oracle or interpreted

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
A failed phase raises, so the exit code is non-zero and that line is never
printed.

  python chip_smoke.py [--seed N]
  python chip_smoke.py --four-cards   # TP=4 decode, dp1 x tp4 serving and
                                      # a 2048-token ring CP prefill, each
                                      # against its one-card result
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
COS_MIN = 0.999   # bf16 operands with f32 accumulation vs the f32 oracle


def log(*a):
    print(*a, flush=True)


def require_gpu():
    """The first device, which must be a GPU; otherwise exit non-zero."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.stderr.write(f"chip_smoke: needs a GPU, JAX found "
                         f"{dev.platform!r}\n")
        raise SystemExit(2)
    return dev


def card_line() -> str:
    """`name, power.limit` of the card(s) as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip()


def cosine(a, b) -> float:
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


class Placement:
    """Accumulates which implementation served each op in the fast-path
    runs (runtime/profile counters are recorded at trace time)."""

    def __init__(self):
        self.counts: collections.Counter = collections.Counter()

    def fast(self, fn, *args, **kw):
        from zgml.runtime.profile import global_profile
        global_profile.reset()
        out = fn(*args, **kw)
        self.counts.update(global_profile.op_tiers)
        return out

    @staticmethod
    def oracle(fn, *args, **kw):
        from zgml.ops.dispatch import force_ref
        from zgml.runtime.profile import global_profile
        with force_ref():
            out = fn(*args, **kw)
        global_profile.reset()
        return out


# Weight std of the random model: TinyLlama's published initializer_range.
# A wider draw (the synthetic writer's default 0.05) makes a 22-layer random
# network amplify bf16 rounding until logits drift from the f32 oracle
# (cosine 0.992 measured), which says nothing about the kernels.
INIT_STD = 0.02


def build_model(cfg, seed: int, quant: str = "q4_0"):
    """Seeded synthetic GGUF under .bench_cache/, loaded quantized and put
    on the device."""
    import jax
    from zgml.io.gguf import GGMLType
    from zgml.io.llama_loader import load_llama
    from zgml.utils.synthetic import write_synthetic_llama_gguf
    cache = os.path.join(ROOT, ".bench_cache")
    os.makedirs(cache, exist_ok=True)
    path = os.path.join(cache, f"smoke_d{cfg.d_model}_l{cfg.n_layers}_"
                               f"{quant}_std{INIT_STD}_seed{seed}.gguf")
    t0 = time.perf_counter()
    if not os.path.exists(path):
        write_synthetic_llama_gguf(path, cfg, getattr(GGMLType, quant.upper()),
                                   seed=seed, scale=INIT_STD)
    model, _ = load_llama(path, mode="quantized")
    model.params = jax.device_put(model.params)
    jax.block_until_ready(model.params)
    log(f"model: {path} written+loaded in {time.perf_counter() - t0:.1f} s")
    return model


def phase_kernels(cfg, ms=(1, 8, 128), kv_lens=(1, 300, 2047),
                  q_offsets=(0, 384), chunk=128, reps=20, seed=0):
    from zgml.runtime.conformance import render, run_conformance
    rows = run_conformance(cfg, ms=ms, kv_lens=kv_lens, q_offsets=q_offsets,
                           chunk=chunk, seed=seed, reps=reps)
    log(render(rows))
    bad = [r["name"] for r in rows if not r["ok"]]
    assert not bad, f"kernels over tolerance: {bad}"
    return rows


def _timed(fn, *args):
    import jax
    t0 = time.perf_counter()
    out = fn(*args)
    jax.block_until_ready(out)
    return out, time.perf_counter() - t0


def phase_engine(model, placement: Placement, prompt_len=300, chunk=128,
                 n_decode=64, cache_dtypes=("bf16", "int8"), seed=0):
    """Prefill + decode_n through LlamaEngine; the prefill logits and one
    step's logits vs the oracle fed the same tokens (teacher forcing)."""
    import jax.numpy as jnp
    from zgml.runtime.engine import LlamaEngine
    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, model.cfg.vocab_size, prompt_len).astype(np.int32)
    out = {}
    for name in cache_dtypes:
        dt = "int8" if name == "int8" else jnp.bfloat16
        eng = LlamaEngine(model, prefill_chunk=chunk, cache_dtype=dt)

        def run(eng=eng):
            eng.reset()
            last, t_pp = _timed(eng.prefill, prompt)
            tok = jnp.argmax(last, axis=-1).astype(jnp.int32)
            toks, t_tg = _timed(eng.decode_n, tok, n_decode)
            step_logits = eng.step(toks[-1])[1]
            return last, toks, step_logits, t_pp, t_tg

        placement.fast(run)                                  # compile
        last, toks, step_logits, t_pp, t_tg = placement.fast(run)

        ref = LlamaEngine(model, prefill_chunk=chunk, cache_dtype=dt)

        def teacher(ref=ref):
            ref_last = ref.prefill(prompt)
            first = np.asarray(jnp.argmax(last, axis=-1))
            ref.prefill(np.concatenate([first, np.asarray(toks)[:-1, 0]]))
            return ref_last, ref.step(toks[-1])[1]

        ref_last, ref_step = placement.oracle(teacher)
        c_pp, c_step = cosine(last, ref_last), cosine(step_logits, ref_step)
        log(f"engine[{name}]: prefill {prompt_len} tok in chunks of {chunk}: "
            f"{prompt_len / t_pp:.1f} tok/s; decode_n({n_decode}): "
            f"{n_decode / t_tg:.1f} tok/s; cosine vs oracle: prefill "
            f"{c_pp:.6f}, step {c_step:.6f}")
        assert np.isfinite(np.asarray(step_logits)).all()
        assert c_pp >= COS_MIN and c_step >= COS_MIN, (name, c_pp, c_step)
        out[name] = {"prefill_tok_s": prompt_len / t_pp,
                     "decode_tok_s": n_decode / t_tg,
                     "cos_prefill": c_pp, "cos_step": c_step}
    return out


# (prompt tokens, new tokens); the last two arrive while the others decode
SERVING_REQUESTS = ((17, 16), (700, 48), (129, 32), (300, 24), (64, 40),
                    (511, 16))


def phase_serving(model, placement: Placement, requests=SERVING_REQUESTS,
                  max_batch=8, chunk=128, seed=1, mesh=None, lone_model=None):
    """ContinuousBatchingEngine answers every request; each request's
    prefill logits match a lone LlamaEngine run of `lone_model` (default:
    `model`; a sharded model needs its one-card original). Returns
    rid -> output."""
    from zgml.runtime.engine import LlamaEngine
    from zgml.runtime.serving import ContinuousBatchingEngine
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, model.cfg.vocab_size, n).astype(np.int32)
               for n, _ in requests]

    def serve():
        srv = ContinuousBatchingEngine(model, max_batch=max_batch,
                                       prefill_chunk=chunk, mesh=mesh)
        t0 = time.perf_counter()
        early = len(requests) - 2
        rids = [srv.submit(p, n) for p, (_, n) in zip(prompts[:early],
                                                      requests[:early])]
        while not any(s is not None for s in srv.slots):
            srv.step()
        rids += [srv.submit(p, n) for p, (_, n) in zip(prompts[early:],
                                                       requests[early:])]
        steps = 0
        while srv.waiting or srv.prefilling or any(
                s is not None for s in srv.slots):
            srv.step()
            steps += 1
        return srv, rids, time.perf_counter() - t0, steps

    srv, rids, dt, steps = placement.fast(serve)
    reqs = [srv.requests[r] for r in rids]
    done = sum(r.done and len(r.output) == n
               for r, (_, n) in zip(reqs, requests))
    n_tok = sum(len(r.output) for r in reqs)
    cos = []
    for p, r in zip(prompts, reqs):
        lone = LlamaEngine(lone_model or model, prefill_chunk=chunk)
        cos.append(cosine(r.prefill_logits, placement.fast(lone.prefill, p)))
    log(f"serving: {done}/{len(requests)} requests done, {n_tok} tokens in "
        f"{steps} steps, {dt:.2f} s (compile included); prefill cosine vs "
        f"lone engine: min {min(cos):.6f}")
    assert done == len(requests), [(len(r.output), r.done) for r in reqs]
    assert min(cos) >= COS_MIN, cos
    return {r: srv.requests[r].output for r in rids}


def phase_gpu_tests():
    import pytest
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(ROOT, "tests")])
    assert rc == 0, f"gpu-marked tests failed (pytest exit {rc})"


def phase_placement(counts: collections.Counter):
    tiers = collections.defaultdict(dict)
    for (op, tier), n in counts.items():
        tiers[op][tier] = n
    log("placement: " + ", ".join(
        f"{op}[{' '.join(f'{t}={n}' for t, n in sorted(ts.items()))}]"
        for op, ts in sorted(tiers.items())))
    bad = {k: n for k, n in counts.items() if k[1] in ("ref", "interpret")}
    assert not bad, f"ops served by the oracle or the interpreter: {bad}"
    assert counts.get(("qmatmul", "triton"), 0) > 0, "matmul kernel unused"
    assert counts.get(("decode_attention", "triton"), 0) > 0, \
        "decode kernel unused"


def _bytes_in_use(devices):
    return [int(d.memory_stats()["bytes_in_use"]) for d in devices]


def four_cards(model, seed: int):
    """TP=4 quantized decode, dp1 x tp4 serving and a 2048-token ring CP
    prefill, each against the one-card result."""
    import jax
    import jax.numpy as jnp
    from zgml.models.llama import LlamaModel
    from zgml.parallel import make_mesh, make_sharded_forward
    from zgml.parallel.tp import shard_llama_params
    from zgml.runtime.engine import LlamaEngine
    devs = jax.devices()
    assert len(devs) == 4, f"--four-cards needs 4 GPUs, found {len(devs)}"
    cfg = model.cfg
    rng = np.random.default_rng(seed)
    placement = Placement()

    # TP=4 decode through make_sharded_forward vs the one-card forward
    mesh = make_mesh(tp=4, dp=1, devices=devs)
    before = _bytes_in_use(devs)
    params = shard_llama_params(model.params, mesh, cfg)
    jax.block_until_ready(params)
    grew = [a - b for a, b in zip(_bytes_in_use(devs), before)]
    log(f"four-cards: bytes added per device by the sharded weights: {grew}")
    assert all(g > 50e6 for g in grew), grew
    fwd = make_sharded_forward(LlamaModel(cfg, params), mesh)
    prompt = jnp.asarray(rng.integers(0, cfg.vocab_size, (1, 64)), jnp.int32)
    tok = jnp.asarray([[11]], jnp.int32)
    _, cache = placement.fast(fwd, params, prompt,
                              model.init_cache(1, layout="unrolled"), 0)
    tp_logits, _ = placement.fast(fwd, params, tok, cache, 64)
    one = jax.jit(model.forward)
    _, c1 = one(model.params, prompt, model.init_cache(1), 0)
    one_logits, _ = one(model.params, tok, c1, 64)
    c_tp = cosine(tp_logits, one_logits)
    log(f"four-cards: TP=4 decode logits vs one card: cosine {c_tp:.6f}")
    assert c_tp >= COS_MIN, c_tp

    # dp1 x tp4 serving vs one-card serving on the same requests
    reqs = ((17, 16), (300, 24), (129, 32), (64, 8))
    one_out = phase_serving(model, Placement(), requests=reqs, seed=seed)
    tp_out = phase_serving(LlamaModel(cfg, params), placement, requests=reqs,
                           seed=seed, mesh=mesh, lone_model=model)
    same = sum(a == b for a, b in zip(one_out.values(), tp_out.values()))
    log(f"four-cards: serving streams identical to one card: "
        f"{same}/{len(reqs)}")

    # ring context-parallel prefill of a 2048-token prompt over 4 cards
    cp_mesh = make_mesh(tp=4, dp=1, devices=devs, axis_names=("dp", "cp"))
    long = rng.integers(0, cfg.vocab_size, cfg.max_seq_len).astype(np.int32)
    eng = LlamaEngine(model, prefill_chunk=512)
    cp_last = placement.fast(eng.prefill_cp, long, cp_mesh)
    one_last = LlamaEngine(model, prefill_chunk=512).prefill(long)
    c_cp = cosine(cp_last, one_last)
    log(f"four-cards: ring CP prefill of {len(long)} tokens vs one card: "
        f"cosine {c_cp:.6f}")
    assert c_cp >= COS_MIN, c_cp
    phase_placement(placement.counts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true")
    args = ap.parse_args(argv)

    import jax
    dev = require_gpu()
    log(f"device: platform {dev.platform}, kind {dev.device_kind}, "
        f"count {len(jax.devices())}")
    log(f"card (name, power.limit): {card_line()}")
    from zgml.utils.synthetic import TINYLLAMA_1_1B
    cfg = TINYLLAMA_1_1B
    model = build_model(cfg, args.seed)

    if args.four_cards:
        four_cards(model, args.seed)
    else:
        phase_kernels(cfg, seed=args.seed)
        placement = Placement()
        phase_engine(model, placement, seed=args.seed)
        phase_serving(model, placement, seed=args.seed + 1)
        phase_gpu_tests()
        phase_placement(placement.counts)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
