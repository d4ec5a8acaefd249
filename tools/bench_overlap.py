"""Collective/compute overlap measurement (BASELINE config 4).

A/B: the TP-sharded step as scheduled by XLA's latency-hiding scheduler
(collectives free to overlap independent compute/DMA) vs the same step with
every TP collective fenced by optimization_barriers (ZGML_TP_BARRIER=1).
overlap_gain = 1 - t_free / t_fenced: the fraction of collective time the
scheduler hides. Needs the GPUs of one host (the mesh spans all of them);
run it on a host with several GPUs, e.g. `ZGML_TP=4 python tools/bench_overlap.py`.

Measures the three shapes where overlap matters: TP prefill (batch compute to
hide behind), TP decode (critical-path collectives — expect ~0 gain), and
the dp+tp train step (grad psums hide behind backward matmuls).

Usage: [ZGML_TP=tp] python tools/bench_overlap.py
"""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax                                                     # noqa: E402
import jax.numpy as jnp                                        # noqa: E402

if jax.devices()[0].platform != "gpu":
    raise SystemExit("bench_overlap measures GPUs; found "
                     f"{jax.devices()[0].platform}")

from zgml.models.llama import LlamaConfig, LlamaModel, init_params  # noqa: E402
from zgml.parallel import (make_mesh, make_sharded_forward,          # noqa: E402
                               make_sharded_train_step, shard_llama_params)

print("devices:", jax.devices(), flush=True)
n = len(jax.devices())
tp = int(os.environ.get("ZGML_TP", min(8, n)))
dp = n // tp
mesh = make_mesh(tp=tp, dp=dp)
cfg = LlamaConfig(vocab_size=512, d_model=256, n_heads=8, n_kv_heads=8,
                  d_ff=1024, n_layers=4, max_seq_len=256)
model = LlamaModel(cfg, init_params(cfg, seed=0))
params = shard_llama_params(model.params, mesh)
b = 2 * dp
rng = np.random.default_rng(0)
prefill_toks = jnp.asarray(rng.integers(0, 512, (b, 128)), jnp.int32)
decode_toks = jnp.asarray(rng.integers(0, 512, (b, 1)), jnp.int32)
train_toks = jnp.asarray(rng.integers(0, 512, (b, 65)), jnp.int32)


def timed(f, *args, reps=20):
    jax.block_until_ready(jax.tree.leaves(f(*args))[0])   # compile
    t0 = time.time()
    for _ in range(reps):
        out = f(*args)
    jax.block_until_ready(jax.tree.leaves(out)[0])
    return (time.time() - t0) / reps


results = {}
for fenced in (False, True):
    os.environ["ZGML_TP_BARRIER"] = "1" if fenced else "0"
    tag = "fenced" if fenced else "free"
    fwd = make_sharded_forward(LlamaModel(cfg, params), mesh)
    step = make_sharded_train_step(LlamaModel(cfg, params), mesh)
    results[("prefill", tag)] = timed(
        lambda: fwd(params, prefill_toks, model.init_cache(b), 0))
    results[("decode", tag)] = timed(
        lambda: fwd(params, decode_toks, model.init_cache(b), 0))
    results[("train", tag)] = timed(
        lambda: step(params, train_toks, model.init_cache(b), 1e-3))
os.environ["ZGML_TP_BARRIER"] = "0"

print(f"mesh: dp={dp} tp={tp}  (platform {jax.default_backend()})")
for phase in ("prefill", "decode", "train"):
    t_free = results[(phase, "free")]
    t_fen = results[(phase, "fenced")]
    gain = 1 - t_free / t_fen if t_fen > 0 else 0.0
    print(f"{phase:8s} free {t_free*1e3:8.2f} ms   fenced {t_fen*1e3:8.2f} ms"
          f"   overlap gain {100*gain:5.1f}%", flush=True)
