"""Demonstrate context-parallel prefill of a 32k-token prompt over every GPU
of the host through ring attention (parallel/ring.py).

Each device owns a T/n-token shard; every ring hop folds the visiting KV
block into an online-softmax accumulator, so a device holds one
[t_loc, t_loc] score block per head at a time, never the full [T, T].

Usage: python tools/demo_cp32k.py [T=32768] [layers=1]
"""
import os
import sys
import time

import jax  # noqa: E402
import numpy as np  # noqa: E402

if jax.devices()[0].platform != "gpu":
    raise SystemExit(f"demo_cp32k runs on GPUs; found {jax.devices()[0].platform}")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from zgml.models.llama import LlamaConfig, LlamaModel, init_params  # noqa: E402
from zgml.parallel.mesh import make_mesh                            # noqa: E402
from zgml.runtime.engine import LlamaEngine                         # noqa: E402
from zgml.runtime.profile import global_profile                     # noqa: E402

T = int(sys.argv[1]) if len(sys.argv) > 1 else 32768
L = int(sys.argv[2]) if len(sys.argv) > 2 else 1

cfg = LlamaConfig(vocab_size=256, d_model=128, n_heads=4, n_kv_heads=2,
                  d_ff=256, n_layers=L, max_seq_len=T + 64, tied_lm_head=True)
model = LlamaModel(cfg, init_params(cfg, seed=0))
n_dev = len(jax.devices())
mesh = make_mesh(tp=n_dev, dp=1, axis_names=("dp", "cp"))
prompt = np.random.default_rng(0).integers(0, 256, T).astype(np.int32)

eng = LlamaEngine(model, batch=1)
global_profile.reset()
t0 = time.time()
last = eng.prefill_cp(prompt, mesh)
last_np = np.asarray(last)
dt = time.time() - t0
n_ring = global_profile.op_tiers.get(("ring_attention", "xla"), 0)
assert np.isfinite(last_np).all(), "cp prefill produced non-finite logits"
assert n_ring > 0, "ring attention did not run"
print(f"cp32k ok: T={T} layers={L} t_loc={T // n_dev} in {dt:.1f}s "
      f"(compile included, {n_ring} ring calls on {n_dev} devices); "
      f"logits[0,:3]={last_np[0, :3]}")
nxt, _ = eng.step(np.array([int(last_np[0].argmax())]))
print(f"decode continues: next={int(np.asarray(nxt)[0])} pos={eng.pos}")
