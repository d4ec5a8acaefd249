"""HBM-bandwidth roofline harness for decode throughput.

The decode bound. Single-token decode is memory-bound: every
generated token must stream all matmul weights plus the live KV prefix from
HBM, so

    achievable tok/s = measured_HBM_bandwidth / bytes_per_token

This module measures the achievable number on the actual card (not the spec
sheet) and derives bytes/token from the actual resident model, mirroring the
reference's acceptance discipline of comparing against an external bound
rather than itself (ref: docs/perf-targets.md:218-230 of the reference).
"""
from __future__ import annotations

import time
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from zgml.quant.repack import PackedWeight


# Published dense peaks per device, keyed by jax.Device.device_kind:
# (bf16 tensor-core FLOP/s without sparsity, device-memory bytes/s).
# Source: NVIDIA H100 Tensor Core GPU data sheet (SXM5 and PCIe parts).
# The rates assume the part's full power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": (989.4e12, 3.35e12),     # H100 SXM5
    "NVIDIA H100 PCIe": (756.0e12, 2.0e12),
}


def peaks(device_kind: str) -> tuple[float, float]:
    """(bf16 FLOP/s, bytes/s) for a device kind; unknown kinds are an error,
    never a default."""
    if device_kind not in PEAKS:
        raise KeyError(f"no published peaks for device kind {device_kind!r}; "
                       f"known: {sorted(PEAKS)}")
    return PEAKS[device_kind]


def measure_hbm_bandwidth(nbytes: int = 1 << 30, iters: int = 20) -> float:
    """Measured streaming bandwidth (bytes/s) of a large copy-like pass:
    y = x * a + b over `nbytes` reads and writes nbytes each pass (2x
    traffic). Median of `iters` timed passes, each ended by
    block_until_ready."""
    n = nbytes // 4
    x = jnp.zeros((n,), jnp.float32)

    @jax.jit
    def f(x):
        return x * 1.0000001 + 1e-12

    jax.block_until_ready(f(x))   # compile + warm
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(f(x))
        times.append(time.perf_counter() - t0)
    return 2.0 * nbytes / float(np.median(times))


def _leaf_bytes(leaf: Any) -> int:
    if isinstance(leaf, PackedWeight):
        return leaf.nbytes
    return int(np.prod(leaf.shape)) * jnp.dtype(leaf.dtype).itemsize


def weight_bytes_per_token(params: dict) -> int:
    """Bytes of weights streamed per decoded token (bs=1).

    All matmul weights + norms are read in full; the token embedding is a
    single gathered row unless it doubles as a tied LM head (then the full
    matrix feeds the logits matmul).
    """
    total = 0
    layers = params["layers"]
    layer_list = layers if isinstance(layers, (list, tuple)) else [layers]
    for layer in layer_list:
        # stacked leaves already include the layer axis
        for leaf in jax.tree.leaves(
                layer, is_leaf=lambda x: isinstance(x, PackedWeight)):
            total += _leaf_bytes(leaf)
    total += _leaf_bytes(params["out_norm"])
    if "lm_head" in params:
        total += _leaf_bytes(params["lm_head"])
        # embedding: one row gather
        total += params["tok_embd"].shape[1] * jnp.dtype(
            params["tok_embd"].dtype).itemsize
    else:
        # tied head: full embedding matrix read by the logits matmul
        total += _leaf_bytes(params["tok_embd"])
    return total


def kv_bytes_per_token(cfg, kv_len: int, cache_dtype) -> int:
    """KV bytes read per decode step at a live prefix of kv_len positions.

    The decode kernel reads only the live prefix (zgml/ops/attention.py),
    so traffic is proportional to kv_len, not max_seq."""
    elems = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim * kv_len
    if cache_dtype == "int8":
        # int8 vals + one f32 scale per cached position per head
        return elems + (elems // cfg.head_dim) * 4
    return elems * jnp.dtype(cache_dtype).itemsize


def roofline(model, kv_len: int, cache_dtype=jnp.bfloat16,
             bandwidth: float | None = None) -> dict:
    """Achievable decode tok/s for `model` at a given live context length."""
    bw = bandwidth if bandwidth is not None else measure_hbm_bandwidth()
    wb = weight_bytes_per_token(model.params)
    kb = kv_bytes_per_token(model.cfg, kv_len, cache_dtype)
    per_tok = wb + kb
    return {
        "hbm_bandwidth_GBs": bw / 1e9,
        "weight_bytes": wb,
        "kv_bytes": kb,
        "bytes_per_token": per_tok,
        "achievable_tok_s": bw / per_tok,
    }
