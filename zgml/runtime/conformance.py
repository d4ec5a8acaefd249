"""On-device conformance sweep: every hot op's fast path vs the float32 oracle,
at model widths, on the CURRENT backend.

The analog of the reference's conformance suite, which runs identical
DevicePrograms on the reference executor AND the real backend
(src/backend/conformance.zig:13-60). The CPU tests run the kernels in
interpret mode at small shapes; this sweep closes the loop on the card:
`chip_smoke.py` and `python bench.py --conformance` run it there.

Tolerance: max |fast - oracle| <= 2e-2 * max |oracle| for the matmul and
attention paths, whose operands are bf16 (2^-9 relative rounding per
product, accumulated in f32); the oracle is f32 at Precision.HIGHEST.
"""
from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np

from zgml.models.llama import LlamaConfig
from zgml.ops import attention as attn
from zgml.ops import dispatch as ops
from zgml.ops.dispatch import force_ref
from zgml.ops.qmatmul import qmatmul_xla
from zgml.quant.repack import concat_packed, quantize_weight

TOL = 2e-2


def rel_err(got, want) -> float:
    """max |got - want| / max |want|."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = max(float(np.max(np.abs(want))), 1e-6)
    return float(np.max(np.abs(got - want))) / scale


def median_ms(fn, *args, reps: int) -> float | None:
    """Median wall time of a compiled call, each ended by block_until_ready
    (0 reps: not timed)."""
    if reps <= 0:
        return None
    jax.block_until_ready(fn(*args))          # compile + warm
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def projection_weights(cfg: LlamaConfig, kind: str, seed: int = 0) -> dict:
    """The five projections of one llama layer + lm_head at cfg's widths,
    quantized from seeded f32 weights, in the loader's fused layout."""
    rng = np.random.default_rng(seed)
    d, hd, f = cfg.d_model, cfg.head_dim, cfg.d_ff

    def qw(n, k, **kw):
        w = rng.standard_normal((n, k), dtype=np.float32) * 0.05
        return quantize_weight(w, kind, **kw)

    ws = {
        "wqkv": concat_packed([qw(cfg.n_heads * hd, d, n_align=1),
                               qw(cfg.n_kv_heads * hd, d, n_align=1),
                               qw(cfg.n_kv_heads * hd, d, n_align=1)]),
        "wo": qw(d, cfg.n_heads * hd),
        "w_gate_up": concat_packed([qw(f, d, n_align=1),
                                    qw(f, d, n_align=1)]),
        "w_down": qw(d, f),
        "lm_head": qw(cfg.vocab_size, d),
    }
    return jax.device_put(ws)


def run_conformance(cfg: LlamaConfig, kinds=("q4_0", "q8_0"),
                    ms=(1, 8, 128), kv_lens=(1, 300, 2047),
                    q_offsets=(0, 384), chunk: int = 128, seed: int = 0,
                    reps: int = 0) -> list[dict]:
    """Returns [{name, impl, rel_err, tol, ok, fast_ms, xla_ms}] for the
    quantized matmul at each (kind, projection, M), decode attention at each
    kv_len and prefill attention at each q_offset. With reps > 0 each row
    also carries the median time of its fast path and of the plain-XLA
    form (None where the fast path is XLA itself)."""
    rng = np.random.default_rng(seed)
    results: list[dict] = []

    def row(name, impl, got, want, fast_ms=None, xla_ms=None):
        err = rel_err(got, want)
        results.append({"name": name, "impl": impl, "rel_err": err,
                        "tol": TOL, "ok": bool(err <= TOL),
                        "fast_ms": fast_ms, "xla_ms": xla_ms})

    kernel_impl = "interpret" if ops.interpret() else "triton"
    for kind in kinds:
        for pname, pw in projection_weights(cfg, kind, seed).items():
            for m in ms:
                x = jnp.asarray(rng.standard_normal((m, pw.k)), jnp.float32)
                fast = jax.jit(lambda x, w: ops.qmatmul(x, w))
                xla = jax.jit(lambda x, w: qmatmul_xla(
                    jnp.pad(x, ((0, 0), (0, w.k_pad - x.shape[1]))), w))
                with force_ref():
                    want = ops.qmatmul(x, pw)
                row(f"qmatmul_{kind}_{pname}_m{m}", kernel_impl, fast(x, pw),
                    want, median_ms(fast, x, pw, reps=reps),
                    median_ms(xla, x, pw, reps=reps))

    hq, hkv, hd, s = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.max_seq_len
    kc = jnp.asarray(rng.standard_normal((1, hkv, s, hd)) * 0.5, jnp.bfloat16)
    vc = jnp.asarray(rng.standard_normal((1, hkv, s, hd)) * 0.5, jnp.bfloat16)
    q1 = jnp.asarray(rng.standard_normal((1, hq, 1, hd)) * 0.5, jnp.float32)
    for kv_len in kv_lens:
        lens = jnp.asarray([kv_len], jnp.int32)
        fast = jax.jit(ops.decode_attention)
        mask = (jnp.arange(s) < kv_len)[None, None, None, :]
        xla = jax.jit(lambda q, k, v: attn.xla_attention(q, k, v, mask))
        with force_ref():
            want = ops.decode_attention(q1, kc, vc, lens)
        impl = (kernel_impl if attn.decode_kernel_ok(q1, kc) else "xla")
        row(f"decode_attention_kv{kv_len}", impl, fast(q1, kc, vc, lens),
            want, median_ms(fast, q1, kc, vc, lens, reps=reps),
            median_ms(xla, q1, kc, vc, reps=reps))

    qm = jnp.asarray(rng.standard_normal((1, hq, chunk, hd)) * 0.5,
                     jnp.float32)
    for off in q_offsets:
        # a static offset, as a caller with a Python int passes it
        def fast(q, k, v, off=off):
            return ops.flash_attention(q, k, v, kv_len=off + chunk,
                                       q_offset=off)
        fast = jax.jit(fast)
        ki = jnp.arange(s)[None, :]
        qi = jnp.arange(chunk)[:, None] + off
        mask = ((ki < off + chunk) & (ki <= qi))[None, None]
        xla = jax.jit(lambda q, k, v: attn.xla_attention(q, k, v, mask))
        with force_ref():
            want = ops.flash_attention(qm, kc, vc, kv_len=off + chunk,
                                       q_offset=off)
        impl = ("cudnn" if ops.platform() == "gpu"
                and attn.cudnn_ok(qm, kc, off + chunk, off) else "xla")
        row(f"prefill_attention_off{off}", impl, fast(qm, kc, vc), want,
            median_ms(fast, qm, kc, vc, reps=reps) if impl != "xla" else None,
            median_ms(xla, qm, kc, vc, reps=reps))
    return results


def render(results: list[dict]) -> str:
    lines = ["== conformance (fast path vs float32 oracle, this backend) =="]
    for r in results:
        mark = "ok  " if r["ok"] else "FAIL"
        t = ""
        if r["fast_ms"] is not None or r["xla_ms"] is not None:
            fmt = lambda v: "-" if v is None else f"{v:.4f}"  # noqa: E731
            t = f"  {r['impl']} {fmt(r['fast_ms'])} ms  xla {fmt(r['xla_ms'])} ms"
        lines.append(f"  {mark} {r['name']:34s} [{r['impl']}] rel_err "
                     f"{r['rel_err']:.2e} (tol {r['tol']:.0e}){t}")
    n_ok = sum(r["ok"] for r in results)
    lines.append(f"  {n_ok}/{len(results)} passed")
    return "\n".join(lines)
