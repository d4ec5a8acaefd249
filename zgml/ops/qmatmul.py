"""Weight-only Q8_0 / Q4_0 matmul for the GPU: a Pallas kernel (Triton route)
and the plain XLA formulation it is measured against.

The packed weight stays in device memory as int8 (Q8_0) or nibble pairs
(Q4_0) with one f16 scale per 32-element block (zgml/quant/repack.py).
The kernel walks K one 32-row block at a time: it loads a [32, BN] tile of
packed integers and the tile's [BN] scales, unpacks them in registers to
bf16 (the integers -128..127 and -8..7 are exact in bf16), multiplies the
matching [BM, 32] activation slice through the tensor cores with f32
accumulation, and applies the block scale to the partial product. So a
decode step reads 4.5 (Q4_0) or 8.5 (Q8_0) bits per weight and never writes
a dequantized copy.

Blocks of a CUDA grid run in parallel and in no order, so a small M (decode)
leaves too few output tiles to fill the card; the grid then also splits K,
each split writes an f32 partial, and XLA sums the partials.

For Q4_0 the packed row j holds k = j (low nibble) and k = j + K/2 (high
nibble), so one tile of 32 packed rows feeds two 32-wide activation slices.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from zgml.quant.blocks import QK
from zgml.quant.repack import PackedWeight

# Programs to keep in flight: two per streaming multiprocessor of an H100
# (132 SMs), so that one program's loads overlap another's arithmetic.
_TARGET_PROGRAMS = 264
_MIN_STEPS_PER_SPLIT = 4


@dataclasses.dataclass(frozen=True)
class Tiles:
    """Launch geometry of one kernel call (static: part of the jit key)."""
    bm: int        # rows of x per program (16, 32 or 64)
    bn: int        # output columns per program
    splits: int    # K splits (partials summed in XLA)
    steps: int     # 32-row packed blocks each program walks

    def grid(self, m_pad: int, n_pad: int) -> tuple[int, int, int]:
        return (m_pad // self.bm, n_pad // self.bn, self.splits)


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def choose_tiles(kind: str, m: int, k_pad: int, n_pad: int) -> Tiles:
    """Tile sizes for x [m, k_pad] @ W [k_pad, n_pad].

    bm follows M (decode rows pad to 16, the smallest tensor-core tile);
    bn is the widest power of two up to 128 that divides n_pad; K is split
    until about _TARGET_PROGRAMS programs exist, keeping at least
    _MIN_STEPS_PER_SPLIT blocks per split."""
    if kind not in ("q8_0", "q4_0"):
        raise ValueError(f"unsupported quant kind {kind!r}")
    bm = 16 if m <= 16 else 32 if m <= 32 else 64
    bn = next(c for c in (128, 64, 32, 16) if n_pad % c == 0)
    total = k_pad // QK if kind == "q8_0" else k_pad // (2 * QK)
    programs = -(-m // bm) * (n_pad // bn)
    splits = 1
    for cand in range(1, total + 1):
        if total % cand or total // cand < _MIN_STEPS_PER_SPLIT:
            continue
        if programs * cand > _TARGET_PROGRAMS:
            break
        splits = cand
    return Tiles(bm, bn, splits, total // splits)


def _kernel(x_ref, q_ref, s_ref, o_ref, *, kind: str, steps: int,
            half: int):
    """One (M block, N block, K split) program.

    x_ref [BM, K_pad] bf16; q_ref [rows, BN] int8; s_ref [K_pad/32, BN] f16;
    o_ref [BM, BN] f32 (this split's partial)."""
    bm, bn = o_ref.shape
    first = pl.program_id(2) * steps

    def body(i, acc):
        blk = first + i
        rows = pl.ds(blk * QK, QK)
        q = q_ref[rows, :]
        s_lo = s_ref[blk, :].astype(jnp.float32)
        x_lo = x_ref[:, pl.ds(blk * QK, QK)]
        if kind == "q8_0":
            part = pl.dot(x_lo, q.astype(jnp.bfloat16))
            return acc + part * s_lo[None, :]
        b = q.astype(jnp.int32)
        lo = ((b & 15) - 8).astype(jnp.bfloat16)
        hi = (((b >> 4) & 15) - 8).astype(jnp.bfloat16)
        x_hi = x_ref[:, pl.ds(half + blk * QK, QK)]
        s_hi = s_ref[half // QK + blk, :].astype(jnp.float32)
        return (acc + pl.dot(x_lo, lo) * s_lo[None, :]
                + pl.dot(x_hi, hi) * s_hi[None, :])

    acc = jax.lax.fori_loop(0, steps, body,
                            jnp.zeros((bm, bn), jnp.float32))
    o_ref[...] = acc


def _launch(tiles: Tiles, kind: str, interpret: bool, x2, qvals, scales):
    m_pad, k_pad = x2.shape
    n_pad = qvals.shape[-1]
    x2 = x2.astype(jnp.bfloat16)
    kernel = functools.partial(_kernel, kind=kind, steps=tiles.steps,
                               half=k_pad // 2)
    parts = pl.pallas_call(
        kernel,
        grid=tiles.grid(m_pad, n_pad),
        in_specs=[
            pl.BlockSpec((tiles.bm, k_pad), lambda i, j, s: (i, 0)),
            pl.BlockSpec((qvals.shape[0], tiles.bn), lambda i, j, s: (0, j)),
            pl.BlockSpec((scales.shape[0], tiles.bn), lambda i, j, s: (0, j)),
        ],
        out_specs=pl.BlockSpec((None, tiles.bm, tiles.bn),
                               lambda i, j, s: (s, i, j)),
        out_shape=jax.ShapeDtypeStruct((tiles.splits, m_pad, n_pad),
                                       jnp.float32),
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=3),
        backend="triton",
        interpret=interpret,
        name=f"qmatmul_{kind}",
    )(x2, qvals, scales)
    return parts[0] if tiles.splits == 1 else parts.sum(axis=0)


def dequant_bf16(pw: PackedWeight) -> tuple[jax.Array, ...]:
    """Dequantized [K_pad, N_pad] weight (Q8_0) or its two K halves (Q4_0)
    in bf16, as plain jnp for XLA to fuse into the consuming dot."""
    s = jnp.repeat(pw.scales.astype(jnp.float32), QK, axis=0)
    if pw.kind == "q8_0":
        return ((pw.qvals.astype(jnp.float32) * s).astype(jnp.bfloat16),)
    b = pw.qvals.astype(jnp.int32)
    h = b.shape[0]
    lo = ((b & 15) - 8).astype(jnp.float32) * s[:h]
    hi = (((b >> 4) & 15) - 8).astype(jnp.float32) * s[h:]
    return lo.astype(jnp.bfloat16), hi.astype(jnp.bfloat16)


def qmatmul_xla(x2: jax.Array, pw: PackedWeight) -> jax.Array:
    """x2 [M, K_pad] @ dequant(W) -> f32 [M, N_pad] with bf16 operands and
    f32 accumulation, left to XLA (no hand-written kernel)."""
    xb = x2.astype(jnp.bfloat16)
    ws = dequant_bf16(pw)
    if len(ws) == 1:
        return jnp.dot(xb, ws[0], preferred_element_type=jnp.float32)
    h = ws[0].shape[0]
    return (jnp.dot(xb[:, :h], ws[0], preferred_element_type=jnp.float32)
            + jnp.dot(xb[:, h:], ws[1], preferred_element_type=jnp.float32))


@functools.partial(jax.custom_vjp, nondiff_argnums=(0, 1, 2))
def _qmm(tiles, kind, interpret, x2, qvals, scales):
    return _launch(tiles, kind, interpret, x2, qvals, scales)


def _qmm_fwd(tiles, kind, interpret, x2, qvals, scales):
    return _launch(tiles, kind, interpret, x2, qvals, scales), (qvals, scales)


def _qmm_bwd(tiles, kind, interpret, res, g):
    """dx = g @ dequant(W)^T in f32, left to XLA (training is off the hot
    path). The packed weights are frozen constants: zero cotangents."""
    qvals, scales = res
    from zgml.ops.refs import dequant_jnp
    w = dequant_jnp(qvals, scales, kind)
    dx = jnp.dot(g.astype(jnp.float32), w.T,
                 precision=jax.lax.Precision.HIGHEST)
    return (dx,
            np.zeros(qvals.shape, jax.dtypes.float0),
            jnp.zeros_like(scales))


_qmm.defvjp(_qmm_fwd, _qmm_bwd)


def qmatmul_kernel(x: jax.Array, pw: PackedWeight, *, interpret: bool,
                   out_dtype=jnp.float32) -> jax.Array:
    """x [..., K] @ dequant(W) -> [..., N] through the Triton kernel.

    Pads M to the row tile and K to the weight's padded K (zero columns of x
    meet zero-scale blocks), then slices the logical N back out."""
    lead = x.shape[:-1]
    k = x.shape[-1]
    x2 = x.reshape(-1, k)
    m = x2.shape[0]
    tiles = choose_tiles(pw.kind, m, pw.k_pad, pw.n_pad)
    m_pad = _round_up(m, tiles.bm)
    x2 = jnp.pad(x2.astype(jnp.float32),
                 ((0, m_pad - m), (0, pw.k_pad - k)))
    out = _qmm(tiles, pw.kind, interpret, x2, pw.qvals, pw.scales)
    return out[:m, :pw.n].reshape(*lead, pw.n).astype(out_dtype)
