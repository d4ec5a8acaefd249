"""Gradient conformance: prefill attention and the quantized matmul's custom
VJP vs jax.grad of the jnp oracle (kernels interpreted on CPU).

The reference cannot train attention at all (its backward panics,
src/tensor/backward.zig:393-404); here attention differentiates as plain
XLA and the matmul kernel carries a dequant-transpose backward, so training
runs the same dispatch as inference.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from zgml.ops import dispatch as ops
from zgml.ops import refs


def flash_attention_pallas(q, k, v, kv_len=None, q_offset=0):
    return ops.flash_attention(q, k, v, kv_len=kv_len, q_offset=q_offset)


def _grads(fn, *args):
    return jax.grad(lambda *a: jnp.sum(jnp.sin(fn(*a))), argnums=(0, 1, 2))(*args)


@pytest.mark.parametrize("b,hq,hkv,tq,s,kv_len,q_off", [
    (1, 2, 2, 128, 128, 128, 0),      # MHA, full causal square
    (2, 4, 2, 128, 256, 200, 72),     # GQA n_rep=2, live prefix < S, offset
    (1, 4, 1, 64, 256, 96, 32),       # GQA n_rep=4, odd Tq (pad path)
])
def test_flash_vjp_matches_oracle(b, hq, hkv, tq, s, kv_len, q_off):
    d = 64
    n_rep = hq // hkv
    rng = np.random.default_rng(hash((b, hq, tq, s)) % 2**32)
    q = jnp.asarray(rng.standard_normal((b, hq, tq, d)), jnp.float32)
    k = jnp.asarray(rng.standard_normal((b, hkv, s, d)), jnp.float32)
    v = jnp.asarray(rng.standard_normal((b, hkv, s, d)), jnp.float32)

    ki = np.arange(s)[None, :]
    qi = q_off + np.arange(tq)[:, None]
    mask = jnp.asarray((ki < kv_len) & (ki <= qi))

    def ref_fn(q, k, v):
        return refs.gqa_attention_ref(q, k, v, mask[None, None])

    def pallas_fn(q, k, v):
        return flash_attention_pallas(q, k, v, kv_len=kv_len, q_offset=q_off)

    got = _grads(pallas_fn, q, k, v)
    want = _grads(ref_fn, q, k, v)
    for name, a, bb in zip("dq dk dv".split(), got, want):
        a, bb = np.asarray(a), np.asarray(bb)
        scale = np.abs(bb).max() + 1e-9
        # f32 operands here (the inputs are f32), so the residue is
        # accumulation order only
        np.testing.assert_allclose(a / scale, bb / scale, atol=8e-3,
                                   err_msg=name)


@pytest.mark.parametrize("kind,k,n,m", [
    ("q8_0", 512, 384, 16),
    ("q4_0", 512, 384, 16),
    ("q4_0", 768, 256, 40),   # odd m (pad path), k not a multiple of 512
])
def test_qmatmul_vjp_matches_dequant(kind, k, n, m):
    """dx through the kernel's dequant-transpose backward == g @ dequant(W).

    The packed weight leaves are frozen (zero cotangent) — quantized weights
    are inference-side constants in the reference too (src/quant.zig:200-630
    has no backward for quantized mats)."""
    from zgml.quant.repack import quantize_weight, dequant_packed

    def qmatmul_pallas(x, pw, out_dtype):
        return ops.qmatmul(x, pw, out_dtype=out_dtype)

    rng = np.random.default_rng(hash((kind, k, n, m)) % 2**32)
    w = rng.standard_normal((n, k)).astype(np.float32)
    pw = jax.device_put(quantize_weight(w, kind))
    wref = jnp.asarray(dequant_packed(pw))
    x = jnp.asarray(rng.standard_normal((m, k)), jnp.float32)
    g = jnp.asarray(rng.standard_normal((m, n)), jnp.float32)

    dx = jax.grad(
        lambda x: jnp.sum(qmatmul_pallas(x, pw, out_dtype=jnp.float32) * g))(x)
    dx_ref = g @ wref
    scale = float(jnp.max(jnp.abs(dx_ref))) + 1e-9
    np.testing.assert_allclose(np.asarray(dx) / scale,
                               np.asarray(dx_ref) / scale, atol=1e-5)


def test_flash_vjp_value_matches_primal():
    """The forward under jax.vjp must return the same output as the plain
    call."""
    b, hq, hkv, tq, s, d = 1, 4, 2, 128, 256, 64
    kv_len, q_off = 192, 64
    rng = np.random.default_rng(0)
    q = jnp.asarray(rng.standard_normal((b, hq, tq, d)), jnp.float32)
    k = jnp.asarray(rng.standard_normal((b, hkv, s, d)), jnp.float32)
    v = jnp.asarray(rng.standard_normal((b, hkv, s, d)), jnp.float32)

    primal = flash_attention_pallas(q, k, v, kv_len=kv_len, q_offset=q_off)
    via_vjp, _ = jax.vjp(
        lambda q, k, v: flash_attention_pallas(q, k, v, kv_len=kv_len,
                                               q_offset=q_off), q, k, v)
    np.testing.assert_allclose(np.asarray(via_vjp), np.asarray(primal),
                               rtol=1e-5, atol=1e-5)
