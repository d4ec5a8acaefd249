"""The GPU tier as the CPU can check it: the Triton matmul kernel run by the
interpreter, the choice of implementation from the platform and the input,
the decode-attention wrapper, the compile-cache location and the peak table.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from zgml.ops import attention as attn
from zgml.ops import dispatch as ops
from zgml.ops import refs
from zgml.ops.qmatmul import choose_tiles, qmatmul_kernel, qmatmul_xla
from zgml.quant.repack import quantize_weight

# bf16 operands carry 2^-9 relative error per product, accumulated in f32
TOL = 2e-2


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


def _oracle(x, pw):
    return np.asarray(refs.qmatmul_ref(x, pw.qvals, pw.scales, pw.kind)
                      )[:, :pw.n]


@pytest.mark.parametrize("kind", ["q4_0", "q8_0"])
@pytest.mark.parametrize("m", [1, 8, 32, 128])
@pytest.mark.parametrize("n,k", [(300, 576), (200, 992)])
def test_qmatmul_triton_interpreted(kind, m, n, k):
    """The Triton kernel, interpreted, at non-aligned N and K."""
    rng = np.random.default_rng(m * 7 + n)
    w = rng.standard_normal((n, k), dtype=np.float32)
    x = jnp.asarray(rng.standard_normal((m, k)), jnp.float32)
    pw = jax.device_put(quantize_weight(w, kind))
    got = qmatmul_kernel(x, pw, interpret=True)
    assert got.shape == (m, n) and got.dtype == jnp.float32
    assert _rel(got, _oracle(x, pw)) <= TOL


@pytest.mark.parametrize("kind", ["q4_0", "q8_0"])
@pytest.mark.parametrize("m", [1, 64])
def test_qmatmul_xla_tier(kind, m, monkeypatch):
    """ZGML_KERNELS_DISABLE=qmatmul routes to the bf16 XLA form (the side a
    kernel is timed against), which matches the oracle within TOL."""
    from zgml.runtime.profile import global_profile
    monkeypatch.setenv("ZGML_KERNELS_DISABLE", "qmatmul")
    rng = np.random.default_rng(m)
    pw = jax.device_put(quantize_weight(
        rng.standard_normal((96, 160), dtype=np.float32), kind))
    x = jnp.asarray(rng.standard_normal((m, 160)), jnp.float32)
    global_profile.reset()
    got = ops.qmatmul(x, pw)
    assert global_profile.op_tiers[("qmatmul", "xla")] == 1
    assert _rel(got, _oracle(x, pw)) <= TOL
    padded = jnp.pad(x, ((0, 0), (0, pw.k_pad - 160)))
    assert _rel(qmatmul_xla(padded, pw)[:, :96], _oracle(x, pw)) <= TOL


@pytest.mark.parametrize("kind,m,k_pad,n_pad,want_bm", [
    ("q4_0", 1, 2048, 2560, 16),      # TinyLlama wqkv decode
    ("q8_0", 8, 5632, 2048, 16),      # w_down, decode bs 8
    ("q4_0", 32, 2048, 11264, 32),
    ("q4_0", 512, 2048, 2048, 64),    # prefill chunk
])
def test_choose_tiles(kind, m, k_pad, n_pad, want_bm):
    t = choose_tiles(kind, m, k_pad, n_pad)
    blocks = k_pad // 32 if kind == "q8_0" else k_pad // 64
    assert t.bm == want_bm
    assert n_pad % t.bn == 0 and t.bn & (t.bn - 1) == 0
    assert t.splits * t.steps == blocks and t.steps >= 4
    grid = t.grid(-(-m // t.bm) * t.bm, n_pad)
    # decode fills the card: enough programs, or as many splits as allowed
    assert grid[0] * grid[1] * grid[2] <= 264 or t.splits == 1
    if m <= 16:
        assert grid[0] * grid[1] * grid[2] >= 132 or t.steps == 4


@pytest.mark.parametrize("backend,want", [("gpu", False), ("cpu", True)])
def test_tier_follows_platform(backend, want, monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert ops.platform() == backend
    assert ops.interpret() is want


@pytest.mark.parametrize("backend", ["rocm", "METAL"])
def test_other_platform_raises(backend, monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    with pytest.raises(RuntimeError, match="NVIDIA GPU"):
        ops.platform()


def test_gpu_never_interprets(monkeypatch):
    """On the GPU the dispatch hands the kernels interpret=False and counts
    the compiled tier; nothing reads an environment switch for it."""
    from zgml.runtime.profile import global_profile
    seen = []
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(ops, "qmatmul_kernel",
                        lambda x, w, interpret, out_dtype: seen.append(
                            ("qmatmul", interpret)) or jnp.zeros(
                                x.shape[:-1] + (w.n,), out_dtype))
    monkeypatch.setattr(attn, "decode_attention_kernel",
                        lambda q, k, v, kv_len, interpret: seen.append(
                            ("decode", interpret)) or jnp.zeros(q.shape))
    monkeypatch.setenv("ZGML_INTERPRET", "1")     # ignored
    pw = jax.device_put(quantize_weight(np.ones((32, 64), np.float32),
                                        "q8_0"))
    global_profile.reset()
    ops.qmatmul(jnp.ones((1, 64)), pw)
    ops.decode_attention(jnp.ones((2, 4, 1, 16)), jnp.ones((2, 2, 64, 16)),
                         jnp.ones((2, 2, 64, 16)), jnp.asarray(5))
    assert seen == [("qmatmul", False), ("decode", False)]
    assert global_profile.op_tiers[("qmatmul", "triton")] == 1
    assert global_profile.op_tiers[("decode_attention", "triton")] == 1


@pytest.mark.parametrize("m,tier", [(1, "interpret"), (128, "interpret"),
                                    (129, "xla"), (512, "xla")])
def test_qmatmul_choice_by_rows(m, tier):
    """The kernel serves up to KERNEL_MAX_ROWS rows, XLA's GEMM above."""
    from zgml.runtime.profile import global_profile
    pw = jax.device_put(quantize_weight(
        np.random.default_rng(m).standard_normal((64, 64), dtype=np.float32),
        "q8_0"))
    global_profile.reset()
    jax.eval_shape(lambda x: ops.qmatmul(x, pw), jnp.ones((m, 64)))
    assert dict(global_profile.op_tiers) == {("qmatmul", tier): 1}


@pytest.mark.parametrize("b,tier", [(1, "interpret"), (2, "interpret"),
                                    (8, "interpret")])
def test_decode_choice_by_batch(b, tier):
    """The library decode kernel serves every batch size, so one sequence's
    numerics do not change with the batch it decodes in."""
    from zgml.runtime.profile import global_profile
    global_profile.reset()
    jax.eval_shape(lambda q, k: ops.decode_attention(q, k, k, jnp.asarray(3)),
                   jnp.ones((b, 4, 1, 16)), jnp.ones((b, 2, 64, 16)))
    assert dict(global_profile.op_tiers) == {("decode_attention", tier): 1}


@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2), (8, 1), (32, 4)])
def test_decode_wrapper_layout_rows_gqa(hq, hkv):
    """The library kernel over the [B, Hkv, S, d] cache with a different
    live length per row == the oracle masked per row."""
    rng = np.random.default_rng(hq * 10 + hkv)
    b, s, d = 3, 128, 32
    q = jnp.asarray(rng.standard_normal((b, hq, 1, d)), jnp.float32)
    k = jnp.asarray(rng.standard_normal((b, hkv, s, d)), jnp.bfloat16)
    v = jnp.asarray(rng.standard_normal((b, hkv, s, d)), jnp.bfloat16)
    lens = jnp.asarray([1, 77, 128], jnp.int32)
    got = attn.decode_attention_kernel(q, k, v, lens, interpret=True)
    assert got.shape == (b, hq, 1, d)
    mask = (jnp.arange(s)[None, :] < lens[:, None])[:, None, None, :]
    want = refs.gqa_attention_ref(q, k.astype(jnp.float32),
                                  v.astype(jnp.float32), mask)
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("s,want", [(2048, (16, 128)), (64, (4, 16)),
                                    (100, None)])
def test_decode_splits(s, want):
    assert attn.decode_splits(s) == want


def test_decode_falls_back_to_xla_off_pow2_head_dim():
    """head_dim 80 is no power of two: the kernel cannot take it, the XLA
    form serves the call, and the counter says so."""
    from zgml.runtime.profile import global_profile
    q = jnp.ones((1, 2, 1, 80))
    kv = jnp.ones((1, 2, 64, 80))
    assert not attn.decode_kernel_ok(q, kv)
    global_profile.reset()
    ops.decode_attention(q, kv, kv, jnp.asarray(3))
    assert global_profile.op_tiers[("decode_attention", "xla")] == 1


@pytest.mark.parametrize("kv_len,q_offset,d,want", [
    (128, 0, 64, True),                       # first chunk, static offset
    (256, 128, 64, False),                    # later chunk: mask not top-left
    (128, 0, 12, False),                      # head_dim not a multiple of 8
    ("traced", 0, 64, False),                 # length only known at run time
])
def test_cudnn_call_sites(kv_len, q_offset, d, want):
    if kv_len == "traced":
        kv_len = jnp.asarray(128)
    q = jnp.ones((1, 4, 128, d))
    k = jnp.ones((1, 2, 512, d))
    assert attn.cudnn_ok(q, k, kv_len, q_offset) is want


def test_compile_cache_dir_from_env(monkeypatch, tmp_path):
    from zgml import config
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert config.compile_cache_dir() == str(tmp_path)


def test_compile_cache_dir_default_is_checkout(monkeypatch):
    from zgml import config
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(config.__file__)))
    assert config.compile_cache_dir() == os.path.join(root, ".jax_cache")
    assert os.path.isfile(os.path.join(root, "zgml", "config.py"))


@pytest.mark.parametrize("env_dir", [False, True])
def test_compile_cache_setup(env_dir, monkeypatch, tmp_path):
    """Off the CPU the package points JAX at the checkout's .jax_cache, and
    leaves JAX_COMPILATION_CACHE_DIR to JAX when that is set."""
    import zgml
    from zgml import config
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_PLATFORMS", "")
    if env_dir:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        monkeypatch.setattr(config, "_CHECKOUT", str(tmp_path))
    try:
        zgml._enable_compilation_cache()
        want = before if env_dir else str(tmp_path / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == want
        assert env_dir or (tmp_path / ".jax_cache").is_dir()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_skipped_for_cpu_runs(monkeypatch, tmp_path):
    import zgml
    from zgml import config
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setattr(config, "_CHECKOUT", str(tmp_path))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    zgml._enable_compilation_cache()            # JAX_PLATFORMS=cpu here
    assert jax.config.jax_compilation_cache_dir == before
    assert not (tmp_path / ".jax_cache").exists()


@pytest.mark.parametrize("kind", ["NVIDIA H100 80GB HBM3", "NVIDIA H100 PCIe"])
def test_peak_table_known(kind):
    from zgml.runtime.roofline import peaks
    flops, bw = peaks(kind)
    assert 5e14 < flops < 1e15 and 1e12 < bw < 4e12


def test_peak_table_unknown_is_error():
    from zgml.runtime.roofline import peaks
    with pytest.raises(KeyError, match="no published peaks"):
        peaks("NVIDIA A100-SXM4-40GB")


@pytest.mark.gpu
def test_qmatmul_compiled_on_card(gpu_device):
    """The compiled kernel on the card against the oracle (skips on CPU)."""
    rng = np.random.default_rng(0)
    for kind in ("q4_0", "q8_0"):
        pw = jax.device_put(quantize_weight(
            rng.standard_normal((2048, 2048), dtype=np.float32), kind))
        for m in (1, 8, 128):
            x = jnp.asarray(rng.standard_normal((m, 2048)), jnp.float32)
            got = qmatmul_kernel(x, pw, interpret=False)
            with ops.force_ref():
                want = ops.qmatmul(x, pw)
            assert _rel(got, want) <= TOL, (kind, m)


@pytest.mark.gpu
def test_decode_kernel_compiled_on_card(gpu_device):
    rng = np.random.default_rng(1)
    q = jnp.asarray(rng.standard_normal((2, 32, 1, 64)), jnp.float32)
    k = jnp.asarray(rng.standard_normal((2, 4, 2048, 64)), jnp.bfloat16)
    v = jnp.asarray(rng.standard_normal((2, 4, 2048, 64)), jnp.bfloat16)
    lens = jnp.asarray([300, 2047], jnp.int32)
    got = attn.decode_attention_kernel(q, k, v, lens, interpret=False)
    with ops.force_ref():
        want = ops.decode_attention(q, k, v, lens)
    assert _rel(got, want) <= TOL
