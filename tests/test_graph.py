"""Graph IR tests: lowering correctness, fusion detection, autodiff.

Mirrors the reference's graph/autodiff test strategy (SURVEY.md §4.1-4.2):
per-op checks vs explicit formulas, analytic-gradient checks, fusion on/off
equivalence.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from zgml.graph import ComputeGraph, LazyTensor, Op, var, const
from zgml.graph.graph import topo_order


def test_build_and_shapes():
    x = var("x", (4, 8))
    w = var("w", (8, 16))
    y = x.matmul(w).relu().sum()
    assert y.shape == ()
    order = topo_order([y])
    assert order[-1] is y
    with pytest.raises(ValueError):
        x.matmul(var("bad", (4, 4)))  # inner-dim mismatch at build time
    with pytest.raises(ValueError):
        x.reshape(5, 5)


def test_forward_matches_numpy():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((4, 8)).astype(np.float32)
    b = rng.standard_normal((4, 8)).astype(np.float32)
    x, y = var("x", (4, 8)), var("y", (4, 8))
    z = (x * y + x).silu().sum(axis=1)
    g = ComputeGraph(z)
    out = np.asarray(g.run(x=a, y=b))
    t = a * b + a
    want = (t / (1 + np.exp(-t))).sum(1)
    np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-4)


def test_fusion_detects_chain():
    x = var("x", (8, 8))
    y = x.neg().exp().scale(2.0).relu()   # 4-op chain
    g = ComputeGraph(y)
    assert g.fusion is not None
    assert len(g.fusion.chains) == 1
    assert len(g.fusion.chains[0].nodes) == 4


def test_fusion_on_off_equivalence():
    """ref: fusion on/off equivalence (SURVEY.md §4.3)."""
    rng = np.random.default_rng(1)
    a = rng.standard_normal((16, 32)).astype(np.float32)
    b = rng.standard_normal((16, 32)).astype(np.float32)
    x, y = var("x", (16, 32)), var("y", (16, 32))
    z = (x.exp().mul(y).add(x).tanh()).sum()
    out_f = np.asarray(ComputeGraph(z, fuse=True).run(x=a, y=b))
    out_n = np.asarray(ComputeGraph(z, fuse=False).run(x=a, y=b))
    np.testing.assert_allclose(out_f, out_n, rtol=1e-4, atol=1e-4)


def test_multi_consumer_blocks_fusion():
    x = var("x", (4, 4))
    e = x.exp()
    y = e.mul(e.neg())   # e has two consumers -> not a simple chain head
    g = ComputeGraph(y)
    for c in (g.fusion.chains if g.fusion else []):
        assert e not in c.nodes[:-1]


def test_grad_simple():
    # d/dx sum(x^2 * 3) = 6x
    x = var("x", (5,))
    y = x.sqr().scale(3.0).sum()
    g = ComputeGraph(y)
    a = np.arange(5, dtype=np.float32)
    grads = g.grad(["x"])(x=a)
    np.testing.assert_allclose(np.asarray(grads["x"]), 6 * a, rtol=1e-5)


def test_grad_matmul_and_softmax():
    rng = np.random.default_rng(2)
    a = rng.standard_normal((3, 4)).astype(np.float32)
    w0 = rng.standard_normal((4, 2)).astype(np.float32)
    tgt = np.asarray([1, 0, 1], np.int32)
    x, w, t = var("x", (3, 4)), var("w", (4, 2)), var("t", (3,), np.int32)
    loss = x.matmul(w).cross_entropy(t)
    g = ComputeGraph(loss)
    val, grads = g.value_and_grad(["w"])(x=a, w=w0, t=tgt)
    # finite-difference check
    eps = 1e-3
    gw = np.asarray(grads["w"])
    fn = g.compile()
    for i in (0, 1):
        for j in (0, 1):
            wp = w0.copy(); wp[i, j] += eps
            wm = w0.copy(); wm[i, j] -= eps
            fd = (float(fn(a, wp, tgt)) - float(fn(a, wm, tgt))) / (2 * eps)
            assert abs(fd - gw[i, j]) < 1e-2, (i, j, fd, gw[i, j])


def test_attention_node_and_grad():
    """The reference panics on attention backward (backward.zig:393-404);
    here it must just work."""
    rng = np.random.default_rng(3)
    qv = rng.standard_normal((1, 4, 8)).astype(np.float32)
    kv = rng.standard_normal((1, 4, 8)).astype(np.float32)
    vv = rng.standard_normal((1, 4, 8)).astype(np.float32)
    q, k, v = var("q", (1, 4, 8)), var("k", (1, 4, 8)), var("v", (1, 4, 8))
    y = q.attention(k, v, causal=True).sum()
    g = ComputeGraph(y)
    grads = g.grad(["q", "k", "v"])(q=qv, k=kv, v=vv)
    for key in ("q", "k", "v"):
        assert np.isfinite(np.asarray(grads[key])).all()


def test_composites_match_jnp():
    rng = np.random.default_rng(4)
    a = rng.standard_normal((6, 10)).astype(np.float32)
    gm = rng.standard_normal(10).astype(np.float32)
    x, gvar = var("x", (6, 10)), var("g", (10,))
    out = ComputeGraph(x.rms_norm(gvar, 1e-5)).run(x=a, g=gm)
    from zgml.ops import refs
    want = refs.rmsnorm_ref(jnp.asarray(a), jnp.asarray(gm), 1e-5)
    np.testing.assert_allclose(np.asarray(out), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_report_and_dot():
    x = var("x", (4, 4))
    y = x.exp().relu().sum()
    g = ComputeGraph(y)
    rep = g.report()
    assert "nodes" in rep and "chains" in rep
    dot = g.to_dot()
    assert dot.startswith("digraph") and "exp" in dot


def test_conv_and_pool_forward_and_grad():
    """Graph-tier conv2d/maxpool (ref fusion patterns, fusion.zig:261-335):
    forward matches XLA conv; grads flow (conv backward came free)."""
    rng = np.random.default_rng(5)
    xv = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    wv = rng.standard_normal((3, 3, 3, 4)).astype(np.float32)
    x, w = var("x", (2, 8, 8, 3)), var("w", (3, 3, 3, 4))
    y = x.conv2d(w).relu().max_pool2d(2).sum()
    g = ComputeGraph(y)
    val = float(g.run(x=xv, w=wv))
    from zgml.nn.layers import conv2d, max_pool2d
    want = float(jnp.sum(max_pool2d(jax.nn.relu(conv2d(
        jnp.asarray(xv), jnp.asarray(wv))), 2)))
    assert abs(val - want) < 1e-2 * abs(want)
    grads = g.grad(["w"])(x=xv, w=wv)
    assert grads["w"].shape == (3, 3, 3, 4)
    assert np.isfinite(np.asarray(grads["w"])).all()
    # build-time shape check
    with pytest.raises(ValueError):
        x.conv2d(var("bad", (3, 3, 5, 4)))


def test_rope_slice_assign_scatter_add():
    """The three graph-tier cache ops: build-time checks + lowering vs oracles."""
    from zgml.ops import refs
    rng = np.random.default_rng(7)
    xh = rng.standard_normal((2, 8, 16)).astype(np.float32)   # [H, T, d]
    pos = np.arange(8)
    cos_np, sin_np = refs.rope_cos_sin(jnp.asarray(pos), 16)

    x = var("x", (2, 8, 16))
    cos, sin = var("cos", (8, 8)), var("sin", (8, 8))
    g = ComputeGraph(x.rope(cos, sin))
    got = np.asarray(g.run(x=xh, cos=np.asarray(cos_np), sin=np.asarray(sin_np)))
    want = np.asarray(refs.rope_apply_ref(jnp.asarray(xh), cos_np, sin_np))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        x.rope(var("c2", (8, 4)), sin)            # wrong cos shape

    # slice_assign
    dst = var("dst", (4, 6))
    src = var("src", (2, 3))
    g2 = ComputeGraph(dst.slice_assign(src, (1, 2)))
    d = np.zeros((4, 6), np.float32)
    s = np.ones((2, 3), np.float32)
    out = np.asarray(g2.run(dst=d, src=s))
    want2 = d.copy()
    want2[1:3, 2:5] = 1.0
    np.testing.assert_array_equal(out, want2)
    with pytest.raises(ValueError):
        dst.slice_assign(src, (3, 2))             # out of bounds at build time

    # scatter_add_rows
    tbl = var("tbl", (5, 4))
    upd = var("upd", (3, 4))
    idx = var("idx", (3,))
    g3 = ComputeGraph(tbl.scatter_add_rows(upd, idx))
    t0 = np.zeros((5, 4), np.float32)
    u = rng.standard_normal((3, 4)).astype(np.float32)
    ii = np.array([1, 3, 1], np.int32)
    out3 = np.asarray(g3.run(tbl=t0, upd=u, idx=ii))
    want3 = t0.copy()
    np.add.at(want3, ii, u)
    np.testing.assert_allclose(out3, want3, rtol=1e-6, atol=1e-6)


def test_graph_kv_cache_decode():
    """A KV-cache decode step is expressible in the graph tier: write the new
    K/V at a static position, attend q over the live prefix, == jnp oracle."""
    from zgml.ops import refs
    h, s, d, pos = 2, 8, 16, 5
    rng = np.random.default_rng(8)
    ck = rng.standard_normal((h, s, d)).astype(np.float32)
    cv = rng.standard_normal((h, s, d)).astype(np.float32)
    qn = rng.standard_normal((h, 1, d)).astype(np.float32)
    kn = rng.standard_normal((h, 1, d)).astype(np.float32)
    vn = rng.standard_normal((h, 1, d)).astype(np.float32)

    cache_k, cache_v = var("ck", (h, s, d)), var("cv", (h, s, d))
    q = var("q", (h, 1, d))
    k_new, v_new = var("kn", (h, 1, d)), var("vn", (h, 1, d))
    ck2 = cache_k.slice_assign(k_new, (0, pos, 0))
    cv2 = cache_v.slice_assign(v_new, (0, pos, 0))
    live_k = ck2.slice((0, 0, 0), (h, pos + 1, d))
    live_v = cv2.slice((0, 0, 0), (h, pos + 1, d))
    out = q.attention(live_k, live_v, causal=False)
    g = ComputeGraph(out)
    got = np.asarray(g.run(ck=ck, cv=cv, q=qn, kn=kn, vn=vn))

    ck_ref = ck.copy(); ck_ref[:, pos] = kn[:, 0]
    cv_ref = cv.copy(); cv_ref[:, pos] = vn[:, 0]
    want = np.asarray(refs.attention_ref(
        jnp.asarray(qn), jnp.asarray(ck_ref[:, :pos + 1]),
        jnp.asarray(cv_ref[:, :pos + 1]), None))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_every_op_has_a_lowering_rule():
    """No enum member without a lowering rule."""
    import inspect
    from zgml.graph import lower
    src = inspect.getsource(lower)
    for op in Op:
        assert (f"Op.{op.name}" in src) or op in (Op.VAR, Op.CONST) \
            or op.name in ("SCALE", "ADD_SCALAR"), f"no lowering for {op}"


def test_env_reads_centralized():
    """Every ZGML_* toggle is read in zgml/config.py and nowhere else
    (the reference centralizes capabilities the same way, backend.zig:14-111)."""
    import pathlib
    import re
    import zgml
    root = pathlib.Path(zgml.__file__).parent
    offenders = []
    for p in root.rglob("*.py"):
        rel = p.relative_to(root).as_posix()
        if rel == "config.py":
            continue
        for i, line in enumerate(p.read_text().splitlines(), 1):
            if re.search(r"os\.environ(\.get)?\s*[\[(]\s*['\"]ZGML", line):
                offenders.append(f"{rel}:{i}: {line.strip()}")
    assert not offenders, "\n".join(offenders)
