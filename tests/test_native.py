"""Native C++ codec tier: bit-exact equality with the numpy implementations."""
import os

import numpy as np
import pytest

from zgml import native


pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native lib unavailable (no g++?)")


def _numpy_only():
    """Context: force numpy paths regardless of the native lib."""
    import contextlib

    @contextlib.contextmanager
    def ctx():
        old = os.environ.get("ZGML_NATIVE")
        os.environ["ZGML_NATIVE"] = "0"
        try:
            yield
        finally:
            if old is None:
                os.environ.pop("ZGML_NATIVE", None)
            else:
                os.environ["ZGML_NATIVE"] = old
    return ctx()


@pytest.mark.parametrize("kind", ["q8_0", "q4_0"])
def test_quantize_bitexact(kind):
    from zgml.quant import blocks
    rng = np.random.default_rng(0)
    x = rng.standard_normal(4096).astype(np.float32)
    fn = blocks.quantize_q8_0 if kind == "q8_0" else blocks.quantize_q4_0
    got = fn(x)
    with _numpy_only():
        want = fn(x)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["q8_0", "q4_0"])
def test_repack_bitexact(kind):
    from zgml.quant import blocks, repack
    rng = np.random.default_rng(1)
    n, k = 96, 576
    w = rng.standard_normal((n, k)).astype(np.float32)
    raw = (blocks.quantize_q8_0 if kind == "q8_0" else blocks.quantize_q4_0)(w)
    fn = repack.repack_q8_0 if kind == "q8_0" else repack.repack_q4_0
    got = fn(raw, n, k)
    with _numpy_only():
        want = fn(raw, n, k)
    np.testing.assert_array_equal(np.asarray(got.qvals), np.asarray(want.qvals))
    np.testing.assert_array_equal(np.asarray(got.scales),
                                  np.asarray(want.scales))
    assert (got.n_pad, got.k_pad) == (want.n_pad, want.k_pad)


def test_native_dequant_matches_numpy():
    from zgml.quant import blocks
    lib = native.get_lib()
    rng = np.random.default_rng(2)
    x = rng.standard_normal(2048).astype(np.float32)
    for kind, qfn, dfn, cname in [
            ("q8_0", blocks.quantize_q8_0, blocks.dequantize_q8_0, "dequant_q8_0"),
            ("q4_0", blocks.quantize_q4_0, blocks.dequantize_q4_0, "dequant_q4_0")]:
        raw = qfn(x)
        want = dfn(raw, x.size)
        out = np.empty(x.size, np.float32)
        getattr(lib, cname)(np.ascontiguousarray(raw), x.size // 32, out)
        np.testing.assert_allclose(out, want, rtol=0, atol=0)
