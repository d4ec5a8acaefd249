"""GGUF writer/parser roundtrip with synthetic in-memory files (the reference's
format-test strategy: byte-built GGUF buffers, src/gguf.zig:507-660)."""
import numpy as np
import pytest

from zgml.io import GGUFFile, GGUFWriter, GGMLType


@pytest.fixture
def tmp_gguf(tmp_path):
    return tmp_path / "model.gguf"


def test_roundtrip_metadata_and_f32(tmp_gguf):
    w = GGUFWriter()
    w.add_metadata("general.architecture", "llama")
    w.add_metadata("llama.embedding_length", 64)
    w.add_metadata("llama.rope.freq_base", 10000.0)
    w.add_metadata("flag", True)
    w.add_metadata("tokens", ["a", "b", "c"])
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    w.add_tensor("tok_embd.weight", x, GGMLType.F32)
    w.write(tmp_gguf)

    with GGUFFile(tmp_gguf) as gf:
        assert gf.version == 3
        assert gf.metadata["general.architecture"] == "llama"
        assert gf.metadata["llama.embedding_length"] == 64
        assert abs(gf.metadata["llama.rope.freq_base"] - 10000.0) < 1e-6
        assert gf.metadata["flag"] is True
        assert gf.metadata["tokens"] == ["a", "b", "c"]
        info = gf.tensors["tok_embd.weight"]
        assert info.dims == (4, 3)  # GGUF innermost-first
        assert info.np_shape == (3, 4)
        np.testing.assert_array_equal(gf.tensor_f32("tok_embd.weight"), x)


@pytest.mark.parametrize("ttype", [GGMLType.F16, GGMLType.Q8_0, GGMLType.Q4_0])
def test_roundtrip_quantized(tmp_gguf, ttype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 64)).astype(np.float32)
    w = GGUFWriter()
    w.add_tensor("w", x, ttype)
    w.write(tmp_gguf)
    with GGUFFile(tmp_gguf) as gf:
        y = gf.tensor_f32("w")
        assert y.shape == (8, 64)
        tol = {GGMLType.F16: 1e-3, GGMLType.Q8_0: 0.02, GGMLType.Q4_0: 0.4}[ttype]
        assert np.abs(x - y).max() < tol


def test_alignment_of_data_section(tmp_gguf):
    w = GGUFWriter(alignment=64)
    w.add_tensor("a", np.ones((2, 32), np.float32), GGMLType.F32)
    w.add_tensor("b", np.ones((2, 32), np.float32), GGMLType.Q8_0)
    w.write(tmp_gguf)
    with GGUFFile(tmp_gguf) as gf:
        assert gf.data_start % 64 == 0
        assert gf.tensors["b"].offset % 64 == 0
        assert gf.tensors["b"].nbytes == (2 * 32 // 32) * 34


def test_multiple_tensors_nonoverlapping(tmp_gguf):
    w = GGUFWriter()
    a = np.full((4, 32), 1.0, np.float32)
    b = np.full((4, 32), 2.0, np.float32)
    w.add_tensor("a", a)
    w.add_tensor("b", b)
    w.write(tmp_gguf)
    with GGUFFile(tmp_gguf) as gf:
        np.testing.assert_array_equal(gf.tensor_f32("a"), a)
        np.testing.assert_array_equal(gf.tensor_f32("b"), b)
