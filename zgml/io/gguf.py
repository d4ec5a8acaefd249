"""GGUF v2/v3 parser and writer (mmap + zero-copy numpy views).

Format parity target: src/gguf.zig (header/KV/tensor-info/aligned data section,
13 metadata value types incl. arrays, 30 GGML tensor type tags with block/type-size
tables, gguf.zig:30-464). The writer exists so tests and benchmarks can build
synthetic models without network access (the reference builds GGUF buffers
byte-by-byte in tests, gguf.zig:507-660).

Layout:
  [magic 'GGUF'][version u32][n_tensors u64][n_kv u64]
  n_kv * [string key][u32 vtype][value]
  n_tensors * [string name][u32 n_dims][u64 dims...][u32 ggml_type][u64 offset]
  padding to `general.alignment` (default 32)
  tensor data (each tensor offset is relative to data section start, aligned)

GGUF dims are stored innermost-first: ne[0] = contiguous axis (K for a weight
matrix whose rows are output features). As numpy, tensor ne=[K, N] == shape (N, K).
"""
from __future__ import annotations

import enum
import mmap
import os
import struct
from typing import Any, BinaryIO

import numpy as np


class GGMLType(enum.IntEnum):
    F32 = 0
    F16 = 1
    Q4_0 = 2
    Q4_1 = 3
    Q5_0 = 6
    Q5_1 = 7
    Q8_0 = 8
    Q8_1 = 9
    Q2_K = 10
    Q3_K = 11
    Q4_K = 12
    Q5_K = 13
    Q6_K = 14
    Q8_K = 15
    IQ2_XXS = 16
    IQ2_XS = 17
    IQ3_XXS = 18
    IQ1_S = 19
    IQ4_NL = 20
    IQ3_S = 21
    IQ2_S = 22
    IQ4_XS = 23
    I8 = 24
    I16 = 25
    I32 = 26
    I64 = 27
    F64 = 28
    IQ1_M = 29


# (block_size, type_size) per GGML type (ref: src/gguf.zig:65-110)
_TYPE_TRAITS: dict[int, tuple[int, int]] = {
    GGMLType.F32: (1, 4), GGMLType.F16: (1, 2), GGMLType.F64: (1, 8),
    GGMLType.I8: (1, 1), GGMLType.I16: (1, 2), GGMLType.I32: (1, 4), GGMLType.I64: (1, 8),
    GGMLType.Q4_0: (32, 18), GGMLType.Q4_1: (32, 20),
    GGMLType.Q5_0: (32, 22), GGMLType.Q5_1: (32, 24),
    GGMLType.Q8_0: (32, 34), GGMLType.Q8_1: (32, 40),
    GGMLType.Q2_K: (256, 84), GGMLType.Q3_K: (256, 110), GGMLType.Q4_K: (256, 144),
    GGMLType.Q5_K: (256, 176), GGMLType.Q6_K: (256, 210), GGMLType.Q8_K: (256, 292),
    GGMLType.IQ2_XXS: (256, 66), GGMLType.IQ2_XS: (256, 74), GGMLType.IQ2_S: (256, 82),
    GGMLType.IQ3_XXS: (256, 98), GGMLType.IQ3_S: (256, 110),
    GGMLType.IQ1_S: (256, 50), GGMLType.IQ1_M: (256, 56),
    GGMLType.IQ4_NL: (32, 18), GGMLType.IQ4_XS: (256, 136),
}


def block_size(t: int) -> int:
    return _TYPE_TRAITS[t][0]


def type_size(t: int) -> int:
    return _TYPE_TRAITS[t][1]


def tensor_nbytes(t: int, n_elems: int) -> int:
    bs, ts = _TYPE_TRAITS[t]
    if n_elems % bs != 0:
        raise ValueError(f"{n_elems} elements not divisible by block size {bs}")
    return (n_elems // bs) * ts


# GGUF metadata value types
class GGUFValueType(enum.IntEnum):
    UINT8 = 0
    INT8 = 1
    UINT16 = 2
    INT16 = 3
    UINT32 = 4
    INT32 = 5
    FLOAT32 = 6
    BOOL = 7
    STRING = 8
    ARRAY = 9
    UINT64 = 10
    INT64 = 11
    FLOAT64 = 12


_SCALAR_FMT = {
    GGUFValueType.UINT8: "<B", GGUFValueType.INT8: "<b",
    GGUFValueType.UINT16: "<H", GGUFValueType.INT16: "<h",
    GGUFValueType.UINT32: "<I", GGUFValueType.INT32: "<i",
    GGUFValueType.FLOAT32: "<f", GGUFValueType.UINT64: "<Q",
    GGUFValueType.INT64: "<q", GGUFValueType.FLOAT64: "<d",
}

MAGIC = 0x46554747  # 'GGUF' little-endian (ref: src/gguf.zig:191)


class TensorInfo:
    __slots__ = ("name", "dims", "ggml_type", "offset")

    def __init__(self, name: str, dims: tuple[int, ...], ggml_type: int, offset: int):
        self.name = name
        self.dims = dims          # GGUF order: dims[0] is contiguous
        self.ggml_type = GGMLType(ggml_type)
        self.offset = offset

    @property
    def n_elems(self) -> int:
        n = 1
        for d in self.dims:
            n *= d
        return n

    @property
    def nbytes(self) -> int:
        return tensor_nbytes(self.ggml_type, self.n_elems)

    @property
    def np_shape(self) -> tuple[int, ...]:
        """numpy shape (outermost-first): reversed GGUF dims."""
        return tuple(reversed(self.dims))

    def __repr__(self):
        return f"TensorInfo({self.name!r}, dims={self.dims}, {self.ggml_type.name}, off={self.offset})"


class _Reader:
    def __init__(self, buf):
        self.buf = buf
        self.pos = 0

    def read(self, fmt: str):
        size = struct.calcsize(fmt)
        vals = struct.unpack_from(fmt, self.buf, self.pos)
        self.pos += size
        return vals[0] if len(vals) == 1 else vals

    def read_string(self) -> str:
        n = self.read("<Q")
        s = bytes(self.buf[self.pos:self.pos + n]).decode("utf-8", errors="replace")
        self.pos += n
        return s

    def read_value(self, vtype: int) -> Any:
        vtype = GGUFValueType(vtype)
        if vtype == GGUFValueType.STRING:
            return self.read_string()
        if vtype == GGUFValueType.BOOL:
            return bool(self.read("<B"))
        if vtype == GGUFValueType.ARRAY:
            elem_t = self.read("<I")
            n = self.read("<Q")
            return [self.read_value(elem_t) for _ in range(n)]
        return self.read(_SCALAR_FMT[vtype])


class GGUFFile:
    """Parsed GGUF file. Tensor payloads are zero-copy views into the mmap."""

    def __init__(self, path: str | os.PathLike):
        self.path = os.fspath(path)
        self._file: BinaryIO = open(self.path, "rb")
        self._mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        buf = memoryview(self._mm)
        r = _Reader(buf)
        if r.read("<I") != MAGIC:
            raise ValueError("bad GGUF magic")
        self.version = r.read("<I")
        if self.version not in (2, 3):
            raise ValueError(f"unsupported GGUF version {self.version}")
        n_tensors = r.read("<Q")
        n_kv = r.read("<Q")
        self.metadata: dict[str, Any] = {}
        for _ in range(n_kv):
            key = r.read_string()
            vtype = r.read("<I")
            self.metadata[key] = r.read_value(vtype)
        self.tensors: dict[str, TensorInfo] = {}
        for _ in range(n_tensors):
            name = r.read_string()
            n_dims = r.read("<I")
            dims = tuple(r.read("<Q") for _ in range(n_dims))
            ttype = r.read("<I")
            offset = r.read("<Q")
            self.tensors[name] = TensorInfo(name, dims, ttype, offset)
        align = int(self.metadata.get("general.alignment", 32))
        self.alignment = align
        self.data_start = (r.pos + align - 1) // align * align
        self._buf = buf

    # -- accessors ----------------------------------------------------------
    def tensor_raw(self, name: str) -> np.ndarray:
        """Raw bytes of a tensor as a uint8 view (no copy)."""
        info = self.tensors[name]
        start = self.data_start + info.offset
        return np.frombuffer(self._buf, dtype=np.uint8, count=info.nbytes, offset=start)

    def tensor_f32(self, name: str) -> np.ndarray:
        """Dequantize any supported tensor to f32 with its numpy shape."""
        from zgml.quant.blocks import (dequantize_q4_0, dequantize_q8_0,
                                           f16_bytes_to_f32)
        info = self.tensors[name]
        raw = self.tensor_raw(name)
        t = info.ggml_type
        if t == GGMLType.F32:
            out = raw.view(np.float32).copy()
        elif t == GGMLType.F16:
            out = f16_bytes_to_f32(raw, info.n_elems)
        elif t == GGMLType.Q8_0:
            out = dequantize_q8_0(raw, info.n_elems)
        elif t == GGMLType.Q4_0:
            out = dequantize_q4_0(raw, info.n_elems)
        else:
            raise NotImplementedError(f"dequant for {t.name}")
        return out.reshape(info.np_shape)

    def close(self):
        self._buf = None
        self._mm.close()
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _encode_string(s: str) -> bytes:
    b = s.encode("utf-8")
    return struct.pack("<Q", len(b)) + b


def _encode_value(v: Any) -> tuple[int, bytes]:
    """Infer a GGUF value type for a python value and encode it."""
    if isinstance(v, bool):
        return GGUFValueType.BOOL, struct.pack("<B", int(v))
    if isinstance(v, int):
        if 0 <= v < 2**32:
            return GGUFValueType.UINT32, struct.pack("<I", v)
        return GGUFValueType.INT64, struct.pack("<q", v)
    if isinstance(v, float):
        return GGUFValueType.FLOAT32, struct.pack("<f", v)
    if isinstance(v, str):
        return GGUFValueType.STRING, _encode_string(v)
    if isinstance(v, (list, tuple)):
        if not v:
            return GGUFValueType.ARRAY, struct.pack("<IQ", GGUFValueType.UINT32, 0)
        elem_t, _ = _encode_value(v[0])
        payload = b"".join(_encode_value(x)[1] for x in v)
        return GGUFValueType.ARRAY, struct.pack("<IQ", int(elem_t), len(v)) + payload
    raise TypeError(f"cannot encode {type(v)} as GGUF value")


class GGUFWriter:
    """Minimal GGUF v3 writer for synthetic test/bench models."""

    def __init__(self, alignment: int = 32):
        self.metadata: dict[str, Any] = {"general.alignment": alignment}
        self.alignment = alignment
        self._tensors: list[tuple[str, tuple[int, ...], int, bytes]] = []

    def add_metadata(self, key: str, value: Any):
        self.metadata[key] = value

    def add_tensor(self, name: str, array: np.ndarray, ggml_type: int = GGMLType.F32):
        """array is numpy-shaped (outermost-first); stored with GGUF dims reversed.

        For quantized types, pass the f32 array — it is encoded here.
        """
        from zgml.quant.blocks import quantize_q4_0, quantize_q8_0
        ggml_type = GGMLType(ggml_type)
        a = np.ascontiguousarray(array)
        dims = tuple(reversed(a.shape))
        if ggml_type == GGMLType.F32:
            payload = a.astype(np.float32).tobytes()
        elif ggml_type == GGMLType.F16:
            payload = a.astype(np.float16).tobytes()
        elif ggml_type == GGMLType.Q8_0:
            payload = quantize_q8_0(a.astype(np.float32)).tobytes()
        elif ggml_type == GGMLType.Q4_0:
            payload = quantize_q4_0(a.astype(np.float32)).tobytes()
        elif ggml_type == GGMLType.I32:
            payload = a.astype(np.int32).tobytes()
        else:
            raise NotImplementedError(ggml_type.name)
        self._tensors.append((name, dims, int(ggml_type), payload))

    def write(self, path: str | os.PathLike):
        align = self.alignment
        header = bytearray()
        header += struct.pack("<IIQQ", MAGIC, 3, len(self._tensors), len(self.metadata))
        for key, val in self.metadata.items():
            header += _encode_string(key)
            vtype, payload = _encode_value(val)
            header += struct.pack("<I", int(vtype)) + payload
        # tensor infos with aligned offsets
        offset = 0
        infos = bytearray()
        offsets = []
        for name, dims, ttype, payload in self._tensors:
            offset = (offset + align - 1) // align * align
            offsets.append(offset)
            infos += _encode_string(name)
            infos += struct.pack("<I", len(dims))
            for d in dims:
                infos += struct.pack("<Q", d)
            infos += struct.pack("<IQ", ttype, offset)
            offset += len(payload)
        with open(path, "wb") as f:
            f.write(header)
            f.write(infos)
            pos = len(header) + len(infos)
            data_start = (pos + align - 1) // align * align
            f.write(b"\x00" * (data_start - pos))
            for (name, dims, ttype, payload), off in zip(self._tensors, offsets):
                cur = f.tell() - data_start
                if cur < off:
                    f.write(b"\x00" * (off - cur))
                f.write(payload)
