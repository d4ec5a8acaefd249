"""LazyTensor: graph-building tensor nodes with a fluent op API.

The analog of the reference's Tensor struct + lazy op ctors
(src/tensor.zig:29-131, src/tensor/api.zig:19-768): calling an op method appends
a node; nothing computes until the graph is lowered and jitted
(zgml.graph.graph.ComputeGraph). Shapes are inferred eagerly at build time —
the analog of the reference's comptime shape checking (src/shaped.zig):
shape errors surface at graph-build time, before any compile.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any

import numpy as np

from zgml.graph.op import Op

_ids = itertools.count()


def _broadcast_shapes(a: tuple, b: tuple) -> tuple:
    """numpy-style broadcast (ref: binaryOp shape infer, api.zig:100-121)."""
    out = []
    for x, y in itertools.zip_longest(reversed(a), reversed(b), fillvalue=1):
        if x == y or y == 1:
            out.append(x)
        elif x == 1:
            out.append(y)
        else:
            raise ValueError(f"cannot broadcast {a} with {b}")
    return tuple(reversed(out))


@dataclasses.dataclass(eq=False)
class LazyTensor:
    op: Op
    shape: tuple
    srcs: tuple = ()
    payload: Any = None          # per-op static data (axes, eps, scalar, name)
    name: str | None = None
    dtype: Any = np.float32

    def __post_init__(self):
        self.id = next(_ids)

    # -- elementwise --------------------------------------------------------
    def _binary(self, other, op: Op) -> "LazyTensor":
        other = _as_tensor(other, like=self)
        return LazyTensor(op, _broadcast_shapes(self.shape, other.shape),
                          (self, other))

    def _unary(self, op: Op, payload=None) -> "LazyTensor":
        return LazyTensor(op, self.shape, (self,), payload)

    def add(self, o):  return self._binary(o, Op.ADD)      # noqa: E704
    def sub(self, o):  return self._binary(o, Op.SUB)      # noqa: E704
    def mul(self, o):  return self._binary(o, Op.MUL)      # noqa: E704
    def div(self, o):  return self._binary(o, Op.DIV)      # noqa: E704
    def maximum(self, o): return self._binary(o, Op.MAX2)  # noqa: E704
    __add__ = add
    __sub__ = sub
    __mul__ = mul
    __truediv__ = div

    def neg(self):   return self._unary(Op.NEG)        # noqa: E704
    def recip(self): return self._unary(Op.RECIP)      # noqa: E704
    def sqr(self):   return self._unary(Op.SQR)        # noqa: E704
    def sqrt(self):  return self._unary(Op.SQRT)       # noqa: E704
    def exp(self):   return self._unary(Op.EXP)        # noqa: E704
    def log(self):   return self._unary(Op.LOG)        # noqa: E704
    def abs(self):   return self._unary(Op.ABS)        # noqa: E704
    def tanh(self):  return self._unary(Op.TANH)       # noqa: E704
    def sigmoid(self): return self._unary(Op.SIGMOID)  # noqa: E704
    def relu(self):  return self._unary(Op.RELU)       # noqa: E704
    def silu(self):  return self._unary(Op.SILU)       # noqa: E704
    def gelu(self):  return self._unary(Op.GELU)       # noqa: E704
    def scale(self, s: float): return self._unary(Op.SCALE, float(s))  # noqa: E704
    def add_scalar(self, s: float): return self._unary(Op.ADD_SCALAR, float(s))  # noqa: E704

    # -- structural ---------------------------------------------------------
    def reshape(self, *shape) -> "LazyTensor":
        shape = tuple(shape[0]) if len(shape) == 1 and isinstance(
            shape[0], (tuple, list)) else shape
        if int(np.prod(shape)) != int(np.prod(self.shape)):
            raise ValueError(f"reshape {self.shape} -> {shape}: size mismatch")
        return LazyTensor(Op.RESHAPE, tuple(shape), (self,))

    def transpose(self) -> "LazyTensor":
        if len(self.shape) < 2:
            raise ValueError("transpose needs >=2 dims")
        sh = self.shape[:-2] + (self.shape[-1], self.shape[-2])
        return LazyTensor(Op.TRANSPOSE, sh, (self,))

    def permute(self, perm) -> "LazyTensor":
        if sorted(perm) != list(range(len(self.shape))):
            raise ValueError(f"bad permutation {perm} for {self.shape}")
        sh = tuple(self.shape[p] for p in perm)
        return LazyTensor(Op.PERMUTE, sh, (self,), tuple(perm))

    def broadcast_to(self, shape) -> "LazyTensor":
        _broadcast_shapes(self.shape, tuple(shape))
        return LazyTensor(Op.BROADCAST_TO, tuple(shape), (self,))

    def slice(self, starts, sizes) -> "LazyTensor":
        return LazyTensor(Op.SLICE, tuple(sizes), (self,),
                          (tuple(starts), tuple(sizes)))

    # -- reductions ---------------------------------------------------------
    def _reduce(self, op: Op, axis, keepdims) -> "LazyTensor":
        axes = tuple(range(len(self.shape))) if axis is None else (
            (axis,) if isinstance(axis, int) else tuple(axis))
        axes = tuple(a % len(self.shape) for a in axes)
        if keepdims:
            sh = tuple(1 if i in axes else d for i, d in enumerate(self.shape))
        else:
            sh = tuple(d for i, d in enumerate(self.shape) if i not in axes)
        return LazyTensor(op, sh, (self,), (axes, keepdims))

    def sum(self, axis=None, keepdims=False):
        return self._reduce(Op.SUM, axis, keepdims)

    def max(self, axis=None, keepdims=False):
        return self._reduce(Op.MAX, axis, keepdims)

    def mean(self, axis=None, keepdims=False):
        return self._reduce(Op.MEAN, axis, keepdims)

    # -- indexing -----------------------------------------------------------
    def gather_rows(self, idx: "LazyTensor") -> "LazyTensor":
        """rows of a [V, D] table by integer ids (ref: gather_rows)."""
        return LazyTensor(Op.GATHER_ROWS, tuple(idx.shape) + (self.shape[-1],),
                          (self, idx))

    def pick_rows(self, idx: "LazyTensor") -> "LazyTensor":
        """out[i] = self[i, idx[i]] (ref: pick_rows; used by cross-entropy)."""
        return LazyTensor(Op.PICK_ROWS, tuple(self.shape[:-1]), (self, idx))

    # -- convolution / pooling ----------------------------------------------
    def conv2d(self, w: "LazyTensor", stride: int = 1,
               padding: str = "VALID") -> "LazyTensor":
        """self: [B, H, W, Cin]; w: [kh, kw, Cin, Cout]
        (ref: conv2d decomposition, api.zig:707-732)."""
        b, h, wd, cin = self.shape
        kh, kw, cin2, cout = w.shape
        if cin != cin2:
            raise ValueError(f"conv2d channel mismatch {cin} vs {cin2}")
        if padding == "VALID":
            oh = (h - kh) // stride + 1
            ow = (wd - kw) // stride + 1
        else:  # SAME
            oh = -(-h // stride)
            ow = -(-wd // stride)
        return LazyTensor(Op.CONV2D, (b, oh, ow, cout), (self, w),
                          (stride, padding))

    def max_pool2d(self, window: int = 2, stride: int | None = None
                   ) -> "LazyTensor":
        """ref: maxPool2d as 6-D strided max, api.zig:738-756."""
        stride = stride or window
        b, h, w, c = self.shape
        oh = (h - window) // stride + 1
        ow = (w - window) // stride + 1
        return LazyTensor(Op.MAXPOOL2D, (b, oh, ow, c), (self,),
                          (window, stride))

    # -- composites ---------------------------------------------------------
    def softmax(self, axis=-1):
        return LazyTensor(Op.SOFTMAX, self.shape, (self,), axis)

    def log_softmax(self, axis=-1):
        return LazyTensor(Op.LOG_SOFTMAX, self.shape, (self,), axis)

    def rms_norm(self, gamma: "LazyTensor", eps: float = 1e-5):
        return LazyTensor(Op.RMSNORM, self.shape, (self, gamma), eps)

    def layer_norm(self, gamma: "LazyTensor", beta: "LazyTensor",
                   eps: float = 1e-5):
        return LazyTensor(Op.LAYERNORM, self.shape, (self, gamma, beta), eps)

    def matmul(self, other: "LazyTensor", trans_a=False, trans_b=False):
        """ref: matMul with trans flags (api.zig:403-425)."""
        a_sh = self.shape[:-2] + ((self.shape[-1], self.shape[-2])
                                  if trans_a else self.shape[-2:])
        b_sh = other.shape[:-2] + ((other.shape[-1], other.shape[-2])
                                   if trans_b else other.shape[-2:])
        if a_sh[-1] != b_sh[-2]:
            raise ValueError(f"matmul {self.shape}@{other.shape} "
                             f"(ta={trans_a},tb={trans_b}): inner dim mismatch")
        sh = a_sh[:-1] + (b_sh[-1],)
        return LazyTensor(Op.MATMUL, sh, (self, other), (trans_a, trans_b))

    def attention(self, k: "LazyTensor", v: "LazyTensor", causal=True,
                  scale=None):
        return LazyTensor(Op.ATTENTION, self.shape, (self, k, v),
                          (causal, scale))

    def rope(self, cos: "LazyTensor", sin: "LazyTensor") -> "LazyTensor":
        """Rotary embedding, half-split pairing. self [..., T, d];
        cos/sin [T, d//2] (ref: ropeRotate, api.zig:620-636)."""
        d = self.shape[-1]
        if d % 2:
            raise ValueError(f"rope head_dim {d} must be even")
        want = (self.shape[-2], d // 2)
        if tuple(cos.shape) != want or tuple(sin.shape) != want:
            raise ValueError(
                f"rope cos/sin must be {want}, got {cos.shape}/{sin.shape}")
        return LazyTensor(Op.ROPE, self.shape, (self, cos, sin))

    def slice_assign(self, src: "LazyTensor", starts) -> "LazyTensor":
        """Return self with `src` written at static offsets `starts` — the
        functional KV-cache write (ref: sliceAssign/sliceAssignRows,
        api.zig:605-696; here one op covers both axes)."""
        starts = tuple(int(s) for s in starts)
        if len(starts) != len(self.shape) or len(src.shape) != len(self.shape):
            raise ValueError(f"slice_assign rank mismatch: {self.shape} vs "
                             f"{src.shape} at {starts}")
        for st, sz, full in zip(starts, src.shape, self.shape):
            if st < 0 or st + sz > full:
                raise ValueError(
                    f"slice_assign out of bounds: start {starts}, "
                    f"src {src.shape}, dst {self.shape}")
        return LazyTensor(Op.SLICE_ASSIGN, self.shape, (self, src), starts)

    def scatter_add_rows(self, src: "LazyTensor",
                         idx: "LazyTensor") -> "LazyTensor":
        """out = self with out[idx[i]] += src[i] (ref: scatter_add_rows —
        the embedding-backward primitive)."""
        if tuple(src.shape) != (idx.shape[0],) + tuple(self.shape[1:]):
            raise ValueError(
                f"scatter_add_rows: src {src.shape} must be "
                f"[{idx.shape[0]}, *{self.shape[1:]}]")
        return LazyTensor(Op.SCATTER_ADD_ROWS, self.shape, (self, src, idx))

    def cross_entropy(self, target_idx: "LazyTensor"):
        """mean(-log_softmax(x)[target]) (ref: loss.zig:16-43, fused pattern
        fusion.zig:171-203)."""
        return LazyTensor(Op.CROSS_ENTROPY, (), (self, target_idx))

    def __repr__(self):
        return (f"LazyTensor(#{self.id} {self.op.value} {self.shape}"
                + (f" '{self.name}'" if self.name else "") + ")")


def _as_tensor(x, like: LazyTensor) -> LazyTensor:
    if isinstance(x, LazyTensor):
        return x
    arr = np.asarray(x, dtype=like.dtype)
    return LazyTensor(Op.CONST, arr.shape, (), arr)


def var(name: str, shape, dtype=np.float32) -> LazyTensor:
    """Graph input / parameter placeholder."""
    return LazyTensor(Op.VAR, tuple(shape), (), name, name=name, dtype=dtype)


def const(value) -> LazyTensor:
    arr = np.asarray(value)
    return LazyTensor(Op.CONST, arr.shape, (), arr, dtype=arr.dtype)
