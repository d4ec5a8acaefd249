"""Primitive-op IR for the lazy graph tier (ref: src/op.zig:11-119).

The reference's 33-variant enum is the entire graph IR; this mirrors its
capability surface re-grouped for lowering to jnp: structural ops become jnp
view ops, elementwise ops become fusion-chain candidates, composites lower to
XLA-fused jnp.
"""
from __future__ import annotations

import enum


class Op(enum.Enum):
    # leaf
    VAR = "var"              # placeholder input / parameter
    CONST = "const"          # embedded constant
    # structural (ref: view/reshape/transpose/permute/broadcast_to)
    RESHAPE = "reshape"
    TRANSPOSE = "transpose"
    PERMUTE = "permute"
    BROADCAST_TO = "broadcast_to"
    SLICE = "slice"
    # elementwise binary (fusible)
    ADD = "add"
    SUB = "sub"
    MUL = "mul"
    DIV = "div"
    MAX2 = "max2"
    # elementwise unary (fusible; ref: 10 unary ops)
    NEG = "neg"
    RECIP = "recip"
    SQR = "sqr"
    SQRT = "sqrt"
    EXP = "exp"
    LOG = "log"
    ABS = "abs"
    TANH = "tanh"
    SIGMOID = "sigmoid"
    RELU = "relu"
    SILU = "silu"
    GELU = "gelu"
    SCALE = "scale"          # * static scalar (payload)
    ADD_SCALAR = "add_scalar"
    # reductions
    SUM = "sum"              # payload: axes, keepdims
    MAX = "max"
    MEAN = "mean"
    # indexing (ref: gather_rows/pick_rows/scatter_add_rows)
    GATHER_ROWS = "gather_rows"
    PICK_ROWS = "pick_rows"  # out[i] = x[i, idx[i]]
    SCATTER_ADD_ROWS = "scatter_add_rows"  # out[idx[i]] += src[i]
    # in-place-style updates (ref: sliceAssign/sliceAssignRows,
    # api.zig:605-696 — the KV-cache write primitive); functional here:
    # returns x with src written at static offsets
    SLICE_ASSIGN = "slice_assign"          # payload: starts
    # composites (single nodes in the reference: softmax/rmsnorm/attention)
    SOFTMAX = "softmax"
    LOG_SOFTMAX = "log_softmax"
    RMSNORM = "rmsnorm"      # payload: eps
    LAYERNORM = "layernorm"  # payload: eps
    ATTENTION = "attention"  # payload: scale, causal
    ROPE = "rope"
    # convolution / pooling (ref: conv2d as as_strided+GEMM decomposition,
    # api.zig:707-732; here a first-class op lowered to XLA conv)
    CONV2D = "conv2d"        # payload: (stride, padding)
    MAXPOOL2D = "maxpool2d"  # payload: (window, stride)
    # matmul (payload: trans_a, trans_b)
    MATMUL = "matmul"
    # losses (pattern-fused in the reference, fusion.zig:171-203)
    CROSS_ENTROPY = "cross_entropy"

    @property
    def is_unary_elementwise(self) -> bool:
        return self in _UNARY

    @property
    def is_binary_elementwise(self) -> bool:
        return self in _BINARY

    @property
    def is_fusible(self) -> bool:
        """Candidate for the elementwise-chain fusion pass
        (ref: Op.isFusible, src/op.zig)."""
        return self in _UNARY or self in _BINARY


_UNARY = {Op.NEG, Op.RECIP, Op.SQR, Op.SQRT, Op.EXP, Op.LOG, Op.ABS, Op.TANH,
          Op.SIGMOID, Op.RELU, Op.SILU, Op.GELU, Op.SCALE, Op.ADD_SCALAR}
_BINARY = {Op.ADD, Op.SUB, Op.MUL, Op.DIV, Op.MAX2}
