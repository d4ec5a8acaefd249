"""Lower a LazyTensor graph to a pure jnp function (jit/grad-able).

Per-op lowering rules: the analog of the reference's forward kernels
(src/tensor/forward.zig) — except here each rule emits jnp calls that XLA
fuses, fused chains included.
"""
from __future__ import annotations

from typing import Any, Callable

import jax
import jax.numpy as jnp

from zgml.graph.op import Op
from zgml.graph.tensor import LazyTensor
from zgml.ops import refs

# elementwise op -> jnp callable (also consumed by the chain fusion kernel)
UNARY_FNS: dict[Op, Callable] = {
    Op.NEG: lambda x: -x,
    Op.RECIP: lambda x: 1.0 / x,
    Op.SQR: lambda x: x * x,
    Op.SQRT: jnp.sqrt,
    Op.EXP: jnp.exp,
    Op.LOG: jnp.log,
    Op.ABS: jnp.abs,
    Op.TANH: jnp.tanh,
    Op.SIGMOID: jax.nn.sigmoid,
    Op.RELU: lambda x: jnp.maximum(x, 0),
    Op.SILU: lambda x: x * jax.nn.sigmoid(x),
    Op.GELU: jax.nn.gelu,
}
BINARY_FNS: dict[Op, Callable] = {
    Op.ADD: jnp.add,
    Op.SUB: jnp.subtract,
    Op.MUL: jnp.multiply,
    Op.DIV: jnp.divide,
    Op.MAX2: jnp.maximum,
}


def lower_node(node: LazyTensor, vals: dict[int, Any]) -> Any:
    """Evaluate one node given its sources' values."""
    op = node.op
    srcs = [vals[s.id] for s in node.srcs]
    if op == Op.VAR:
        raise KeyError(f"unbound var {node.name!r}")
    if op == Op.CONST:
        return jnp.asarray(node.payload)
    if op in UNARY_FNS:
        return UNARY_FNS[op](srcs[0])
    if op == Op.SCALE:
        return srcs[0] * node.payload
    if op == Op.ADD_SCALAR:
        return srcs[0] + node.payload
    if op in BINARY_FNS:
        return BINARY_FNS[op](srcs[0], srcs[1])
    if op == Op.RESHAPE:
        return jnp.reshape(srcs[0], node.shape)
    if op == Op.TRANSPOSE:
        return jnp.swapaxes(srcs[0], -1, -2)
    if op == Op.PERMUTE:
        return jnp.transpose(srcs[0], node.payload)
    if op == Op.BROADCAST_TO:
        return jnp.broadcast_to(srcs[0], node.shape)
    if op == Op.SLICE:
        starts, sizes = node.payload
        return jax.lax.slice(srcs[0], starts,
                             tuple(st + sz for st, sz in zip(starts, sizes)))
    if op in (Op.SUM, Op.MAX, Op.MEAN):
        axes, keepdims = node.payload
        fn = {Op.SUM: jnp.sum, Op.MAX: jnp.max, Op.MEAN: jnp.mean}[op]
        return fn(srcs[0], axis=axes, keepdims=keepdims)
    if op == Op.GATHER_ROWS:
        return jnp.take(srcs[0], srcs[1].astype(jnp.int32), axis=0)
    if op == Op.PICK_ROWS:
        idx = srcs[1].astype(jnp.int32)
        return jnp.take_along_axis(srcs[0], idx[..., None], axis=-1)[..., 0]
    if op == Op.SCATTER_ADD_ROWS:
        return srcs[0].at[srcs[2].astype(jnp.int32)].add(srcs[1])
    if op == Op.SLICE_ASSIGN:
        return jax.lax.dynamic_update_slice(srcs[0], srcs[1].astype(
            srcs[0].dtype), node.payload)
    if op == Op.ROPE:
        return refs.rope_apply_ref(srcs[0], srcs[1], srcs[2])
    if op == Op.SOFTMAX:
        return jax.nn.softmax(srcs[0], axis=node.payload)
    if op == Op.LOG_SOFTMAX:
        return jax.nn.log_softmax(srcs[0], axis=node.payload)
    if op == Op.RMSNORM:
        return refs.rmsnorm_ref(srcs[0], srcs[1], node.payload)
    if op == Op.LAYERNORM:
        return refs.layernorm_ref(srcs[0], srcs[1], srcs[2], node.payload)
    if op == Op.CONV2D:
        from zgml.nn.layers import conv2d
        stride, padding = node.payload
        return conv2d(srcs[0], srcs[1], stride, padding)
    if op == Op.MAXPOOL2D:
        from zgml.nn.layers import max_pool2d
        window, stride = node.payload
        return max_pool2d(srcs[0], window, stride)
    if op == Op.MATMUL:
        trans_a, trans_b = node.payload
        a = jnp.swapaxes(srcs[0], -1, -2) if trans_a else srcs[0]
        b = jnp.swapaxes(srcs[1], -1, -2) if trans_b else srcs[1]
        return jnp.matmul(a, b, preferred_element_type=jnp.float32)
    if op == Op.ATTENTION:
        causal, scale = node.payload
        q, k, v = srcs
        mask = refs.causal_mask(q.shape[-2], k.shape[-2]) if causal else None
        return refs.attention_ref(q, k, v, mask, scale)
    if op == Op.CROSS_ENTROPY:
        logits, idx = srcs
        logp = jax.nn.log_softmax(logits, axis=-1)
        picked = jnp.take_along_axis(
            logp, idx.astype(jnp.int32)[..., None], axis=-1)[..., 0]
        return -jnp.mean(picked)
    raise NotImplementedError(op)
