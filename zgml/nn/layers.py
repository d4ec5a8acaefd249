"""NN building blocks (ref: src/nn.zig:1-662).

Functional: params are dicts of arrays, layers are pure functions.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def kaiming_init(rng: np.random.Generator, fan_in: int, shape) -> jnp.ndarray:
    """Kaiming-uniform (ref: nn.zig kaiming init)."""
    bound = float(np.sqrt(6.0 / fan_in))
    return jnp.asarray(rng.uniform(-bound, bound, shape).astype(np.float32))


def linear_init(rng: np.random.Generator, d_in: int, d_out: int,
                bias: bool = True) -> dict:
    p = {"w": kaiming_init(rng, d_in, (d_in, d_out))}
    if bias:
        p["b"] = jnp.zeros((d_out,), jnp.float32)
    return p


def linear(p: dict, x: jax.Array) -> jax.Array:
    y = jnp.dot(x, p["w"], preferred_element_type=jnp.float32)
    if "b" in p:
        y = y + p["b"]
    return y.astype(x.dtype)


def silu(x):
    return x * jax.nn.sigmoid(x)


def gelu(x):
    return jax.nn.gelu(x)


def dropout(x, rate: float, key, train: bool = True):
    """Inverted dropout with an eager mask (ref: nn.zig Dropout)."""
    if not train or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = jax.random.bernoulli(key, keep, x.shape)
    return jnp.where(mask, x / keep, 0.0)


def causal_mask(t: int) -> jax.Array:
    """[t, t] boolean lower-triangular mask (ref: nn.zig causal mask builder)."""
    return jnp.tril(jnp.ones((t, t), jnp.bool_))


def argmax(x, axis=-1):
    return jnp.argmax(x, axis=axis)


def batchnorm2d_init(channels: int) -> dict:
    return {"gamma": jnp.ones((channels,), jnp.float32),
            "beta": jnp.zeros((channels,), jnp.float32),
            "mean": jnp.zeros((channels,), jnp.float32),
            "var": jnp.ones((channels,), jnp.float32)}


def batchnorm2d(p: dict, x: jax.Array, train: bool = True, eps: float = 1e-5,
                momentum: float = 0.1):
    """x: [B, H, W, C]. Returns (y, updated_params) in train mode.
    (ref: nn.zig batchNorm2d composed ops)."""
    if train:
        mu = jnp.mean(x, axis=(0, 1, 2))
        var = jnp.var(x, axis=(0, 1, 2))
        new_p = dict(p)
        new_p["mean"] = (1 - momentum) * p["mean"] + momentum * mu
        new_p["var"] = (1 - momentum) * p["var"] + momentum * var
    else:
        mu, var = p["mean"], p["var"]
        new_p = p
    y = (x - mu) * jax.lax.rsqrt(var + eps) * p["gamma"] + p["beta"]
    return y, new_p


def conv2d(x: jax.Array, w: jax.Array, stride: int = 1,
           padding: str = "VALID") -> jax.Array:
    """x: [B, H, W, Cin], w: [kh, kw, Cin, Cout] — lowers to XLA conv, which
    runs on the tensor cores (the reference decomposes conv to
    as_strided+GEMM, api.zig:707-732; XLA does that internally)."""
    return jax.lax.conv_general_dilated(
        x, w, (stride, stride), padding,
        dimension_numbers=("NHWC", "HWIO", "NHWC"))


def max_pool2d(x: jax.Array, window: int = 2, stride: int | None = None):
    stride = stride or window
    return jax.lax.reduce_window(
        x, -jnp.inf, jax.lax.max, (1, window, window, 1),
        (1, stride, stride, 1), "VALID")
