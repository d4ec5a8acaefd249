"""Losses (ref: src/loss.zig:16-43)."""
from __future__ import annotations

import jax
import jax.numpy as jnp


def mean_sq_err(pred: jax.Array, target: jax.Array) -> jax.Array:
    d = pred.astype(jnp.float32) - target.astype(jnp.float32)
    return jnp.mean(d * d)


def cross_entropy(logits: jax.Array, target_probs: jax.Array) -> jax.Array:
    logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
    return -jnp.mean(jnp.sum(target_probs * logp, axis=-1))


def cross_entropy_idx(logits: jax.Array, targets: jax.Array) -> jax.Array:
    """Integer-target CE = mean(-log_softmax(x)[target]) — the pattern the
    reference fuses (fusion.zig:171-203); XLA fuses it."""
    logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
    picked = jnp.take_along_axis(
        logp, targets.astype(jnp.int32)[..., None], axis=-1)[..., 0]
    return -jnp.mean(picked)
