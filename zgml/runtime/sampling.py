"""On-device token sampling: greedy, temperature, top-k, top-p.

The reference samples on host after downloading logits; here the whole
sampling step stays on device so decode never syncs more than the 4-byte token
id per step (SURVEY.md §7 "keep the whole step on device").
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0      # 0 => greedy
    top_k: int = 0                # 0 => disabled
    top_p: float = 1.0            # 1 => disabled


def sample(logits: jax.Array, params: SamplingParams, key: jax.Array) -> jax.Array:
    """logits [B, V] -> token ids [B]."""
    if params.temperature == 0.0:
        return jnp.argmax(logits, axis=-1).astype(jnp.int32)
    x = logits / params.temperature
    if params.top_k > 0:
        kth = jnp.sort(x, axis=-1)[:, -params.top_k][:, None]
        x = jnp.where(x < kth, -jnp.inf, x)
    if params.top_p < 1.0:
        sorted_x = jnp.sort(x, axis=-1)[:, ::-1]
        probs = jax.nn.softmax(sorted_x, axis=-1)
        cum = jnp.cumsum(probs, axis=-1)
        # keep the smallest prefix with cumulative prob >= top_p
        cutoff_idx = jnp.sum(cum < params.top_p, axis=-1, keepdims=True)
        cutoff = jnp.take_along_axis(sorted_x, cutoff_idx, axis=-1)
        x = jnp.where(x < cutoff, -jnp.inf, x)
    return jax.random.categorical(key, x, axis=-1).astype(jnp.int32)
