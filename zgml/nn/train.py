"""Generic training loops (ref: nn.zig trainSupervised/trainUnsupervised).

jit-compiled step with optimizer pytree state; works with any pure
(params, batch) -> loss function.
"""
from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from zgml.optim.adam import AdamConfig, adam_init, adam_update


def train_supervised(params, loss_fn: Callable, data_x, data_y,
                     epochs: int = 10, batch_size: int = 32,
                     adam: AdamConfig = AdamConfig(), seed: int = 0,
                     log_every: int = 0):
    """loss_fn(params, x, y) -> scalar. Returns (params, losses)."""
    import numpy as np
    state = adam_init(params)

    @jax.jit
    def step(params, state, x, y):
        loss, grads = jax.value_and_grad(loss_fn)(params, x, y)
        params, state = adam_update(params, grads, state, adam)
        return params, state, loss

    rng = np.random.default_rng(seed)
    n = len(data_x)
    losses = []
    for epoch in range(epochs):
        perm = rng.permutation(n)
        total, batches = 0.0, 0
        for i in range(0, n - batch_size + 1, batch_size):
            idx = perm[i:i + batch_size]
            params, state, loss = step(params, state,
                                       jnp.asarray(data_x[idx]),
                                       jnp.asarray(data_y[idx]))
            total += float(loss)
            batches += 1
        losses.append(total / max(1, batches))
        if log_every and (epoch + 1) % log_every == 0:
            print(f"epoch {epoch+1}: loss {losses[-1]:.5f}")
    return params, losses


def train_unsupervised(params, loss_fn: Callable, data_x, **kw):
    """Autoencoder-style: loss_fn(params, x, x)."""
    return train_supervised(params, loss_fn, data_x, data_x, **kw)
