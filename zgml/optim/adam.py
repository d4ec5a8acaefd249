"""Adam / AdamW as pure pytree transforms (ref: src/optim/adam.zig:29-217).

The reference hand-fuses the scalar update loop; under XLA the whole tree update is
one fused XLA elementwise program, so the idiomatic form is the plain math.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0   # >0 => AdamW (decoupled)


def adam_init(params):
    zeros = lambda: jax.tree.map(jnp.zeros_like, params)  # noqa: E731
    return {"m": zeros(), "v": zeros(), "t": jnp.zeros((), jnp.int32)}


def adam_update(params, grads, state, cfg: AdamConfig = AdamConfig()):
    """Returns (new_params, new_state). Bias-corrected, decoupled weight decay."""
    t = state["t"] + 1
    b1t = 1.0 - cfg.b1 ** t.astype(jnp.float32)
    b2t = 1.0 - cfg.b2 ** t.astype(jnp.float32)
    m = jax.tree.map(lambda m_, g: cfg.b1 * m_ + (1 - cfg.b1) * g,
                     state["m"], grads)
    v = jax.tree.map(lambda v_, g: cfg.b2 * v_ + (1 - cfg.b2) * g * g,
                     state["v"], grads)

    def upd(p, m_, v_):
        mhat = m_ / b1t
        vhat = v_ / b2t
        step = cfg.lr * mhat / (jnp.sqrt(vhat) + cfg.eps)
        if cfg.weight_decay:
            step = step + cfg.lr * cfg.weight_decay * p
        return (p - step).astype(p.dtype)

    new_params = jax.tree.map(upd, params, m, v)
    return new_params, {"m": m, "v": v, "t": t}
