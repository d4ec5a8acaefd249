#!/usr/bin/env python
"""Train a tiny llama from scratch and save a checkpoint
(ref: scripts/train_tiny.zig).

Synthetic copy-task data (next token = (t + 1) % modulus) so the loss curve is
meaningful without external datasets.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="tiny_llama.zgmt")
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--d-model", type=int, default=64)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--lr", type=float, default=5e-3)
    args = ap.parse_args()

    import jax.numpy as jnp
    from zgml.io.checkpoint import save_checkpoint
    from zgml.models.llama import LlamaConfig, LlamaModel, init_params
    from zgml.nn.losses import cross_entropy_idx
    from zgml.nn.train import train_supervised
    from zgml.optim.adam import AdamConfig

    cfg = LlamaConfig(vocab_size=64, d_model=args.d_model, n_heads=4,
                      n_kv_heads=2, d_ff=2 * args.d_model,
                      n_layers=args.layers, max_seq_len=32, tied_lm_head=True)
    model = LlamaModel(cfg, init_params(cfg, seed=0))
    rng = np.random.default_rng(0)
    seqs = np.stack([np.arange(i, i + 16) % 32
                     for i in rng.integers(0, 32, 256)]).astype(np.int32)

    def loss_fn(params, x, y):
        logits, _ = model.forward(params, x, model.init_cache(x.shape[0]), 0)
        return cross_entropy_idx(logits[:, :-1], y[:, 1:])

    params, losses = train_supervised(
        model.params, loss_fn, seqs, seqs, epochs=args.epochs, batch_size=32,
        adam=AdamConfig(lr=args.lr), log_every=5)
    print(f"loss: {losses[0]:.4f} -> {losses[-1]:.4f}")
    save_checkpoint(args.out, params)
    print(f"saved {args.out}")

    # quick sanity generation with the trained weights
    from zgml.runtime.engine import LlamaEngine
    eng = LlamaEngine(LlamaModel(cfg, params), donate_cache=False)
    print("sample:", eng.generate([3, 4, 5], 8))


if __name__ == "__main__":
    main()
