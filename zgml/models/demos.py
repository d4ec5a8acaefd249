"""Demo models (ref: src/models/{linear,poly,xor_mlp,mlp_classifier,
conv_classifier,autoencoder}.zig — each with build/train/predict used as tests
and benchmarks)."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from zgml.nn.layers import (batchnorm2d, batchnorm2d_init, conv2d, linear,
                                linear_init, max_pool2d)
from zgml.nn.losses import cross_entropy_idx, mean_sq_err
from zgml.nn.train import train_supervised, train_unsupervised


# -- linear regression (ref: models/linear.zig) -------------------------------
def linear_regression_init(rng=None):
    return {"w": jnp.zeros((1, 1), jnp.float32), "b": jnp.zeros((1,), jnp.float32)}


def linear_regression_forward(p, x):
    return x @ p["w"] + p["b"]


def linear_regression_loss(p, x, y):
    return mean_sq_err(linear_regression_forward(p, x), y)


# -- polynomial regression (ref: models/poly.zig) -----------------------------
def poly_init(degree: int = 3):
    return {"coef": jnp.zeros((degree + 1,), jnp.float32)}


def poly_forward(p, x):
    """x: [N, 1] -> sum_i coef[i] * x^i."""
    powers = jnp.concatenate([x ** i for i in range(p["coef"].shape[0])], axis=1)
    return powers @ p["coef"][:, None]


def poly_loss(p, x, y):
    return mean_sq_err(poly_forward(p, x), y)


# -- XOR MLP (ref: models/xor_mlp.zig) ----------------------------------------
def xor_mlp_init(seed: int = 0, hidden: int = 8):
    rng = np.random.default_rng(seed)
    return {"l1": linear_init(rng, 2, hidden), "l2": linear_init(rng, hidden, 1)}


def xor_mlp_forward(p, x):
    h = jnp.tanh(linear(p["l1"], x))
    return jax.nn.sigmoid(linear(p["l2"], h))


def xor_mlp_loss(p, x, y):
    return mean_sq_err(xor_mlp_forward(p, x), y)


def train_xor(epochs: int = 800, lr_cfg=None):
    from zgml.optim.adam import AdamConfig
    x = np.asarray([[0, 0], [0, 1], [1, 0], [1, 1]], np.float32)
    y = np.asarray([[0], [1], [1], [0]], np.float32)
    p = xor_mlp_init()
    p, losses = train_supervised(p, xor_mlp_loss, x, y, epochs=epochs,
                                 batch_size=4,
                                 adam=lr_cfg or AdamConfig(lr=0.02))
    return p, losses


# -- MLP classifier (ref: models/mlp_classifier.zig) --------------------------
def mlp_classifier_init(d_in: int, hidden: int, n_classes: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return {"l1": linear_init(rng, d_in, hidden),
            "l2": linear_init(rng, hidden, n_classes)}


def mlp_classifier_forward(p, x):
    return linear(p["l2"], jax.nn.relu(linear(p["l1"], x)))


def mlp_classifier_loss(p, x, y):
    return cross_entropy_idx(mlp_classifier_forward(p, x), y)


# -- conv classifier (ref: models/conv_classifier.zig) ------------------------
def conv_classifier_init(n_classes: int = 10, seed: int = 0,
                         batchnorm: bool = False):
    rng = np.random.default_rng(seed)
    p = {
        "c1": jnp.asarray(rng.standard_normal((3, 3, 1, 8)).astype(np.float32)
                          * 0.1),
        "c2": jnp.asarray(rng.standard_normal((3, 3, 8, 16)).astype(np.float32)
                          * 0.1),
        "fc": linear_init(rng, 5 * 5 * 16, n_classes),
    }
    if batchnorm:
        p["bn1"] = batchnorm2d_init(8)
    return p


def conv_classifier_forward(p, x, train: bool = False):
    """x: [B, 28, 28] -> logits [B, n_classes]."""
    h = x[..., None]
    h = conv2d(h, p["c1"])                 # [B, 26, 26, 8]
    if "bn1" in p:
        h, _ = batchnorm2d(p["bn1"], h, train=False)
    h = jax.nn.relu(h)
    h = max_pool2d(h)                      # [B, 13, 13, 8]
    h = jax.nn.relu(conv2d(h, p["c2"]))    # [B, 11, 11, 16]
    h = max_pool2d(h)                      # [B, 5, 5, 16]
    return linear(p["fc"], h.reshape(h.shape[0], -1))


def conv_classifier_loss(p, x, y):
    return cross_entropy_idx(conv_classifier_forward(p, x), y)


# -- autoencoder (ref: models/autoencoder.zig) --------------------------------
def autoencoder_init(d_in: int = 784, d_hidden: int = 32, seed: int = 0):
    rng = np.random.default_rng(seed)
    return {"enc": linear_init(rng, d_in, d_hidden),
            "dec": linear_init(rng, d_hidden, d_in)}


def autoencoder_forward(p, x):
    return jax.nn.sigmoid(linear(p["dec"], jnp.tanh(linear(p["enc"], x))))


def autoencoder_loss(p, x, y):
    return mean_sq_err(autoencoder_forward(p, x), y)
