"""Training-path tests: optimizers, losses, demo models learn, checkpoints.

Mirrors the reference's model-test strategy (each demo model's train loop is a
test, SURVEY.md §2.4) and its checkpoint roundtrip/shape-mismatch tests.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from zgml.models import demos
from zgml.nn.losses import cross_entropy_idx, mean_sq_err
from zgml.nn.train import train_supervised
from zgml.optim.adam import AdamConfig, adam_init, adam_update
from zgml.optim.sgd import sgd_init, sgd_momentum_update, sgd_update
from zgml.io.checkpoint import save_checkpoint, load_checkpoint


def test_sgd_reduces_quadratic():
    p = {"x": jnp.asarray([5.0, -3.0])}
    loss = lambda p: jnp.sum(p["x"] ** 2)  # noqa: E731
    for _ in range(50):
        g = jax.grad(loss)(p)
        p = sgd_update(p, g, 0.1)
    assert float(loss(p)) < 1e-3


def test_sgd_momentum_and_adam_converge():
    loss = lambda p: jnp.sum((p["x"] - 3.0) ** 2)  # noqa: E731
    p = {"x": jnp.zeros(4)}
    st = sgd_init(p)
    for _ in range(200):
        p, st = sgd_momentum_update(p, jax.grad(loss)(p), st, 0.02)
    assert float(loss(p)) < 1e-3

    p = {"x": jnp.zeros(4)}
    st = adam_init(p)
    cfg = AdamConfig(lr=0.1)
    for _ in range(200):
        p, st = adam_update(p, jax.grad(loss)(p), st, cfg)
    assert float(loss(p)) < 1e-3


def test_linear_regression_learns():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((256, 1)).astype(np.float32)
    y = 2.5 * x + 0.7
    p = demos.linear_regression_init()
    p, losses = train_supervised(p, demos.linear_regression_loss, x, y,
                                 epochs=40, batch_size=64,
                                 adam=AdamConfig(lr=0.05))
    assert losses[-1] < 0.01
    assert abs(float(p["w"][0, 0]) - 2.5) < 0.1
    assert abs(float(p["b"][0]) - 0.7) < 0.1


def test_xor_mlp_learns():
    p, losses = demos.train_xor(epochs=400)
    x = jnp.asarray([[0, 0], [0, 1], [1, 0], [1, 1]], jnp.float32)
    pred = np.asarray(demos.xor_mlp_forward(p, x))[:, 0]
    assert (pred.round() == np.asarray([0, 1, 1, 0])).all(), pred


def test_mlp_classifier_learns_blobs():
    rng = np.random.default_rng(1)
    centers = rng.standard_normal((3, 8)) * 4
    y = rng.integers(0, 3, 512)
    x = (centers[y] + rng.standard_normal((512, 8))).astype(np.float32)
    p = demos.mlp_classifier_init(8, 32, 3)
    p, _ = train_supervised(p, demos.mlp_classifier_loss, x,
                            y.astype(np.int32), epochs=20, batch_size=64,
                            adam=AdamConfig(lr=0.01))
    acc = float(np.mean(np.argmax(
        np.asarray(demos.mlp_classifier_forward(p, jnp.asarray(x))), -1) == y))
    assert acc > 0.9, acc


def test_conv_classifier_on_synthetic_mnist(tmp_path):
    from zgml.data import load_mnist, write_synthetic_mnist
    write_synthetic_mnist(tmp_path, n_train=256, n_test=64)
    xi, yi = load_mnist(tmp_path, "train")
    xt, yt = load_mnist(tmp_path, "test")
    p = demos.conv_classifier_init()
    p, _ = train_supervised(p, demos.conv_classifier_loss, xi, yi, epochs=6,
                            batch_size=32, adam=AdamConfig(lr=3e-3))
    acc = float(np.mean(np.argmax(
        np.asarray(demos.conv_classifier_forward(p, jnp.asarray(xt))), -1) == yt))
    assert acc > 0.8, acc


def test_autoencoder_reconstructs():
    rng = np.random.default_rng(2)
    basis = rng.standard_normal((4, 64)).astype(np.float32)
    codes = rng.standard_normal((256, 4)).astype(np.float32)
    x = jax.nn.sigmoid(jnp.asarray(codes @ basis))
    x = np.asarray(x)
    p = demos.autoencoder_init(64, 16)
    from zgml.nn.train import train_unsupervised
    p, losses = train_unsupervised(p, demos.autoencoder_loss, x, epochs=30,
                                   batch_size=64, adam=AdamConfig(lr=3e-3))
    assert losses[-1] < losses[0] * 0.5


def test_dataloader_shuffles_and_batches():
    from zgml.data import DataLoader
    x = np.arange(100)
    y = np.arange(100) * 2
    dl = DataLoader(x, y, batch_size=16, seed=0)
    assert len(dl) == 6
    seen = []
    for bx, by in dl:
        assert bx.shape == (16,)
        np.testing.assert_array_equal(by, bx * 2)
        seen.extend(bx.tolist())
    assert len(seen) == 96 and len(set(seen)) == 96
    epoch2 = [bx.tolist() for bx, _ in dl]
    assert epoch2[0] != seen[:16]  # reshuffled


def test_checkpoint_roundtrip_and_mismatch(tmp_path):
    p = {"a": jnp.arange(6, dtype=jnp.float32).reshape(2, 3),
         "nest": {"b": jnp.ones((4,), jnp.int32)}}
    path = tmp_path / "ck.zgmt"
    save_checkpoint(path, p)
    out = load_checkpoint(path, jax.tree.map(jnp.zeros_like, p))
    np.testing.assert_array_equal(np.asarray(out["a"]), np.asarray(p["a"]))
    np.testing.assert_array_equal(np.asarray(out["nest"]["b"]),
                                  np.asarray(p["nest"]["b"]))
    bad = {"a": jnp.zeros((3, 3)), "nest": {"b": jnp.ones((4,), jnp.int32)}}
    with pytest.raises(ValueError, match="shape mismatch"):
        load_checkpoint(path, bad)


def test_checkpoint_optimizer_state(tmp_path):
    p = {"w": jnp.ones((3,))}
    st = adam_init(p)
    p2, st = adam_update(p, {"w": jnp.asarray([1.0, -1.0, 0.5])}, st)
    save_checkpoint(tmp_path / "opt.zgmt", {"params": p2, "opt": st})
    like = {"params": jax.tree.map(jnp.zeros_like, p2),
            "opt": jax.tree.map(jnp.zeros_like, st)}
    out = load_checkpoint(tmp_path / "opt.zgmt", like)
    assert int(out["opt"]["t"]) == 1


def test_llama_end_to_end_training():
    """Full llama training step path (the reference cannot train attention —
    backward.zig:393-404 panics; here jax.grad covers the whole model)."""
    from zgml.models.llama import LlamaConfig, LlamaModel, init_params
    cfg = LlamaConfig(vocab_size=64, d_model=32, n_heads=4, n_kv_heads=2,
                      d_ff=64, n_layers=2, max_seq_len=16, tied_lm_head=True)
    model = LlamaModel(cfg, init_params(cfg, seed=0))
    rng = np.random.default_rng(0)
    # learnable pattern: next token = (token + 1) % 16
    seqs = np.stack([np.arange(i, i + 9) % 16 for i in rng.integers(0, 16, 64)])

    def loss_fn(params, x, y):
        # the default dispatch trains: attention differentiates as XLA
        logits, _ = model.forward(params, x, model.init_cache(x.shape[0]), 0)
        from zgml.nn.losses import cross_entropy_idx
        return cross_entropy_idx(logits[:, :-1], y[:, 1:])

    p, losses = train_supervised(model.params, loss_fn,
                                 seqs.astype(np.int32), seqs.astype(np.int32),
                                 epochs=30, batch_size=16,
                                 adam=AdamConfig(lr=5e-3))
    assert losses[-1] < losses[0] * 0.3, losses[::10]
    # trained model predicts the pattern
    model2 = LlamaModel(cfg, p)
    logits, _ = model2.forward(p, jnp.asarray([[3, 4, 5, 6]], jnp.int32),
                               model2.init_cache(1), 0)
    assert int(np.argmax(np.asarray(logits[0, -1]))) == 7
