"""Whisper model smoke + CLI tests."""
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest

from zgml.models.whisper import WhisperConfig, WhisperModel, init_params


CFG = WhisperConfig(n_mels=16, n_audio_ctx=32, n_audio_state=32,
                    n_audio_heads=4, n_audio_layers=2, vocab_size=64,
                    n_text_ctx=16, n_text_state=32, n_text_heads=4,
                    n_text_layers=2)


def test_whisper_encode_decode_shapes():
    model = WhisperModel(CFG, init_params(CFG, seed=0))
    mel = jnp.asarray(np.random.default_rng(0).standard_normal(
        (1, 32, 16)).astype(np.float32))
    enc = model.encode_features(mel)
    assert enc.shape == (1, 16, 32)          # stride-2 conv halves T
    logits = model.decode(jnp.asarray([[1, 2, 3]], jnp.int32), enc)
    assert logits.shape == (1, 3, 64)
    assert np.isfinite(np.asarray(logits)).all()


def test_whisper_transcribe_greedy_deterministic():
    model = WhisperModel(CFG, init_params(CFG, seed=1))
    mel = jnp.asarray(np.random.default_rng(1).standard_normal(
        (1, 32, 16)).astype(np.float32))
    a = model.transcribe_greedy(mel, bos=1, eos=2, max_tokens=6)
    b = model.transcribe_greedy(mel, bos=1, eos=2, max_tokens=6)
    assert a == b and a[0] == 1


def test_whisper_causality():
    """Decoder token t must not depend on future tokens."""
    model = WhisperModel(CFG, init_params(CFG, seed=2))
    mel = jnp.asarray(np.random.default_rng(2).standard_normal(
        (1, 32, 16)).astype(np.float32))
    enc = model.encode_features(mel)
    l1 = model.decode(jnp.asarray([[1, 2, 3]], jnp.int32), enc)
    l2 = model.decode(jnp.asarray([[1, 2, 9]], jnp.int32), enc)
    np.testing.assert_allclose(np.asarray(l1[0, :2]), np.asarray(l2[0, :2]),
                               rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def tiny_gguf(tmp_path_factory):
    from zgml.io.gguf import GGMLType
    from zgml.utils.synthetic import TINY_TEST, write_synthetic_llama_gguf
    path = tmp_path_factory.mktemp("cli") / "t.gguf"
    write_synthetic_llama_gguf(str(path), TINY_TEST, GGMLType.Q4_0, seed=0)
    return str(path)


def test_cli_inspect(tiny_gguf, capsys):
    from zgml.utils.cli import main
    main(["inspect", tiny_gguf])
    out = capsys.readouterr().out
    assert "architecture: llama" in out
    assert "Q4_0" in out
    assert "params:" in out


def test_cli_generate(tiny_gguf, capsys):
    from zgml.utils.cli import main
    main(["generate", tiny_gguf, "--prompt-ids", "1,2,3", "-n", "4",
          "--mode", "dense"])
    out = capsys.readouterr().out
    assert "output ids:" in out


def test_whisper_cached_decode_matches_uncached():
    """The cached decode_step path must match the stateless
    full-sequence decoder token-for-token."""
    model = WhisperModel(CFG, init_params(CFG, seed=3))
    mel = jnp.asarray(np.random.default_rng(3).standard_normal(
        (1, 32, 16)).astype(np.float32))
    enc = model.encode_features(mel)

    # uncached greedy loop (oracle: re-runs the full sequence per token)
    toks = [1]
    for _ in range(8):
        logits = model.decode(jnp.asarray([toks], jnp.int32), enc)
        toks.append(int(np.argmax(np.asarray(logits[0, -1]))))

    # cached greedy
    got = model.transcribe_greedy(mel, bos=1, eos=-1, max_tokens=8)
    assert got == toks, (got, toks)


def test_whisper_hf_loader_roundtrip(tmp_path):
    """HF-named safetensors -> load_whisper_hf == directly-built params
    (ref name map: whisper_loader.zig:1-117)."""
    from zgml.io.hf_loaders import load_whisper_hf
    from zgml.io.safetensors import save_safetensors
    from zgml.models.gpt import sinusoidal_positions

    rng = np.random.default_rng(4)
    model = WhisperModel(CFG, init_params(CFG, seed=4))
    p = model.params
    t = lambda a: np.ascontiguousarray(np.asarray(a, np.float32).T)

    tensors = {
        "model.encoder.conv1.weight": np.asarray(p["conv1_w"]).transpose(2, 1, 0),
        "model.encoder.conv1.bias": np.asarray(p["conv1_b"]),
        "model.encoder.conv2.weight": np.asarray(p["conv2_w"]).transpose(2, 1, 0),
        "model.encoder.conv2.bias": np.asarray(p["conv2_b"]),
        "model.encoder.embed_positions.weight":
            sinusoidal_positions(CFG.n_audio_ctx, CFG.n_audio_state
                                 ).astype(np.float32),
        "model.encoder.layer_norm.weight": np.asarray(p["enc_ln_post"]["g"]),
        "model.encoder.layer_norm.bias": np.asarray(p["enc_ln_post"]["b"]),
        "model.decoder.embed_tokens.weight": np.asarray(p["tok_embd"]),
        "model.decoder.embed_positions.weight": np.asarray(p["pos_embd"]),
        "model.decoder.layer_norm.weight": np.asarray(p["dec_ln"]["g"]),
        "model.decoder.layer_norm.bias": np.asarray(p["dec_ln"]["b"]),
    }

    def dump_attn(prefix, a):
        tensors[prefix + ".q_proj.weight"] = t(a["wq"])
        tensors[prefix + ".q_proj.bias"] = np.asarray(a["bq"])
        tensors[prefix + ".k_proj.weight"] = t(a["wk"])
        tensors[prefix + ".v_proj.weight"] = t(a["wv"])
        tensors[prefix + ".v_proj.bias"] = np.asarray(a["bv"])
        tensors[prefix + ".out_proj.weight"] = t(a["wo"])
        tensors[prefix + ".out_proj.bias"] = np.asarray(a["bo"])

    for i, lyr in enumerate(p["enc_layers"]):
        pre = f"model.encoder.layers.{i}"
        dump_attn(pre + ".self_attn", lyr["attn"])
        tensors[pre + ".self_attn_layer_norm.weight"] = np.asarray(lyr["ln_1"]["g"])
        tensors[pre + ".self_attn_layer_norm.bias"] = np.asarray(lyr["ln_1"]["b"])
        tensors[pre + ".final_layer_norm.weight"] = np.asarray(lyr["ln_2"]["g"])
        tensors[pre + ".final_layer_norm.bias"] = np.asarray(lyr["ln_2"]["b"])
        tensors[pre + ".fc1.weight"] = t(lyr["w_fc"])
        tensors[pre + ".fc1.bias"] = np.asarray(lyr["b_fc"])
        tensors[pre + ".fc2.weight"] = t(lyr["w_proj"])
        tensors[pre + ".fc2.bias"] = np.asarray(lyr["b_proj"])
    for i, lyr in enumerate(p["dec_layers"]):
        pre = f"model.decoder.layers.{i}"
        dump_attn(pre + ".self_attn", lyr["attn"])
        dump_attn(pre + ".encoder_attn", lyr["cross"])
        tensors[pre + ".self_attn_layer_norm.weight"] = np.asarray(lyr["ln_1"]["g"])
        tensors[pre + ".self_attn_layer_norm.bias"] = np.asarray(lyr["ln_1"]["b"])
        tensors[pre + ".encoder_attn_layer_norm.weight"] = np.asarray(lyr["ln_x"]["g"])
        tensors[pre + ".encoder_attn_layer_norm.bias"] = np.asarray(lyr["ln_x"]["b"])
        tensors[pre + ".final_layer_norm.weight"] = np.asarray(lyr["ln_2"]["g"])
        tensors[pre + ".final_layer_norm.bias"] = np.asarray(lyr["ln_2"]["b"])
        tensors[pre + ".fc1.weight"] = t(lyr["w_fc"])
        tensors[pre + ".fc1.bias"] = np.asarray(lyr["b_fc"])
        tensors[pre + ".fc2.weight"] = t(lyr["w_proj"])
        tensors[pre + ".fc2.bias"] = np.asarray(lyr["b_proj"])

    path = str(tmp_path / "whisper.safetensors")
    save_safetensors(path, tensors)
    import json
    (tmp_path / "config.json").write_text(json.dumps(
        {"encoder_attention_heads": CFG.n_audio_heads,
         "decoder_attention_heads": CFG.n_text_heads}))
    loaded = load_whisper_hf(path)
    assert loaded.cfg.n_audio_layers == CFG.n_audio_layers
    assert loaded.cfg.vocab_size == CFG.vocab_size

    mel = jnp.asarray(rng.standard_normal((1, 32, 16)).astype(np.float32))
    toks = jnp.asarray([[1, 5, 9]], jnp.int32)
    want = model.decode(toks, model.encode_features(mel))
    got = loaded.decode(toks, loaded.encode_features(mel))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_log_mel_spectrogram():
    """Mel frontend: a pure tone lights up a higher mel bin for a higher
    frequency; shapes/normalization match the Whisper convention."""
    from zgml.data.audio import (log_mel_spectrogram, mel_filterbank,
                                     pad_or_trim)
    sr = 16000
    t = np.arange(sr) / sr
    mel_lo = log_mel_spectrogram(np.sin(2 * np.pi * 200 * t))
    mel_hi = log_mel_spectrogram(np.sin(2 * np.pi * 4000 * t))
    assert mel_lo.shape == (100 * 1 - 1 + 1, 80) or mel_lo.shape[1] == 80
    assert np.isfinite(mel_lo).all()
    assert int(np.argmax(mel_lo.mean(0))) < int(np.argmax(mel_hi.mean(0)))
    assert mel_lo.max() <= 2.0 and mel_lo.min() >= -2.0   # (log+4)/4 range

    fb = mel_filterbank()
    assert fb.shape == (80, 201) and (fb >= 0).all()

    padded = pad_or_trim(mel_lo, 3000)
    assert padded.shape == (3000, 80)
    assert pad_or_trim(padded, 100).shape == (100, 80)
