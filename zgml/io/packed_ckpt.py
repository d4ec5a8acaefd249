"""Repacked-checkpoint format: PackedWeight params serialized to safetensors.

Loading a GGUF means dequant-aware parsing plus the planar repack
(quant/repack.py) — host work that costs minutes at 7B on a small host. The
reference sidesteps this with mmap zero-copy of its native layout
(ref: src/gguf.zig mmap path); this is the analog for the planar layout: the
ALREADY-REPACKED qvals/scales and the dense leaves go into one safetensors
file (+ config json in its metadata), and loading is an mmap + device_put —
seconds, not minutes. `bench.py` and serving deployments convert once and
reload fast forever after.
"""
from __future__ import annotations

import dataclasses
import json

import jax.numpy as jnp
import numpy as np

from zgml.io.safetensors import SafetensorsFile, save_safetensors
from zgml.models.llama import LlamaConfig, LlamaModel
from zgml.quant.repack import PackedWeight

_PW_AUX = ("kind", "n", "k", "n_pad", "k_pad")


def _flatten_params(params, prefix="", out=None, meta=None):
    out = {} if out is None else out
    meta = {} if meta is None else meta
    if isinstance(params, PackedWeight):
        out[prefix + ".qvals"] = np.asarray(params.qvals)
        out[prefix + ".scales"] = np.asarray(params.scales)
        meta[prefix] = {"packed": [getattr(params, f) for f in _PW_AUX]}
        return out, meta
    if isinstance(params, dict):
        for k, v in params.items():
            _flatten_params(v, f"{prefix}.{k}" if prefix else k, out, meta)
        return out, meta
    if isinstance(params, (list, tuple)):
        for i, v in enumerate(params):
            _flatten_params(v, f"{prefix}#{i}", out, meta)
        meta[prefix + "#len"] = len(params)
        return out, meta
    out[prefix] = np.asarray(params)
    return out, meta


def save_packed_llama(path: str, model: LlamaModel):
    """Serialize a (possibly quantized) llama model to one safetensors file."""
    tensors, meta = _flatten_params(model.params)
    save_safetensors(path, tensors, metadata={
        "zgml_config": json.dumps(dataclasses.asdict(model.cfg)),
        "zgml_tree": json.dumps(meta),
    })


def load_packed_llama(path: str, max_seq_len: int | None = None,
                      dtype=jnp.float32) -> LlamaModel:
    """mmap-load a repacked llama checkpoint (no dequant, no repack)."""
    st = SafetensorsFile(path)
    cfg = LlamaConfig(**json.loads(st.metadata["zgml_config"]))
    if max_seq_len is not None:
        cfg = dataclasses.replace(cfg, max_seq_len=max_seq_len)
    tree = json.loads(st.metadata["zgml_tree"])
    names = list(st.keys())

    def build(prefix):
        if prefix in tree and isinstance(tree[prefix], dict):
            kind, n, k, n_pad, k_pad = tree[prefix]["packed"]
            # keep numpy (mmap zero-copy): the caller's device_put
            # uploads everything once
            return PackedWeight(kind, n, k, n_pad, k_pad,
                                st.tensor(prefix + ".qvals"),
                                st.tensor(prefix + ".scales"))
        if (prefix + "#len") in tree:
            return [build(f"{prefix}#{i}")
                    for i in range(tree[prefix + "#len"])]
        # dict node: children share the dotted prefix
        pre = prefix + "." if prefix else ""
        kids = set()
        for nm in names:
            if nm.startswith(pre):
                rest = nm[len(pre):]
                kids.add(rest.split(".")[0].split("#")[0])
        for key in list(tree):
            if key.startswith(pre) and key != prefix:
                rest = key[len(pre):]
                kids.add(rest.split(".")[0].split("#")[0])
        if not kids:
            arr = st.tensor(prefix)
            a = jnp.asarray(arr)
            return a.astype(dtype) if a.dtype == jnp.float32 else a
        return {k: build(pre + k) for k in sorted(kids)}

    return LlamaModel(cfg, build(""))
