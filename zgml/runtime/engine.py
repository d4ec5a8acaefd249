"""Inference engine: the analog of LlamaInferenceSession/Plan.

The reference freezes one forward graph per token_len (1 = decode, 128 =
prefill) and patches inputs per step with zero per-step allocation
(src/llama_inference.zig:51-149, 405-466). Here each (batch, token_len) bucket
is one jit-compiled function with static shapes and a donated KV cache — XLA's
equivalent of the frozen plan — compiled once, then executed with only a token
id crossing the host boundary per decode step.

Chunked prefill mirrors session.prefill (llama_inference.zig:697-727): full
`prefill_chunk`-token windows through the prefill bucket, the padded tail
through the same bucket with kv_len masking (instead of the reference's
step-loop tail).
"""
from __future__ import annotations

import functools
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from zgml.models.llama import LlamaConfig, LlamaModel
from zgml.runtime.profile import global_profile
from zgml.runtime.sampling import SamplingParams, sample


class LlamaEngine:
    """Single-model inference session with KV cache and shape-bucketed plans."""

    def __init__(self, model: LlamaModel, batch: int = 1,
                 prefill_chunk: int = 128, cache_dtype=jnp.bfloat16,
                 sampling: SamplingParams = SamplingParams(),
                 donate_cache: bool = True):
        self.model = model
        self.cfg = model.cfg
        self.batch = batch
        self.prefill_chunk = min(prefill_chunk, model.cfg.max_seq_len)
        self.sampling = sampling
        self.cache = model.init_cache(batch, cache_dtype)
        self.pos = 0
        self.key = jax.random.PRNGKey(0)
        donate = (2,) if donate_cache else ()

        # decode plan: tokens [B,1] -> (next_token [B], logits [B,V], cache)
        @functools.partial(jax.jit, donate_argnums=donate)
        def _decode_step(params, tokens, cache, pos, key):
            logits, cache = model.forward(params, tokens, cache, pos)
            tok = sample(logits[:, -1], self.sampling, key)
            return tok, logits[:, -1], cache

        # prefill plan: tokens [B,C] -> (logits at last valid [B,V], cache)
        @functools.partial(jax.jit, donate_argnums=donate)
        def _prefill_chunk(params, tokens, cache, pos, n_valid):
            logits, cache = model.forward(params, tokens, cache, pos)
            last = logits[:, n_valid - 1]      # dynamic index into [B,C,V]
            return last, cache

        # on-device multi-token decode: the whole generate loop (forward +
        # sampling) runs as one lax.scan dispatch, so the host syncs once per
        # N tokens instead of per token (SURVEY.md §7: decode is
        # dispatch-latency-dominated; zgml needed 7.5k lines of command-stream
        # fusion for this — here it is one scan).
        import inspect
        greedy_ok = "greedy_head" in inspect.signature(
            model.forward).parameters

        @functools.partial(jax.jit, static_argnames=("n_steps",),
                           donate_argnums=(2,))
        def _decode_scan(params, tok0, cache, pos0, key, n_steps):
            greedy = self.sampling.temperature == 0.0 and greedy_ok

            def body(carry, _):
                tok, cache, pos, key = carry
                if greedy:
                    # greedy tail: the argmax happens inside the forward,
                    # so no logits leave the step
                    nxt, cache = model.forward(params, tok[:, None], cache,
                                               pos, greedy_head=True)
                else:
                    logits, cache = model.forward(params, tok[:, None],
                                                  cache, pos)
                    key, sub = jax.random.split(key)
                    nxt = sample(logits[:, -1], self.sampling, sub)
                return (nxt, cache, pos + 1, key), nxt

            (tok, cache, pos, key), toks = jax.lax.scan(
                body, (tok0, cache, pos0, key), length=n_steps)
            return toks, cache  # toks: [n_steps, B]

        self._decode_step = _decode_step
        self._prefill_chunk = _prefill_chunk
        self._decode_scan = _decode_scan

    # -- session api (ref: llama_inference.zig:479-764) ----------------------
    def reset(self):
        """Rewind to position 0. Cache contents beyond kv_len are never read,
        so no zeroing is needed (ref zeroes, :596-604)."""
        self.pos = 0

    def prefill(self, tokens: np.ndarray | list[int]) -> jax.Array:
        """Process a prompt; returns last-token logits [B, V].

        tokens: [T] (batch 1) or [B, T].
        """
        tokens = np.atleast_2d(np.asarray(tokens, np.int32))
        b, t = tokens.shape
        assert b == self.batch, f"engine compiled for batch {self.batch}, got {b}"
        if self.pos + t > self.cfg.max_seq_len:
            raise ValueError("SequenceTooLong")  # ref: llama_inference.zig:682
        chunk = self.prefill_chunk
        last = None
        with global_profile.phase("prefill"):
            for i in range(0, t, chunk):
                window = tokens[:, i:i + chunk]
                n_valid = window.shape[1]
                if n_valid < chunk:
                    window = np.pad(window, ((0, 0), (0, chunk - n_valid)))
                last, self.cache = self._prefill_chunk(
                    self.model.params, jnp.asarray(window), self.cache,
                    self.pos, n_valid)
                self.pos += n_valid
        global_profile.add("prefill_tokens", int(t) * b)
        return last

    def prefill_cp(self, tokens: np.ndarray | list[int], mesh,
                   axis: str = "cp") -> jax.Array:
        """Context-parallel one-shot prefill (ring attention over `axis`).

        The prompt's sequence axis and the O(T²) prefill FLOPs split across
        the cp devices (parallel/cp.py); the gathered per-layer KV lands in
        this engine's cache and decode continues on the normal path. Enables
        prefilling prompts whose attention working set exceeds one chip.
        Requires a fresh session (pos == 0). int8 caches are quantized from
        the gathered dense K/V (per-position scales).
        """
        tokens = np.atleast_2d(np.asarray(tokens, np.int32))
        b, t = tokens.shape
        assert b == self.batch, f"engine batch {self.batch}, got {b}"
        if self.pos != 0:
            raise ValueError("prefill_cp requires a fresh session (pos==0)")
        if t > self.cfg.max_seq_len:
            raise ValueError("SequenceTooLong")
        ck = self.cache["k"]
        int8_cache = ((isinstance(ck, list) and isinstance(ck[0], tuple))
                      or isinstance(ck, tuple))
        from zgml.parallel.cp import make_cp_prefill
        cp = mesh.shape[axis]
        t_pad = -(-t // cp) * cp
        toks = np.pad(tokens, ((0, 0), (0, t_pad - t)))
        key = (id(mesh), axis, t_pad)
        if getattr(self, "_cp_plan", None) is None or self._cp_plan[0] != key:
            self._cp_plan = (key, make_cp_prefill(self.model, mesh, axis))
        with global_profile.phase("prefill_cp"):
            logits, ks, vs = self._cp_plan[1](self.model.params,
                                              jnp.asarray(toks))
            ks, vs = ks[:, :, :, :t], vs[:, :, :, :t]
            if int8_cache:
                # quantize the gathered dense K/V into the int8 columns
                # (per-position scales, quant/kv_cache.py)
                from zgml.quant.kv_cache import (quantize_columns,
                                                     write_columns)
                if isinstance(ck, list):
                    for li in range(self.cfg.n_layers):
                        # ks[li]: [B, Hkv, T, d] -> columns at pos 0
                        kq, ksc = quantize_columns(
                            ks[li].astype(jnp.float32))
                        vq, vsc = quantize_columns(
                            vs[li].astype(jnp.float32))
                        self.cache["k"][li] = write_columns(
                            ck[li][0], ck[li][1], kq, ksc, 0)
                        self.cache["v"][li] = write_columns(
                            self.cache["v"][li][0], self.cache["v"][li][1],
                            vq, vsc, 0)
                else:
                    # stacked tuple cache [L, B, Hkv, d, S]
                    kq, ksc = jax.vmap(
                        lambda a: quantize_columns(a.astype(jnp.float32)))(ks)
                    vq, vsc = jax.vmap(
                        lambda a: quantize_columns(a.astype(jnp.float32)))(vs)
                    dus = jax.lax.dynamic_update_slice
                    self.cache["k"] = (
                        dus(ck[0], kq, (0, 0, 0, 0, 0)),
                        dus(ck[1], ksc, (0, 0, 0, 0)))
                    cv = self.cache["v"]
                    self.cache["v"] = (
                        dus(cv[0], vq, (0, 0, 0, 0, 0)),
                        dus(cv[1], vsc, (0, 0, 0, 0)))
            elif isinstance(ck, list):
                for li in range(self.cfg.n_layers):
                    self.cache["k"][li] = jax.lax.dynamic_update_slice_in_dim(
                        self.cache["k"][li], ks[li].astype(ck[li].dtype),
                        0, axis=2)
                    self.cache["v"][li] = jax.lax.dynamic_update_slice_in_dim(
                        self.cache["v"][li], vs[li].astype(ck[li].dtype),
                        0, axis=2)
            else:
                self.cache["k"] = jax.lax.dynamic_update_slice_in_dim(
                    self.cache["k"], ks.astype(ck.dtype), 0, axis=3)
                self.cache["v"] = jax.lax.dynamic_update_slice_in_dim(
                    self.cache["v"], vs.astype(ck.dtype), 0, axis=3)
        self.pos = t
        global_profile.add("prefill_tokens", int(t) * b)
        return logits[:, t - 1]

    def step(self, tokens: np.ndarray | list[int] | jax.Array) -> tuple[jax.Array, jax.Array]:
        """One decode step. tokens: [B] last generated ids.

        Returns (next_token [B], logits [B, V]).
        """
        if self.pos + 1 > self.cfg.max_seq_len:
            raise ValueError("SequenceTooLong")
        tok = jnp.asarray(tokens, jnp.int32).reshape(self.batch, 1)
        self.key, sub = jax.random.split(self.key)
        with global_profile.phase("decode"):
            nxt, logits, self.cache = self._decode_step(
                self.model.params, tok, self.cache, self.pos, sub)
        self.pos += 1
        global_profile.add("decode_tokens", self.batch)
        return nxt, logits

    def decode_n(self, tokens, n_steps: int) -> jax.Array:
        """Generate n_steps tokens in ONE device dispatch (on-device loop).

        tokens: [B] ids to feed first. Returns [n_steps, B] generated ids.
        Position bookkeeping matches n_steps sequential `step()` calls.
        """
        if self.pos + n_steps > self.cfg.max_seq_len:
            raise ValueError("SequenceTooLong")
        tok0 = jnp.asarray(tokens, jnp.int32).reshape(self.batch)
        self.key, sub = jax.random.split(self.key)
        with global_profile.phase("decode_scan"):
            toks, self.cache = self._decode_scan(
                self.model.params, tok0, self.cache, self.pos, sub,
                n_steps=n_steps)
        self.pos += n_steps
        global_profile.add("decode_tokens", n_steps * self.batch)
        return toks

    def generate(self, prompt: np.ndarray | list[int], max_new_tokens: int,
                 stop_ids: tuple[int, ...] = (), burst: int = 32) -> list[int]:
        """Greedy/sampled autoregressive generation (batch 1 convenience).

        Decodes in `burst`-token on-device scans (decode_n — ONE dispatch per
        burst instead of one per token) and truncates at the first stop id,
        the same burst discipline the serving loop uses. A stop mid-burst
        wastes at most burst-1 speculatively generated tokens."""
        last_logits = self.prefill(prompt)
        self.key, sub = jax.random.split(self.key)
        tok = sample(last_logits, self.sampling, sub)
        out = [int(tok[0])]
        while len(out) < max_new_tokens and out[-1] not in stop_ids:
            n = min(burst, max_new_tokens - len(out))
            if n == 1 or self.pos + n > self.cfg.max_seq_len:
                tok, _ = self.step(tok)
                out.append(int(tok[0]))
                continue
            toks = self.decode_n(tok, n)
            for t in np.asarray(toks)[:, 0]:
                out.append(int(t))
                if int(t) in stop_ids:
                    break
            tok = toks[-1]
        return out
