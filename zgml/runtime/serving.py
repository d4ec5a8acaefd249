"""Continuous batching serving engine.

A new capability over the reference (which is single-request, single-session —
SURVEY.md §2.7): decode requests share one fixed-shape batched decode step
(slots), join between steps after a per-slot prefill, and leave when finished.
Maps the BASELINE.json requirement "continuous batching of decode requests".

Design (slot model, v2):
  - `max_batch` slots, one compiled batched-decode plan with per-row positions
    (pos vector + per-row kv_len masking in attention).
  - Admission is CHUNK-INTERLEAVED: each step() advances at most one
    prefill-chunk of one pending request between decode steps, so decoding
    slots never stall behind a long prompt.
  - Prefill writes DIRECTLY into the request's slot rows of the shared cache
    and attends over that row (kv_row): no staging cache.
  - decode_burst(n): N decode steps in ONE device dispatch (lax.scan) when no
    admissions are pending — host syncs once per burst; stop-token overshoot
    is truncated on the host (the overshot KV is dead weight the slot's next
    occupant overwrites).
  - Inactive slots keep pos=0 and their sampled tokens are ignored.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
from collections import deque
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from zgml.runtime.profile import global_profile
from zgml.runtime.sampling import SamplingParams, sample


@dataclasses.dataclass
class Request:
    prompt: list[int]
    max_new_tokens: int
    stop_ids: tuple[int, ...] = ()
    rid: int = -1
    output: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # [V] logits of the prompt's last token, left on the device (the first
    # output token is sampled from them)
    prefill_logits: Any = None


@dataclasses.dataclass
class _Prefill:
    """A request whose prompt is being prefilled chunk-by-chunk into its
    reserved slot (interleaved with decode steps)."""
    req: Request
    slot: int
    pos: int = 0                 # prompt tokens written so far


class ContinuousBatchingEngine:
    """Single-host by default; pass `mesh` (axes 'dp','tp') to serve a
    TENSOR-PARALLEL-sharded model with slots sharded over 'dp' — the decode
    step, burst scan and chunked prefill all run inside shard_map so psum /
    all_gather ride the mesh (BASELINE configs 4-5; no reference counterpart).

    dp slot sharding: each dp shard owns max_batch/dp slot rows PLUS one
    scratch row. A prefill chunk is SPMD — every shard runs the same batch-1
    forward, but only the owner shard's dynamic_update_slice lands in its
    real local row; the other shards dump the identical write into their
    scratch row (same trick as the dead-position decode write below, spent
    on a row instead of a position). model.params must already be sharded
    (shard_llama_params).
    """

    def __init__(self, model, max_batch: int = 8, prefill_chunk: int = 128,
                 cache_dtype=jnp.bfloat16,
                 sampling: SamplingParams = SamplingParams(),
                 mesh=None):
        self.model = model
        self.cfg = model.cfg
        self.max_batch = max_batch
        self.sampling = sampling
        self.mesh = mesh
        if mesh is not None:
            self.dp = int(mesh.shape.get("dp", 1))
            self.tp = int(mesh.shape.get("tp", 1))
            if max_batch % self.dp:
                raise ValueError(f"max_batch={max_batch} not divisible by "
                                 f"dp={self.dp}")
            self._b_loc = max_batch // self.dp      # real rows per dp shard
            n_phys = max_batch + self.dp            # + one scratch row each
        else:
            self.dp = self.tp = 1
            self._b_loc = max_batch
            n_phys = max_batch
        self._n_phys = n_phys
        # per-layer list cache: serving's cache_row/write_pos slot paths
        # route through the unrolled forward branch
        self.cache = model.init_cache(n_phys, cache_dtype, layout="unrolled")
        self.prefill_chunk = min(prefill_chunk, self.cfg.max_seq_len)
        self._staging_cache_dtype = cache_dtype
        self.pos = np.zeros(n_phys, np.int64)
        self.slots: list[Request | None] = [None] * max_batch
        self.last_tok = np.zeros(n_phys, np.int32)
        self.waiting: deque[Request] = deque()
        self.requests: dict[int, Request] = {}   # rid -> request (registry)
        self._ids = itertools.count()
        self.key = jax.random.PRNGKey(0)

        dead_pos = self.cfg.max_seq_len - 1   # never-live dump position

        def _prefill_slot_fn(params, tokens, cache, slot, pos, n_valid,
                             tp_axis=None, tp_size=1, dp_axis=None):
            """One prefill chunk written straight into slot `slot`'s rows of
            the shared cache (kv_row path — no staging cache)."""
            if dp_axis is not None:
                # localize the global slot row; non-owners hit their scratch
                # row (local index b_loc) instead
                shard = jax.lax.axis_index(dp_axis)
                row = slot - shard * (self._b_loc + 1)
                owner = (row >= 0) & (row < self._b_loc)
                slot = jnp.where(owner, row, self._b_loc)
            logits, cache = model.forward(params, tokens, cache, pos,
                                          cache_row=slot, tp_axis=tp_axis,
                                          tp_size=tp_size)
            return logits[:, n_valid - 1], cache

        def _decode_fn(params, tokens, cache, pos_vec, active, key,
                       tp_axis=None, tp_size=1):
            # inactive/prefilling slots dump their garbage K/V write at the
            # dead last position so they can't clobber a mid-prefill row
            wpos = jnp.where(active, pos_vec, dead_pos)
            logits, cache = model.forward(params, tokens, cache, pos_vec,
                                          write_pos=wpos, tp_axis=tp_axis,
                                          tp_size=tp_size)
            tok = sample(logits[:, -1], self.sampling, key)
            return tok, cache

        def _decode_burst_fn(params, tok0, cache, pos_vec, active, key, n,
                             tp_axis=None, tp_size=1):
            def body(carry, _):
                tok, cache, pos, key = carry
                wpos = jnp.where(active, pos, dead_pos)
                logits, cache = model.forward(params, tok[:, None], cache,
                                              pos, write_pos=wpos,
                                              tp_axis=tp_axis,
                                              tp_size=tp_size)
                key, sub = jax.random.split(key)
                nxt = sample(logits[:, -1], self.sampling, sub)
                return (nxt, cache, pos + 1, key), nxt

            (tok, cache, pos, key), toks = jax.lax.scan(
                body, (tok0, cache, pos_vec, key), length=n)
            return toks, cache           # toks: [n, B]

        if mesh is None:
            self._prefill_slot = jax.jit(_prefill_slot_fn,
                                         donate_argnums=(2,))
            self._decode = jax.jit(_decode_fn, donate_argnums=(2,))
            self._decode_burst = jax.jit(
                functools.partial(_decode_burst_fn),
                static_argnames=("n",), donate_argnums=(2,))
        else:
            from jax.sharding import PartitionSpec as P
            from zgml.parallel.tp import (llama_param_specs, shard_map)
            pspecs = llama_param_specs(model.params)
            if isinstance(model.params["layers"], (list, tuple)):
                n_l = len(model.params["layers"])
                cspecs = {"k": [P("dp", "tp", None, None)] * n_l,
                          "v": [P("dp", "tp", None, None)] * n_l}
            else:
                from zgml.parallel.tp import cache_specs
                cspecs = cache_specs()
            tp_kw = dict(tp_axis="tp" if self.tp > 1 else None,
                         tp_size=self.tp)

            self._prefill_slot = jax.jit(shard_map(
                functools.partial(_prefill_slot_fn, dp_axis="dp", **tp_kw),
                mesh=mesh,
                in_specs=(pspecs, P(None, None), cspecs, P(), P(), P()),
                out_specs=(P(None, None), cspecs)), donate_argnums=(2,))
            self._decode = jax.jit(shard_map(
                functools.partial(_decode_fn, **tp_kw), mesh=mesh,
                in_specs=(pspecs, P("dp", None), cspecs, P("dp"), P("dp"),
                          P()),
                out_specs=(P("dp"), cspecs)), donate_argnums=(2,))

            def _burst(params, tok0, cache, pos_vec, active, key, n):
                return shard_map(
                    functools.partial(_decode_burst_fn, n=n, **tp_kw),
                    mesh=mesh,
                    in_specs=(pspecs, P("dp"), cspecs, P("dp"), P("dp"),
                              P()),
                    out_specs=(P(None, "dp"), cspecs))(
                        params, tok0, cache, pos_vec, active, key)

            self._decode_burst = jax.jit(_burst, static_argnames=("n",),
                                         donate_argnums=(2,))
        self.prefilling: deque = deque()   # _Prefill entries, FIFO

    def _phys(self, slot: int) -> int:
        """Logical slot -> physical cache row (skips dp scratch rows)."""
        if self.mesh is None:
            return slot
        return (slot // self._b_loc) * (self._b_loc + 1) + slot % self._b_loc

    # -- public api ----------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int,
               stop_ids: tuple[int, ...] = ()) -> int:
        prompt = list(prompt)
        # a prompt longer than the cache would silently clamp the DUS start
        # and corrupt the cache tail; reject like LlamaEngine.prefill
        # (ref: error.SequenceTooLong, llama_inference.zig:682)
        if len(prompt) + 1 > self.cfg.max_seq_len:
            raise ValueError(
                f"SequenceTooLong: prompt {len(prompt)} + 1 exceeds "
                f"max_seq_len {self.cfg.max_seq_len}")
        req = Request(prompt, max_new_tokens, stop_ids,
                      rid=next(self._ids))
        self.waiting.append(req)
        self.requests[req.rid] = req
        return req.rid

    def _free_slot(self) -> int | None:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    def _admit(self):
        """Assign free slots to waiting requests (prefill happens chunkwise
        in _advance_prefill, interleaved with decode steps)."""
        reserved = {p.slot for p in self.prefilling}
        while self.waiting:
            slot = next((i for i, s in enumerate(self.slots)
                         if s is None and i not in reserved), None)
            if slot is None:
                return
            req = self.waiting.popleft()
            self.prefilling.append(_Prefill(req, slot))
            reserved.add(slot)

    def _advance_prefill(self, max_chunks: int = 1):
        """Advance pending prefills by up to `max_chunks` chunks total —
        the admission work done between two decode steps."""
        chunk = self.prefill_chunk
        for _ in range(max_chunks):
            if not self.prefilling:
                return
            p = self.prefilling[0]
            toks = np.asarray(p.req.prompt, np.int32)[None, p.pos:p.pos + chunk]
            n_valid = toks.shape[1]
            if n_valid < chunk:
                toks = np.pad(toks, ((0, 0), (0, chunk - n_valid)))
            with global_profile.phase("serve_prefill"):
                last, self.cache = self._prefill_slot(
                    self.model.params, jnp.asarray(toks), self.cache,
                    self._phys(p.slot), p.pos, n_valid)
            p.pos += n_valid
            if p.pos >= len(p.req.prompt):        # prefill complete
                self.prefilling.popleft()
                p.req.prefill_logits = last[0]
                self.key, sub = jax.random.split(self.key)
                first = sample(last, self.sampling, sub)
                p.req.output.append(int(first[0]))
                ph = self._phys(p.slot)
                self.slots[p.slot] = p.req
                self.pos[ph] = p.pos
                self.last_tok[ph] = p.req.output[-1]
                self._maybe_finish(p.slot)

    def _maybe_finish(self, slot: int):
        req = self.slots[slot]
        if req is None:
            return
        if (len(req.output) >= req.max_new_tokens
                or (req.output and req.output[-1] in req.stop_ids)
                or self.pos[self._phys(slot)] + 1 >= self.cfg.max_seq_len):
            req.done = True
            self.slots[slot] = None
            self.pos[self._phys(slot)] = 0

    def step(self) -> list[tuple[int, int]]:
        """Admit + one prefill chunk + one batched decode step; returns
        (rid, token) emissions."""
        self._admit()
        self._advance_prefill()
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            return []
        self.key, sub = jax.random.split(self.key)
        with global_profile.phase("serve_decode"):
            mask = np.zeros(self._n_phys, bool)
            mask[[self._phys(i) for i in active]] = True
            tok, self.cache = self._decode(
                self.model.params,
                jnp.asarray(self.last_tok[:, None]),
                self.cache,
                jnp.asarray(self.pos, jnp.int32),
                jnp.asarray(mask),
                sub)
        tok_host = np.asarray(tok)
        out = []
        for i in active:
            ph = self._phys(i)
            req = self.slots[i]
            t = int(tok_host[ph])
            req.output.append(t)
            self.pos[ph] += 1
            self.last_tok[ph] = t
            out.append((req.rid, t))
            self._maybe_finish(i)
        global_profile.add("serve_decode_tokens", len(active))
        return out

    def step_burst(self, n: int) -> list[tuple[int, int]]:
        """Like step() but decodes `n` tokens in ONE device dispatch.

        Used when no admissions are pending: the host syncs once per burst
        instead of per token. Slots that hit a stop id or their token budget
        mid-burst get their overshoot truncated on the host (the garbage KV
        beyond their stop is never read again: the slot is freed and its next
        occupant prefills from position 0)."""
        self._admit()
        self._advance_prefill()
        if self.prefilling or self.waiting:
            return self.step()              # fall back to stepwise interleave
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            return []
        n = min(n, *(s.max_new_tokens - len(s.output)
                     for s in self.slots if s is not None),
                int(self.cfg.max_seq_len - 1 - max(self.pos[self._phys(i)]
                                                   for i in active)))
        if n < 1:
            return self.step()
        n = 1 << (n.bit_length() - 1)   # pow2 buckets: one compile per size
        self.key, sub = jax.random.split(self.key)
        with global_profile.phase("serve_decode"):
            mask = np.zeros(self._n_phys, bool)
            mask[[self._phys(i) for i in active]] = True
            toks, self.cache = self._decode_burst(
                self.model.params, jnp.asarray(self.last_tok), self.cache,
                jnp.asarray(self.pos, jnp.int32), jnp.asarray(mask), sub, n=n)
        toks_host = np.asarray(toks)        # [n, B]
        out = []
        for i in active:
            ph = self._phys(i)
            req = self.slots[i]
            for step_i in range(n):
                t = int(toks_host[step_i, ph])
                req.output.append(t)
                self.pos[ph] += 1
                self.last_tok[ph] = t
                out.append((req.rid, t))
                if (len(req.output) >= req.max_new_tokens
                        or t in req.stop_ids):
                    break                   # truncate overshoot
            self._maybe_finish(i)
        global_profile.add("serve_decode_tokens", len(out))
        return out

    def run(self, requests: list[tuple[list[int], int]],
            burst: int = 1) -> dict[int, list[int]]:
        """Drain a list of (prompt, max_new_tokens); returns rid -> output.

        burst > 1 decodes that many tokens per dispatch once admissions have
        drained (multi-token emission; exact for greedy/sampled streams,
        stop-token overshoot is truncated)."""
        reqs = {self.submit(p, n): None for p, n in requests}
        results: dict[int, list[int]] = {}
        all_reqs: dict[int, Request] = {}
        pending = list(self.waiting)
        for r in pending:
            all_reqs[r.rid] = r
        while (self.waiting or self.prefilling
               or any(s is not None for s in self.slots)):
            if burst > 1:
                self.step_burst(burst)
            else:
                self.step()
        for rid, req in all_reqs.items():
            results[rid] = req.output
        return {rid: results[rid] for rid in reqs}
