"""Ring attention: context-parallel causal attention over a sequence sharded
across the mesh.

No reference counterpart (SURVEY.md §5: sequence scaling "must come from
KV-cache sharding, blockwise flash attention, and optionally ring-attention
— new components"). This is the
blockwise-parallel ring formulation: each device owns a query block and its
KV shard; KV shards rotate around the ring via ppermute while each device
folds every visiting block into an online-softmax accumulator. Peak memory is
O(T/cp) per device.

The ring is plain jnp: lax.ppermute inside shard_map, testable on the
virtual CPU mesh; XLA hands the permutes to NCCL on GPUs.
"""
from __future__ import annotations


import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from zgml.parallel.tp import shard_map

NEG_INF = -1e30


def _ring_attention_local(q, k, v, axis_name: str, causal: bool = True):
    """Inside shard_map. q: [B, Hq, T_loc, d], k/v: [B, Hkv, T_loc, d] (this
    device's sequence shard); GQA-aware (Hq = n_rep * Hkv — the un-repeated
    KV rotates around the ring, so link traffic is Hkv-sized, not Hq-sized).
    Returns [B, Hq, T_loc, d]."""
    from zgml.runtime.profile import global_profile
    global_profile.count_op("ring_attention", "xla")
    cp = jax.lax.psum(1, axis_name)
    idx = jax.lax.axis_index(axis_name)
    b, hq, t_loc, d = q.shape
    hkv = k.shape[1]
    n_rep = hq // hkv
    scale = 1.0 / (d ** 0.5)
    qf = q.astype(jnp.float32).reshape(b, hkv, n_rep, t_loc, d)

    m0 = jnp.full((b, hkv, n_rep, t_loc, 1), NEG_INF, jnp.float32)
    l0 = jnp.zeros((b, hkv, n_rep, t_loc, 1), jnp.float32)
    acc0 = jnp.zeros((b, hkv, n_rep, t_loc, d), jnp.float32)

    def body(i, carry):
        k_cur, v_cur, m, l, acc = carry
        owner = (idx - i) % cp                       # whose KV block this is
        s = jnp.einsum("bhrqd,bhkd->bhrqk", qf,
                       k_cur.astype(jnp.float32)) * scale
        if causal:
            qi = jax.lax.broadcasted_iota(jnp.int32, (t_loc, t_loc), 0) \
                + idx * t_loc
            ki = jax.lax.broadcasted_iota(jnp.int32, (t_loc, t_loc), 1) \
                + owner * t_loc
            s = jnp.where((ki <= qi)[None, None, None], s, NEG_INF)
        m_new = jnp.maximum(m, jnp.max(s, axis=-1, keepdims=True))
        alpha = jnp.exp(m - m_new)
        p = jnp.exp(s - m_new)
        l = l * alpha + jnp.sum(p, axis=-1, keepdims=True)
        acc = acc * alpha + jnp.einsum("bhrqk,bhkd->bhrqd", p,
                                       v_cur.astype(jnp.float32))
        # rotate KV to the right neighbour
        perm = [(j, (j + 1) % cp) for j in range(cp)]
        k_nxt = jax.lax.ppermute(k_cur, axis_name, perm)
        v_nxt = jax.lax.ppermute(v_cur, axis_name, perm)
        return (k_nxt, v_nxt, m_new, l, acc)

    k_c, v_c, m, l, acc = jax.lax.fori_loop(
        0, cp, body, (k, v, m0, l0, acc0))
    safe = jnp.where(l > 0, l, 1.0)
    return (acc / safe).reshape(b, hq, t_loc, d).astype(q.dtype)


def make_ring_attention(mesh: Mesh, axis: str = "tp", causal: bool = True):
    """jit(shard_map) ring attention over sequence-sharded q/k/v
    [B, H, T, d] with T sharded along `axis`."""
    spec = P(None, None, axis, None)

    def fn(q, k, v):
        return _ring_attention_local(q, k, v, axis, causal)

    sm = shard_map(fn, mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec)
    return jax.jit(sm)
