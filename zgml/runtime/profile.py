"""Runtime profiling counters — the "no silent fallback" discipline.

The reference requires fast paths to be visible in profiles so a CPU fallback
"cannot masquerade as GPU parity" (perf-targets.md:52-54, 224; RuntimeProfile
src/profile.zig:820-910). Here: every dispatched op records its tier
(triton / interpret / cudnn / xla / ref) at *trace* time, plus wall-clock phase timers for the
engine. jax.profiler traces cover per-kernel device timing; these counters cover
placement accounting.
"""
from __future__ import annotations

import collections
import contextlib
import time


class RuntimeProfile:
    def __init__(self):
        self.op_tiers = collections.Counter()      # (op, tier) -> trace-time count
        self.phase_ns = collections.Counter()      # phase -> wall ns
        self.phase_calls = collections.Counter()
        self.counters = collections.Counter()      # free-form (tokens, steps...)

    def count_op(self, op: str, tier: str, n: int = 1):
        self.op_tiers[(op, tier)] += n

    def add(self, counter: str, n: int = 1):
        self.counters[counter] += n

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.phase_ns[name] += time.perf_counter_ns() - t0
            self.phase_calls[name] += 1

    def reset(self):
        self.op_tiers.clear()
        self.phase_ns.clear()
        self.phase_calls.clear()
        self.counters.clear()

    # -- reporting ----------------------------------------------------------
    def tier_summary(self) -> dict:
        """op -> {tier: count}; an oracle (ref) or interpreted entry for a hot
        op on the card is a visible fallback, not a silent one."""
        out: dict[str, dict[str, int]] = {}
        for (op, tier), n in sorted(self.op_tiers.items()):
            out.setdefault(op, {})[tier] = n
        return out

    def render(self) -> str:
        lines = ["== op placement (trace-time counts) =="]
        for op, tiers in self.tier_summary().items():
            lines.append(f"  {op:<20} " +
                         "  ".join(f"{t}={n}" for t, n in tiers.items()))
        if self.phase_ns:
            lines.append("== phases ==")
            for name, ns in sorted(self.phase_ns.items()):
                calls = self.phase_calls[name]
                lines.append(f"  {name:<20} {ns/1e6:10.2f} ms total"
                             f"  {ns/1e6/max(1,calls):8.3f} ms/call  x{calls}")
        if self.counters:
            lines.append("== counters ==")
            for name, n in sorted(self.counters.items()):
                lines.append(f"  {name:<20} {n}")
        return "\n".join(lines)


global_profile = RuntimeProfile()


def profile_program(fn, *args, **kwargs) -> dict:
    """Static program profile: trace `fn` and census its primitive ops and
    array traffic — the analog of the reference's profileProgram
    (src/profile.zig:72-167: op-tag counts, buffer bytes, placement).

    Returns {op_counts, n_eqns, input_bytes, output_bytes, custom_calls}.
    """
    import jax

    closed = jax.make_jaxpr(fn)(*args, **kwargs)

    op_counts: collections.Counter = collections.Counter()
    custom_calls = 0

    def walk(jaxpr):
        nonlocal custom_calls
        for eqn in jaxpr.eqns:
            op_counts[eqn.primitive.name] += 1
            if "pallas" in eqn.primitive.name or "custom_call" in eqn.primitive.name:
                custom_calls += 1
            for sub in jax.core.jaxprs_in_params(eqn.params) \
                    if hasattr(jax.core, "jaxprs_in_params") else []:
                walk(sub)
            # common nested-jaxpr params
            for key in ("jaxpr", "call_jaxpr", "branches", "cond_jaxpr",
                        "body_jaxpr"):
                sub = eqn.params.get(key)
                if sub is None:
                    continue
                subs = sub if isinstance(sub, (list, tuple)) else [sub]
                for s in subs:
                    inner = getattr(s, "jaxpr", s)
                    if hasattr(inner, "eqns"):
                        walk(inner)

    walk(closed.jaxpr)

    def tree_bytes(avals):
        return sum(int(a.size) * a.dtype.itemsize for a in avals
                   if hasattr(a, "size"))

    return {
        "op_counts": dict(op_counts.most_common()),
        "n_eqns": sum(op_counts.values()),
        "custom_calls": custom_calls,
        "input_bytes": tree_bytes(closed.in_avals),
        "output_bytes": tree_bytes(closed.out_avals),
    }
