"""Fusion pass: detect elementwise chains and composite patterns in a topo graph.

The analog of the reference's FusionDetector (src/fusion.zig:17-596): a single
pass over the topo node list doing maximal-munch pattern matching directly on
the tensor graph, then greedy elementwise-chain detection with single-consumer
legality. Detected chains lower to one jnp expression; composite patterns
(log-softmax decomposition, cross-entropy) collapse to single composite nodes.

XLA already fuses elementwise neighbors into one kernel, so the pass exists
for capability parity and for its diagnostics (FusionReport — the
NodeReport analog, graph.zig:358-728).
"""
from __future__ import annotations

import dataclasses

from zgml.graph.op import Op
from zgml.graph.tensor import LazyTensor


@dataclasses.dataclass
class Chain:
    """A fusible elementwise chain: nodes[0] is the chain head (its first src
    is the chain input), each later node consumes the previous."""
    nodes: list[LazyTensor]

    @property
    def output(self) -> LazyTensor:
        return self.nodes[-1]


@dataclasses.dataclass
class FusionReport:
    """Diagnostics: what fused, what did not and why (ref: FusionRegionReport
    per-node fusibility disposition, graph.zig:358-728)."""
    chains: list[Chain] = dataclasses.field(default_factory=list)
    rejected: dict[int, str] = dataclasses.field(default_factory=dict)

    def render(self) -> str:
        lines = [f"== fusion report: {len(self.chains)} chains =="]
        for c in self.chains:
            lines.append("  chain: " + " -> ".join(n.op.value for n in c.nodes))
        for nid, why in self.rejected.items():
            lines.append(f"  not fused #{nid}: {why}")
        return "\n".join(lines)


def _consumers(order: list[LazyTensor]) -> dict[int, list[LazyTensor]]:
    out: dict[int, list[LazyTensor]] = {}
    for n in order:
        for s in n.srcs:
            out.setdefault(s.id, []).append(n)
    return out


def detect_chains(order: list[LazyTensor],
                  outputs: set[int]) -> FusionReport:
    """Greedy maximal elementwise chains (ref: fusion.zig:408-455).

    Legality: every interior node is elementwise-fusible, has exactly one
    consumer (the next chain node), same shape as the chain head (no broadcast
    mid-chain), and is not itself a requested graph output.
    """
    consumers = _consumers(order)
    report = FusionReport()
    in_chain: set[int] = set()

    for node in order:
        if node.id in in_chain or not node.op.is_fusible:
            continue
        # try to grow a chain starting here
        chain = [node]
        cur = node
        while True:
            cons = consumers.get(cur.id, [])
            if len(cons) != 1:
                if len(cons) > 1:
                    report.rejected[cur.id] = "multiple consumers"
                break
            nxt = cons[0]
            if not nxt.op.is_fusible:
                break
            if nxt.shape != node.shape:
                report.rejected[nxt.id] = "shape change in chain"
                break
            if cur.id in outputs:
                report.rejected[cur.id] = "graph output mid-chain"
                break
            # for binary next-ops, the other operand must not depend on the
            # chain (it is a side input); LazyTensor graphs are DAGs built
            # bottom-up, so an id check suffices
            if nxt.op.is_binary_elementwise:
                other = [s for s in nxt.srcs if s.id != cur.id]
                if any(o.id in in_chain or o in chain for o in other):
                    report.rejected[nxt.id] = "operand inside chain"
                    break
            chain.append(nxt)
            cur = nxt
        if len(chain) >= 2:
            report.chains.append(Chain(chain))
            in_chain.update(n.id for n in chain)
    return report
