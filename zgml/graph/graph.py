"""ComputeGraph: topo ordering, fusion, lowering to jitted JAX, autodiff.

The analog of src/graph.zig's ComputeGraph, re-based on the XLA compilation
model (SURVEY.md §7): graph capture -> topo order -> fusion pass -> lowered
pure function -> jax.jit (the execution plan) and jax.grad (buildBackward).
The reference hand-implements backward rules per op (src/tensor/backward.zig);
here the lowered function is differentiable by construction — including
attention, which the reference's backward cannot do (backward.zig:393-404).
"""
from __future__ import annotations

from typing import Any, Sequence

import jax
import jax.numpy as jnp

from zgml.graph.fusion import FusionReport, detect_chains
from zgml.graph.lower import BINARY_FNS, UNARY_FNS, lower_node
from zgml.graph.op import Op
from zgml.graph.tensor import LazyTensor


def topo_order(outputs: Sequence[LazyTensor]) -> list[LazyTensor]:
    """Parents-then-self DFS with a visited set (ref: addParentsThenSelf,
    graph.zig:1294-1312)."""
    seen: set[int] = set()
    order: list[LazyTensor] = []

    def visit(n: LazyTensor):
        if n.id in seen:
            return
        seen.add(n.id)
        for s in n.srcs:
            visit(s)
        order.append(n)

    for o in outputs:
        visit(o)
    return order


class ComputeGraph:
    """Build once, execute many times (the frozen-plan discipline,
    llama_inference.zig:51-149)."""

    def __init__(self, outputs: LazyTensor | Sequence[LazyTensor],
                 fuse: bool = True):
        self.outputs = ([outputs] if isinstance(outputs, LazyTensor)
                        else list(outputs))
        self.order = topo_order(self.outputs)
        self.vars = [n for n in self.order if n.op == Op.VAR]
        self.fusion: FusionReport | None = None
        if fuse:
            self.fusion = detect_chains(
                self.order, {o.id for o in self.outputs})
        self._fn = None
        self._jit = None

    # -- lowering ------------------------------------------------------------
    def _build_fn(self):
        order = self.order
        chains = self.fusion.chains if self.fusion else []
        chain_by_head: dict[int, Any] = {}
        interior: set[int] = set()
        for c in chains:
            chain_by_head[c.nodes[0].id] = c
            for n in c.nodes:
                interior.add(n.id)
            interior.discard(c.output.id)

        var_names = [v.name for v in self.vars]

        def fn(*args):
            if len(args) != len(var_names):
                raise TypeError(f"expected {len(var_names)} args "
                                f"({var_names}), got {len(args)}")
            vals: dict[int, Any] = {v.id: jnp.asarray(a)
                                    for v, a in zip(self.vars, args)}
            emitted_chain_output: dict[int, Any] = {}
            for node in order:
                if node.op == Op.VAR:
                    continue
                chain = chain_by_head.get(node.id)
                if chain is not None and len(chain.nodes) >= 2:
                    vals[chain.output.id] = self._emit_chain(chain, vals)
                    continue
                if node.id in interior:
                    continue  # computed as part of its chain
                if node.id in vals:
                    continue
                vals[node.id] = lower_node(node, vals)
            outs = [vals[o.id] for o in self.outputs]
            return outs[0] if len(outs) == 1 else tuple(outs)

        return fn

    @staticmethod
    def _emit_chain(chain, vals):
        """Lower a fused chain to one jnp expression; XLA fuses the chain
        into a single elementwise kernel."""
        head = chain.nodes[0]
        x = vals[head.srcs[0].id]
        steps = []
        sides = []
        first = True
        for node in chain.nodes:
            if node.op in UNARY_FNS:
                steps.append((UNARY_FNS[node.op], False))
            elif node.op == Op.SCALE:
                steps.append(((lambda p: lambda a: a * p)(node.payload), False))
            elif node.op == Op.ADD_SCALAR:
                steps.append(((lambda p: lambda a: a + p)(node.payload), False))
            elif node.op in BINARY_FNS:
                if first:
                    # head binary: second operand is a side input
                    other = vals[node.srcs[1].id]
                else:
                    other = [vals[s.id] for s in node.srcs
                             if s.id != prev_id][0]  # noqa: F821
                sides.append(other)
                steps.append((BINARY_FNS[node.op], True))
            else:  # pragma: no cover - detect_chains only admits the above
                raise NotImplementedError(node.op)
            prev_id = node.id  # noqa: F841
            first = False
        acc = x
        si = 0
        for f, takes in steps:
            if takes:
                acc = f(acc, jnp.broadcast_to(sides[si], acc.shape))
                si += 1
            else:
                acc = f(acc)
        return acc

    # -- public api ----------------------------------------------------------
    def compile(self):
        """jit the lowered function (the execution-plan build)."""
        if self._jit is None:
            self._fn = self._build_fn()
            self._jit = jax.jit(self._fn)
        return self._jit

    def run(self, **feeds):
        """Execute forward with named var bindings."""
        args = [feeds[v.name] for v in self.vars]
        return self.compile()(*args)

    def grad(self, wrt: Sequence[str]):
        """Gradient function of the (scalar) first output wrt named vars
        (buildBackward analog — via jax.grad on the lowered function)."""
        self.compile()
        idx = [i for i, v in enumerate(self.vars) if v.name in set(wrt)]
        g = jax.grad(self._fn, argnums=tuple(idx))
        names = [self.vars[i].name for i in idx]

        def grad_fn(**feeds):
            # every Pallas op in the lowering carries a custom VJP (flash
            # attention, qmatmul, fused chains), so jax.grad runs kernel-tier
            args = [feeds[v.name] for v in self.vars]
            gs = g(*args)
            return dict(zip(names, gs))

        return grad_fn

    def value_and_grad(self, wrt: Sequence[str]):
        self.compile()
        idx = [i for i, v in enumerate(self.vars) if v.name in set(wrt)]
        g = jax.value_and_grad(self._fn, argnums=tuple(idx))
        names = [self.vars[i].name for i in idx]

        def fn(**feeds):
            args = [feeds[v.name] for v in self.vars]
            val, gs = g(*args)
            return val, dict(zip(names, gs))

        return fn

    # -- diagnostics ---------------------------------------------------------
    def report(self) -> str:
        """Node census + fusion report (ref: NodeReport graph.zig:358-728)."""
        from collections import Counter
        ops = Counter(n.op.value for n in self.order)
        lines = [f"== graph: {len(self.order)} nodes, "
                 f"{len(self.vars)} vars, {len(self.outputs)} outputs =="]
        for op, cnt in ops.most_common():
            lines.append(f"  {op:<16} x{cnt}")
        if self.fusion:
            lines.append(self.fusion.render())
        return "\n".join(lines)

    def to_dot(self) -> str:
        """GraphViz export (ref: graph.zig:1313-1354)."""
        lines = ["digraph G {", "  rankdir=BT;"]
        for n in self.order:
            label = n.op.value + (f"\\n{n.name}" if n.name else "") + \
                f"\\n{n.shape}"
            shape = "box" if n.op in (Op.VAR, Op.CONST) else "ellipse"
            lines.append(f'  n{n.id} [label="{label}", shape={shape}];')
            for s in n.srcs:
                lines.append(f"  n{s.id} -> n{n.id};")
        lines.append("}")
        return "\n".join(lines)
