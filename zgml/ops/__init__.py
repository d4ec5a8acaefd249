"""Compute ops: the GPU fast paths with pure-jnp reference oracles.

Every hot op has an oracle and a fast path with identical semantics:
  - ``zgml.ops.refs``      — pure jnp in float32 at HIGHEST precision (the
    conformance oracle; the analog of the reference executor,
    src/backend/reference.zig, SURVEY.md §4.4)
  - ``zgml.ops.qmatmul``   — the weight-only Q4_0/Q8_0 matmul kernel (Pallas,
    Triton route) and its plain-XLA form
  - ``zgml.ops.attention`` — decode attention (the JAX library's Triton
    kernel), cuDNN prefill attention, and a plain-XLA masked attention.

``zgml.ops.dispatch`` picks between them from the platform and the input, so
CPU tests (kernels interpreted) and GPU runs execute the same model code.
"""
from zgml.ops import refs  # noqa: F401
from zgml.ops.dispatch import (  # noqa: F401
    qmatmul, rmsnorm, rope_apply, flash_attention, decode_attention,
    platform, route,
)
