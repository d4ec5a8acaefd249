"""zgml — a quantized ML framework on JAX (capability target: candrewlee14/zgml).

Built from scratch on JAX/XLA/Pallas. The reference (zgml) is a single-host
Zig/CPU/Metal framework; this package re-designs its capability set for an
NVIDIA GPU:

- ``zgml.quant``   — ggml-style block quantization (Q4_0/Q8_0) codecs, planar
                         repack, quantized KV cache. (ref: src/quant.zig, src/models/gguf_loader.zig)
- ``zgml.io``      — GGUF parse/write, safetensors, checkpoints, GPT-2 BPE tokenizer.
                         (ref: src/gguf.zig, src/safetensors.zig, src/tokenizer.zig)
- ``zgml.ops``     — the weight-only quantized matmul kernel (Pallas, Triton route),
                         decode/prefill attention, and pure-jnp reference oracles.
                         (ref: src/tensor/forward.zig, src/backend/*)
- ``zgml.graph``   — small primitive-op graph IR with a fusion pass, lowered to
                         jitted JAX. (ref: src/op.zig, src/graph.zig, src/fusion.zig)
- ``zgml.models``  — llama-family, GPT-2, Whisper, demo models as functional
                         param-pytree modules. (ref: src/models/*)
- ``zgml.nn``      — layers, losses, initializers. (ref: src/nn.zig, src/loss.zig)
- ``zgml.optim``   — SGD/Adam/AdamW. (ref: src/optim/*)
- ``zgml.runtime`` — inference engine (prefill/decode plans, sampling, continuous
                         batching), profiling. (ref: src/llama_inference.zig, src/llm.zig)
- ``zgml.parallel``— mesh/sharding/collectives: the multi-chip dimension the
                         reference does not have (SURVEY.md §2.7).
- ``zgml.data``    — MNIST/dataloader. (ref: src/data/*)
"""

__version__ = "0.1.0"


def _enable_compilation_cache():
    """Persistent compilation cache, so a second process skips compiles.

    JAX_COMPILATION_CACHE_DIR, when set, is JAX's own and is left as it is;
    otherwise the cache goes to `.jax_cache` at the checkout's root
    (config.compile_cache_dir). CPU-only processes (the tests) keep no
    cache: XLA:CPU executables bake in the host's CPU features, and the
    test workers would race on the same entries. A failure to set the cache
    up is logged and the process continues without it."""
    import logging
    import os

    import jax
    from zgml import config
    if "cpu" in config.requested_platforms():
        return
    try:
        if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
            path = config.compile_cache_dir()
            os.makedirs(path, exist_ok=True)
            jax.config.update("jax_compilation_cache_dir", path)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    except (OSError, ValueError) as e:
        logging.getLogger(__name__).warning(
            "persistent compilation cache not set up: %s", e)


_enable_compilation_cache()

from zgml import quant, io, ops  # noqa: F401,E402
