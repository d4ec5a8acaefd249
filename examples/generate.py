#!/usr/bin/env python
"""Minimal end-to-end example: build/load a quantized llama GGUF and generate
(ref: scripts/generate_llama.zig). Works standalone in the zero-egress env by
synthesizing a model on first run."""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from zgml.io.gguf import GGMLType                      # noqa: E402
from zgml.io.llama_loader import load_llama            # noqa: E402
from zgml.runtime.engine import LlamaEngine            # noqa: E402
from zgml.runtime.sampling import SamplingParams       # noqa: E402
from zgml.utils.synthetic import (TINY_TEST,           # noqa: E402
                                      write_synthetic_llama_gguf)

path = sys.argv[1] if len(sys.argv) > 1 else "/tmp/example_llama_q8.gguf"
if not os.path.exists(path):
    print(f"synthesizing {path} ...")
    write_synthetic_llama_gguf(path, TINY_TEST, GGMLType.Q8_0, seed=0)

model, gf = load_llama(path, mode="quantized")   # weights stay block-quantized
print(f"loaded {model.cfg}")

eng = LlamaEngine(model, cache_dtype="int8",
                  sampling=SamplingParams(temperature=0.8, top_k=40))
prompt = [1, 2, 3, 4]
out = eng.generate(prompt, max_new_tokens=16)
print("prompt:", prompt)
print("generated:", out)
