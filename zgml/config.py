"""Central runtime configuration — the one audited surface for every
environment read (the analog of the reference's `Capabilities` object,
src/backend.zig:14-111: one place declares what the backend does; callers
never probe ad hoc).

Every ZGML_* read in the package goes through this module (enforced by
test_graph.test_env_reads_centralized). Flags are read live rather than
frozen at import, so a measurement script can set one, build an engine,
and compare it with an engine built without it in the same process;
`snapshot()` returns the resolved values for benchmark headers.

Toggle inventory (env var -> accessor -> effect):
  ZGML_KERNELS=ref           kernels_ref()      route ALL ops to the float32 oracle
  ZGML_KERNELS_DISABLE=a,b   kernels_disabled() send the named ops to plain XLA (A/B)
  ZGML_NATIVE=0              native()           disable the C++ host library
  ZGML_TP_BARRIER=1          tp_barrier()       serialize TP collectives (overlap A/B)
  JAX_COMPILATION_CACHE_DIR      compile_cache_dir() persistent compilation cache
"""
from __future__ import annotations

import os

# the directory holding the zgml package: a source checkout's root
_CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _get(name: str, default: str) -> str:
    return os.environ.get(name, default)


def _flag(name: str, default: str) -> bool:
    return _get(name, default) != "0"


def _names(name: str) -> frozenset[str]:
    raw = _get(name, "")
    return frozenset(s.strip() for s in raw.split(",") if s.strip())


def kernels_ref() -> bool:
    """True: every op dispatches to the jnp oracle tier."""
    return _get("ZGML_KERNELS", "kernel") == "ref"


def kernels_disabled() -> frozenset[str]:
    return _names("ZGML_KERNELS_DISABLE")


def native() -> bool:
    return _flag("ZGML_NATIVE", "1")


def tp_barrier() -> bool:
    """Pin every TP collective behind optimization_barriers (A/B measurement
    of collective/compute overlap, tools/bench_overlap.py). Default off:
    XLA's latency-hiding scheduler is free to overlap psum/all_gather with
    independent compute."""
    return _get("ZGML_TP_BARRIER", "0") == "1"


def requested_platforms() -> str:
    """JAX_PLATFORMS as the process was started with ('' = JAX decides)."""
    return _get("JAX_PLATFORMS", "").lower()


def compile_cache_dir() -> str:
    """Where compiled executables persist: JAX_COMPILATION_CACHE_DIR when
    set (JAX reads it itself), else `.jax_cache` at the checkout's root — a
    fixed path, since the path is part of every cache key."""
    return _get("JAX_COMPILATION_CACHE_DIR", "") or os.path.join(
        _CHECKOUT, ".jax_cache")


def snapshot() -> dict:
    """Fully resolved flag values for bench headers / reproducibility."""
    return {
        "kernels": "ref" if kernels_ref() else "kernel",
        "kernels_disable": sorted(kernels_disabled()),
        "native": native(),
        "tp_barrier": tp_barrier(),
        "compile_cache_dir": compile_cache_dir(),
    }
