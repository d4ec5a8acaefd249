"""Device mesh construction for (dp, tp) sharding.

The reference is single-host with zero distributed execution (SURVEY.md §2.7);
this layer is the new multi-device dimension: a 2-D mesh with an outer 'dp'
(batch) axis and an inner 'tp' axis. The cards of one host reach each other
all to all at one rate, so the mesh follows the algorithm alone: devices are
laid out in the order given.
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(tp: int | None = None, dp: int | None = None,
              devices=None, axis_names=("dp", "tp")) -> Mesh:
    """Build a 2-D mesh over the given (default: all) devices.

    tp defaults to all devices (pure tensor parallelism). axis_names renames
    the axes (e.g. ("dp", "pp") for pipeline stages).
    """
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if tp is None and dp is None:
        tp, dp = n, 1
    elif tp is None:
        tp = n // dp
    elif dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp*tp={dp * tp} != {n} devices")
    arr = np.array(devices).reshape(dp, tp)
    return Mesh(arr, tuple(axis_names))


def multihost_init(coordinator: str | None = None, num_processes: int | None = None,
                   process_id: int | None = None):
    """Initialize multi-host JAX.

    A thin wrapper so serving entrypoints have one call; on a single host it is
    a no-op.
    """
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)
