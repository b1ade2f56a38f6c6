"""Device-mesh construction for sharded rendering.

The film plane (rays) is the data-parallel axis and samples-per-pixel is
the second axis — the path-tracing analogues of DP and "sequence"
parallelism (SURVEY.md §5: rays are embarrassingly parallel; scene/BVH
replicated; the only collectives are the sample-axis XYZ reduction in
forward and parameter-gradient psum in backward, which XLA hands to
NCCL over NVLink on a GPU host).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

DP_AXIS = "dp"  # film-plane rows
SP_AXIS = "sp"  # samples per pixel


def make_mesh(devices: Optional[Sequence] = None,
              shape: Optional[tuple] = None) -> Mesh:
    """(dp, sp) mesh over the given devices.

    Default shape puts everything on dp (pure film sharding) unless the
    device count has a factor of 2 to give sp.
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if shape is None:
        sp = 2 if n % 2 == 0 and n > 1 else 1
        shape = (n // sp, sp)
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} != device count {n}")
    arr = np.asarray(devices).reshape(shape)
    return Mesh(arr, (DP_AXIS, SP_AXIS))


def pad_to_multiple(x: int, m: int) -> int:
    return m * math.ceil(x / m)
