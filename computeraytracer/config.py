"""Typed render/train configuration.

The reference's only "config" is the scene JSON plus compile-time kernel
constants (MAXDEPTH=100, GRID_SIZE=16, lambda range 400-700nm at
reference/src/shaders/ComputeShader.wgsl:11-20). Here those become a
typed dataclass with CLI overrides; the scene JSON schema is unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


# Material enums — match the reference's typeIndexPairs
# (reference/src/main.js:166-170).
DIFFUSE = 0
LIGHT = 1
GLASS = 2
MIRROR = 3  # extension: perfect specular reflector (not in the reference)

# Spectral constants (ComputeShader.wgsl:15-17, main.js:334-336).
LAMBDA_MIN = 400.0
LAMBDA_MAX = 700.0
N_LAMBDA = 301  # 1nm resampling, 400..700 inclusive
N_HERO = 4  # hero-wavelength: 4 wavelengths per path
CIE_OFFSET = 40  # CIE tables start at 360nm; index 40 == 400nm
CIE_N = 471  # 360..830nm at 1nm
CIE_Y_INTEG = 106.856895  # normalization constant (ComputeShader.wgsl:422)

# Sub-pixel jitter strata (ComputeShader.wgsl:15).
GRID_SIZE = 16


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static configuration of one render.

    max_depth: maximum number of path vertices before forced termination.
        The reference uses 100 but Russian roulette terminates paths long
        before that; a fixed-trip bounce loop wants a small static
        bound (ComputeShader.wgsl:14, :279-289).
    """

    width: int = 256
    height: int = 256
    spp: int = 1
    max_depth: int = 8
    # Russian roulette from depth > rr_start (reference: depth > 1).
    rr_start: int = 1
    # Which tracer: "xla" (tracer/xla.py; scenes of more than
    # bvh.builder.BVH_MIN_PRIMS primitives go through the BVH), "triton"
    # (the forward megakernel, GPU only: ~25x the XLA rate once compiled,
    # but its compile costs about a minute per process) or "auto" (triton
    # on a GPU for small scenes and renders long enough to pay for that;
    # tracer/api.resolve_kernel).
    kernel: str = "auto"
    # Ray-batch chunk for memory control (0 = whole image at once).
    ray_chunk: int = 0
    # Starting sample index (progressive rendering / resume).
    first_sample: int = 1

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Configuration for gradient-based scene optimization (config 4)."""

    steps: int = 100
    learning_rate: float = 0.05
    spp_per_step: int = 4
    render: RenderConfig = dataclasses.field(default_factory=RenderConfig)
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 25
