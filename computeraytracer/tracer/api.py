"""User-facing render API.

The reference's "API" is: edit the scene JSON, reload the browser page
(SURVEY.md §1). Here it becomes a function: render(scene, config) returns
the accumulated/mean XYZ and the tonemapped sRGB image; progressive
refinement is spp accumulation with the same 1-based sample counter the
reference maintains in its UpdateVariables pass.

cfg.kernel picks the tracer: "xla", which traces scenes of more than
bvh.builder.BVH_MIN_PRIMS primitives through the skip-link BVH built
here from the concrete scene, "triton", the forward megakernel (GPU
only), or "auto" (the default, resolve_kernel). The result names the
tracer it used.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp

from computeraytracer.bvh import builder as bvh_builder
from computeraytracer.config import RenderConfig
from computeraytracer.ops import color
from computeraytracer.tracer import xla as xla_tracer

# Paths per call from which the megakernel's compile is paid back on the
# H100 at the Cornell box: it compiles in ~55 s per process (the
# persistent cache does not keep it) against ~9 s for the XLA tracer,
# and then runs at ~470 against ~16.6 Mpaths/s, so it wins from
# 46 s / (1/16.6 - 1/470 Mpaths/s) ~ 7.8e8 paths, ~750 spp at 1024^2
# (PERF.md, "Kernel decisions").
TRITON_MIN_PATHS = 780_000_000


def resolve_kernel(scene, kernel: str, paths: int) -> str:
    """"auto" -> "triton" on a GPU when the megakernel unrolls the scene
    and the call traces at least TRITON_MIN_PATHS paths, else "xla"; an
    explicit kernel is returned unchanged."""
    if kernel != "auto":
        return kernel
    from computeraytracer.kernels import megakernel as mk

    n = int(jnp.shape(scene.primitives.category)[0])
    if (jax.default_backend() == "gpu" and n <= mk.MAX_UNROLLED_PRIMS
            and paths >= TRITON_MIN_PATHS):
        return "triton"
    return "xla"


def render_sample(scene, width, height, sample, max_depth=8, rr_start=1,
                  kernel: str = "xla", bvh=None):
    """One progressive sample -> XYZ (H, W, 3)."""
    if kernel == "xla":
        return xla_tracer.render_sample(scene, width, height, sample,
                                        max_depth, rr_start, bvh=bvh)
    if kernel == "triton":
        from computeraytracer.tracer import pallas as pallas_tracer
        return pallas_tracer.render_sample(scene, width, height, sample,
                                           max_depth, rr_start)
    raise ValueError(f"unknown kernel {kernel!r}")


@functools.partial(jax.jit, static_argnames=(
    "width", "height", "tile_h", "spp", "max_depth", "rr_start", "static",
    "interpret"))
def _band_accumulate(scene, bvh, y0, first_sample, *, width, height,
                     tile_h, spp, max_depth, rr_start, static, interpret):
    """Accumulate spp samples for film rows [y0, y0+tile_h) through the
    XLA tracer (static None) or the megakernel built for `static`."""
    px, py = xla_tracer.tile_coords(width, tile_h, y0)

    def body(acc, s):
        if static is None:
            xyz = xla_tracer.render_pixels(
                scene, width, height, px, py, s, max_depth, rr_start,
                bvh=bvh)
        else:
            from computeraytracer.tracer import pallas as pallas_tracer
            xyz = pallas_tracer.render_pixels(
                scene, width, height, px, py, s, max_depth, rr_start,
                static=static, interpret=interpret)
        return acc + xyz, None

    accum0 = jnp.zeros((tile_h * width, 3), jnp.float32)
    samples = first_sample + jnp.arange(spp, dtype=jnp.uint32)
    accum, _ = jax.lax.scan(body, accum0, samples)
    return accum.reshape(tile_h, width, 3)


def _render_accumulate_chunked(scene, cfg: RenderConfig, bvh, static=None,
                               interpret: bool = False):
    """Row-band chunked accumulation: peak live memory scales with
    ray_chunk instead of width*height — the lever large-film renders
    (BASELINE config 5's 2048^2) need on one card."""
    rows = max(1, cfg.ray_chunk // cfg.width)
    bands = []
    for y0 in range(0, cfg.height, rows):
        th = min(rows, cfg.height - y0)
        bands.append(_band_accumulate(
            scene, bvh, jnp.uint32(y0), jnp.uint32(cfg.first_sample),
            width=cfg.width, height=cfg.height, tile_h=th, spp=cfg.spp,
            max_depth=cfg.max_depth, rr_start=cfg.rr_start, static=static,
            interpret=interpret))
    return jnp.concatenate(bands, axis=0)


def render(scene, cfg: Optional[RenderConfig] = None, **overrides):
    """Render a scene. Returns dict with accum_xyz, mean_xyz, srgb."""
    cfg = (cfg or RenderConfig()).replace(**overrides)
    kernel = resolve_kernel(scene, cfg.kernel,
                            cfg.width * cfg.height * cfg.spp)
    if kernel == "triton":
        from computeraytracer.tracer import pallas as pallas_tracer
        if cfg.ray_chunk:
            accum = _render_accumulate_chunked(
                scene, cfg, None, pallas_tracer.SceneStatic.from_scene(scene))
        else:
            accum = pallas_tracer.render_accumulate(
                scene, cfg.width, cfg.height, cfg.spp, cfg.max_depth,
                cfg.rr_start, cfg.first_sample)
    elif kernel == "xla":
        bvh = bvh_builder.auto_bvh(scene)
        if cfg.ray_chunk:
            accum = _render_accumulate_chunked(scene, cfg, bvh)
        else:
            accum = xla_tracer.render_accumulate(
                scene, cfg.width, cfg.height, cfg.spp, cfg.max_depth,
                cfg.rr_start, cfg.first_sample, bvh=bvh)
    else:
        raise ValueError(f"unknown kernel {kernel!r}")
    # The reference divides the never-cleared accumulator by the sample
    # counter (wgsl:107-110).
    total = cfg.first_sample + cfg.spp - 1
    mean = accum / jnp.float32(total)
    return {
        "accum_xyz": accum,
        "mean_xyz": mean,
        "srgb": color.xyz_to_srgb(mean),
        "samples": total,
        "kernel": kernel,
    }
