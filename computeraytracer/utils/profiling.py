"""Tracing / profiling hooks (SURVEY.md §5 "Tracing / profiling").

The reference has no instrumentation at all — no timestamp queries, no
GPU profiling hooks (reference/src/main.js has only a vsync-tied
requestAnimationFrame loop at :620). This module exposes:

- :func:`trace` — an XProf/TensorBoard device trace of a code region
  (``jax.profiler.trace``), viewable with ``tensorboard --logdir`` or
  xprof; captures per-kernel device timelines including the Triton
  megakernel and XLA fusions.
- :func:`annotate` — named host annotations that show up inside a trace
  (``jax.profiler.TraceAnnotation``).
- :func:`roofline` — an analytic cost model of the path-tracing
  workload (FLOPs, HBM bytes, arithmetic intensity) and the implied
  speed-of-light time on a given device, so a measured wall time
  converts to a speed-of-light fraction — the BASELINE.md "fraction of
  speed-of-light" metric. Peaks come from DEVICE_PEAKS, keyed by
  jax's device_kind; a device that is not in the table is an error.

Wall-clock throughput counters (paths/s, rays/s) live in
``utils.metrics.RenderMeter``; this module is about *device-side*
visibility and analytic ceilings.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, asdict


@contextlib.contextmanager
def trace(logdir: str, host_tracer_level: int = 2):
    """Capture an XProf trace of the enclosed region into ``logdir``.

    Usage::

        with profiling.trace("/tmp/xprof"):
            img = render_sample(scene, ...)
            jax.block_until_ready(img)

    Remember to block on results *inside* the region — dispatch is
    async, and an un-synced region records only the host-side enqueue.
    """
    import jax

    with jax.profiler.trace(logdir, create_perfetto_trace=False):
        yield


def annotate(name: str):
    """Named region that appears on the host timeline of a trace."""
    import jax

    return jax.profiler.TraceAnnotation(name)


@dataclass(frozen=True)
class DevicePeaks:
    f32_tflops: float   # f32 FLOP/s outside the tensor cores, in TFLOP/s
    hbm_gbs: float      # device-memory bandwidth, GB/s
    source: str


# Path tracing is f32 vector work: the f32 rate outside the tensor cores
# is the relevant compute ceiling. Keyed by jax.Device.device_kind.
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": DevicePeaks(
        f32_tflops=67.0, hbm_gbs=3350.0,
        source="NVIDIA H100 Tensor Core GPU datasheet, SXM5, dense"),
}


@dataclass
class Roofline:
    flops: float            # total f32 vector FLOPs for the workload
    hbm_bytes: float        # HBM traffic (scene reads + film writes)
    intensity: float        # FLOPs / byte
    sol_compute_s: float    # time if f32-compute-bound at peak
    sol_memory_s: float     # time if HBM-bound at peak
    sol_s: float            # max of the two = speed-of-light time
    bound: str              # "compute" | "memory"

    def fraction(self, measured_s: float) -> float:
        """Speed-of-light fraction achieved by a measured wall time."""
        return self.sol_s / measured_s if measured_s > 0 else 0.0

    def to_dict(self) -> dict:
        return asdict(self)


def roofline(width: int, height: int, spp: int, max_depth: int,
             n_prims: int, peaks: DevicePeaks,
             mean_depth: float | None = None,
             backward: bool = False) -> Roofline:
    """Analytic cost model of the path-tracing workload.

    Per bounce each live path runs two full primitive scans (closest-hit
    + shadow, ComputeShader.wgsl:503-518 semantics) at roughly 60 f32
    ops per primitive test, plus ~400 ops of shading (NEE/MIS pdfs,
    Fresnel, hemisphere sampling, RNG). Russian roulette makes the
    effective depth ``mean_depth`` (~3 for the Cornell box when
    max_depth=8); pass it for a tighter bound, else max_depth is used.

    Memory traffic is modelled as one read of each path's inputs (ray,
    RNG state, per-wavelength spectra) and one write of its result, with
    the scene read from cache: the floor a fused kernel could reach,
    not what a bounce-by-bounce program moves. Under that model the
    workload is compute-bound (intensity >> ridge point).
    """
    paths = width * height * spp
    depth = mean_depth if mean_depth is not None else float(max_depth)
    ops_per_prim_test = 60.0
    ops_shading = 400.0
    flops = paths * depth * (2 * n_prims * ops_per_prim_test + ops_shading)
    # the 4 hero wavelengths are 4 lanes of real work (the WGSL vec4s)
    flops *= 4.0
    if backward:
        flops *= 3.0  # recomputed forward + reverse sweep ~ 3x forward

    # per path: (6 ray + 4 seed + 4 + 8*4 spectra) f32 in, 4 f32 out
    hbm_bytes = paths * (6 + 4 + 4 + 4 * 8) * 4.0

    sol_c = flops / (peaks.f32_tflops * 1e12)
    sol_m = hbm_bytes / (peaks.hbm_gbs * 1e9)
    sol = max(sol_c, sol_m)
    return Roofline(
        flops=flops, hbm_bytes=hbm_bytes,
        intensity=flops / hbm_bytes,
        sol_compute_s=sol_c, sol_memory_s=sol_m, sol_s=sol,
        bound="compute" if sol_c >= sol_m else "memory",
    )


def device_peaks(device=None) -> DevicePeaks:
    """Published peaks of `device` (default: jax.devices()[0])."""
    import jax

    kind = (device or jax.devices()[0]).device_kind
    if kind not in DEVICE_PEAKS:
        raise KeyError(f"no published peaks for device kind {kind!r}; "
                       f"known: {sorted(DEVICE_PEAKS)}")
    return DEVICE_PEAKS[kind]


def measure_mean_depth(scene, width: int = 256, height: int = 256,
                       sample: int = 1, max_depth: int = 8,
                       rr_start: int = 1) -> float:
    """Expected bounce-loop trips per path, measured empirically.

    Runs the XLA tracer bounce-by-bounce and sums the live-lane fraction
    entering each trip — the `mean_depth` the roofline model needs to
    convert a measured wall time into a speed-of-light fraction (Russian
    roulette makes the effective depth much smaller than max_depth).
    """
    import jax
    import jax.numpy as jnp

    from computeraytracer.ops import camera as cam_ops
    from computeraytracer.ops import rng
    from computeraytracer.ops import spectrum as spec
    from computeraytracer.scene import data as scene_data
    from computeraytracer.tracer import xla as xt

    scene = scene_data.as_jax(scene)
    px, py = xt.tile_coords(width, height, 0)
    sample_u = jnp.asarray(sample, jnp.uint32)

    @jax.jit
    def alive_fractions(scene):
        seed = rng.seed_pixel(px, py, sample_u)
        o, d, seed = cam_ops.camera_rays(
            scene.camera.eye, scene.camera.lookat, scene.camera.up,
            scene.camera.fov, width, height, px, py, sample_u, seed)
        lambdas, seed = spec.sample_wavelengths(seed)
        state = xt.init_state(o, d, seed)
        isect_fn = xt.make_intersector(scene)
        fracs = []
        for depth in range(max_depth + 1):
            fracs.append(jnp.mean(state.active.astype(jnp.float32)))
            state = xt.trace_step(scene, lambdas, state, depth,
                                  max_depth, rr_start, isect_fn)
        return jnp.stack(fracs)

    return float(jnp.sum(alive_fractions(scene)))
