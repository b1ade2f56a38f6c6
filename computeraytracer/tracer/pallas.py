"""Triton-megakernel tracer with the same API as tracer/xla.py.

The forward runs kernels/megakernel.py (one GPU thread per path); camera
ray generation, hero-wavelength sampling and the CIE conversion stay in
XLA, where they fuse into one pass. The kernel is specialized on the
non-differentiable scene structure (SceneStatic). Entry points compute
it from a concrete scene; when calling from inside your own jit, pass
`static=SceneStatic.from_scene(scene)` computed outside.

Differentiation: render_pixels carries a custom_vjp whose backward is
JAX AD of tracer/xla.py's render_pixels on the same sample. Both tracers
draw the same pcg4d streams, so the recomputed forward makes the same
sampling decisions and the gradient is the XLA tracer's gradient.

interpret=True runs the kernel in the Pallas interpreter (the CPU
tests); without it the kernel compiles for the GPU and any other
backend raises.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from computeraytracer.kernels import megakernel as mk
from computeraytracer.ops import camera as cam_ops
from computeraytracer.ops import rng
from computeraytracer.ops import spectrum as spec
from computeraytracer.scene import data as scene_data
from computeraytracer.tracer import xla as xla_tracer

SceneStatic = mk.SceneStatic


@functools.lru_cache(maxsize=64)
def _forward_cached(static, max_depth, rr_start, interpret):
    return mk.build_forward(static, max_depth, rr_start, interpret)


def trace_radiance(scene, o, d, lambdas, seed, max_depth: int,
                   rr_start: int = 1, static: SceneStatic | None = None,
                   interpret: bool = False):
    """Megakernel path trace: rays (R, 3) -> spectral radiance (R, 4).

    Rays are padded to a multiple of the kernel's block; padded lanes
    carry zero directions, hit nothing and are sliced off."""
    if static is None:
        static = SceneStatic.from_scene(scene)
    fwd = _forward_cached(static, int(max_depth), int(rr_start),
                          bool(interpret))
    r = o.shape[0]
    r_pad = -(-r // mk.BLOCK) * mk.BLOCK

    def planes(x, dtype):
        xt = x.T.astype(dtype)
        return jnp.pad(xt, ((0, 0), (0, r_pad - r)))

    out = fwd(mk.pack_prims(scene), scene.spectra,
              planes(jnp.concatenate([o, d], axis=-1), jnp.float32),
              planes(seed, jnp.uint32), planes(lambdas, jnp.int32))
    return out[:, :r].T


def render_pixels(scene, width: int, height: int, px, py, sample,
                  max_depth: int = 8, rr_start: int = 1,
                  static: SceneStatic | None = None, vis_grads=False,
                  interpret: bool = False):
    """Megakernel analogue of xla_tracer.render_pixels -> XYZ (R, 3).

    vis_grads accepts the "screen" warped-area domain (ops/warp.py): the
    warp is XLA-side work before ray generation and after the trace, and
    the backward is the XLA tracer's, which carries it. The "light" and
    "hemi" domains hook inside the bounce loop and raise here; use the
    XLA tracer for them.
    """
    if static is None:
        static = SceneStatic.from_scene(scene)
    scene = scene_data.as_jax(scene)
    sample_u = jnp.asarray(sample, jnp.uint32)
    domains = xla_tracer._vis_domains(vis_grads)
    if set(domains) - {"screen"}:
        raise ValueError(
            f"the megakernel supports vis_grads=('screen',); domains "
            f"{sorted(set(domains) - {'screen'})} hook inside the bounce "
            "loop: use tracer.xla render_pixels(vis_grads=...)")
    if domains and jnp.shape(px)[0] != width * height:
        raise ValueError(
            "vis_grads 'screen' requires full-film row-major rays "
            "(the tent splat scatters by py*width+px)")

    # px, py and the sample index are explicit (integer) arguments of
    # the custom_vjp: closing over them would leak tracers of an
    # enclosing scan or jit into the backward
    def run(scene, px, py, sample_u):
        seed = rng.seed_pixel(px, py, sample_u)
        cam = scene.camera
        if domains:
            from computeraytracer.ops import warp
            frame = cam_ops.film_frame(cam.eye, cam.lookat, cam.up,
                                       cam.fov, width, height)
            s, t, seed = cam_ops.film_coords(width, height, px, py,
                                             sample_u, seed,
                                             stratified=False)
            s, t, detj = warp.screen_warp(scene, width, height, s, t)
            o, d = cam_ops.film_ray(cam.eye, *frame, s, t)
        else:
            o, d, seed = cam_ops.camera_rays(
                cam.eye, cam.lookat, cam.up, cam.fov, width, height, px, py,
                sample_u, seed)
        lambdas, seed = spec.sample_wavelengths(seed)
        radiance = trace_radiance(scene, o, d, lambdas, seed, max_depth,
                                  rr_start, static, interpret)
        xyz = spec.spectral_to_xyz(scene.cie, radiance, lambdas)
        if domains:
            xyz = xyz * detj[..., None]
            xyz = xyz + xla_tracer._splat_correction(xyz, s, t, width,
                                                     height)
        return xyz

    @jax.custom_vjp
    def run_cv(scene, px, py, sample_u):
        return run(scene, px, py, sample_u)

    def run_fwd(scene, px, py, sample_u):
        return run(scene, px, py, sample_u), (scene, px, py, sample_u)

    def run_bwd(res, g):
        scene_res, px, py, sample_u = res
        _, vjp = jax.vjp(
            lambda s: xla_tracer.render_pixels(
                s, width, height, px, py, sample_u, max_depth, rr_start,
                vis_grads=vis_grads),
            scene_res)
        (d_scene,) = vjp(g)
        float0 = lambda x: np.zeros(jnp.shape(x), jax.dtypes.float0)
        return d_scene, float0(px), float0(py), float0(sample_u)

    run_cv.defvjp(run_fwd, run_bwd)
    return run_cv(scene, jnp.asarray(px, jnp.uint32),
                  jnp.asarray(py, jnp.uint32), sample_u)


def render_sample(scene, width: int, height: int, sample,
                  max_depth: int = 8, rr_start: int = 1,
                  static: SceneStatic | None = None, vis_grads=False,
                  interpret: bool = False):
    """One progressive sample: XYZ contribution image (H, W, 3)."""
    px, py = xla_tracer.tile_coords(width, height, 0)
    xyz = render_pixels(scene, width, height, px, py, sample, max_depth,
                        rr_start, static=static, vis_grads=vis_grads,
                        interpret=interpret)
    return xyz.reshape(height, width, 3)


@functools.partial(jax.jit, static_argnames=(
    "static", "width", "height", "spp", "max_depth", "rr_start",
    "interpret"))
def _render_accumulate_jit(scene, first_sample, *, static, width, height,
                           spp, max_depth, rr_start, interpret):
    # first_sample is traced: progressive rendering calls this once per
    # chunk, and a static value would recompile every chunk
    def body(accum, s):
        return accum + render_sample(scene, width, height, s, max_depth,
                                     rr_start, static=static,
                                     interpret=interpret), None

    accum0 = jnp.zeros((height, width, 3), jnp.float32)
    samples = first_sample + jnp.arange(spp, dtype=jnp.uint32)
    accum, _ = jax.lax.scan(body, accum0, samples)
    return accum


def render_accumulate(scene, width: int, height: int, spp: int,
                      max_depth: int = 8, rr_start: int = 1,
                      first_sample: int = 1, interpret: bool = False):
    """Accumulate spp progressive samples; summed XYZ (H, W, 3)."""
    return _render_accumulate_jit(
        scene, jnp.uint32(first_sample),
        static=SceneStatic.from_scene(scene), width=width, height=height,
        spp=spp, max_depth=max_depth, rr_start=rr_start,
        interpret=interpret)

