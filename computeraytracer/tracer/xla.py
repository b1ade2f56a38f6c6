"""The XLA path tracer: vectorized-over-rays, scan-over-bounces.

This is a functional re-design of the reference's WGSL megakernel
(reference/src/shaders/ComputeShader.wgsl:77-295): the per-thread
`while(true)` bounce loop with three material branches becomes a
`lax.scan` over a static bounce count with masked lanes, so one trace
step is a single fused XLA program over (rays,) vectors.

It serves three roles:
1. the tracer for mesh scenes (with the BVH) and on every backend,
2. the differentiable path of the trainer and of the Triton forward's
   custom_vjp (pure jnp -> JAX AD works, with detached sampling: RNG
   draws are uint32 state, inherently non-differentiable, so gradients
   treat sampling decisions as fixed — common random numbers),
3. the specification the Triton megakernel matches (same pcg4d streams,
   same draw order).

Estimator semantics (and the exact RNG draw order) follow path_trace
(wgsl:119-295): NEE with the power heuristic, cosine-hemisphere diffuse
bounces, Fresnel reflect/refract glass with beta*eta^2 radiance scaling
and Beer-Lambert attenuation through the LAST spectrum, and Russian
roulette on max(beta*etaScale) for depth > 1. Two reference bugs are
fixed per SURVEY.md §7: the sRGB green-branch gamma (wgsl:453) and
light-pdf lookup by emission index (wgsl:362) — the pdf here uses the
actually-hit light primitive's geometry.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from computeraytracer import config as C
from computeraytracer.ops import camera as cam_ops
from computeraytracer.ops import fresnel as fr
from computeraytracer.ops import intersect as isect
from computeraytracer.ops import rng
from computeraytracer.ops import sampling
from computeraytracer.ops import spectrum as spec

ETA1, ETA2 = 1.0, 1.5  # glass interface (wgsl:210-211)


def _vis_domains(vis_grads):
    """Normalize the vis_grads flag: False -> (), True -> all three
    warped domains, or an explicit subset like ("screen", "light")."""
    if not vis_grads:
        return ()
    if vis_grads is True:
        return ("screen", "light", "hemi")
    if isinstance(vis_grads, str):
        # tuple("screen") would silently become ('s','c','r',...) —
        # no warp enabled but a truthy domains tuple still switching
        # the render to unstratified jitter
        vis_grads = (vis_grads,)
    domains = tuple(vis_grads)
    bad = set(domains) - {"screen", "light", "hemi"}
    if bad:
        raise ValueError(f"unknown vis_grads domains: {sorted(bad)}")
    return domains


class PathState(NamedTuple):
    seed: jnp.ndarray        # (R, 4) uint32
    ray_o: jnp.ndarray       # (R, 3)
    ray_d: jnp.ndarray       # (R, 3)
    radiance: jnp.ndarray    # (R, 4) accumulated spectral radiance
    beta: jnp.ndarray        # (R, 4) throughput
    last_pdf: jnp.ndarray    # (R,) pdf of the previous BSDF bounce
    eta_scale: jnp.ndarray   # (R,)
    exclude: jnp.ndarray     # (R,) int32 excluded primitive (-1 none)
    specular: jnp.ndarray    # (R,) bool last bounce was specular
    in_transmission: jnp.ndarray  # (R,) bool inside glass
    active: jnp.ndarray      # (R,) bool path still alive


_safe_normalize = isect.safe_normalize


def _dot(a, b):
    return jnp.sum(a * b, axis=-1)


def init_state(o, d, seed) -> PathState:
    r = o.shape[:-1]
    f4 = lambda fill: jnp.full(r + (4,), fill, jnp.float32)
    return PathState(
        seed=seed,
        ray_o=o,
        ray_d=d,
        radiance=f4(0.0),
        beta=f4(1.0),
        last_pdf=jnp.ones(r, jnp.float32),
        eta_scale=jnp.ones(r, jnp.float32),
        exclude=jnp.full(r, isect.NO_INDEX, jnp.int32),
        specular=jnp.zeros(r, bool),
        in_transmission=jnp.zeros(r, bool),
        active=jnp.ones(r, bool),
    )


def _nee(scene, hit, brdf, lambdas, beta, is_diffuse, u_l, u_p, v_p,
         isect_fn, vis_grads: bool = False):
    """Next-event estimation (wgsl:379-408). Returns the MIS-weighted
    radiance contribution (R, 4) for diffuse lanes."""
    prims = scene.primitives
    n_lights = scene.lights.count
    li = sampling.pick_light(u_l, n_lights)
    l_prim = scene.lights.prim_index[li]
    l_origin = prims.data1[l_prim]
    l_edge1 = prims.data2[l_prim]
    l_edge2 = prims.data3[l_prim]
    detj = 1.0
    if "light" in _vis_domains(vis_grads):
        from computeraytracer.ops import warp
        u_p, v_p, detj = warp.light_warp(
            scene, hit.position, hit.index, l_origin, l_edge1, l_edge2,
            l_prim, u_p, v_p, is_diffuse)
    p_on_light = sampling.point_on_light(l_origin, l_edge1, l_edge2, u_p, v_p)
    ldir = _safe_normalize(p_on_light - hit.position)
    shadow = isect_fn(hit.position, ldir, hit.index)
    unoccluded = shadow.hit & (shadow.index == l_prim)

    cos_theta = jnp.maximum(0.0, _dot(hit.normal, ldir))
    le = spec.sample_spectrum(scene.spectra, scene.lights.emission[li],
                              lambdas) * cos_theta[..., None]
    pdf_l = sampling.light_solid_angle_pdf(
        l_edge1, l_edge2, n_lights, shadow.normal, ldir,
        shadow.position, hit.position)
    pdf_b = cos_theta / jnp.pi
    weight_l = sampling.power_heuristic(1.0, pdf_l, 1.0, pdf_b)
    contrib = le * (weight_l / jnp.maximum(pdf_l, 1e-12))[..., None]
    take = (is_diffuse & unoccluded)[..., None]
    out = jnp.where(take, brdf * contrib * beta, 0.0)
    if "light" in _vis_domains(vis_grads):
        out = out * detj[..., None]
    return out


def _splat_correction(xyz, s, t, width, height):
    """Zero-primal tent-filter splat for warped screen samples.

    The screen warp moves a sample's film coordinate with the geometry,
    but the sample stays statically binned to its pixel — so the flux
    of radiance BETWEEN pixels (the entire image-gradient signal when a
    flat-radiance silhouette crosses differently-weighted pixels) never
    reaches AD. Each sample therefore also contributes
    (k - stop_grad(k)) * f to the 2x2 pixels of a unit tent filter
    evaluated at the WARPED coordinate: exactly zero primally, while
    the derivative tent-distributes d(film coord)/d(theta) flux to the
    pixels it crosses (the filters form a partition of unity, so flux
    is conserved). Assumes the caller renders a full row-major film
    (render_sample does); requires rays in py*width+px order."""
    sg = jax.lax.stop_gradient
    # pixel px covers s*W in [px, px+1) (center px+.5); row py covers
    # H - t*H in (py-1, py] (center py-.5) — the reference's t-flip quirk
    gx = s * jnp.float32(width) - 0.5
    gy = (jnp.float32(height) - t * jnp.float32(height)) + 0.5
    x0 = jnp.floor(sg(gx))
    y0 = jnp.floor(sg(gy))
    corr = jnp.zeros_like(xyz)
    for dx in (0.0, 1.0):
        for dy in (0.0, 1.0):
            qx = x0 + dx
            qy = y0 + dy
            kk = (jnp.maximum(0.0, 1.0 - jnp.abs(gx - qx))
                  * jnp.maximum(0.0, 1.0 - jnp.abs(gy - qy)))
            w_corr = kk - sg(kk)
            qxi = jnp.clip(qx.astype(jnp.int32), 0, width - 1)
            qyi = jnp.clip(qy.astype(jnp.int32), 0, height - 1)
            lin = qyi * width + qxi
            corr = corr.at[lin].add(w_corr[..., None] * sg(xyz))
    return corr


def make_intersector(scene, bvh=None):
    """Closest-hit closure: brute linear scan, or BVH when provided."""
    if bvh is None:
        return lambda o, d, exclude: isect.intersect_brute(
            o, d, exclude, scene.primitives)
    from computeraytracer.bvh import traverse as bvh_traverse
    return lambda o, d, exclude: bvh_traverse.intersect_bvh(
        o, d, exclude, scene.primitives, bvh)


def trace_step(scene, lambdas, state: PathState, depth: int,
               max_depth: int, rr_start: int,
               isect_fn=None, vis_grads: bool = False) -> PathState:
    """One bounce of the path-trace loop (wgsl:133-293) over all lanes."""
    prims = scene.primitives
    if isect_fn is None:
        isect_fn = make_intersector(scene)
    seed = state.seed
    o, d = state.ray_o, state.ray_d
    beta, radiance = state.beta, state.radiance
    active = state.active

    hit = isect_fn(o, d, state.exclude)
    lane_hit = active & hit.hit
    active = active & hit.hit  # miss -> break (wgsl:141-144)
    exclude = jnp.where(lane_hit, hit.index, state.exclude)

    # --- emissive hit: MIS-weighted radiance, terminate (wgsl:149-164)
    is_light = lane_hit & (hit.material == C.LIGHT)
    le = spec.sample_spectrum(scene.spectra, hit.emission, lambdas)
    pdf_l_hit = sampling.light_solid_angle_pdf(
        prims.data2[hit.index], prims.data3[hit.index], scene.lights.count,
        hit.normal, d, hit.position, o)
    weight_b = sampling.power_heuristic(1.0, state.last_pdf, 1.0, pdf_l_hit)
    mis_w = jnp.where((depth == 0) | state.specular, 1.0, weight_b)
    radiance = radiance + jnp.where(
        is_light[..., None], beta * le * mis_w[..., None], 0.0)
    active = active & ~is_light

    # --- depth cap (wgsl:167-170); final iteration only harvests light
    scatter = active & lane_hit & ~is_light & (depth < max_depth)
    active = active & scatter

    # --- Beer-Lambert attenuation through the extinction spectrum
    # (the LAST spectrum row; wgsl:173-179)
    # NaN-safe distance (missed lanes have position == o)
    dist = isect.safe_sqrt(_dot(hit.position - o, hit.position - o))
    ext = scene.spectra[-1][lambdas]
    atten = jnp.exp(-ext * dist[..., None])
    beta = jnp.where((scatter & state.in_transmission)[..., None],
                     beta * atten, beta)

    is_diffuse = scatter & (hit.material == C.DIFFUSE)
    is_glass = scatter & (hit.material == C.GLASS)
    is_mirror = scatter & (hit.material == C.MIRROR)

    # ---------------- DIFFUSE (wgsl:182-204): 5 draws ----------------
    u_l, seed = rng.rand_masked(seed, is_diffuse)
    u_p, seed = rng.rand_masked(seed, is_diffuse)
    v_p, seed = rng.rand_masked(seed, is_diffuse)
    u_h, seed = rng.rand_masked(seed, is_diffuse)
    v_h, seed = rng.rand_masked(seed, is_diffuse)

    brdf = spec.sample_spectrum(scene.spectra, hit.reflectance,
                                lambdas) / jnp.pi
    radiance = radiance + _nee(scene, hit, brdf, lambdas, beta, is_diffuse,
                               u_l, u_p, v_p, isect_fn, vis_grads)
    detj_h = 1.0
    if "hemi" in _vis_domains(vis_grads):
        from computeraytracer.ops import warp
        u_h, v_h, detj_h = warp.hemisphere_warp(
            scene, hit.position, hit.normal, hit.index, u_h, v_h,
            is_diffuse)
    bounce_dir, bounce_pdf = sampling.cosine_hemisphere(hit.normal, u_h, v_h)
    cos_b = jnp.abs(_dot(hit.normal, bounce_dir))
    beta_diffuse = beta * brdf * (
        cos_b / jnp.maximum(bounce_pdf, 1e-12))[..., None]
    if "hemi" in _vis_domains(vis_grads):
        # detJ of the hemisphere reparameterization scales everything
        # the path gathers AFTER this bounce (beta carries it forward)
        beta_diffuse = beta_diffuse * detj_h[..., None]

    # ---------------- GLASS (wgsl:208-276): 1 draw -------------------
    u_g, seed = rng.rand_masked(seed, is_glass)
    cos_in = _dot(hit.normal, d)
    reflectance = fr.fresnel_s(d, hit.normal, ETA1, ETA2)
    # eta = eta1/eta2, inverted when hitting the backface (wgsl:212,229-234)
    eta = jnp.where(cos_in > 0.0, ETA2 / ETA1, ETA1 / ETA2)
    n_glass = jnp.where((cos_in > 0.0)[..., None], -hit.normal, hit.normal)
    pr = reflectance
    pt = 1.0 - reflectance
    choose_reflect = u_g < pr / jnp.maximum(pr + pt, 1e-12)
    refl_dir = fr.reflect(d, n_glass)
    refr_dir = _safe_normalize(fr.refract(d, n_glass, eta))
    glass_dir = jnp.where(choose_reflect[..., None], refl_dir, refr_dir)
    eta2v = (eta * eta)[..., None]
    beta_glass = jnp.where(choose_reflect[..., None], beta, beta * eta2v)
    eta_scale_glass = jnp.where(choose_reflect, state.eta_scale,
                                state.eta_scale / (eta * eta))
    in_trans_glass = jnp.where(choose_reflect, state.in_transmission,
                               ~state.in_transmission)

    # ---------------- MIRROR (extension): 0 draws --------------------
    mirror_dir = fr.reflect(d, hit.normal)

    # ---------------- state merge ------------------------------------
    new_o = jnp.where(scatter[..., None], hit.position, o)
    new_d = jnp.where(is_diffuse[..., None], bounce_dir,
                      jnp.where(is_glass[..., None], glass_dir,
                                jnp.where(is_mirror[..., None], mirror_dir, d)))
    beta = jnp.where(is_diffuse[..., None], beta_diffuse,
                     jnp.where(is_glass[..., None], beta_glass, beta))
    last_pdf = jnp.where(is_diffuse, bounce_pdf, state.last_pdf)
    specular = jnp.where(is_diffuse, False,
                         jnp.where(is_glass | is_mirror, True, state.specular))
    # glass & mirror clear the exclusion so the ray can re-hit the same
    # primitive from inside (wgsl:246,253)
    exclude = jnp.where(is_glass | is_mirror, isect.NO_INDEX, exclude)
    eta_scale = jnp.where(is_glass, eta_scale_glass, state.eta_scale)
    in_transmission = jnp.where(is_glass, in_trans_glass,
                                state.in_transmission)

    # ---------------- Russian roulette (wgsl:279-289) ----------------
    rbeta = beta * eta_scale[..., None]
    max_c = jnp.max(rbeta[..., :3], axis=-1)  # reference uses xyz only
    rr = active & (depth > rr_start) & (max_c < 1.0)
    u_r, seed = rng.rand_masked(seed, rr)
    q = jnp.maximum(0.0, 1.0 - max_c)
    killed = rr & (u_r < q)
    active = active & ~killed
    beta = jnp.where((rr & ~killed)[..., None],
                     beta / jnp.maximum(1.0 - q, 1e-12)[..., None], beta)

    return PathState(seed, new_o, new_d, radiance, beta, last_pdf,
                     eta_scale, exclude, specular, in_transmission, active)


def path_trace(scene, o, d, lambdas, seed, max_depth: int,
               rr_start: int = 1, use_remat: bool = True, bvh=None,
               vis_grads: bool = False):
    """Trace rays to completion. Returns (radiance (R, 4), final seed).

    Runs max_depth+1 iterations: iteration i scatters only while
    i < max_depth; the final trip harvests emissive hits, matching the
    reference's depth-cap placement (wgsl:149-170).
    """
    state = init_state(o, d, seed)
    isect_fn = make_intersector(scene, bvh)

    def body(state, depth):
        new_state = trace_step(scene, lambdas, state, depth, max_depth,
                               rr_start, isect_fn, vis_grads)
        return new_state, None

    if use_remat:
        body = jax.checkpoint(body)
    state, _ = jax.lax.scan(body, state, jnp.arange(max_depth + 1))
    return state.radiance, state.seed


def render_pixels(scene, width: int, height: int, px, py, sample,
                  max_depth: int = 8, rr_start: int = 1,
                  use_remat: bool = True, bvh=None,
                  vis_grads: bool = False, stratified: bool = True):
    """Trace one sample for explicit pixel coordinates px, py (R,).

    Seeds derive from GLOBAL pixel coordinates and the 1-based sample
    counter (wgsl:98), so any tiling/sharding of the film plane produces
    bit-identical results to a single-device render. Returns XYZ (R, 3).

    vis_grads=True turns on the warped-area reparameterization
    (ops/warp.py) of the screen, light-area and hemisphere sampling
    domains, so AD additionally captures the visibility boundary terms
    (moving silhouettes and shadows) that interior gradients miss.
    Primal values are bit-identical ACROSS vis_grads modes (any warp
    subset, including all three, evaluates to the identity at the
    primal point) — but they differ from the vis_grads=False render,
    because every vis_grads mode disables pixel stratification (see
    film_coords: the reference's shared-stratum jitter is diagonal-
    correlated inside the pixel, which biases the warp's 2D
    boundary-integral estimator). Compare vis_grads renders against
    vis_grads-mode targets, not against default-rendered goldens.
    """
    from computeraytracer.scene import data as scene_data
    scene = scene_data.as_jax(scene)
    if bvh is not None:
        bvh = jax.tree_util.tree_map(jnp.asarray, bvh)
    sample_u = jnp.asarray(sample, jnp.uint32)
    seed = rng.seed_pixel(px, py, sample_u)
    cam = scene.camera
    domains = _vis_domains(vis_grads)
    if "screen" in domains and jnp.shape(px)[0] != width * height:
        # _splat_correction scatters flux via lin = py*width + px into
        # the per-ray array assuming full-film row-major rays; a tiled
        # caller (api._band_accumulate, parallel/render_sharded) would
        # silently corrupt screen-warp gradients
        raise ValueError(
            "vis_grads 'screen' requires full-film rays "
            f"(got {jnp.shape(px)[0]} rays for {width}x{height}); "
            "use the 'light'/'hemi' domains for tiled renders")
    if domains or not stratified:
        # any vis_grads mode renders with unstratified pixel jitter (see
        # film_coords: the reference's shared-stratum scheme is diagonal-
        # correlated inside the pixel, which biases the warp's 2D
        # boundary-integral estimator); the screen warp itself is only
        # applied when requested. stratified=False alone gives the SAME
        # primal render without the warp machinery (warps are primally
        # the exact identity) — the cheap evaluation path for finite
        # differences against vis_grads AD (tests/test_visibility_grads).
        frame = cam_ops.film_frame(cam.eye, cam.lookat, cam.up, cam.fov,
                                   width, height)
        s, t, seed = cam_ops.film_coords(width, height, px, py, sample_u,
                                         seed, stratified=False)
        if "screen" in domains:
            from computeraytracer.ops import warp
            s, t, detj = warp.screen_warp(scene, width, height, s, t)
        o, d = cam_ops.film_ray(cam.eye, *frame, s, t)
    else:
        o, d, seed = cam_ops.camera_rays(
            cam.eye, cam.lookat, cam.up, cam.fov, width, height, px, py,
            sample_u, seed)
    lambdas, seed = spec.sample_wavelengths(seed)
    radiance, _ = path_trace(scene, o, d, lambdas, seed, max_depth,
                             rr_start, use_remat, bvh=bvh,
                             vis_grads=vis_grads)
    xyz = spec.spectral_to_xyz(scene.cie, radiance, lambdas)
    if "screen" in domains:
        xyz = xyz * detj[..., None]
        xyz = xyz + _splat_correction(xyz, s, t, width, height)
    return xyz


def tile_coords(width: int, tile_h: int, y0):
    """Global pixel coordinates for a tile of rows [y0, y0+tile_h)."""
    ys = jnp.asarray(y0, jnp.uint32) + jnp.arange(tile_h, dtype=jnp.uint32)[:, None]
    xs = jnp.arange(width, dtype=jnp.uint32)[None, :]
    py = jnp.broadcast_to(ys, (tile_h, width)).reshape(-1)
    px = jnp.broadcast_to(xs, (tile_h, width)).reshape(-1)
    return px, py


def render_sample(scene, width: int, height: int, sample,
                  max_depth: int = 8, rr_start: int = 1,
                  use_remat: bool = True, bvh=None,
                  vis_grads: bool = False, stratified: bool = True):
    """One progressive sample: XYZ contribution image (H, W, 3).

    `sample` is the 1-based sample counter (wgsl main :77-117). The
    whole function is jit-able and differentiable w.r.t. scene arrays.
    """
    px, py = tile_coords(width, height, 0)
    xyz = render_pixels(scene, width, height, px, py, sample, max_depth,
                        rr_start, use_remat, bvh=bvh,
                        vis_grads=vis_grads, stratified=stratified)
    return xyz.reshape(height, width, 3)


@partial(jax.jit, static_argnames=("width", "height", "spp", "max_depth",
                                   "rr_start", "first_sample"))
def render_accumulate(scene, width: int, height: int, spp: int,
                      max_depth: int = 8, rr_start: int = 1,
                      first_sample: int = 1, bvh=None):
    """Accumulate spp progressive samples; returns summed XYZ (H, W, 3).

    The sample counter advances exactly like the reference's
    UpdateVariables pass (1-based, incremented before each trace)."""
    def body(accum, s):
        xyz = render_sample(scene, width, height, s, max_depth, rr_start,
                            bvh=bvh)
        return accum + xyz, None

    accum0 = jnp.zeros((height, width, 3), jnp.float32)
    samples = jnp.arange(first_sample, first_sample + spp, dtype=jnp.uint32)
    accum, _ = jax.lax.scan(body, accum0, samples)
    return accum
