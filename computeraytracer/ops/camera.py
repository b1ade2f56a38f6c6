"""Pinhole camera: basis construction and per-pixel ray generation.

Matches the reference camera model (ComputeShader.wgsl:470-500):
- right-handed basis from eye/lookat/up,
- `focalLength` in the scene JSON is actually a vertical FOV in radians
  (viewport_height = 2*tan(f/2), wgsl:479),
- per-sample sub-pixel jitter uses stratum (sample % 16) plus one uniform
  in BOTH s and t (the same stratum for both axes), with t measured from
  the bottom: t = (H - py + jitter)/H (wgsl:496-500).
"""

from __future__ import annotations

import jax.numpy as jnp

from computeraytracer import config as C
from computeraytracer.ops import rng


def _normalize(v, axis=-1):
    return v / jnp.linalg.norm(v, axis=axis, keepdims=True)


def camera_basis(eye, lookat, up):
    """Returns (u, v, w) each (3,) — wgsl:470-475."""
    w = _normalize(eye - lookat)
    u = _normalize(jnp.cross(up, w))
    v = jnp.cross(w, u)
    return u, v, w


def film_coords(width, height, px, py, sample, seed,
                stratified: bool = True):
    """Jittered film-plane coordinates (s, t) in [0,1]^2 for pixels
    px, py (...,). Consumes exactly two RNG draws (s then t,
    wgsl:496-500). Returns (s, t, new_seed).

    stratified=False uses the two draws as plain uniforms instead of
    the reference's (sample%16 + u)/16 scheme. The reference applies
    the SAME stratum to both axes (wgsl:496-500), so the joint
    in-pixel distribution is a diagonal band, not uniform over the
    pixel square — harmless for plain rendering (marginals are
    uniform), but it biases 2D boundary-integral estimators (the
    warped-area visibility gradients integrate a velocity divergence
    over the pixel area), so vis_grads mode disables stratification.
    Draw count and order are unchanged either way."""
    us, seed = rng.rand(seed)
    ut, seed = rng.rand(seed)
    if stratified:
        stratum = (sample % jnp.uint32(C.GRID_SIZE)).astype(jnp.float32)
        inv_grid = jnp.float32(1.0 / C.GRID_SIZE)
        js = (stratum + us) * inv_grid
        jt = (stratum + ut) * inv_grid
    else:
        js, jt = us, ut
    s = (px.astype(jnp.float32) + js) / jnp.float32(width)
    t = (jnp.float32(height) - py.astype(jnp.float32) + jt) / jnp.float32(height)
    return s, t, seed


def film_frame(eye, lookat, up, fov, width, height):
    """(lower_left, horizontal, vertical) film-plane frame (wgsl:477-489).

    A film point (s, t) maps to the ray direction
    lower_left + s*horizontal + t*vertical - eye."""
    u, v, w = camera_basis(eye, lookat, up)
    aspect = jnp.float32(width) / jnp.float32(height)
    viewport_h = 2.0 * jnp.tan(fov / 2.0)
    viewport_w = aspect * viewport_h
    horizontal = viewport_w * u
    vertical = viewport_h * v
    lower_left = eye - horizontal / 2.0 - vertical / 2.0 - w
    return lower_left, horizontal, vertical


def film_ray(eye, lower_left, horizontal, vertical, s, t):
    """Ray through film point (s, t); op order identical to the original
    fused camera_rays so results stay bitwise unchanged."""
    d = (lower_left + s[..., None] * horizontal + t[..., None] * vertical - eye)
    d = _normalize(d)
    o = jnp.broadcast_to(eye, d.shape)
    return o, d


def world_to_film(eye, lookat, up, fov, width, height, x):
    """Project world points x (..., 3) back to film coordinates (s, t).

    Inverse of film_ray up to normalization: used by the warped-area
    reparameterization (ops/warp.py) to express the screen-space
    velocity of a surface point. Guarded so points at/behind the eye
    produce finite values (callers mask those lanes)."""
    u, v, w = camera_basis(eye, lookat, up)
    aspect = jnp.float32(width) / jnp.float32(height)
    viewport_h = 2.0 * jnp.tan(fov / 2.0)
    viewport_w = aspect * viewport_h
    dirv = x - eye
    denom = jnp.sum(dirv * (-w), axis=-1)
    denom = jnp.where(jnp.abs(denom) < 1e-6, 1e-6, denom)
    dn = dirv / denom[..., None]
    s = (jnp.sum(dn * u, axis=-1) + viewport_w / 2.0) / viewport_w
    t = (jnp.sum(dn * v, axis=-1) + viewport_h / 2.0) / viewport_h
    return s, t


def camera_rays(eye, lookat, up, fov, width, height, px, py, sample, seed):
    """Generate jittered primary rays for pixel coordinates px, py (...,).

    sample is the 1-based sample counter (uint32). Consumes exactly two
    RNG draws per ray (s then t), like wgsl:496-500. Returns
    (origins (..., 3), directions (..., 3), new_seed).
    """
    lower_left, horizontal, vertical = film_frame(eye, lookat, up, fov,
                                                  width, height)
    s, t, seed = film_coords(width, height, px, py, sample, seed)
    o, d = film_ray(eye, lower_left, horizontal, vertical, s, t)
    return o, d, seed
