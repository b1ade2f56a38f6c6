"""Sampling routines: cosine hemisphere, area lights, MIS power heuristic.

Mirrors reference/src/shaders/ComputeShader.wgsl:
- power_heuristic (beta=2) :297-302
- uniform light selection + uniform point on a rectangular light :341-355
- area->solid-angle light pdf :357-377
- cosine-weighted hemisphere with the z-up/x-up tangent frame :751-774
"""

from __future__ import annotations

import jax.numpy as jnp

from computeraytracer.ops.intersect import safe_normalize, safe_sqrt


def power_heuristic(nf, f_pdf, ng, g_pdf):
    """Power heuristic (beta=2), in the scale-invariant ratio form
    1/(1+(g/f)^2) == f^2/(f^2+g^2).

    The textbook form's backward pass squares the denominator, which
    underflows f32 to 0 for pdfs ~< 1e-10 and turns masked-lane
    gradients into 0/0 NaNs; the ratio form stays finite for any finite
    ratio (values agree to rounding)."""
    f = nf * f_pdf
    g = ng * g_pdf
    r = g / jnp.maximum(f, 1e-12)
    return 1.0 / (1.0 + r * r)


def cosine_hemisphere(normal, u, v):
    """Cosine-weighted direction about `normal` from two uniforms.

    Returns (direction (..., 3), pdf (...,)). pdf = cos(theta)/pi.
    """
    r = safe_sqrt(u)
    theta = 2.0 * jnp.pi * v
    x = r * jnp.cos(theta)
    y = r * jnp.sin(theta)
    z = safe_sqrt(1.0 - u)
    z_minor = jnp.abs(normal[..., 2]) < 0.999
    up = jnp.where(
        z_minor[..., None],
        jnp.array([0.0, 0.0, 1.0], jnp.float32),
        jnp.array([1.0, 0.0, 0.0], jnp.float32),
    )
    tangent = safe_normalize(jnp.cross(up, normal))
    bitangent = jnp.cross(normal, tangent)
    direction = (
        tangent * x[..., None] + bitangent * y[..., None] + normal * z[..., None]
    )
    pdf = z / jnp.pi
    return direction, pdf


def pick_light(u, n_lights):
    """Uniform light index from one uniform (wgsl:341-347)."""
    idx = (u * jnp.float32(n_lights)).astype(jnp.int32)
    return jnp.clip(idx, 0, n_lights - 1)


def point_on_light(origin, edge1, edge2, u, v):
    """Uniform point on a rectangular area light (wgsl:349-355)."""
    return origin + u[..., None] * edge1 + v[..., None] * edge2


def light_solid_angle_pdf(edge1, edge2, n_lights, normal_at_light,
                          ray_direction, light_position, ray_origin):
    """Solid-angle pdf of sampling the point hit on an area light.

    Matches compute_light_pdf (wgsl:357-377): (1/area) / (|cos|/d^2) *
    (1/n_lights), with |cos| clamped to >= 1e-5. The result is clipped to
    1e16 so that masked lanes evaluating this on degenerate geometry
    (e.g. a sphere's zero edge2) stay finite — pdf^2 must not overflow
    f32 inside the power heuristic, or NaNs poison gradients through
    jnp.where. Real light pdfs are many orders of magnitude below the
    clip.
    """
    area = safe_sqrt(jnp.sum(edge1 * edge1, axis=-1)) * \
        safe_sqrt(jnp.sum(edge2 * edge2, axis=-1))
    abs_cos = jnp.maximum(
        1e-5, jnp.abs(jnp.sum(normal_at_light * (-ray_direction), axis=-1))
    )
    dist2 = jnp.sum((light_position - ray_origin) ** 2, axis=-1)
    geometric = abs_cos / jnp.maximum(dist2, 1e-12)
    pdf = (1.0 / jnp.maximum(area, 1e-12)) / geometric / jnp.float32(n_lights)
    return jnp.clip(pdf, 0.0, 1e16)
