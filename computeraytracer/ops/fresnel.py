"""Unpolarized Fresnel reflectance and reflect/refract helpers.

fresnel_s matches reference/src/shaders/ComputeShader.wgsl:814-837:
full (Rs^2+Rp^2)/2 with eta swap on cosi > 0 and TIR -> 1. reflect and
refract follow WGSL built-in semantics (refract returns 0 on TIR).
"""

from __future__ import annotations

import jax.numpy as jnp

from computeraytracer.ops.intersect import safe_sqrt


def fresnel_s(ray_dir, normal, eta1: float, eta2: float):
    """Unpolarized Fresnel reflectance for unit ray_dir/normal (...)."""
    cosi = jnp.clip(jnp.sum(ray_dir * normal, axis=-1), -1.0, 1.0)
    eta = jnp.where(cosi > 0.0, eta2 / eta1, eta1 / eta2)
    sint2 = eta * eta * (1.0 - cosi * cosi)
    tir = sint2 > 1.0
    cost = safe_sqrt(1.0 - sint2)
    cosi_a = jnp.abs(cosi)
    rs = (eta1 * cosi_a - eta2 * cost) / (eta1 * cosi_a + eta2 * cost)
    rp = (eta2 * cosi_a - eta1 * cost) / (eta2 * cosi_a + eta1 * cost)
    return jnp.where(tir, 1.0, 0.5 * (rs * rs + rp * rp))


def reflect(incident, normal):
    """WGSL reflect: i - 2*dot(n, i)*n."""
    return incident - 2.0 * jnp.sum(normal * incident, axis=-1, keepdims=True) * normal


def refract(incident, normal, eta):
    """WGSL refract: returns the zero vector on total internal reflection.

    eta: (...,) or scalar ratio eta_i/eta_t.
    """
    ndoti = jnp.sum(normal * incident, axis=-1)
    eta = jnp.asarray(eta, incident.dtype)
    k = 1.0 - eta * eta * (1.0 - ndoti * ndoti)
    tir = k < 0.0
    out = (
        eta[..., None] * incident
        - (eta * ndoti + safe_sqrt(k))[..., None] * normal
    )
    return jnp.where(tir[..., None], 0.0, out)
