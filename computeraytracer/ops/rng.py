"""Counter-style TEA + pcg4d RNG, vectorized for JAX.

The reference keeps a per-thread ``vec4<u32>`` PRNG state seeded from
(pixel, sample) and advances it with pcg4d on every ``rand()`` call
(reference/src/shaders/ComputeShader.wgsl:864-899). Because the seed
is a pure function of (pixel, sample) and the draw sequence is pinned by
the tracer's control flow, the same stream can be reproduced exactly by
the NumPy oracle, the XLA tracer, and the Triton kernel — which is what
makes "allclose vs CPU reference" achievable for a Monte Carlo estimator
and makes checkpoint/resume bit-exact.

State is carried explicitly as a (..., 4) uint32 array (JAX is functional;
there is no var<private>). Draws that the scalar code performs
conditionally (per-material, Russian roulette) must advance state only on
lanes where the branch is taken: use `rand_masked`.
"""

from __future__ import annotations

import jax.numpy as jnp

_U32 = jnp.uint32

# TEA round constants ("GPU Random Numbers via the Tiny Encryption
# Algorithm"; reference ComputeShader.wgsl:865-877).
_TEA_DELTA = 0x9E3779B9
_TEA_K0, _TEA_K1 = 0xA341316C, 0xC8013EA4
_TEA_K2, _TEA_K3 = 0xAD90777D, 0x7E95761E


def tea(val0, val1, rounds: int = 16):
    """TEA hash of two uint32s; returns uint32. Vectorized over inputs."""
    v0 = jnp.asarray(val0, _U32)
    v1 = jnp.asarray(val1, _U32)
    s0 = _U32(0)
    for _ in range(rounds):
        s0 = s0 + _U32(_TEA_DELTA)
        v0 = v0 + (((v1 << 4) + _U32(_TEA_K0)) ^ (v1 + s0) ^ ((v1 >> 5) + _U32(_TEA_K1)))
        v1 = v1 + (((v0 << 4) + _U32(_TEA_K2)) ^ (v0 + s0) ^ ((v0 >> 5) + _U32(_TEA_K3)))
    return v0


def seed_pixel(px, py, sample):
    """Initial state for a pixel at a given 1-based sample index.

    Matches ComputeShader.wgsl:98:
    seed = vec4(y, x*100, sample, tea(x, y*100)).
    Returns (..., 4) uint32.
    """
    px = jnp.asarray(px, _U32)
    py = jnp.asarray(py, _U32)
    sample = jnp.asarray(sample, _U32)
    s = jnp.stack(
        [
            py,
            px * _U32(100),
            jnp.broadcast_to(sample, px.shape),
            tea(px, py * _U32(100)),
        ],
        axis=-1,
    )
    return s


def pcg4d(seed):
    """One pcg4d state advance. seed: (..., 4) uint32 -> (..., 4) uint32.

    Mirrors ComputeShader.wgsl:879-891 including the sequential component
    mixing (each component update sees the previously-updated ones).
    """
    seed = seed * _U32(1664525) + _U32(1013904223)
    x, y, z, w = seed[..., 0], seed[..., 1], seed[..., 2], seed[..., 3]
    x = x + y * w
    y = y + z * x
    z = z + x * y
    w = w + y * z
    x, y, z, w = (v ^ (v >> 16) for v in (x, y, z, w))
    x = x + y * w
    y = y + z * x
    z = z + x * y
    w = w + y * z
    return jnp.stack([x, y, z, w], axis=-1)


def to_unit_float(bits):
    """uint32 -> f32 in [0, 1) using the low 24 bits (wgsl:893-897)."""
    return (bits & _U32(0x00FFFFFF)).astype(jnp.float32) * jnp.float32(1.0 / 0x01000000)


def rand(seed):
    """Advance state and draw one uniform. Returns (u, new_seed)."""
    new_seed = pcg4d(seed)
    return to_unit_float(new_seed[..., 0]), new_seed


def rand_masked(seed, mask):
    """Draw one uniform only on lanes where mask is True.

    Lanes with mask=False keep their state unchanged (their u is
    arbitrary/0). This reproduces the scalar code's conditional draws.
    """
    new_seed = pcg4d(seed)
    u = to_unit_float(new_seed[..., 0])
    keep = mask[..., None]
    return jnp.where(mask, u, 0.0), jnp.where(keep, new_seed, seed)
