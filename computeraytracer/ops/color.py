"""XYZ -> sRGB display pipeline (ComputeShader.wgsl:428-467).

Implements the reference's color pipeline: the standard XYZ->linear-sRGB
3x3, exponential tone map 1-exp(-rgb*exposure), and sRGB gamma encoding.
The reference's gamma green-branch bug (g *= 12.92*g for small g,
wgsl:453) is intentionally NOT reproduced — per SURVEY.md §7 step 3 the
rebuild fixes known bugs; small-value channels use the standard 12.92
linear segment.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Standard XYZ -> linear sRGB (D65) matrix (wgsl:428-434).
XYZ_TO_RGB = jnp.array(
    [
        [3.2404542, -1.5371385, -0.4985314],
        [-0.9692660, 1.8760108, 0.0415560],
        [0.0556434, -0.2040259, 1.0572252],
    ],
    dtype=jnp.float32,
)

DEFAULT_EXPOSURE = 2.2  # wgsl:112


def xyz_to_linear_rgb(xyz):
    """(..., 3) XYZ -> (..., 3) linear sRGB (f32 exact: Precision.HIGHEST
    keeps a GPU from running the product in TF32)."""
    return jnp.matmul(xyz, XYZ_TO_RGB.T,
                      precision=jax.lax.Precision.HIGHEST)


def tone_map(rgb, exposure: float = DEFAULT_EXPOSURE):
    """Exponential tone map: 1 - exp(-rgb * exposure) (wgsl:436-439)."""
    return 1.0 - jnp.exp(-rgb * jnp.float32(exposure))


def gamma_encode(rgb):
    """Linear -> sRGB gamma (piecewise, wgsl:441-467 minus the green bug)."""
    rgb = jnp.asarray(rgb)
    lo = rgb * 12.92
    hi = 1.055 * jnp.power(jnp.maximum(rgb, 1e-12), 1.0 / 2.4) - 0.055
    return jnp.where(rgb < 0.0031308, lo, hi)


def xyz_to_srgb(xyz, exposure: float = DEFAULT_EXPOSURE):
    """Full display transform: XYZ -> tonemapped sRGB in [0, 1]."""
    return jnp.clip(gamma_encode(tone_map(xyz_to_linear_rgb(xyz), exposure)), 0.0, 1.0)
