"""Spectral sampling: hero-wavelength draws, spectrum tables, CIE matching.

Reproduces the reference's spectral machinery:
- sparse (wavelength, value) pairs resampled to 301 samples at 1nm over
  400-700nm (reference/src/main.js:334-364),
- hero-wavelength sampling of 1 uniform wavelength index + 3 companions
  offset 4/8/12nm mod 301 (ComputeShader.wgsl:315-322),
- CIE 1931 lookups with the +40 index offset that maps a 400nm-based
  wavelength index into the 360nm-based CIE tables (wgsl:324-338),
- Riemann spectral->XYZ with the 300/(106.856895*4) normalization
  (wgsl:419-426).

CIE tables are generated from the public analytic multi-lobe Gaussian fit
(Wyman, Sloan & Shirley 2013, JCGT) so the framework is standalone;
a CIE.json-format file can also be loaded (scene/loader.py).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from computeraytracer import config as C
from computeraytracer.ops import rng


# ---------------------------------------------------------------------------
# Host-side (NumPy) preparation
# ---------------------------------------------------------------------------

def resample_spectrum(wavelengths, values, lambda_min=C.LAMBDA_MIN,
                      lambda_max=C.LAMBDA_MAX) -> np.ndarray:
    """Resample sparse (wavelength, value) pairs to a dense 1nm table.

    Semantics match the reference's sampleSpectrum (main.js:340-356):
    find-first wavelength >= lambda, then lerp between it and its
    predecessor; exact matches and out-of-range-low return the endpoint.
    """
    wl = np.asarray(wavelengths, np.float64)
    vals = np.asarray(values, np.float64)
    n = int(lambda_max - lambda_min) + 1
    out = np.empty(n, np.float32)
    for i in range(n):
        lam = lambda_min + i
        idx = int(np.searchsorted(wl, lam, side="left"))
        if idx >= len(wl):
            out[i] = vals[-1]
            continue
        start_i = max(idx - 1, 0)
        end_i = min(idx, len(wl) - 1)
        s_lam, e_lam = wl[start_i], wl[end_i]
        s_val, e_val = vals[start_i], vals[end_i]
        if s_lam == e_lam:
            out[i] = s_val
        else:
            t = (lam - s_lam) / (e_lam - s_lam)
            out[i] = s_val + t * (e_val - s_val)
    return out


def _gauss_lobe(x, mu, s1, s2):
    sigma = np.where(x < mu, s1, s2)
    return np.exp(-0.5 * ((x - mu) / sigma) ** 2)


def cie_1931_tables(n: int = C.CIE_N, start_nm: float = 360.0) -> np.ndarray:
    """(3, 471) CIE 1931 x̄ȳz̄ at 1nm from 360nm, via the analytic fit."""
    lam = start_nm + np.arange(n, dtype=np.float64)
    x = (1.056 * _gauss_lobe(lam, 599.8, 37.9, 31.0)
         + 0.362 * _gauss_lobe(lam, 442.0, 16.0, 26.7)
         - 0.065 * _gauss_lobe(lam, 501.1, 20.4, 26.2))
    y = (0.821 * _gauss_lobe(lam, 568.8, 46.9, 40.5)
         + 0.286 * _gauss_lobe(lam, 530.9, 16.3, 31.1))
    z = (1.217 * _gauss_lobe(lam, 437.0, 11.8, 36.0)
         + 0.681 * _gauss_lobe(lam, 459.0, 26.0, 13.8))
    return np.stack([x, y, z]).astype(np.float32)


# ---------------------------------------------------------------------------
# Device-side (jnp) sampling
# ---------------------------------------------------------------------------

def sample_wavelengths(seed):
    """Hero-wavelength draw (wgsl:315-322).

    One uniform picks the hero index in [0, 301); companions at +4/+8/+12
    wrap mod 301. Returns (lambdas (..., 4) int32, new_seed).
    """
    u, seed = rng.rand(seed)
    n = jnp.int32(C.N_LAMBDA)
    hero = (u * jnp.float32(C.N_LAMBDA)).astype(jnp.int32)
    lam = jnp.stack(
        [hero, (hero + 4) % n, (hero + 8) % n, (hero + 12) % n], axis=-1
    )
    return lam, seed


def sample_spectrum(spectra, index, lambdas):
    """spectra: (S, 301); index: (...,) int; lambdas: (..., 4) -> (..., 4)."""
    return spectra[index[..., None], lambdas]


@jax.custom_vjp
def take_rows(table_t, lam):
    """Row gather with a scatter-free backward.

    table_t: (L, S) transposed spectral table; lam: (...,) int32 in
    [0, L). Forward is a contiguous row gather; backward computes
    d_table as a one-hot contraction (a dot with the one-hot fused into
    the operand) instead of the scatter-add XLA AD would emit for
    gather's transpose. Precision.HIGHEST keeps that f32 contraction
    exact: at default precision a GPU may run it in TF32. Whether a
    scatter-add is faster on the GPU is an open measurement.
    """
    return table_t[lam]


def _take_rows_fwd(table_t, lam):
    return table_t[lam], (lam, table_t.shape[0])


# Upper bound on rows contracted per one-hot block. XLA normally fuses
# the comparison into the dot operand (no materialized one-hot), but the
# block keeps peak HBM bounded at ~(BLOCK x L) even if that fusion
# regresses (~0.3 GB at L=301 instead of N x L for N = rays x 4).
_ONEHOT_BLOCK = 1 << 18


def _chunked(lam_flat, g_flat, contract, out_shape):
    """Sum contract(lam_block, g_block) -> out_shape over row blocks of
    _ONEHOT_BLOCK; g_flat rows are the flattened gather sites."""
    n = lam_flat.shape[0]
    if n <= _ONEHOT_BLOCK:
        return contract(lam_flat, g_flat)
    pad = (-n) % _ONEHOT_BLOCK
    lam_p = jnp.pad(lam_flat, (0, pad), constant_values=-1)  # matches no col
    g_p = jnp.pad(g_flat, ((0, pad), (0, 0)))
    lam_b = lam_p.reshape(-1, _ONEHOT_BLOCK)
    g_b = g_p.reshape(-1, _ONEHOT_BLOCK, g_flat.shape[1])

    def body(acc, xs):
        return acc + contract(*xs), None

    out, _ = jax.lax.scan(body, jnp.zeros(out_shape, g_flat.dtype),
                          (lam_b, g_b))
    return out


def _take_rows_bwd(res, g):
    lam, n_rows = res
    lam_flat = lam.reshape(-1)
    g_flat = g.reshape(-1, g.shape[-1])

    def contract(lam_b, g_b):
        onehot = (lam_b[:, None] ==
                  jnp.arange(n_rows, dtype=lam_b.dtype)[None, :])
        return jnp.einsum("rl,rs->ls", onehot.astype(g_b.dtype), g_b,
                          precision=jax.lax.Precision.HIGHEST)

    return _chunked(lam_flat, g_flat, contract,
                    (n_rows, g_flat.shape[1])), None


take_rows.defvjp(_take_rows_fwd, _take_rows_bwd)


def sample_cie(cie, lambdas):
    """cie: (3, 471); lambdas (..., 4) -> (..., 3, 4) response rows.

    The reference indexes the 360nm-based CIE tables at lambda+40
    (wgsl:324-338); every runtime index lies in [40, 341) because
    wavelength indices wrap mod 301 (sample_wavelengths), so the +40
    offset is applied by pre-slicing. One row-indexed gather of the
    (301, 3) transposed window replaces three scalar gathers of the
    full tables, so each gathered row is contiguous.
    """
    window = jnp.swapaxes(
        cie[:, C.CIE_OFFSET:C.CIE_OFFSET + C.N_LAMBDA], 0, 1)  # (301, 3)
    return jnp.swapaxes(take_rows(window, lambdas), -1, -2)  # (..., 3, 4)


def spectral_to_xyz(cie, radiance, lambdas):
    """Riemann sum over the 4 hero wavelengths (wgsl:419-426).

    radiance: (..., 4); returns (..., 3) XYZ. Contracts the gathered
    (..., 4, 3) CIE rows directly. Precision.HIGHEST: the default lets
    a GPU run this f32 contraction in TF32.
    """
    window = jnp.swapaxes(
        cie[:, C.CIE_OFFSET:C.CIE_OFFSET + C.N_LAMBDA], 0, 1)  # (301, 3)
    bars = take_rows(window, lambdas)  # (..., 4, 3)
    xyz = jnp.einsum("...jk,...j->...k", bars, radiance,
                     precision=jax.lax.Precision.HIGHEST)
    scale = jnp.float32(
        (C.LAMBDA_MAX - C.LAMBDA_MIN) / (C.CIE_Y_INTEG * C.N_HERO)
    )
    return xyz * scale
