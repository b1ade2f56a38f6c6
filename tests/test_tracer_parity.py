"""Golden tests: vectorized XLA tracer vs the scalar NumPy oracle.

Because both consume identical pcg4d streams, images must match to f32
rounding; a tiny fraction of pixels may diverge where accumulated
rounding flips a Russian-roulette or tie decision."""

import numpy as np
import pytest

from computeraytracer.scene import presets, scene_from_dict
from computeraytracer.tracer import reference_cpu as oracle
from computeraytracer.tracer import xla as xla_tracer


def _compare(scene, w, h, sample, max_depth, frac_close=0.995, tol=1e-3,
             energy_frac=1e-3):
    want = oracle.render_sample(scene, w, h, sample, max_depth)
    got = np.asarray(xla_tracer.render_sample(scene, w, h, sample, max_depth))
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    denom = np.maximum(np.abs(want), 1e-2)
    rel = np.abs(got - want) / denom
    close = (rel < tol).all(axis=-1)
    frac = close.mean()
    assert frac >= frac_close, (
        f"only {frac:.4f} of pixels match (worst rel {rel.max():.3g})")
    # bound the DIVERGENT set too: a masking bug hiding in the <0.5%
    # escape hatch would carry real energy. Total |got-want| energy in
    # divergent pixels must be a negligible fraction of image energy.
    div_energy = np.abs(got - want)[~close].sum()
    total = np.abs(want).sum() + 1e-12
    assert div_energy <= energy_frac * total, (
        f"divergent pixels carry {div_energy / total:.3e} of image "
        f"energy (limit {energy_frac:g})")


def test_simple_scene_primary(simple_scene):
    # config-1 style: few primitives, short paths
    _compare(simple_scene, 24, 24, sample=1, max_depth=2)


def test_simple_scene_deeper(simple_scene):
    _compare(simple_scene, 16, 16, sample=3, max_depth=6)


def test_cornell_multibounce(cornell_scene):
    # full Cornell incl. glass sphere + coplanar light tie-breaking
    _compare(cornell_scene, 20, 20, sample=1, max_depth=5)


def test_cornell_second_sample(cornell_scene):
    _compare(cornell_scene, 12, 12, sample=7, max_depth=8)


@pytest.mark.parametrize("depth", [1, 8])
@pytest.mark.parametrize("preset", ["cornell_box_glassless",
                                    "occluder_scene", "mesh_scene"])
def test_more_scenes_and_depths(preset, depth):
    """Pure diffuse, an occluded light, and triangles (brute scan), each
    at a single bounce and at the full depth 8."""
    kw = {"subdivisions": 1} if preset == "mesh_scene" else {}
    scene, _ = scene_from_dict(getattr(presets, preset)(16, 16, **kw))
    _compare(scene, 16, 16, sample=2, max_depth=depth)


def test_mean_energy_sane(cornell_scene):
    img = np.asarray(xla_tracer.render_sample(cornell_scene, 32, 32, 1, 6))
    # Y channel (luminance) should be positive on average and finite
    assert np.isfinite(img).all()
    assert img[..., 1].mean() > 0.01


def test_depth_cap_energy_converged(cornell_scene):
    """The reference caps at MAXDEPTH=100 (ComputeShader.wgsl:14) but is
    Russian-roulette-bounded in practice; this build defaults to
    max_depth=8 (SURVEY.md §7 step 5). Justify the truncation: with
    identical seeds, doubling the cap to 16 must change total image
    energy by <0.5% — the RR tail beyond 8 bounces carries negligible
    radiance in the Cornell box."""
    w = h = 24
    spp = 4
    e8 = np.asarray(
        xla_tracer.render_accumulate(cornell_scene, w, h, spp, max_depth=8))
    e16 = np.asarray(
        xla_tracer.render_accumulate(cornell_scene, w, h, spp, max_depth=16))
    assert np.isfinite(e8).all() and np.isfinite(e16).all()
    tot8, tot16 = np.abs(e8).sum(), np.abs(e16).sum()
    rel = abs(tot16 - tot8) / tot16
    # deeper cap can only ADD energy (same seeds, truncation only)
    assert tot16 >= tot8 - 1e-4 * tot16
    assert rel < 5e-3, f"depth-8 truncation loses {rel:.4%} of energy"
