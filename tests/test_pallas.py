"""Triton megakernel vs the XLA tracer: same estimator, same RNG.

The megakernel consumes the identical pcg4d draw stream as tracer/xla.py
(kernels/megakernel.py mirrors ops/rng.py on u32 vectors), so per-pixel
XYZ must agree to f32 rounding. On the CPU the kernel runs in the
Pallas interpreter (interpret=True); the compiled kernel is checked on
the card by the gpu-marked test below and by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from computeraytracer.kernels import megakernel as mk
from computeraytracer.scene import presets, scene_from_dict
from computeraytracer.tracer import pallas as pallas_tracer
from computeraytracer.tracer import xla as xla_tracer

SCENES = {
    "simple": presets.simple_scene,
    "cornell": presets.cornell_box,
    "glass_mirror": presets.multi_material_box,
}


def _match_fraction(got, want, tol):
    denom = np.maximum(np.abs(want), 1e-2)
    rel = np.abs(got - want) / denom
    return (rel < tol).all(axis=-1).mean(), rel.max()


def _compare(scene, w, h, sample, max_depth, tol=1e-4, min_frac=0.999):
    want = np.asarray(
        xla_tracer.render_sample(scene, w, h, sample, max_depth=max_depth))
    got = np.asarray(pallas_tracer.render_sample(
        scene, w, h, sample, max_depth=max_depth, interpret=True))
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    frac, worst = _match_fraction(got, want, tol)
    assert frac >= min_frac, (
        f"only {frac:.4f} of pixels match (worst rel {worst:.3g})")


def test_simple_scene(simple_scene):
    _compare(simple_scene, 16, 16, sample=1, max_depth=3)


def test_cornell(cornell_scene):
    _compare(cornell_scene, 16, 16, sample=2, max_depth=4)


@pytest.mark.parametrize("depth", [1, 3, 8])
@pytest.mark.parametrize("scene_name", sorted(SCENES))
def test_kernel_matches_xla(scene_name, depth):
    # f32 association differs between the kernel and XLA's fusions; a
    # Fresnel or Russian-roulette decision at a rounding boundary can
    # flip a whole path, so almost all pixels must match, not all
    scene, _ = scene_from_dict(SCENES[scene_name](16, 8))
    _compare(scene, 16, 8, sample=2, max_depth=depth, min_frac=0.99)


def test_ray_count_not_multiple_of_block(cornell_scene):
    """12x9 = 108 rays: one partly filled block; padded lanes are inert."""
    assert (12 * 9) % mk.BLOCK
    _compare(cornell_scene, 12, 9, sample=1, max_depth=3)


def test_accumulate_matches_xla(simple_scene):
    w = h = 12
    want = np.asarray(xla_tracer.render_accumulate(
        simple_scene, w, h, spp=2, max_depth=3))
    got = np.asarray(pallas_tracer.render_accumulate(
        simple_scene, w, h, spp=2, max_depth=3, interpret=True))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_compiled_kernel_refuses_cpu(simple_scene):
    """Without interpret=True the kernel compiles for the GPU only; on
    another backend it raises instead of silently interpreting."""
    with pytest.raises(RuntimeError, match="GPU backend"):
        pallas_tracer.render_sample(simple_scene, 8, 8, 1, max_depth=1)


def test_scene_static_refuses_mesh_scale():
    """Mesh-size scenes are not unrolled into the kernel."""
    scene, _ = scene_from_dict(presets.mesh_scene(8, 8, subdivisions=2))
    with pytest.raises(ValueError, match="BVH"):
        pallas_tracer.SceneStatic.from_scene(scene)


@pytest.mark.parametrize("backward", ["xla"])
def test_spectra_gradient_matches_xla(simple_scene, backward):
    """The kernel's custom_vjp backward (JAX AD of the XLA tracer on the
    same sample, the only backward) == XLA AD."""
    w = h = 8

    def loss(tracer, spectra, **kw):
        s = simple_scene._replace(spectra=spectra)
        return jnp.sum(tracer.render_sample(s, w, h, 1, max_depth=2,
                                            **kw) ** 2)

    spectra = jnp.asarray(simple_scene.spectra)
    g_pal = np.asarray(jax.grad(
        lambda sp: loss(pallas_tracer, sp, interpret=True))(spectra))
    g_xla = np.asarray(jax.grad(lambda sp: loss(xla_tracer, sp))(spectra))
    assert np.isfinite(g_pal).all()
    np.testing.assert_allclose(g_pal, g_xla, rtol=1e-3, atol=1e-5)


def test_geometry_and_camera_gradient_matches_xla(simple_scene):
    """The backward reaches geometry AND camera."""
    w = h = 8

    def loss(tracer, d1, eye, **kw):
        s = simple_scene._replace(
            primitives=simple_scene.primitives._replace(data1=d1),
            camera=simple_scene.camera._replace(eye=eye))
        img = tracer.render_sample(s, w, h, 1, max_depth=2, **kw)
        return jnp.sum(img ** 2)

    d1 = jnp.asarray(simple_scene.primitives.data1)
    eye = jnp.asarray(simple_scene.camera.eye)
    g_pal = jax.grad(lambda a, b: loss(pallas_tracer, a, b, interpret=True),
                     argnums=(0, 1))(d1, eye)
    g_xla = jax.grad(lambda a, b: loss(xla_tracer, a, b),
                     argnums=(0, 1))(d1, eye)
    for gp, gx in zip(g_pal, g_xla):
        gp, gx = np.asarray(gp), np.asarray(gx)
        assert np.isfinite(gp).all()
        scale = max(np.abs(gx).max(), 1e-6)
        np.testing.assert_allclose(gp / scale, gx / scale,
                                   rtol=1e-3, atol=1e-4)


def test_gradient_inside_jit_scan(simple_scene):
    """Gradients through the kernel inside a jitted sample scan (the
    sample index is a scan tracer crossing the custom_vjp)."""
    w = h = 8
    static = pallas_tracer.SceneStatic.from_scene(simple_scene)

    def loss(tracer, spectra, **kw):
        s = simple_scene._replace(spectra=spectra)

        def body(acc, k):
            return acc + tracer.render_sample(s, w, h, k, max_depth=2,
                                              **kw), None

        img, _ = jax.lax.scan(body, jnp.zeros((h, w, 3)),
                              jnp.arange(1, 3, dtype=jnp.uint32))
        return jnp.sum(img ** 2)

    spectra = jnp.asarray(simple_scene.spectra)
    g_pal = jax.jit(jax.grad(lambda sp: loss(
        pallas_tracer, sp, static=static, interpret=True)))(spectra)
    g_xla = jax.jit(jax.grad(lambda sp: loss(xla_tracer, sp)))(spectra)
    np.testing.assert_allclose(np.asarray(g_pal), np.asarray(g_xla),
                               rtol=1e-3, atol=1e-5)


@pytest.mark.gpu
def test_compiled_kernel_matches_xla_on_gpu(gpu_device):
    """The kernel as compiled for the card agrees with the XLA tracer."""
    w = h = 64
    scene, _ = scene_from_dict(presets.multi_material_box(w, h))
    want = np.asarray(xla_tracer.render_sample(scene, w, h, 1, max_depth=8))
    got = np.asarray(pallas_tracer.render_sample(scene, w, h, 1,
                                                 max_depth=8))
    frac, worst = _match_fraction(got, want, 1e-3)
    assert frac >= 0.99, (frac, worst)


def test_ray_chunk_bands_through_kernel(cornell_scene):
    """render()'s ray_chunk row bands run through the megakernel as well
    (tracer/api.py) and match its one-shot accumulation."""
    from computeraytracer import RenderConfig
    from computeraytracer.tracer import api

    cfg = RenderConfig(width=16, height=16, spp=2, max_depth=3,
                       kernel="triton", ray_chunk=64)
    static = pallas_tracer.SceneStatic.from_scene(cornell_scene)
    got = np.asarray(api._render_accumulate_chunked(
        cornell_scene, cfg, None, static, interpret=True))
    want = np.asarray(pallas_tracer.render_accumulate(
        cornell_scene, 16, 16, 2, 3, interpret=True))
    assert got.shape == want.shape == (16, 16, 3)
    frac, worst = _match_fraction(got, want, 1e-4)
    assert frac >= 0.99, (frac, worst)


@pytest.mark.parametrize("preset,paths,backend,kernel,want", [
    ("cornell_box", 1024 * 1024 * 1024, "gpu", "auto", "triton"),
    ("cornell_box", 1024 * 1024 * 64, "gpu", "auto", "xla"),
    ("mesh_scene", 1024 * 1024 * 1024, "gpu", "auto", "xla"),
    ("cornell_box", 1024 * 1024 * 1024, "cpu", "auto", "xla"),
    ("cornell_box", 16, "cpu", "triton", "triton"),
    ("cornell_box", 1024 * 1024 * 1024, "gpu", "xla", "xla"),
])
def test_auto_kernel_choice(monkeypatch, preset, paths, backend, kernel,
                            want):
    """kernel="auto" takes the megakernel only on a GPU, for a scene it
    unrolls, and for a render long enough to pay for its compile."""
    from computeraytracer.tracer import api

    kw = {"subdivisions": 1} if preset == "mesh_scene" else {}
    scene, _ = scene_from_dict(getattr(presets, preset)(8, 8, **kw))
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert api.resolve_kernel(scene, kernel, paths) == want
