"""Visibility/silhouette gradients (ops/warp.py) vs finite differences.

The estimator is discontinuous in its sampling domains; interior AD
(common random numbers, detached sampling) sees NONE of the boundary
motion — finite differences see ALL of it. These tests pin the
warped-area reparameterization at three levels:

1. core identity on an ANALYTIC 2D step (no renderer): the AD boundary
   flux must match the closed form within ~10% — this is the test that
   caught the round-3 field construction integrating only ~60% of the
   flux (kernel-reweighting over fixed aux flags; fixed by the
   analytic coverage-profile field, see _make_field);
2. the light-area warp in ISOLATION on a half-plane blocker with a
   closed-form derivative;
3. the full renderer on presets.occluder_scene: a translating occluder
   whose screen silhouette and cast shadow are the entire image
   derivative (interior AD is identically zero — asserted). Screen
   domain matches FD tightly; the shadow (light-domain) test uses the
   documented approximation band of this method family (projective
   obliquity + domain-border taper + silhouette corners), asserting
   the warp captures the MAJORITY of the FD boundary signal where
   interior AD captures exactly none.

FD evaluations use render_sample(stratified=False) — bit-identical
primal to every vis_grads mode (test below) at ~10x less cost.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from computeraytracer.ops import intersect as isect
from computeraytracer.ops import sampling
from computeraytracer.ops import warp
from computeraytracer.scene import presets, scene_from_dict
from computeraytracer.scene import data as scene_data
from computeraytracer.tracer import xla as xt

SG = jax.lax.stop_gradient
W = H = 32
OCC = 3  # occluder primitive row in presets.occluder_scene


@pytest.fixture(scope="module")
def occ_scene():
    scene, _ = scene_from_dict(presets.occluder_scene(W, H))
    return scene_data.as_jax(scene)


def _weights():
    rng = np.random.default_rng(5)
    ramp = (0.25 + np.arange(W) / W)[None, :, None]
    base = (ramp * rng.uniform(0.7, 1.3, (H, W, 3))).astype(np.float32)
    sil = np.zeros((H, W, 3), np.float32)
    sil[7:18] = base[7:18]          # occluder silhouette block rows
    sha = np.zeros((H, W, 3), np.float32)
    sha[25:32] = base[25:32]        # floor shadow rows
    return sil, sha


def _make_loss(scene, weight, domains, spp, cheap=False):
    wgt = jnp.asarray(weight)

    def loss(dx):
        d1 = jnp.asarray(scene.primitives.data1).at[OCC, 0].add(dx)
        s = scene._replace(primitives=scene.primitives._replace(data1=d1))

        def body(acc, k):
            kw = dict(stratified=False) if cheap else dict(vis_grads=domains)
            img = xt.render_sample(s, W, H, k, max_depth=1,
                                   use_remat=False, **kw)
            return acc + img, None

        acc, _ = jax.lax.scan(body, jnp.zeros((H, W, 3), jnp.float32),
                              jnp.arange(1, spp + 1, dtype=jnp.uint32))
        return jnp.sum(acc / spp * wgt)

    return loss


def _fd(scene, weight, spp=2048, eps=0.06):
    jl = jax.jit(_make_loss(scene, weight, (), spp, cheap=True))
    return (float(jl(jnp.float32(eps)))
            - float(jl(jnp.float32(-eps)))) / (2 * eps)


def _ad(scene, weight, domains, spp=512):
    g = jax.jit(jax.grad(_make_loss(scene, weight, domains, spp)))
    return float(g(jnp.float32(0.0)))


# ---------------------------------------------------------------------------
# 1. primal invariance
# ---------------------------------------------------------------------------

def test_primal_bit_identical_across_warp_modes(occ_scene):
    """Every vis_grads subset (and the cheap stratified=False render)
    produces the bit-identical image: warps are exactly the identity
    primally (x - stop_grad(x) == 0.0, detj == 1.0)."""
    base = np.asarray(xt.render_sample(occ_scene, W, H, 1, max_depth=2,
                                       stratified=False))
    for doms in [("screen",), ("light",), ("hemi",), True]:
        img = np.asarray(xt.render_sample(occ_scene, W, H, 1, max_depth=2,
                                          vis_grads=doms))
        np.testing.assert_array_equal(img, base, err_msg=str(doms))


def test_vis_grads_str_and_bad_domain():
    assert xt._vis_domains("screen") == ("screen",)
    assert xt._vis_domains(True) == ("screen", "light", "hemi")
    with pytest.raises(ValueError):
        xt._vis_domains(("scren",))


# ---------------------------------------------------------------------------
# 2. core identity on an analytic step
# ---------------------------------------------------------------------------

def _step_loss(u, w_pix, npix, a=2.0, b=0.5, s0=0.53125, rad=0.04):
    """Warp machinery on f = a if x < s0+theta else b, with static pixel
    binning + tent splat exactly like the renderer's screen domain."""
    offs = warp.ring_offsets(8) * rad

    def loss(theta):
        a_k = SG(u)[:, None, :] + offs
        fg = a_k[..., 0] < (s0 + SG(theta))
        s_k = jnp.where(fg[..., None],
                        a_k + jnp.stack([theta - SG(theta),
                                         jnp.zeros_like(theta)]),
                        a_k)
        z_k = jnp.where(fg, 1.0, 2.0)
        idx_k = jnp.where(fg, 1, 0)
        field = warp._make_field(a_k, s_k, z_k, idx_k, bandwidth=rad,
                                 beta=8.0)
        uv_w, detj = warp._reparam(field, u, margins=(0.1, 0.1))
        f = jnp.where(uv_w[:, 0] < (s0 + theta), a, b)
        pi = jnp.clip((SG(u) * npix).astype(jnp.int32), 0, npix - 1)
        out = f * detj * w_pix[pi[:, 1], pi[:, 0]]
        g = uv_w * npix - 0.5
        x0 = jnp.floor(SG(g))
        for dx in (0.0, 1.0):
            for dy in (0.0, 1.0):
                q = x0 + jnp.array([dx, dy])
                kk = (jnp.maximum(0.0, 1.0 - jnp.abs(g[:, 0] - q[:, 0]))
                      * jnp.maximum(0.0, 1.0 - jnp.abs(g[:, 1] - q[:, 1])))
                qi = jnp.clip(q.astype(jnp.int32), 0, npix - 1)
                out = out + (kk - SG(kk)) * SG(f * detj) * w_pix[qi[:, 1],
                                                                 qi[:, 0]]
        return jnp.mean(out)

    return loss


@pytest.mark.parametrize("wkind", ["flat", "rand"])
def test_synthetic_step_boundary_flux(wkind):
    """AD of the warped estimator == d/dtheta of the true integral
    (A - B) * mean edge weight, within ~10%, on an analytic step."""
    npix = 16
    rng = np.random.default_rng(0)
    u = jnp.asarray(rng.uniform(0, 1, (120000, 2)).astype(np.float32))
    if wkind == "flat":
        w_np = np.ones((npix, npix), np.float32)
    else:
        w_np = rng.uniform(0.5, 1.5, (npix, npix)).astype(np.float32)
    w_pix = jnp.asarray(w_np)
    # edge at a pixel CENTER (s0 = 8.5/16): the splat tent-interpolates
    # pixel weights, so an edge on a pixel border would see the average
    # of two columns instead of one
    ad = float(jax.jit(jax.grad(_step_loss(u, w_pix, npix)))(
        jnp.float32(0.0)))
    analytic = (2.0 - 0.5) * w_np[:, npix // 2].mean()
    assert abs(ad - analytic) <= 0.12 * analytic, (ad, analytic)


# ---------------------------------------------------------------------------
# 3. light-area warp in isolation (closed form)
# ---------------------------------------------------------------------------

def test_light_warp_matches_analytic():
    """Half-plane blocker at y=1 (edge x = theta), unit-ish light at
    y=2: visible fraction is 1 - (0.5 + 2.5 theta) for a shade point at
    the origin, so dL/dtheta = -2.5 exactly. The warp's AD must land
    within ~10% (FD of the same MC estimator confirms)."""
    doc = {
        "camera": {"eye": [0, 0, 5], "lookat": [0, 0, 0], "up": [0, 1, 0],
                   "focalLength": 0.9, "width": 8, "height": 8},
        "objects": {"patches": [
            {"origin": [-10, 1, -10], "edge1": [10, 0, 0],
             "edge2": [0, 0, 20], "emission": "dark",
             "reflectance": "white", "type": "diffuse"},
            {"origin": [-0.4, 2, -0.4], "edge1": [0.8, 0, 0],
             "edge2": [0, 0, 0.8], "emission": "light",
             "reflectance": "white", "type": "light"},
        ], "spheres": []},
        "spectra": presets._cornell_spectra(),
    }
    scene0, _ = scene_from_dict(doc)
    scene0 = scene_data.as_jax(scene0)
    l_prim_i = 1
    rng = np.random.default_rng(3)
    n = 120000
    uv = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    u0, v0 = jnp.asarray(uv[:, 0]), jnp.asarray(uv[:, 1])

    def loss(dx):
        d1 = jnp.asarray(scene0.primitives.data1).at[0, 0].add(dx)
        s = scene0._replace(primitives=scene0.primitives._replace(data1=d1))
        prims = s.primitives
        shade = jnp.zeros((n, 3), jnp.float32)
        exclude = jnp.full((n,), isect.NO_INDEX, jnp.int32)
        active = jnp.ones((n,), bool)
        l_origin = jnp.broadcast_to(prims.data1[l_prim_i], (n, 3))
        l_e1 = jnp.broadcast_to(prims.data2[l_prim_i], (n, 3))
        l_e2 = jnp.broadcast_to(prims.data3[l_prim_i], (n, 3))
        l_prim = jnp.full((n,), l_prim_i, jnp.int32)
        uw, vw, detj = warp.light_warp(s, shade, exclude, l_origin, l_e1,
                                       l_e2, l_prim, u0, v0, active)
        p = sampling.point_on_light(l_origin, l_e1, l_e2, uw, vw)
        ldir = isect.safe_normalize(p - shade)
        sh = isect.intersect_brute(shade, ldir, exclude, prims)
        vis = (sh.hit & (sh.index == l_prim_i)).astype(jnp.float32)
        return jnp.mean(vis * detj)

    ad = float(jax.jit(jax.grad(loss))(jnp.float32(0.0)))
    assert abs(ad - (-2.5)) <= 0.25, ad  # 10% of the analytic -2.5


# ---------------------------------------------------------------------------
# 4. full renderer: screen silhouette
# ---------------------------------------------------------------------------

def test_screen_silhouette_matches_fd(occ_scene):
    """Occluder silhouette sweeping the weighted image: FD is pure
    boundary signal (interior AD = 0, asserted), and the screen warp
    recovers it. Tolerance covers FD + AD Monte Carlo noise at these
    sample counts (both estimate the same boundary integral)."""
    sil, _ = _weights()
    fd = _fd(occ_scene, sil)
    # interior-only AD under the same unstratified jitter: the light
    # warp is enabled but no shadow edge crosses these rows, so it
    # contributes ~nothing; the screen boundary term is entirely absent
    ad_interior = _ad(occ_scene, sil, ("light",), spp=256)
    ad_screen = _ad(occ_scene, sil, ("screen",), spp=512)
    assert abs(fd) > 1.0  # the band really carries boundary signal
    assert abs(ad_interior) <= 0.10 * abs(fd), (ad_interior, fd)
    assert abs(ad_screen - fd) <= 0.25 * abs(fd), (ad_screen, fd)


# ---------------------------------------------------------------------------
# 5. full renderer: cast shadow (light + hemi domains)
# ---------------------------------------------------------------------------

def test_shadow_boundary_majority_captured(occ_scene):
    """Moving soft shadow on the floor: interior AD is exactly zero;
    the light-area warp must recover the MAJORITY of the FD boundary
    flux. The capture band (not ~1.0) is the documented approximation
    of this warp family on oblique projective geometry: the shadow rays
    here leave the floor at ~50 degrees to the light plane, and the
    blocked-region boundary terminates in corners, both outside the
    straight-edge model of _make_field (the same machinery measures
    0.9-1.05 on normal-incidence geometry: test_light_warp above)."""
    _, sha = _weights()
    fd = _fd(occ_scene, sha)
    ad_interior = _ad(occ_scene, sha, ("screen",), spp=256)
    ad_light = _ad(occ_scene, sha, ("light", "hemi"), spp=512)
    assert abs(fd) > 2.0
    assert abs(ad_interior) <= 0.05 * abs(fd), (ad_interior, fd)
    ratio = ad_light / fd
    assert 0.40 <= ratio <= 1.10, (ad_light, fd)


# ---------------------------------------------------------------------------
# 6. Triton megakernel path: screen warp wrapped around the kernel
# ---------------------------------------------------------------------------

def test_pallas_screen_warp_matches_xla(occ_scene):
    """The screen warp on the megakernel path (tracer/pallas.py
    render_pixels vis_grads=("screen",)): primal allclose to the XLA
    path's screen-warp render (same draws, same estimator; equality is
    to f32 rounding, as for every kernel-vs-xla image comparison),
    gradient close (the kernel's custom_vjp backward is the XLA
    tracer's, warp included)."""
    from computeraytracer.tracer import pallas as pt

    static = pt.SceneStatic.from_scene(occ_scene)
    a = np.asarray(xt.render_sample(occ_scene, W, H, 1, max_depth=1,
                                    vis_grads=("screen",),
                                    use_remat=False))
    b = np.asarray(pt.render_sample(occ_scene, W, H, 1, max_depth=1,
                                    static=static,
                                    vis_grads=("screen",), interpret=True))
    np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-6)

    sil, _ = _weights()
    wgt = jnp.asarray(sil)

    def loss_of(render):
        def loss(dx):
            d1 = jnp.asarray(occ_scene.primitives.data1).at[OCC, 0].add(dx)
            s = occ_scene._replace(
                primitives=occ_scene.primitives._replace(data1=d1))

            def body(acc, k):
                return acc + render(s, k), None

            acc, _ = jax.lax.scan(body, jnp.zeros((H, W, 3), jnp.float32),
                                  jnp.arange(1, 65, dtype=jnp.uint32))
            return jnp.sum(acc / 64 * wgt)

        return loss

    g_xla = float(jax.jit(jax.grad(loss_of(
        lambda s, k: xt.render_sample(s, W, H, k, max_depth=1,
                                      vis_grads=("screen",),
                                      use_remat=False))))(jnp.float32(0.0)))
    g_pal = float(jax.jit(jax.grad(loss_of(
        lambda s, k: pt.render_sample(s, W, H, k, max_depth=1,
                                      static=static,
                                      vis_grads=("screen",),
                                      interpret=True))))(
        jnp.float32(0.0)))
    assert abs(g_pal - g_xla) <= 0.05 * max(1.0, abs(g_xla)), (g_pal, g_xla)


def test_silhouette_recovery_on_fast_path(occ_scene):
    """r4 ask 7's "done" bar: a silhouette-recovery optimization — move
    a displaced occluder back to its target position — CONVERGES using
    gradients from the megakernel path (screen warp around the
    kernel). Interior AD alone has exactly zero signal for a pure
    translation (asserted in test_screen_silhouette_matches_fd), so
    any recovery is the boundary term."""
    import optax

    from computeraytracer.tracer import pallas as pt

    static = pt.SceneStatic.from_scene(occ_scene)
    spp = 32

    @jax.jit
    def render_mean(dx):
        d1 = jnp.asarray(occ_scene.primitives.data1).at[OCC, 0].add(dx)
        s = occ_scene._replace(
            primitives=occ_scene.primitives._replace(data1=d1))

        def body(acc, k):
            return acc + pt.render_sample(s, W, H, k, max_depth=1,
                                          static=static,
                                          vis_grads=("screen",),
                                          interpret=True), None

        acc, _ = jax.lax.scan(body, jnp.zeros((H, W, 3), jnp.float32),
                              jnp.arange(1, spp + 1, dtype=jnp.uint32))
        return acc / spp

    target = jax.lax.stop_gradient(render_mean(jnp.float32(0.0)))

    def loss(dx):
        return jnp.mean((render_mean(dx) - target) ** 2) * 1e3

    gfn = jax.jit(jax.value_and_grad(loss))
    dx = jnp.float32(0.22)   # ~2 pixels of silhouette displacement
    opt = optax.adam(5e-2)
    state = opt.init(dx)
    dx0 = float(dx)
    for _ in range(25):
        _, g = gfn(dx)
        upd, state = opt.update(g, state)
        dx = optax.apply_updates(dx, upd)
    assert abs(float(dx)) < abs(dx0) / 3, (
        f"occluder did not recover: dx {dx0} -> {float(dx)}")
