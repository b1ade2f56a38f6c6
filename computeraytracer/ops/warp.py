"""Warped-area reparameterization: visibility/silhouette gradients.

The path-tracing estimator is discontinuous in its sampling domains —
which primitive a primary ray hits (screen space), whether a shadow ray
reaches the light (light-area space), and what a BSDF bounce ray hits
(hemisphere space) all flip as geometry moves. Interior AD (detached
sampling, common random numbers) differentiates everything EXCEPT the
motion of those discontinuity boundaries, so vertex gradients of scenes
with visible silhouettes or shadows miss the boundary term that finite
differences see. The reference estimator has the same discontinuities
(reference/src/shaders/ComputeShader.wgsl:119-295, 503-518);
differentiating it correctly is a north-star capability (BASELINE
config 3), not a reference feature.

Method — reparameterized sampling in the style of Loubet et al. 2019
("Reparameterizing discontinuous integrands") with the
change-of-variables factor of warped-area sampling (Bangaru et al.
2020). Each 2D sampling domain u gets a warp

    T(u) = u + V(u;theta),   V = F(u;theta) - stop_grad(F(u;theta)),

where F is a smoothed centroid field built from K auxiliary rays in a
fixed ring around the sample. V is exactly zero primally
(x - stop_grad(x) == 0.0 in f32), so primal renders are bit-identical
with the warp on; under AD, dV/dtheta is the local velocity of the
visible geometry. Each warped sample's contribution is multiplied by

    detJ = 1 + (div_u F - stop_grad(div_u F)),

(exact to first order since V == 0 primally) whose theta-derivative is
the divergence of the velocity field: by the divergence theorem,
E[grad_u f . V' + f div_u V'] equals the boundary integral of the
moving discontinuity whenever V' matches the boundary velocity on it.
div_u F comes from two jax.jvp calls along the domain axes
(forward-over-reverse under the outer jax.grad is fine).

Two details are load-bearing:

1. **Material velocity, not intersection velocity.** The hit point of a
   FIXED auxiliary ray always lies on that ray, so projecting it back
   into the sampling domain returns the auxiliary sample itself — zero
   velocity, no matter how the geometry moves. The velocity that moves
   with silhouettes is that of the surface MATERIAL point: the hit
   re-expressed in its primitive's own local coordinates (patch (u,v),
   triangle barycentrics, sphere unit normal), with the local
   coordinates detached and the primitive's frame theta-attached
   (`material_point`). For a translating primitive this is exactly the
   translation — and a silhouette is carried by its surface, so the
   boundary-velocity condition holds for rigid motion (rotation adds
   the usual O(ring radius) tangential error of this method family).

2. **Theta-detached auxiliary intersections.** Auxiliary closest-hits
   run against a stop_gradient'ed scene, so the aux hit t / index /
   position carry u-tangents (for the divergence) but no
   theta-gradient: the nearest-surface weights then contribute no
   spurious d(weight)/d(theta) terms, and near-grazing aux hits (whose
   dt/dtheta explodes) cannot blow up the estimator. Theta enters F
   only through the material-point reconstruction.

Weights prefer the NEAREST surface (exp(-beta (z - z_min)/z_min)):
the occluder owns the silhouette, so the field approaches the
occluder's velocity on both sides of the boundary.

Scope and measured accuracy (tests/test_visibility_grads.py):
boundary terms are captured for the screen, light-area (NEE shadow)
and cosine-hemisphere domains on diffuse vertices. On an analytic 2D
step and on normal-incidence occlusion the AD flux lands within ~5-10%
of the closed form / converged FD; on the full renderer the screen
silhouette matches FD within MC noise (~10-25%), while strongly
OBLIQUE projective geometry (shadow rays leaving the surface far from
the light-plane normal) plus silhouette CORNERS degrade the light-
domain capture to ~0.5-0.7 of the FD flux — the straight-edge
coverage model and the domain-border taper are the approximations.
Specular (glass) chains and rotation-induced tangential silhouette
motion remain out of scope; cost is 2*K auxiliary closest-hit scans
per warped domain per bounce. Off by default (vis_grads=False);
intended for the XLA path (tracer/xla.py), whose AD is every gradient
in this framework; the Triton forward's backward recomputes it.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from computeraytracer.ops import camera as cam_ops
from computeraytracer.ops import intersect as isect

_SG = jax.lax.stop_gradient
_BIG = 1e8


def _dot(a, b):
    return jnp.sum(a * b, axis=-1)


def _ring_offsets_np(k: int):
    """(K, 2) fixed offsets: a SINGLE unit circle of K points — fixed
    constants so auxiliary rays consume no RNG and the primal stream is
    untouched. The single-radius design is load-bearing: with the
    Gaussian kernel bandwidth equal to the ring radius, the kernel
    field reproduces LINEAR velocity fields with unit derivative gain
    (2 E[offs_ax^2] / bw^2 = 2 (r^2/2) / r^2 = 1), so the divergence
    estimator is exact for smooth fields (a mixed-radius ring halves
    it, leaving a large un-cancelled f*divV residue on every smooth
    region) while step transitions integrate correctly for any kernel
    (total variation is preserved by smoothing)."""
    a = 2 * np.pi * np.arange(k) / k
    return np.stack([np.cos(a), np.sin(a)], -1).astype(np.float32)


def ring_offsets(k: int = 8):
    return jnp.asarray(_ring_offsets_np(k))


def _sg_prims(prims):
    return jax.tree_util.tree_map(_SG, prims)


def material_point(prims, idx, p):
    """Hit point p of primitive idx re-expressed in the primitive's own
    local coordinates (detached), with the primitive's geometry arrays
    theta-attached: primally equal to p (up to recompute rounding, which
    the warp never exposes), but its theta-derivative is the SURFACE
    material velocity instead of the along-ray intersection slide."""
    d1 = prims.data1[idx]
    d2 = prims.data2[idx]
    d3 = prims.data3[idx]
    d1s, d2s, d3s = _SG(d1), _SG(d2), _SG(d3)
    m = _SG(p) - d1s

    # patch: p = d1 + u*d2 + v*d3 (data2/3 are edges)
    u_l = _dot(m, d2s) / jnp.maximum(_dot(d2s, d2s), 1e-12)
    v_l = _dot(m, d3s) / jnp.maximum(_dot(d3s, d3s), 1e-12)
    p_patch = d1 + u_l[..., None] * d2 + v_l[..., None] * d3

    # triangle: data1/2/3 are vertices; barycentric via the edge Gram
    e1s, e2s = d2s - d1s, d3s - d1s
    a11 = _dot(e1s, e1s)
    a12 = _dot(e1s, e2s)
    a22 = _dot(e2s, e2s)
    det = jnp.maximum(a11 * a22 - a12 * a12, 1e-12)
    r1 = _dot(m, e1s)
    r2 = _dot(m, e2s)
    b1 = (a22 * r1 - a12 * r2) / det
    b2 = (a11 * r2 - a12 * r1) / det
    p_tri = d1 + b1[..., None] * (d2 - d1) + b2[..., None] * (d3 - d1)

    # sphere: center data1, radius data2[0]; unit normal detached
    n_hat = isect.safe_normalize(m)
    p_sph = d1 + n_hat * d2[..., 0:1]

    cat = prims.category[idx]
    return jnp.where((cat == isect.CAT_SPHERE)[..., None], p_sph,
                     jnp.where((cat == isect.CAT_TRIANGLE)[..., None],
                               p_tri, p_patch))


def _edge_taper(uv, margins):
    """Per-axis envelope: 1 in the domain interior, 0 on [0,1] edges.

    The true loss integrates over a FIXED domain, so its derivative has
    no flux term at the domain boundary; the warp estimator would add a
    spurious \\oint f V.n there unless V.n vanishes on the boundary.
    Returns an (..., 2) per-COMPONENT envelope: env[..., ax] damps only
    V_ax near the ax-borders (where it is the border-normal component).
    Killing just the normal component zeroes the spurious border flux
    exactly while PRESERVING the flux across a silhouette that exits
    transversally through the border (its normal there is the border-
    tangent direction) — a scalar taper measured ~2x flux loss on
    shadow boundaries crossing a compact light domain. margins:
    per-axis taper width, or None for a periodic axis (no damping)."""
    envs = []
    for ax, m in enumerate(margins):
        if m is None:
            envs.append(jnp.ones_like(uv[..., ax]))
            continue
        x = jnp.clip(jnp.minimum(uv[..., ax], 1.0 - uv[..., ax]) / m,
                     0.0, 1.0)
        envs.append(x * x * (3.0 - 2.0 * x))
    return jnp.stack(envs, axis=-1)


def _reparam(field, uv, margins=None):
    """(uv_warped, detj) for a centroid field (..., 2) -> (..., 2).

    uv_warped == uv and detj == 1 primally; their theta-derivatives are
    the velocity and velocity-divergence of the (boundary-tapered)
    field."""
    if margins is not None:
        raw = field
        field = lambda uv: uv + _edge_taper(uv, margins) * (raw(uv) - uv)
    e0 = jnp.zeros_like(uv).at[..., 0].set(1.0)
    e1 = jnp.zeros_like(uv).at[..., 1].set(1.0)
    f, df0 = jax.jvp(field, (uv,), (e0,))
    _, df1 = jax.jvp(field, (uv,), (e1,))
    v = f - _SG(f)
    div = df0[..., 0] + df1[..., 1]
    detj = 1.0 + (div - _SG(div))
    return uv + v, detj


def _make_field(a_k, s_k, z_k, idx_k, bandwidth, beta):
    """Bump-modulated velocity field from FIXED auxiliary samples.

    a_k: (..., K, 2) aux domain positions (constants w.r.t. u — they
    were built at stop_grad(u)); s_k: (..., K, 2) aux target points
    (theta-attached; their theta-derivative is the material velocity);
    z_k: (..., K) theta-detached depths (misses carry _BIG); idx_k:
    (..., K) hit primitive ids (misses -1).

    Structure: F(u') = u' + G(u') * (C(u') - u'), where C is the
    nearest-surface-preferring centroid (the occluder owns the
    silhouette, so C's theta-velocity approaches the occluder velocity
    at the boundary) and G = 4 p (1-p) is a smooth bump on the local
    FOREGROUND COVERAGE p (foreground = aux rays that resolved to the
    same primitive as the nearest aux hit). G is 1 on the discontinuity
    (p = 1/2), decays to 0 at ring distance, and is identically 0 for
    uniform rings — so smooth regions carry ZERO velocity (exactly
    valid there). G is theta-constant (ids/depths are frozen), so
    d/dtheta F = G * dC.

    Self-consistency is load-bearing. The estimator integrates each
    sample's LOCAL u'-derivative of the field, so the per-sample
    profile must match how the field actually varies along the
    diagonal u -> F_u(u): any u-dependence that flows through the
    DISCRETE aux classification (flags flipping as the ring crosses
    the silhouette) is invisible to AD, and a kernel-reweighting field
    over fixed flags under-integrates the boundary flux by ~40%
    (measured on an analytic step). The fix implemented here
    reconstructs the silhouette ANALYTICALLY per sample:
      - edge normal n (toward background) from the fg/bg centroid
        split of the ring offsets,
      - signed edge distance delta from the coverage fraction via the
        EXACT straight-edge ring-coverage inverse: a straight edge at
        distance d from the ring center covers arc fraction
        p(d) = 1 - arccos(d / R) / pi, so delta = -R cos(pi p_bar) —
        the same function pair both ways, which is what makes the
        local derivative integrate to G(edge) exactly for straight
        edges (tests/test_visibility_grads.py pins the synthetic-step
        response at ~1.0; the old kernel-p field measured ~0.6),
      - analytic coverage profile p(u') = 1 - arccos((delta -
        (u' - u) . n) / R) / pi with frozen delta, n.
    The per-sample delta is a staircase estimate of the true distance
    (K discrete aux), but its error is mean-zero along the edge, so
    the integrated flux is first-order exact."""
    z_min = jnp.min(z_k, axis=-1, keepdims=True)
    pref = jnp.exp(-beta * (z_k - z_min) / jnp.maximum(z_min, 1e-6))
    near = jnp.argmin(z_k, axis=-1)
    idx_near = jnp.take_along_axis(idx_k, near[..., None], axis=-1)
    fg = (idx_k == idx_near).astype(jnp.float32)

    center = jnp.mean(a_k, axis=-2)                      # == sg(u)
    offs = a_k - center[..., None, :]
    R = jnp.float32(bandwidth)
    p_bar = jnp.mean(fg, axis=-1)
    # outward (toward-background) edge normal from the classification
    nvec = -jnp.sum(offs * (fg - p_bar[..., None])[..., None], axis=-2)
    nlen = jnp.sqrt(jnp.maximum(jnp.sum(nvec * nvec, axis=-1), 1e-20))
    n_hat = nvec / jnp.maximum(nlen[..., None], 1e-10)
    delta = -R * jnp.cos(jnp.pi * p_bar)
    eps = jnp.float32(1e-3)
    # uniform rings (p_bar exactly 0 or 1: every aux sample on one side)
    # are smooth-region samples and must carry EXACTLY zero velocity;
    # the arccos clip alone would leave them g ~ 4*eps-ish spurious
    # velocity that only cancels in expectation (ADVICE r4). The clip
    # stays for MIXED rings, where it merely bounds arccos' derivative.
    mixed = ((p_bar > 0.0) & (p_bar < 1.0)).astype(jnp.float32)

    def field(uv):
        # analytic coverage: all u'-dependence through the profile
        h = (delta - jnp.sum((uv - center) * n_hat, axis=-1)) / R
        p = 1.0 - jnp.arccos(jnp.clip(h, eps - 1.0, 1.0 - eps)) / jnp.pi
        g = mixed * 4.0 * p * (1.0 - p)
        d2 = jnp.sum((uv[..., None, :] - a_k) ** 2, axis=-1)
        b = jnp.exp(-d2 / (bandwidth * bandwidth))
        w = b * pref
        w_sum = jnp.maximum(jnp.sum(w, axis=-1, keepdims=True), 1e-12)
        c = jnp.sum(w[..., None] * s_k, axis=-2) / w_sum
        return uv + g[..., None] * (c - uv)

    return field


def screen_warp(scene, width, height, s, t, k: int = 8,
                radius_px: float = 1.5, beta: float = 8.0):
    """Warp film coordinates so primary silhouettes move with geometry.

    s, t: (...,) film coords of the primal sample. Returns
    (s', t', detj) with s' == s, t' == t, detj == 1 primally."""
    cam = scene.camera
    prims = scene.primitives
    sgp = _sg_prims(prims)
    frame = cam_ops.film_frame(cam.eye, cam.lookat, cam.up, cam.fov,
                               width, height)
    scale = jnp.asarray([radius_px / width, radius_px / height],
                        jnp.float32)
    offs = ring_offsets(k) * scale
    clip_s = 4.0 * radius_px / width
    clip_t = 4.0 * radius_px / height

    uv = jnp.stack([s, t], axis=-1)
    a_k = _SG(uv)[..., None, :] + offs                 # (..., K, 2)
    sk, tk = a_k[..., 0], a_k[..., 1]
    o, d = cam_ops.film_ray(cam.eye, *frame, sk, tk)
    ex = jnp.full(sk.shape, isect.NO_INDEX, jnp.int32)
    hit = isect.intersect_brute(o, d, ex, sgp)
    p_mat = material_point(prims, hit.index, hit.position)
    ps, pt = cam_ops.world_to_film(cam.eye, cam.lookat, cam.up,
                                   cam.fov, width, height, p_mat)
    # silhouette velocities are local: bound the projection near the
    # auxiliary film point (primally it IS the film point)
    ps = jnp.clip(ps, sk - clip_s, sk + clip_s)
    pt = jnp.clip(pt, tk - clip_t, tk + clip_t)
    proj = jnp.stack([ps, pt], axis=-1)
    s_k = jnp.where(hit.hit[..., None], proj, a_k)
    z_k = jnp.where(hit.hit, _SG(hit.t), _BIG)
    idx_k = jnp.where(hit.hit, hit.index, isect.NO_INDEX)

    # anisotropic domain (s and t pixels differ): normalize to pixel
    # units for the kernel so the bandwidth is circular in pixels
    pix = jnp.asarray([float(width), float(height)], jnp.float32)
    field_px = _make_field(a_k * pix, s_k * pix, z_k, idx_k,
                           bandwidth=radius_px, beta=beta)
    field = lambda q: field_px(q * pix) / pix
    uv_w, detj = _reparam(field, uv,
                          margins=(3.0 / width, 3.0 / height))
    return uv_w[..., 0], uv_w[..., 1], detj


def light_warp(scene, shade_pos, exclude, l_origin, l_e1, l_e2, l_prim,
               u, v, active, k: int = 8, radius: float = 0.15,
               beta: float = 8.0):
    """Warp the light-area sample (u, v) so blocker silhouettes
    (projected from the shade point onto the light plane) move with the
    blockers. Returns (u', v', detj); primally (u, v, 1)."""
    prims = scene.primitives
    sgp = _sg_prims(prims)
    offs = ring_offsets(k) * radius
    x = shade_pos[..., None, :]
    xs = _SG(x)
    o_l = l_origin[..., None, :]
    e1 = l_e1[..., None, :]
    e2 = l_e2[..., None, :]
    n_l = jnp.cross(l_e1, l_e2)[..., None, :]

    uv = jnp.stack([jnp.where(active, u, 0.5),
                    jnp.where(active, v, 0.5)], axis=-1)
    a_k = _SG(uv)[..., None, :] + offs                 # (..., K, 2)
    uk, vk = a_k[..., 0], a_k[..., 1]
    p = _SG(o_l) + uk[..., None] * _SG(e1) + vk[..., None] * _SG(e2)
    ldir = isect.safe_normalize(p - xs)
    sh = isect.intersect_brute(xs, ldir, exclude[..., None], sgp)
    occluded = sh.hit & (sh.index != l_prim[..., None])
    y_mat = material_point(prims, sh.index, sh.position)
    # project the blocker's material point back onto the (moving)
    # light plane through the (moving) shade point
    dirw = jnp.where(occluded[..., None], y_mat - x, ldir)
    denom = _dot(dirw, n_l)
    denom = jnp.where(jnp.abs(denom) < 1e-9,
                      jnp.where(denom < 0, -1e-9, 1e-9), denom)
    tau = _dot(o_l - x, n_l) / denom
    q = x + tau[..., None] * dirw
    m = q - o_l
    qu = _dot(m, e1) / jnp.maximum(_dot(e1, e1), 1e-12)
    qv = _dot(m, e2) / jnp.maximum(_dot(e2, e2), 1e-12)
    qu = jnp.clip(qu, uk - 4 * radius, uk + 4 * radius)
    qv = jnp.clip(qv, vk - 4 * radius, vk + 4 * radius)
    proj = jnp.stack([qu, qv], axis=-1)
    s_k = jnp.where(occluded[..., None], proj, a_k)
    z_k = jnp.where(occluded, _SG(sh.t), _BIG)
    idx_k = jnp.where(occluded, sh.index, isect.NO_INDEX)

    field = _make_field(a_k, s_k, z_k, idx_k, bandwidth=radius, beta=beta)
    uv_w, detj = _reparam(field, uv, margins=(0.5 * radius, 0.5 * radius))
    detj = jnp.where(active, detj, 1.0)
    u_w = jnp.where(active, uv_w[..., 0], u)
    v_w = jnp.where(active, uv_w[..., 1], v)
    return u_w, v_w, detj


def hemisphere_warp(scene, shade_pos, normal, exclude, u, v, active,
                    k: int = 8, radius: float = 0.12, beta: float = 8.0):
    """Warp the cosine-hemisphere sample (u, v) so secondary-hit
    silhouettes (incl. the emitter's own edges, the MIS complement of
    NEE) move with the geometry. Returns (u', v', detj)."""
    prims = scene.primitives
    sgp = _sg_prims(prims)
    offs = ring_offsets(k) * radius
    x = shade_pos[..., None, :]
    xs = _SG(x)
    n = normal[..., None, :]

    # tangent frame exactly as sampling.cosine_hemisphere builds it
    z_minor = jnp.abs(normal[..., 2]) < 0.999
    up = jnp.where(z_minor[..., None],
                   jnp.array([0.0, 0.0, 1.0], jnp.float32),
                   jnp.array([1.0, 0.0, 0.0], jnp.float32))
    tangent = isect.safe_normalize(jnp.cross(up, normal))[..., None, :]
    bitangent = jnp.cross(normal, tangent[..., 0, :])[..., None, :]

    uv = jnp.stack([jnp.where(active, u, 0.5),
                    jnp.where(active, v, 0.5)], axis=-1)
    a_k = _SG(uv)[..., None, :] + offs                 # (..., K, 2)
    uk = jnp.clip(a_k[..., 0], 1e-4, 1.0 - 1e-4)
    vk = a_k[..., 1]
    r = jnp.sqrt(uk)
    th = 2.0 * jnp.pi * vk
    d = (_SG(tangent) * (r * jnp.cos(th))[..., None]
         + _SG(bitangent) * (r * jnp.sin(th))[..., None]
         + _SG(n) * jnp.sqrt(1.0 - uk)[..., None])
    hit = isect.intersect_brute(xs, d, exclude[..., None], sgp)
    y_mat = material_point(prims, hit.index, hit.position)
    dirh = jnp.where(hit.hit[..., None],
                     isect.safe_normalize(y_mat - x), d)
    xl = _dot(dirh, tangent)
    yl = _dot(dirh, bitangent)
    u_p = xl * xl + yl * yl
    xg = jnp.where(u_p < 1e-10, 1.0, xl)
    v_p = jnp.arctan2(yl, xg) / (2.0 * jnp.pi)
    # re-center onto the sample's branch of the angular coordinate
    v_p = v_p + _SG(jnp.round(vk - v_p))
    u_p = jnp.clip(u_p, uk - 4 * radius, uk + 4 * radius)
    v_p = jnp.clip(v_p, vk - 4 * radius, vk + 4 * radius)
    proj = jnp.stack([u_p, v_p], axis=-1)
    s_k = jnp.where(hit.hit[..., None], proj, a_k)
    z_k = jnp.where(hit.hit, _SG(hit.t), _BIG)
    idx_k = jnp.where(hit.hit, hit.index, isect.NO_INDEX)

    field = _make_field(a_k, s_k, z_k, idx_k, bandwidth=radius, beta=beta)
    # v is periodic (angular): taper only the radial u axis
    uv_w, detj = _reparam(field, uv, margins=(0.5 * radius, None))
    detj = jnp.where(active, detj, 1.0)
    u_w = jnp.where(active, uv_w[..., 0], u)
    v_w = jnp.where(active, uv_w[..., 1], v)
    return u_w, v_w, detj
