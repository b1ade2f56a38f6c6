"""Forward path-tracing megakernel, Pallas on the Triton route.

A re-design of the reference's WGSL compute megakernel
(reference/src/shaders/ComputeShader.wgsl:77-295) with its own
shape: one path per GPU thread. A Triton program owns a 1-D block of
BLOCK rays; the bounce loop is a `fori_loop` whose carry (origin,
direction, radiance, throughput, pdf, RNG state, flags) stays in
registers for all max_depth+1 trips, where the XLA tracer
(tracer/xla.py) writes the whole path state to device memory at every
bounce.

- **Static scene structure.** Primitive categories, materials, spectrum
  bindings and light rows are Python constants at kernel-build time
  (SceneStatic), so each unrolled primitive test emits only its own
  category's arithmetic and the material branches reduce to mask
  algebra. Geometry and spectra stay traced inputs.
- **Scene reads.** The primitive table (P, 12) is read as scalars and
  the (S, 301) spectra table is gathered at each ray's 4 hero
  wavelengths; both are a few KB and stay in L1.
- **In-order primitive scan.** Primitives are tested in packing order
  with the reference's strict t > t_max rejection, which reproduces its
  last-wins tie rule (the coplanar ceiling light depends on it).
- **Same RNG stream.** pcg4d (ops/rng.py) runs on u32 vectors in the
  kernel with the tracer's draw order, so a path makes the same
  sampling decisions as in tracer/xla.py.
- **Watertight edges.** ptxas contracts `a*b - c*d` into an FMA, which
  breaks the exact-negation symmetry of shared-edge functions
  (ops/intersect.watertight_inside). The compiled kernel rounds each
  product with `mul.rn.f32`, which ptxas does not contract; interpret
  mode runs through XLA and uses its optimization barrier.

The kernel is forward-only. tracer/pallas.py gives it a custom_vjp whose
backward is JAX AD of the XLA tracer on the same sample.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from computeraytracer import config as C

T_MIN = 0.001
ETA1, ETA2 = 1.0, 1.5
# Rays per Triton program, one path per thread (a power of two, as
# Triton requires), and the warps that run them: 128 rays in 4 warps
# measured as fast as any block/warp pair tried on the H100 (PERF.md).
BLOCK = 128
NUM_WARPS = 4
# The scan is unrolled per primitive at build time, so compile time
# grows with the scene: ~55 s at the Cornell box's 18 primitives on the
# H100 (PERF.md). The cap is not measured; larger scenes take the XLA
# tracer (kernel="xla").
MAX_UNROLLED_PRIMS = 64


class SceneStatic(NamedTuple):
    """Non-differentiable scene structure, static at kernel build."""

    categories: tuple      # per primitive: 0 patch, 1 sphere, 2 triangle
    materials: tuple
    emission_idx: tuple
    reflectance_idx: tuple
    light_rows: tuple      # primitive ids of the lights
    n_spectra: int

    @classmethod
    def from_scene(cls, scene) -> "SceneStatic":
        p = scene.primitives
        cat = np.asarray(p.category)
        if cat.shape[0] > MAX_UNROLLED_PRIMS:
            raise ValueError(
                f"{cat.shape[0]} primitives: the Triton megakernel unrolls "
                f"at most {MAX_UNROLLED_PRIMS}; render mesh scenes with the "
                "XLA tracer and a BVH (kernel='xla')")
        return cls(
            categories=tuple(int(c) for c in cat),
            materials=tuple(int(m) for m in np.asarray(p.material)),
            emission_idx=tuple(int(e) for e in np.asarray(p.emission)),
            reflectance_idx=tuple(int(r) for r in np.asarray(p.reflectance)),
            light_rows=tuple(int(x) for x in
                             np.asarray(scene.lights.prim_index)),
            n_spectra=int(scene.spectra.shape[0]),
        )


# ---------------------------------------------------------------------------
# small vector helpers over (BLOCK,) arrays; a "vec3" is a 3-tuple
# ---------------------------------------------------------------------------

def _vdot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _vadd(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def _vsub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def _vscale(s, a):
    return (s * a[0], s * a[1], s * a[2])


def _vwhere(m, a, b):
    return (jnp.where(m, a[0], b[0]), jnp.where(m, a[1], b[1]),
            jnp.where(m, a[2], b[2]))


def _vnormalize(a):
    s = _vdot(a, a)
    s = jnp.where(s < 1e-20, 1.0, s)
    inv = 1.0 / jnp.sqrt(s)
    return _vscale(inv, a)


def _vcross(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


# ---------------------------------------------------------------------------
# in-kernel pcg4d (vector u32), mirroring ops/rng.py exactly
# ---------------------------------------------------------------------------

_U32 = jnp.uint32


def _pcg4d(s):
    x, y, z, w = (v * _U32(1664525) + _U32(1013904223) for v in s)
    x = x + y * w
    y = y + z * x
    z = z + x * y
    w = w + y * z
    x, y, z, w = (v ^ (v >> 16) for v in (x, y, z, w))
    x = x + y * w
    y = y + z * x
    z = z + x * y
    w = w + y * z
    return (x, y, z, w)


def _to_unit(bits):
    # the value is < 2^24, so the i32 hop is exact
    return (bits & _U32(0x00FFFFFF)).astype(jnp.int32).astype(
        jnp.float32) * jnp.float32(1.0 / 0x01000000)


def _rand_masked(seed, mask):
    new = _pcg4d(seed)
    u = jnp.where(mask, _to_unit(new[0]), 0.0)
    return u, tuple(jnp.where(mask, n, o) for n, o in zip(new, seed))


def _mul_rn(a, b):
    """f32 product rounded on its own: ptxas never contracts an
    explicitly rounded mul into an FMA."""
    (out,) = plt.elementwise_inline_asm(
        "mul.rn.f32 $0, $1, $2;", args=[a, b], constraints="=r,r,r",
        pack=1, result_shape_dtypes=[jax.ShapeDtypeStruct(a.shape,
                                                          jnp.float32)])
    return out


# ---------------------------------------------------------------------------
# closest-hit scan and one bounce
# ---------------------------------------------------------------------------

def _scan_primitives(static: SceneStatic, getp, o, d, exclude, shape, mul):
    """In-order closest-hit scan (wgsl:503-632 semantics).

    getp(i, j): scalar element j of primitive i. mul: the watertight
    edge functions' product (ops/intersect.watertight_inside).
    Returns dict of (BLOCK,) arrays: hit, t, idx, pos, nrm.
    """
    from computeraytracer.ops import intersect as isect

    zero = jnp.zeros(shape, jnp.float32)
    state = {
        "t": jnp.full(shape, jnp.inf, jnp.float32),
        "idx": jnp.full(shape, -1, jnp.int32),
        "pos": (zero, zero, zero),
        "nrm": (zero, zero, zero),
    }
    d_dot_d = _vdot(d, d)
    # watertight-triangle shear constants are per ray: hoisted out of the
    # primitive loop
    wt = (isect.watertight_setup(o, d)
          if any(c == 2 for c in static.categories) else None)

    for i, cat in enumerate(static.categories):
        not_excluded = exclude != i
        if cat in (0, 2):  # planar patch / triangle share the plane test
            p0 = (getp(i, 0), getp(i, 1), getp(i, 2))
            if cat == 2:  # triangles store vertices (scene/data.py)
                v1 = (getp(i, 3), getp(i, 4), getp(i, 5))
                v2 = (getp(i, 6), getp(i, 7), getp(i, 8))
                e1 = _vsub(v1, p0)
                e2 = _vsub(v2, p0)
            else:
                e1 = (getp(i, 3), getp(i, 4), getp(i, 5))
                e2 = (getp(i, 6), getp(i, 7), getp(i, 8))
            n_raw = _vcross(e1, e2)
            n_len2 = _vdot(n_raw, n_raw)
            inv_len = 1.0 / jnp.sqrt(jnp.maximum(n_len2, 1e-30))
            n0 = _vscale(inv_len, n_raw)
            ndotd = _vdot(n0, d)
            flip = ndotd > 0.0
            ndotd_f = jnp.where(flip, -ndotd, ndotd)
            grazing = jnp.abs(ndotd_f) < 1e-4
            num = (n0[0] * (p0[0] - o[0]) + n0[1] * (p0[1] - o[1])
                   + n0[2] * (p0[2] - o[2]))
            # the flipped normal flips numerator and denominator alike,
            # so t is unchanged; guard the denominator on grazing lanes
            t = num / jnp.where(grazing, 1.0, ndotd)
            p = _vadd(o, _vscale(t, d))
            if cat == 0:
                m = _vsub(p, p0)
                u = _vdot(m, e1) / jnp.maximum(_vdot(e1, e1), 1e-12)
                v = _vdot(m, e2) / jnp.maximum(_vdot(e2, e2), 1e-12)
                inside = (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (v <= 1.0)
            else:
                inside = isect.watertight_inside(wt, p0, v1, v2, mul=mul)
            valid = (not_excluded & ~grazing & inside
                     & (t >= T_MIN) & (t <= state["t"]))
            sgn = jnp.where(flip, -1.0, 1.0)
            n_eff = _vscale(sgn, n0)
        else:  # sphere
            cx = (getp(i, 0), getp(i, 1), getp(i, 2))
            radius = getp(i, 3)
            co = _vsub(o, cx)
            a = d_dot_d
            b = 2.0 * _vdot(d, co)
            c2 = _vdot(co, co) - radius * radius
            disc = b * b - 4.0 * a * c2
            has_root = disc > 0.0
            sq = jnp.sqrt(jnp.where(has_root, disc, 1.0))
            denom = jnp.where(a > 1e-12, 2.0 * a, 1.0)
            t_near = (-b - sq) / denom
            t_far = (-b + sq) / denom
            near_ok = (t_near >= T_MIN) & (t_near <= state["t"])
            t = jnp.where(near_ok, t_near, t_far)
            valid = (not_excluded & has_root & (a > 1e-12)
                     & (t >= T_MIN) & (t <= state["t"]))
            p = _vadd(o, _vscale(t, d))
            n_eff = _vnormalize(_vsub(p, cx))
        state = {
            "t": jnp.where(valid, t, state["t"]),
            "idx": jnp.where(valid, i, state["idx"]),
            "pos": _vwhere(valid, p, state["pos"]),
            "nrm": _vwhere(valid, n_eff, state["nrm"]),
        }
    state["hit"] = state["idx"] >= 0
    return state


def make_bounce(static: SceneStatic, shape, max_depth: int, rr_start: int,
                mul):
    """One bounce of the path-trace loop (wgsl:133-293) over a block.

    Returns bounce(getp, gets, diff, nondiff, depth) -> (diff, nondiff):
      getp(i, j)  scalar element j of primitive i
      gets(row)   4-tuple: spectrum `row` at the ray's hero wavelengths
      diff        (o3, d3, L4, beta4, last_pdf, eta_scale) f32 arrays
      nondiff     (seed u32x4, exclude i32, specular/in_trans/active bool)
    """
    S = static.n_spectra
    n_lights = len(static.light_rows)

    def light_pdf(getp, l_row, n_at_light, ray_dir, l_pos, r_origin):
        """compute_light_pdf (wgsl:357-377) for a static light row."""
        e1 = (getp(l_row, 3), getp(l_row, 4), getp(l_row, 5))
        e2 = (getp(l_row, 6), getp(l_row, 7), getp(l_row, 8))
        area = jnp.sqrt(jnp.maximum(_vdot(e1, e1), 1e-30)) * jnp.sqrt(
            jnp.maximum(_vdot(e2, e2), 1e-30))
        abs_cos = jnp.maximum(1e-5, jnp.abs(-_vdot(n_at_light, ray_dir)))
        diff = _vsub(l_pos, r_origin)
        geo = abs_cos / jnp.maximum(_vdot(diff, diff), 1e-12)
        pdf = (1.0 / jnp.maximum(area, 1e-12)) / geo / float(n_lights)
        return jnp.clip(pdf, 0.0, 1e16)

    def power_heuristic(f, g):
        r = g / jnp.maximum(f, 1e-12)
        return 1.0 / (1.0 + r * r)

    def select_spectrum(idx, rows, gets, want_material):
        out = [jnp.zeros(shape, jnp.float32)] * 4
        for i, (m, row) in enumerate(zip(static.materials, rows)):
            if m == want_material:
                sel = idx == i
                vals = gets(row)
                out = [jnp.where(sel, vals[j], out[j]) for j in range(4)]
        return out

    def scan(getp, o, d, exclude):
        return _scan_primitives(static, getp, o, d, exclude, shape, mul)

    def bounce(getp, gets, diff, nondiff, depth):
        o, d, L, beta, last_pdf, eta_scale = diff
        seed, exclude, specular, in_trans, active = nondiff
        zero = jnp.zeros(shape, jnp.float32)
        inv_pi = jnp.float32(1.0 / math.pi)

        hit = scan(getp, o, d, exclude)
        lane_hit = active & hit["hit"]
        active = lane_hit
        exclude = jnp.where(lane_hit, hit["idx"], exclude)
        idx = hit["idx"]

        def material_mask(m):
            mask = jnp.zeros(shape, bool)
            for i, mi in enumerate(static.materials):
                if mi == m:
                    mask = mask | (idx == i)
            return mask

        # ---- emissive hit (wgsl:149-164)
        is_light = lane_hit & material_mask(C.LIGHT)
        le = select_spectrum(idx, static.emission_idx, gets, C.LIGHT)
        pdf_l_hit = zero
        for lr in static.light_rows:
            pdf_l_hit = jnp.where(
                idx == lr, light_pdf(getp, lr, hit["nrm"], d, hit["pos"], o),
                pdf_l_hit)
        weight_b = power_heuristic(last_pdf, pdf_l_hit)
        mis_w = jnp.where((depth == 0) | specular, 1.0, weight_b)
        L = tuple(L[j] + jnp.where(is_light, beta[j] * le[j] * mis_w, 0.0)
                  for j in range(4))
        active = active & ~is_light

        scatter = active & (depth < max_depth)
        active = scatter

        # ---- Beer-Lambert through the last spectrum (wgsl:173-179)
        ext = gets(S - 1)
        diffp = _vsub(hit["pos"], o)
        dsq = _vdot(diffp, diffp)
        dist = jnp.sqrt(jnp.where(dsq > 0, dsq, 1.0)) * (dsq > 0)
        bl = scatter & in_trans
        beta = tuple(jnp.where(bl, beta[j] * jnp.exp(-ext[j] * dist),
                               beta[j]) for j in range(4))

        is_diffuse = scatter & material_mask(C.DIFFUSE)
        is_glass = scatter & material_mask(C.GLASS)
        is_mirror = scatter & material_mask(C.MIRROR)

        # ---- DIFFUSE: NEE + cosine bounce (5 draws)
        u_l, seed = _rand_masked(seed, is_diffuse)
        u_p, seed = _rand_masked(seed, is_diffuse)
        v_p, seed = _rand_masked(seed, is_diffuse)
        u_h, seed = _rand_masked(seed, is_diffuse)
        v_h, seed = _rand_masked(seed, is_diffuse)

        brdf = select_spectrum(idx, static.reflectance_idx, gets, C.DIFFUSE)
        brdf = [b * inv_pi for b in brdf]

        # light selection, uniform over the light rows
        li = jnp.clip((u_l * float(n_lights)).astype(jnp.int32), 0,
                      n_lights - 1)
        nee = [zero] * 4
        for l_i, lr in enumerate(static.light_rows):
            lsel = is_diffuse & (li == l_i)
            l_o = (getp(lr, 0), getp(lr, 1), getp(lr, 2))
            l_e1 = (getp(lr, 3), getp(lr, 4), getp(lr, 5))
            l_e2 = (getp(lr, 6), getp(lr, 7), getp(lr, 8))
            p_l = (l_o[0] + u_p * l_e1[0] + v_p * l_e2[0],
                   l_o[1] + u_p * l_e1[1] + v_p * l_e2[1],
                   l_o[2] + u_p * l_e1[2] + v_p * l_e2[2])
            ldir = _vnormalize(_vsub(p_l, hit["pos"]))
            sh = scan(getp, hit["pos"], ldir, hit["idx"])
            unocc = sh["hit"] & (sh["idx"] == lr)
            cos_t = jnp.maximum(0.0, _vdot(hit["nrm"], ldir))
            pdf_l = light_pdf(getp, lr, sh["nrm"], ldir, sh["pos"],
                              hit["pos"])
            w_l = power_heuristic(pdf_l, cos_t * inv_pi)
            scale = jnp.where(lsel & unocc,
                              cos_t * w_l / jnp.maximum(pdf_l, 1e-12), 0.0)
            l_emis = gets(static.emission_idx[lr])
            nee = [nee[j] + l_emis[j] * scale for j in range(4)]
        L = tuple(L[j] + brdf[j] * nee[j] * beta[j] for j in range(4))

        # cosine hemisphere (wgsl:751-774)
        r_h = jnp.sqrt(jnp.maximum(u_h, 0.0))
        th = jnp.float32(2.0 * math.pi) * v_h
        xh = r_h * jnp.cos(th)
        yh = r_h * jnp.sin(th)
        zh = jnp.sqrt(jnp.maximum(0.0, 1.0 - u_h))
        n = hit["nrm"]
        z_minor = jnp.abs(n[2]) < 0.999
        up = (jnp.where(z_minor, 0.0, 1.0), zero,
              jnp.where(z_minor, 1.0, 0.0))
        tangent = _vnormalize(_vcross(up, n))
        bitangent = _vcross(n, tangent)
        bounce_d = (tangent[0] * xh + bitangent[0] * yh + n[0] * zh,
                    tangent[1] * xh + bitangent[1] * yh + n[1] * zh,
                    tangent[2] * xh + bitangent[2] * yh + n[2] * zh)
        bounce_pdf = zh * inv_pi
        cos_b = jnp.abs(_vdot(n, bounce_d))
        bfac = cos_b / jnp.maximum(bounce_pdf, 1e-12)
        beta_diffuse = tuple(beta[j] * brdf[j] * bfac for j in range(4))

        # ---- GLASS (1 draw); fresnel_s (wgsl:814-837)
        u_g, seed = _rand_masked(seed, is_glass)
        cos_in = _vdot(n, d)
        cosi = jnp.clip(cos_in, -1.0, 1.0)
        fe = jnp.where(cosi > 0.0, ETA2 / ETA1, ETA1 / ETA2)
        sint2 = fe * fe * (1.0 - cosi * cosi)
        tir = sint2 > 1.0
        cost = jnp.sqrt(jnp.where(tir, 1.0, 1.0 - sint2))
        ci = jnp.abs(cosi)
        rs = (ETA1 * ci - ETA2 * cost) / (ETA1 * ci + ETA2 * cost)
        rp = (ETA2 * ci - ETA1 * cost) / (ETA2 * ci + ETA1 * cost)
        reflectance = jnp.where(tir, 1.0, 0.5 * (rs * rs + rp * rp))
        eta = jnp.where(cos_in > 0.0, ETA2 / ETA1, ETA1 / ETA2)
        ng = _vwhere(cos_in > 0.0, _vscale(-1.0, n), n)
        refl_dir = _vsub(d, _vscale(2.0 * _vdot(ng, d), ng))
        # refract (WGSL semantics; 0 on total internal reflection)
        ndoti = _vdot(ng, d)
        kk = 1.0 - eta * eta * (1.0 - ndoti * ndoti)
        ktir = kk < 0.0
        sqk = jnp.sqrt(jnp.where(ktir, 1.0, kk))
        rft = _vsub(_vscale(eta, d), _vscale(eta * ndoti + sqk, ng))
        refr_dir = _vnormalize(_vwhere(ktir, (zero, zero, zero), rft))
        pr = reflectance
        choose_refl = u_g < pr / jnp.maximum(pr + (1.0 - pr), 1e-12)
        glass_dir = _vwhere(choose_refl, refl_dir, refr_dir)
        eta2v = eta * eta
        beta_glass = tuple(jnp.where(choose_refl, beta[j], beta[j] * eta2v)
                           for j in range(4))
        eta_scale_glass = jnp.where(choose_refl, eta_scale,
                                    eta_scale / eta2v)
        toggle_trans = is_glass & ~choose_refl

        # ---- MIRROR
        mirror_dir = _vsub(d, _vscale(2.0 * _vdot(n, d), n))

        # ---- merge
        o = _vwhere(scatter, hit["pos"], o)
        d = _vwhere(is_diffuse, bounce_d,
                    _vwhere(is_glass, glass_dir,
                            _vwhere(is_mirror, mirror_dir, d)))
        beta = tuple(jnp.where(is_diffuse, beta_diffuse[j],
                               jnp.where(is_glass, beta_glass[j], beta[j]))
                     for j in range(4))
        last_pdf = jnp.where(is_diffuse, bounce_pdf, last_pdf)
        is_spec_bounce = is_glass | is_mirror
        specular = is_spec_bounce | (specular
                                     & ~(is_diffuse | is_spec_bounce))
        exclude = jnp.where(is_spec_bounce, -1, exclude)
        eta_scale = jnp.where(is_glass, eta_scale_glass, eta_scale)
        in_trans = in_trans ^ toggle_trans

        # ---- Russian roulette (wgsl:279-289)
        max_c = jnp.maximum(beta[0] * eta_scale, jnp.maximum(
            beta[1] * eta_scale, beta[2] * eta_scale))
        rr = active & (depth > rr_start) & (max_c < 1.0)
        u_r, seed = _rand_masked(seed, rr)
        q = jnp.maximum(0.0, 1.0 - max_c)
        killed = rr & (u_r < q)
        active = active & ~killed
        surv = rr & ~killed
        inv1q = 1.0 / jnp.maximum(1.0 - q, 1e-12)
        beta = tuple(jnp.where(surv, beta[j] * inv1q, beta[j])
                     for j in range(4))

        return ((o, d, L, beta, last_pdf, eta_scale),
                (seed, exclude, specular, in_trans, active))

    return bounce


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

def _flatten(diff, nondiff):
    """Loop carry as flat arrays; bools cross the loop as int32."""
    o, d, L, beta, last_pdf, eta_scale = diff
    seed, exclude, specular, in_trans, active = nondiff
    return (*o, *d, *L, *beta, last_pdf, eta_scale, *seed, exclude,
            specular.astype(jnp.int32), in_trans.astype(jnp.int32),
            active.astype(jnp.int32))


def _unflatten(c):
    diff = (c[0:3], c[3:6], c[6:10], c[10:14], c[14], c[15])
    nondiff = (c[16:20], c[20], c[21] != 0, c[22] != 0, c[23] != 0)
    return diff, nondiff


def build_forward(static: SceneStatic, max_depth: int, rr_start: int,
                  interpret: bool = False):
    """Build the forward megakernel for a fixed scene structure.

    Returns f(prims (P, 12) f32, spectra (S, 301) f32, rays (6, R) f32,
    seeds (4, R) u32, lambdas (4, R) i32) -> radiance (4, R) f32, with R
    a multiple of BLOCK. interpret=True runs the kernel through the
    Pallas interpreter (CPU tests); without it the kernel compiles for
    the GPU and refuses any other backend.
    """
    block = BLOCK
    shape = (block,)
    bounce = make_bounce(static, shape, max_depth, rr_start,
                         mul=None if interpret else _mul_rn)

    def kernel(prims_ref, spectra_ref, rays_ref, seeds_ref, lam_ref,
               out_ref):
        rows = pl.ds(pl.program_id(0) * block, block)
        lams = [lam_ref[j, rows] for j in range(4)]
        getp = lambda i, j: prims_ref[i, j]
        gets = lambda row: tuple(spectra_ref[row, lam] for lam in lams)
        zero = jnp.zeros(shape, jnp.float32)
        one = jnp.ones(shape, jnp.float32)
        diff = (tuple(rays_ref[c, rows] for c in range(3)),
                tuple(rays_ref[c, rows] for c in range(3, 6)),
                (zero,) * 4, (one,) * 4, one, one)
        nondiff = (tuple(seeds_ref[c, rows] for c in range(4)),
                   jnp.full(shape, -1, jnp.int32), jnp.zeros(shape, bool),
                   jnp.zeros(shape, bool), jnp.ones(shape, bool))

        def body(depth, carry):
            def trip(carry):
                return _flatten(*bounce(getp, gets, *_unflatten(carry),
                                        depth))

            # a bounce over a block with no live path is the identity;
            # Russian roulette ends most paths well before max_depth
            alive = jnp.max(carry[-1]) > 0
            return jax.lax.cond(alive, trip, lambda c: c, carry)

        carry = jax.lax.fori_loop(0, max_depth + 1, body,
                                  _flatten(diff, nondiff))
        L = _unflatten(carry)[0][2]
        for j in range(4):
            out_ref[j, rows] = L[j]

    def forward(prims, spectra, rays, seeds, lams):
        if not interpret and jax.default_backend() != "gpu":
            raise RuntimeError(
                "the Triton megakernel compiles only for a GPU backend "
                f"(got {jax.default_backend()!r}); pass interpret=True to "
                "run it in the Pallas interpreter")
        r = rays.shape[1]
        if r % block:
            raise ValueError(f"{r} rays is not a multiple of block {block}")
        return pl.pallas_call(
            kernel,
            out_shape=jax.ShapeDtypeStruct((4, r), jnp.float32),
            grid=(r // block,),
            backend="triton",
            compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                               num_stages=1),
            interpret=interpret,
            name="path_trace_forward",
        )(prims, spectra, rays, seeds, lams)

    return forward


def pack_prims(scene) -> jnp.ndarray:
    """(P, 12) f32: [origin/center, edge1/radius, edge2, pad].

    Sphere rows put the radius at column 3 (edge1.x), matching the
    reference's (r, r, r) packing of data2 (main.js:239)."""
    p = scene.primitives
    return jnp.concatenate(
        [p.data1, p.data2, p.data3, jnp.zeros_like(p.data1)], axis=-1)
