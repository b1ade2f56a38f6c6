"""Scalar NumPy oracle tracer (tests only; deliberately slow and simple).

An independent, per-pixel, genuine-while-loop implementation of the
estimator in reference/src/shaders/ComputeShader.wgsl:77-295. Its
pcg4d/TEA RNG streams are bit-identical to ops/rng.py, so the vectorized
XLA tracer and the Triton megakernel can be validated allclose against it
(SURVEY.md §4): any masking/ordering bug in the vector code breaks the
comparison immediately.

This file intentionally mirrors the reference's *control flow*
(branches, draw order, early breaks) in scalar Python; it shares no code
with the vector paths beyond the scene container.
"""

from __future__ import annotations

import math

import numpy as np

from computeraytracer import config as C

F = np.float32
_MASK = 0xFFFFFFFF


class Pcg4dRng:
    """Scalar pcg4d with TEA seeding (wgsl:864-899), python-int state."""

    def __init__(self, px: int, py: int, sample: int):
        self.state = [
            py & _MASK,
            (px * 100) & _MASK,
            sample & _MASK,
            tea(px, (py * 100) & _MASK),
        ]

    def _advance(self):
        s = [(v * 1664525 + 1013904223) & _MASK for v in self.state]
        x, y, z, w = s
        x = (x + y * w) & _MASK
        y = (y + z * x) & _MASK
        z = (z + x * y) & _MASK
        w = (w + y * z) & _MASK
        x, y, z, w = (v ^ (v >> 16) for v in (x, y, z, w))
        x = (x + y * w) & _MASK
        y = (y + z * x) & _MASK
        z = (z + x * y) & _MASK
        w = (w + y * z) & _MASK
        self.state = [x, y, z, w]

    def rand(self) -> np.float32:
        self._advance()
        return F(self.state[0] & 0x00FFFFFF) / F(0x01000000)


def tea(val0: int, val1: int, rounds: int = 16) -> int:
    v0, v1, s0 = val0 & _MASK, val1 & _MASK, 0
    for _ in range(rounds):
        s0 = (s0 + 0x9E3779B9) & _MASK
        v0 = (v0 + ((((v1 << 4) & _MASK) + 0xA341316C) ^ ((v1 + s0) & _MASK)
                    ^ ((v1 >> 5) + 0xC8013EA4)) & _MASK) & _MASK
        v1 = (v1 + ((((v0 << 4) & _MASK) + 0xAD90777D) ^ ((v0 + s0) & _MASK)
                    ^ ((v0 >> 5) + 0x7E95761E)) & _MASK) & _MASK
    return v0


def _norm(v):
    return v / F(np.linalg.norm(v))


def _watertight_inside(o, d, v0, v1, v2):
    """Scalar twin of ops.intersect.watertight_inside (same op order)."""
    ax, ay, az = abs(F(d[0])), abs(F(d[1])), abs(F(d[2]))
    if ax >= ay and ax >= az:
        kz = 0
    elif ay >= az:
        kz = 1
    else:
        kz = 2
    kx = 0 if kz == 2 else kz + 1
    ky = 0 if kx == 2 else kx + 1
    dkz = F(d[kz])
    safe = F(1.0) if dkz == 0.0 else dkz
    sx = F(d[kx]) / safe
    sy = F(d[ky]) / safe

    def shear2(v):
        pkx = F(v[kx]) - F(o[kx])
        pky = F(v[ky]) - F(o[ky])
        pkz = F(v[kz]) - F(o[kz])
        return pkx - sx * pkz, pky - sy * pkz

    ax_, ay_ = shear2(v0)
    bx_, by_ = shear2(v1)
    cx_, cy_ = shear2(v2)
    u = cx_ * by_ - cy_ * bx_
    v = ax_ * cy_ - ay_ * cx_
    w = bx_ * ay_ - by_ * ax_
    pos = u >= 0 and v >= 0 and w >= 0
    neg = u <= 0 and v <= 0 and w <= 0
    det = u + v + w
    return (pos or neg) and det != 0.0


class OracleScene:
    """NumPy copy of a Scene pytree for scalar access."""

    def __init__(self, scene):
        p = scene.primitives
        self.category = np.asarray(p.category)
        self.data1 = np.asarray(p.data1, F)
        self.data2 = np.asarray(p.data2, F)
        self.data3 = np.asarray(p.data3, F)
        self.emission = np.asarray(p.emission)
        self.reflectance = np.asarray(p.reflectance)
        self.material = np.asarray(p.material)
        self.n_prims = len(self.category)
        self.light_prims = np.asarray(scene.lights.prim_index)
        self.light_emission = np.asarray(scene.lights.emission)
        self.n_lights = len(self.light_prims)
        self.spectra = np.asarray(scene.spectra, F)
        self.cie = np.asarray(scene.cie, F)
        self.eye = np.asarray(scene.camera.eye, F)
        self.lookat = np.asarray(scene.camera.lookat, F)
        self.up = np.asarray(scene.camera.up, F)
        self.fov = F(scene.camera.fov)


class _Hit:
    __slots__ = ("hit", "t", "index", "position", "normal", "emission",
                 "reflectance", "material")

    def __init__(self):
        self.hit = False
        self.t = F(np.inf)
        self.index = -1


def intersect(sc: OracleScene, o, d, exclude: int) -> _Hit:
    """In-order linear scan; strict t > t_max rejection => last-wins ties
    (wgsl:503-632)."""
    h = _Hit()
    t_min, t_max = F(0.001), F(np.inf)
    for i in range(sc.n_prims):
        if i == exclude:
            continue
        cat = sc.category[i]
        if cat == 0 or cat == 2:  # patch / triangle share the plane test
            if cat == 2:  # triangles store vertices (scene/data.py)
                e1 = sc.data2[i] - sc.data1[i]
                e2 = sc.data3[i] - sc.data1[i]
            else:
                e1, e2 = sc.data2[i], sc.data3[i]
            n = _norm(np.cross(e1, e2).astype(F))
            ndotd = F(np.dot(n, d))
            if ndotd > 0:
                n = -n
                ndotd = -ndotd
            if abs(ndotd) < 1e-4:
                continue
            t = F(np.dot(n, sc.data1[i] - o)) / ndotd
            if t < t_min or t > t_max:
                continue
            p = o + t * d
            if cat == 0:
                m = p - sc.data1[i]
                u = F(np.dot(m, e1)) / F(np.dot(e1, e1))
                v = F(np.dot(m, e2)) / F(np.dot(e2, e2))
                if u < 0 or u > 1 or v < 0 or v > 1:
                    continue
            else:  # watertight edge-function test (ops/intersect.py)
                if not _watertight_inside(o, d, sc.data1[i], sc.data2[i],
                                          sc.data3[i]):
                    continue
        else:  # sphere (cat == 1)
            center, radius = sc.data1[i], sc.data2[i][0]
            co = o - center
            a = F(np.dot(d, d))
            b = F(2.0) * F(np.dot(d, co))
            c = F(np.dot(co, co)) - radius * radius
            disc = b * b - F(4.0) * a * c
            if disc <= 0:
                continue
            sq = F(math.sqrt(disc))
            t = (-b - sq) / (F(2.0) * a)
            if t < t_min or t > t_max:
                t = (-b + sq) / (F(2.0) * a)
                if t < t_min or t > t_max:
                    continue
            p = o + t * d
            n = _norm(p - center)
        h.hit = True
        h.t = t
        h.index = i
        h.position = p
        h.normal = n
        h.emission = int(sc.emission[i])
        h.reflectance = int(sc.reflectance[i])
        h.material = int(sc.material[i])
        t_max = t
    return h


def _sample_spectrum(sc, idx, lambdas):
    return sc.spectra[idx][lambdas]


def _light_pdf(sc, light_prim, n_at_light, ray_dir, light_pos, ray_origin):
    e1 = sc.data2[light_prim]
    e2 = sc.data3[light_prim]
    area = F(np.linalg.norm(e1)) * F(np.linalg.norm(e2))
    abs_cos = max(F(1e-5), abs(F(np.dot(n_at_light, -ray_dir))))
    dist = F(np.linalg.norm(light_pos - ray_origin))
    geo = abs_cos / (dist * dist)
    return (F(1.0) / area) / geo / F(sc.n_lights)


def _power_heuristic(f_pdf, g_pdf):
    f, g = f_pdf, g_pdf
    return (f * f) / (f * f + g * g)


def path_trace(sc: OracleScene, rng_: Pcg4dRng, o, d, lambdas,
               max_depth: int, rr_start: int = 1):
    """Scalar transcription of path_trace (wgsl:119-295)."""
    L = np.zeros(4, F)
    beta = np.ones(4, F)
    last_pdf = F(1.0)
    exclude = -1
    specular = False
    eta_scale = F(1.0)
    in_trans = False
    depth = 0
    while True:
        h = intersect(sc, o, d, exclude)
        if not h.hit:
            break
        exclude = h.index
        if h.material == C.LIGHT:
            le = _sample_spectrum(sc, h.emission, lambdas)
            if depth == 0 or specular:
                L += beta * le
            else:
                pdf_l = _light_pdf(sc, h.index, h.normal, d, h.position, o)
                L += _power_heuristic(last_pdf, pdf_l) * le * beta
            break
        if depth >= max_depth:
            break
        if in_trans:
            dist = F(np.linalg.norm(h.position - o))
            ext = _sample_spectrum(sc, len(sc.spectra) - 1, lambdas)
            beta = beta * np.exp(-ext * dist).astype(F)
        if h.material == C.DIFFUSE:
            brdf = _sample_spectrum(sc, h.reflectance, lambdas) / F(np.pi)
            # --- NEE (wgsl:379-408)
            u_l = rng_.rand()
            li = min(int(u_l * F(sc.n_lights)), sc.n_lights - 1)
            l_prim = int(sc.light_prims[li])
            u_p, v_p = rng_.rand(), rng_.rand()
            p_light = (sc.data1[l_prim] + u_p * sc.data2[l_prim]
                       + v_p * sc.data3[l_prim])
            ldir = _norm(p_light - h.position)
            sh = intersect(sc, h.position, ldir, h.index)
            cos_t = max(F(0.0), F(np.dot(h.normal, ldir)))
            if sh.hit and sh.index == l_prim:
                le = _sample_spectrum(sc, int(sc.light_emission[li]),
                                      lambdas) * cos_t
                pdf_l = _light_pdf(sc, l_prim, sh.normal, ldir, sh.position,
                                   h.position)
                pdf_b = cos_t / F(np.pi)
                w_l = _power_heuristic(pdf_l, pdf_b)
                L += brdf * (le * w_l / pdf_l) * beta
            # --- cosine bounce (wgsl:751-774)
            u, v = rng_.rand(), rng_.rand()
            r = F(math.sqrt(u))
            th = F(2.0) * F(np.pi) * v
            x, y = r * F(math.cos(th)), r * F(math.sin(th))
            z = F(math.sqrt(max(0.0, 1.0 - u)))
            n = h.normal
            up = np.array([0, 0, 1], F) if abs(n[2]) < 0.999 else \
                np.array([1, 0, 0], F)
            tangent = _norm(np.cross(up, n).astype(F))
            bitangent = np.cross(n, tangent).astype(F)
            nd = tangent * x + bitangent * y + n * z
            last_pdf = z / F(np.pi)
            cos_b = abs(F(np.dot(n, nd)))
            beta = beta * brdf * cos_b / last_pdf
            o, d = h.position, nd
            specular = False
        elif h.material == C.GLASS:
            eta1, eta2 = F(1.0), F(1.5)
            eta = eta1 / eta2
            cos_in = F(np.dot(h.normal, d))
            # fresnel_s (wgsl:814-837)
            cosi = F(np.clip(cos_in, -1.0, 1.0))
            fe = eta2 / eta1 if cosi > 0 else eta1 / eta2
            sint2 = fe * fe * (F(1.0) - cosi * cosi)
            if sint2 > 1.0:
                refl = F(1.0)
            else:
                cost = F(math.sqrt(1.0 - sint2))
                ci = abs(cosi)
                rs = (eta1 * ci - eta2 * cost) / (eta1 * ci + eta2 * cost)
                rp = (eta2 * ci - eta1 * cost) / (eta2 * ci + eta1 * cost)
                refl = (rs * rs + rp * rp) / F(2.0)
            pr, pt = refl, F(1.0) - refl
            u = rng_.rand()
            n = h.normal.copy()
            if cos_in > 0:
                eta = F(1.0) / eta
                n = -n
            if u < pr / (pr + pt):
                d = d - F(2.0) * F(np.dot(n, d)) * n
            else:
                ndoti = F(np.dot(n, d))
                k = F(1.0) - eta * eta * (F(1.0) - ndoti * ndoti)
                d = _norm(eta * d - (eta * ndoti + F(math.sqrt(max(k, 0.0)))) * n)
                beta = beta * (eta * eta)
                eta_scale = eta_scale / (eta * eta)
                in_trans = not in_trans
            o = h.position
            specular = True
            exclude = -1
        elif h.material == C.MIRROR:
            d = d - F(2.0) * F(np.dot(h.normal, d)) * h.normal
            o = h.position
            specular = True
            exclude = -1
        # --- Russian roulette (wgsl:279-289)
        rbeta = beta * eta_scale
        mc = max(rbeta[0], rbeta[1], rbeta[2])
        if depth > rr_start and mc < 1.0:
            q = max(F(0.0), F(1.0) - mc)
            if rng_.rand() < q:
                break
            beta = beta / (F(1.0) - q)
        depth += 1
    return L


def render_sample(scene, width: int, height: int, sample: int,
                  max_depth: int = 8, rr_start: int = 1) -> np.ndarray:
    """One full sample as XYZ (H, W, 3) — the golden image generator."""
    sc = OracleScene(scene)
    w_basis = _norm(sc.eye - sc.lookat)
    u_basis = _norm(np.cross(sc.up, w_basis).astype(F))
    v_basis = np.cross(w_basis, u_basis).astype(F)
    aspect = F(width) / F(height)
    vp_h = F(2.0) * F(math.tan(sc.fov / 2.0))
    vp_w = aspect * vp_h
    horizontal = vp_w * u_basis
    vertical = vp_h * v_basis
    lower_left = sc.eye - horizontal / F(2.0) - vertical / F(2.0) - w_basis

    n_lam = C.N_LAMBDA
    scale = F((C.LAMBDA_MAX - C.LAMBDA_MIN) / (C.CIE_Y_INTEG * C.N_HERO))
    out = np.zeros((height, width, 3), F)
    stratum = F(sample % C.GRID_SIZE)
    for py in range(height):
        for px in range(width):
            rng_ = Pcg4dRng(px, py, sample)
            us, ut = rng_.rand(), rng_.rand()
            s = (F(px) + (stratum + us) / F(C.GRID_SIZE)) / F(width)
            t = (F(height) - F(py) + (stratum + ut) / F(C.GRID_SIZE)) / F(height)
            d = _norm(lower_left + s * horizontal + t * vertical - sc.eye)
            u = rng_.rand()
            hero = int(u * F(n_lam))
            lambdas = np.array([hero, (hero + 4) % n_lam, (hero + 8) % n_lam,
                                (hero + 12) % n_lam])
            L = path_trace(sc, rng_, sc.eye.copy(), d, lambdas, max_depth,
                           rr_start)
            bars = sc.cie[:, lambdas + C.CIE_OFFSET]  # (3, 4)
            out[py, px] = (bars @ L) * scale
    return out
