"""Ray-primitive intersection, vectorized over rays x primitives.

Semantics follow the reference's tagged-dispatch intersector
(reference/src/shaders/ComputeShader.wgsl:503-632):

- planar patch (category 0): plane hit with the geometric normal flipped
  toward the ray, |n.d| < 1e-4 rejection, and 2D (u,v) in [0,1]^2
  edge-projection bounds (wgsl:524-583);
- sphere (category 1): quadratic with near-then-far root selection
  (wgsl:584-631);
- triangle (category 2): NEW (the reference has no mesh support) —
  watertight Woop-style shear-constant edge-function test (Woop,
  Benthin & Wald 2013, "Watertight Ray/Triangle Intersection") with
  the same normal-flipped-toward-ray convention. Triangles store
  VERTICES (v0, v1, v2), not (v0, e1, e2): watertightness along a
  shared edge requires both triangles to test the bitwise-identical
  endpoint coordinates, which edge-vector storage cannot reconstruct
  (v0 + fl(v1 - v0) != v1 in f32). t comes from the shared plane
  test, in the same op order as the Triton megakernel.

Self-hit avoidance is via an excluded primitive index, not epsilon alone
(wgsl:527-532), with t_min=0.001 (wgsl:720). Closest hit uses
first-minimum-wins, matching the reference's in-order scan with strict
`t > t_max` rejection.

The scan here is the XLA tracer's closest hit: a fully vectorized
(rays x primitives) broadcast reduced with argmin, O(R*P); BVH traversal
(bvh/) replaces it for meshes.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

T_MIN = 0.001
INF = jnp.float32(jnp.inf)
NO_INDEX = jnp.int32(-1)  # stands in for the reference's MAX_U32_VALUE

CAT_PATCH = 0
CAT_SPHERE = 1
CAT_TRIANGLE = 2


class Hit(NamedTuple):
    """Closest-hit record for a batch of rays (leading dims = ray batch)."""

    hit: jnp.ndarray        # bool
    t: jnp.ndarray          # f32
    index: jnp.ndarray      # int32 global primitive index (-1 if miss)
    position: jnp.ndarray   # (..., 3)
    normal: jnp.ndarray     # (..., 3) flipped toward the ray
    emission: jnp.ndarray   # int32 spectrum index
    reflectance: jnp.ndarray
    material: jnp.ndarray   # int32


def _dot(a, b):
    return jnp.sum(a * b, axis=-1)


def safe_normalize(v, eps=1e-20):
    """Normalize with NaN-free gradients at v ~= 0.

    jnp.linalg.norm has an inf gradient at 0 which poisons grads through
    jnp.where (the double-where problem); guard the sum-of-squares before
    the sqrt. For |v| >= 1e-10 the result is bitwise identical in f32.
    """
    s = _dot(v, v)
    s = jnp.where(s < eps, 1.0, s)
    # division (not rsqrt) so results stay bitwise identical to v/|v|
    return v / jnp.sqrt(s)[..., None]


def safe_sqrt(x, eps=0.0):
    """sqrt with a NaN-free gradient for x <= 0 (value is 0 there)."""
    pos = x > 0.0
    return jnp.where(pos, jnp.sqrt(jnp.where(pos, x, 1.0)), eps)


def patch_candidates(o, d, origin, edge1, edge2):
    """Ray-vs-patch t for broadcast shapes; returns (t, valid).

    o, d: (..., 3); origin/edge1/edge2: broadcastable to (..., 3).
    """
    n = safe_normalize(jnp.cross(edge1, edge2))
    ndotd = _dot(n, d)
    # Flip toward ray (wgsl:541-545); after the flip ndotd <= 0.
    n = jnp.where(ndotd[..., None] > 0, -n, n)
    ndotd = jnp.where(ndotd > 0, -ndotd, ndotd)
    grazing = jnp.abs(ndotd) < 1e-4
    safe_ndotd = jnp.where(grazing, 1.0, ndotd)
    t = _dot(n, origin - o) / safe_ndotd
    p = o + t[..., None] * d
    m = p - origin
    u = _dot(m, edge1) / jnp.maximum(_dot(edge1, edge1), 1e-12)
    v = _dot(m, edge2) / jnp.maximum(_dot(edge2, edge2), 1e-12)
    valid = (~grazing) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (v <= 1.0)
    return t, valid


def sphere_candidates(o, d, center, radius, t_min, t_max):
    """Ray-vs-sphere t with near-then-far root selection; (t, valid)."""
    co = o - center
    a = _dot(d, d)
    b = 2.0 * _dot(d, co)
    c = _dot(co, co) - radius * radius
    disc = b * b - 4.0 * a * c
    has_root = disc > 0.0
    sq = safe_sqrt(disc)
    # guard the 2a denominator for degenerate (zero-direction) rays on
    # masked lanes; true division keeps bitwise parity with the oracle
    denom = jnp.where(a > 1e-12, 2.0 * a, 1.0)
    t_near = (-b - sq) / denom
    t_far = (-b + sq) / denom
    has_root = has_root & (a > 1e-12)
    near_ok = (t_near >= t_min) & (t_near <= t_max)
    t = jnp.where(near_ok, t_near, t_far)
    valid = has_root & (t >= t_min) & (t <= t_max)
    return t, valid


def _sel3(k, v):
    """Select component k (int array) from a 3-tuple of arrays."""
    return jnp.where(k == 0, v[0], jnp.where(k == 1, v[1], v[2]))


def watertight_setup(o3, d3):
    """Per-ray constants for the watertight triangle test.

    o3/d3: 3-tuples of broadcastable arrays (component-planes form, so
    the SAME traced ops serve both the XLA scan and the Triton
    megakernel). kz is the ray direction's
    max-|component| axis; kx/ky the cyclic others (no winding swap: the
    both-signs edge test below is orientation-free). Sx/Sy shear the
    triangle into ray space (Woop et al. 2013, listing 1).
    """
    ax, ay, az = jnp.abs(d3[0]), jnp.abs(d3[1]), jnp.abs(d3[2])
    kz = jnp.where((ax >= ay) & (ax >= az), 0,
                   jnp.where(ay >= az, 1, 2)).astype(jnp.int32)
    kx = jnp.where(kz == 2, 0, kz + 1)
    ky = jnp.where(kx == 2, 0, kx + 1)
    dkz = _sel3(kz, d3)
    safe = jnp.where(dkz == 0.0, 1.0, dkz)  # dkz==0 only for null rays
    sx = _sel3(kx, d3) / safe
    sy = _sel3(ky, d3) / safe
    okx, oky, okz = _sel3(kx, o3), _sel3(ky, o3), _sel3(kz, o3)
    return (kx, ky, kz, sx, sy, okx, oky, okz)


def watertight_inside(setup, v0, v1, v2, *, mul=None):
    """Watertight 2D edge-function inside test; True if the sheared ray
    passes through triangle (v0, v1, v2) (3-tuples of arrays).

    Shared edges evaluate the identical f32 edge function (same two
    vertices, same ray) with opposite orientation in the two adjacent
    triangles, so with the both-signs acceptance one of them always
    passes: no cracks. The f64 fallback of the paper (for edge
    functions that round to exactly 0) is unnecessary here — an exact
    0 is accepted by BOTH triangles, which double-hits instead of
    cracking, and last-wins tie-breaking picks one.

    Each edge function must be a difference of two INDIVIDUALLY
    f32-rounded products: an fma(a, b, -(c*d)) contraction's
    single-rounded first product breaks the exact-negation symmetry
    between adjacent triangles' shared-edge functions, the whole
    watertight argument. mul(a, b) computes such a product. The default
    pins each product with an optimization barrier, which stops XLA
    (CPU and GPU) from contracting it at no runtime cost; the Triton
    kernel passes a `mul.rn.f32` product instead
    (kernels/megakernel.py), since ptxas contracts plain mul+sub.
    """
    kx, ky, kz, sx, sy, okx, oky, okz = setup
    if mul is None:
        def mul(a, b):
            return jax.lax.optimization_barrier(a * b)

    def shear2(v):
        pkx = _sel3(kx, v) - okx
        pky = _sel3(ky, v) - oky
        pkz = _sel3(kz, v) - okz
        return pkx - sx * pkz, pky - sy * pkz

    ax_, ay_ = shear2(v0)
    bx_, by_ = shear2(v1)
    cx_, cy_ = shear2(v2)

    def edge_fn(px, py, qx, qy):
        return mul(px, qy) - mul(py, qx)

    u = edge_fn(cx_, cy_, bx_, by_)
    v = edge_fn(ax_, ay_, cx_, cy_)
    w = edge_fn(bx_, by_, ax_, ay_)
    pos = (u >= 0.0) & (v >= 0.0) & (w >= 0.0)
    neg = (u <= 0.0) & (v <= 0.0) & (w <= 0.0)
    det = u + v + w
    return (pos | neg) & (det != 0.0)


def _comps(a):
    return (a[..., 0], a[..., 1], a[..., 2])


def triangle_candidates(o, d, v0, v1, v2):
    """Watertight ray/triangle test; returns (t, valid).

    v0/v1/v2 are VERTICES (scene/data.py cat-2 convention). t is the
    plane-test value in the op order of the Triton megakernel's shared
    patch/triangle branch (kernels/megakernel.py _scan_primitives);
    validity is the Woop watertight edge test.

    Direction contract: d SHOULD be unit-length — the |n.d| < 1e-4
    grazing cutoff compares a normalized normal against d, so the
    effective angular rejection band scales with 1/|d| (callers in this
    framework always pass normalized directions: camera rays,
    cosine-hemisphere samples, normalized refractions). Known watertight
    exception: at a SILHOUETTE shared edge the two adjacent triangles
    face the ray at different angles, and the grazing cutoff can reject
    one while the other's edge test fails — a ~1e-4-radian leak band
    that exists in the reference's estimator too (wgsl:538).
    """
    o3, d3 = _comps(o), _comps(d)
    v03, v13, v23 = _comps(v0), _comps(v1), _comps(v2)
    e1 = tuple(v13[i] - v03[i] for i in range(3))
    e2 = tuple(v23[i] - v03[i] for i in range(3))
    n_raw = (e1[1] * e2[2] - e1[2] * e2[1],
             e1[2] * e2[0] - e1[0] * e2[2],
             e1[0] * e2[1] - e1[1] * e2[0])
    n_len2 = n_raw[0] * n_raw[0] + n_raw[1] * n_raw[1] + n_raw[2] * n_raw[2]
    inv_len = 1.0 / jnp.sqrt(jnp.maximum(n_len2, 1e-30))
    n0 = (n_raw[0] * inv_len, n_raw[1] * inv_len, n_raw[2] * inv_len)
    ndotd = n0[0] * d3[0] + n0[1] * d3[1] + n0[2] * d3[2]
    flip = ndotd > 0.0
    ndotd_f = jnp.where(flip, -ndotd, ndotd)
    grazing = jnp.abs(ndotd_f) < 1e-4
    num = (n0[0] * (v03[0] - o3[0]) + n0[1] * (v03[1] - o3[1])
           + n0[2] * (v03[2] - o3[2]))
    t = num / jnp.where(grazing, 1.0, ndotd)
    inside = watertight_inside(watertight_setup(o3, d3), v03, v13, v23)
    valid = (~grazing) & inside
    return t, valid


def scene_candidates(o, d, prims, t_min=T_MIN):
    """All-primitive candidate ts for rays o, d of shape (..., 3).

    prims: scene.data.ScenePrimitives with (P,) leaves.
    Returns (t (..., P), valid (..., P)) — range/exclusion NOT yet applied
    (sphere root selection needs t range, so spheres get it here).
    """
    ob = o[..., None, :]
    db = d[..., None, :]
    t_p, ok_p = patch_candidates(ob, db, prims.data1, prims.data2, prims.data3)
    t_s, ok_s = sphere_candidates(ob, db, prims.data1, prims.data2[..., 0],
                                  t_min, INF)
    t_t, ok_t = triangle_candidates(ob, db, prims.data1, prims.data2,
                                    prims.data3)
    cat = prims.category
    t = jnp.where(cat == CAT_PATCH, t_p,
                  jnp.where(cat == CAT_SPHERE, t_s, t_t))
    ok = jnp.where(cat == CAT_PATCH, ok_p,
                   jnp.where(cat == CAT_SPHERE, ok_s, ok_t))
    ok = ok & (t >= t_min)
    return t, ok


def shading_normal(prims, idx, o, d, position):
    """Geometric normal of primitive idx at `position`, flipped toward -d."""
    cat = prims.category[idx]
    d1 = prims.data1[idx]
    d2 = prims.data2[idx]
    d3 = prims.data3[idx]
    # patches store edges in data2/3; triangles store vertices
    is_tri = (cat == CAT_TRIANGLE)[..., None]
    e1 = jnp.where(is_tri, d2 - d1, d2)
    e2 = jnp.where(is_tri, d3 - d1, d3)
    n_flat = jnp.cross(e1, e2)  # patches and triangles
    n_sph = position - d1
    n = safe_normalize(jnp.where((cat == CAT_SPHERE)[..., None], n_sph, n_flat))
    # Patches/triangles flip toward the ray; spheres use the outward
    # normal unflipped (wgsl:617-618).
    flip = (_dot(n, d) > 0) & (cat != CAT_SPHERE)
    return jnp.where(flip[..., None], -n, n)


def intersect_brute(o, d, exclude, prims, t_min=T_MIN):
    """Closest-hit over all primitives by linear scan (the naive path).

    o, d: (..., 3); exclude: (...,) int32 primitive index (-1 = none).
    Returns a Hit.
    """
    t, ok = scene_candidates(o, d, prims, t_min)
    ok = ok & (prims.index != exclude[..., None])
    t_masked = jnp.where(ok, t, INF)
    # The reference scans primitives in order and only rejects on strict
    # t > t_max (wgsl:557,609), so the LAST primitive wins exact-t ties.
    # This is load-bearing: the Cornell area light is coplanar with the
    # ceiling and only visible because it is packed after it. Reversed
    # argmin reproduces last-wins.
    n_prims = t_masked.shape[-1]
    winner_rev = jnp.argmin(t_masked[..., ::-1], axis=-1)
    winner = jnp.int32(n_prims - 1) - winner_rev
    t_hit = jnp.take_along_axis(t_masked, winner[..., None], axis=-1)[..., 0]
    hit = jnp.isfinite(t_hit)
    t_safe = jnp.where(hit, t_hit, 0.0)
    position = o + t_safe[..., None] * d
    normal = shading_normal(prims, winner, o, d, position)
    return Hit(
        hit=hit,
        t=t_safe,
        index=jnp.where(hit, prims.index[winner], NO_INDEX),
        position=position,
        normal=normal,
        emission=prims.emission[winner],
        reflectance=prims.reflectance[winner],
        material=prims.material[winner],
    )
