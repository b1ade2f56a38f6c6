"""Vectorized stackless BVH traversal (XLA, masked over a ray batch).

Replaces the reference's per-ray linear primitive scan
(reference/src/shaders/ComputeShader.wgsl:503-518) for mesh-scale
scenes. Every ray carries ONE int of traversal state (its current node
in DFS order); one `lax.while_loop` step gathers that node's box +
fixed-width leaf for all rays at once, and the loop runs until the
slowest ray escapes. Divergence costs masked work, not scalarization.

Tie semantics: the closest-hit accept is `t < t_best`, with exact ties
broken toward the HIGHER primitive id — the order-free restatement of
the reference's in-order scan with strict `t > t_max` rejection
(wgsl:557,609: later primitives win exact ties; the Cornell ceiling
light depends on it).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from computeraytracer.ops import intersect as isect

T_MIN = isect.T_MIN
INF = isect.INF


def _dot(a, b):
    return jnp.sum(a * b, axis=-1)


def _leaf_candidates(o, d, prims, pid, t_min):
    """Candidate t for gathered primitive rows pid (..., K); (t, valid)."""
    safe = jnp.maximum(pid, 0)
    cat = prims.category[safe]
    d1 = prims.data1[safe]
    d2 = prims.data2[safe]
    d3 = prims.data3[safe]
    ob = o[..., None, :]
    db = d[..., None, :]
    t_p, ok_p = isect.patch_candidates(ob, db, d1, d2, d3)
    t_s, ok_s = isect.sphere_candidates(ob, db, d1, d2[..., 0], t_min, INF)
    t_t, ok_t = isect.triangle_candidates(ob, db, d1, d2, d3)
    t = jnp.where(cat == isect.CAT_PATCH, t_p,
                  jnp.where(cat == isect.CAT_SPHERE, t_s, t_t))
    ok = jnp.where(cat == isect.CAT_PATCH, ok_p,
                   jnp.where(cat == isect.CAT_SPHERE, ok_s, ok_t))
    ok = ok & (t >= t_min) & (pid >= 0)
    return t, ok


def intersect_bvh(o, d, exclude, prims, bvh, t_min=T_MIN) -> isect.Hit:
    """Closest-hit via skip-link BVH; same contract as intersect_brute.

    o, d: (..., 3); exclude: (...,) int32 (-1 = none). bvh: BVHArrays.
    """
    batch = o.shape[:-1]
    n_nodes = bvh.bbox_min.shape[0]
    bvh = jax.tree_util.tree_map(jnp.asarray, bvh)

    # lax.while_loop has no reverse-mode rule, and traversal is pure
    # DECISION (which primitive wins) — so the loop runs on detached
    # values and the winner's t/position/normal are recomputed
    # differentiably afterwards. Gradients w.r.t. geometry flow through
    # the recompute; the BVH itself is a non-differentiable sampling
    # structure (rebuilt host-side when vertices move).
    o_l, d_l, prims_l, bvh_l = jax.lax.stop_gradient((o, d, prims, bvh))

    # slab test: 1/d with the sign of d preserved so the +-inf side of
    # each slab lands correctly for axis-parallel rays
    tiny = jnp.abs(d_l) < 1e-12
    sign = jnp.where(d_l < 0.0, -1.0, 1.0)
    inv_d = jnp.where(tiny, sign * jnp.float32(1e30), 1.0 / jnp.where(
        tiny, 1.0, d_l))

    def cond(state):
        node, _, _ = state
        return jnp.any(node < n_nodes)

    def step(state):
        node, t_best, idx_best = state
        active = node < n_nodes
        nidx = jnp.minimum(node, n_nodes - 1)

        bmin = bvh_l.bbox_min[nidx]
        bmax = bvh_l.bbox_max[nidx]
        t0 = (bmin - o_l) * inv_d
        t1 = (bmax - o_l) * inv_d
        t_enter = jnp.max(jnp.minimum(t0, t1), axis=-1)
        t_exit = jnp.min(jnp.maximum(t0, t1), axis=-1)
        # pad the interval by 4 ulp (Ize 2013): shared mesh edges lie
        # exactly on node AABB faces, and an unpadded slab can cull an
        # edge-grazing ray before it reaches the one triangle whose
        # watertight test would accept it
        pad = jnp.float32(4 * 2.0 ** -23)
        t_exit = t_exit + jnp.abs(t_exit) * pad
        t_enter = t_enter - jnp.abs(t_enter) * pad
        hit_box = active & (t_enter <= t_exit) & (t_exit >= t_min) & \
            (t_enter <= t_best)

        pid = bvh_l.leaf_prims[nidx]            # (..., K)
        is_leaf = pid[..., 0] >= 0
        t_c, ok = _leaf_candidates(o_l, d_l, prims_l, pid, t_min)
        ok = ok & (hit_box & is_leaf)[..., None] & (pid != exclude[..., None])

        # fold K slots, ties -> higher primitive id (reference last-wins)
        for j in range(pid.shape[-1]):
            tj = t_c[..., j]
            pj = pid[..., j]
            better = ok[..., j] & (
                (tj < t_best) | ((tj == t_best) & (pj > idx_best)))
            t_best = jnp.where(better, tj, t_best)
            idx_best = jnp.where(better, pj, idx_best)

        descend = hit_box & ~is_leaf
        node = jnp.where(active,
                         jnp.where(descend, node + 1, bvh_l.miss[nidx]),
                         node)
        return node, t_best, idx_best

    node0 = jnp.zeros(batch, jnp.int32)
    t0 = jnp.full(batch, INF, jnp.float32)
    i0 = jnp.full(batch, -1, jnp.int32)
    _, _, idx_best = jax.lax.while_loop(cond, step, (node0, t0, i0))

    # differentiable recompute of the winner's hit record
    hit = idx_best >= 0
    winner = jnp.maximum(idx_best, 0)
    t_re, _ = _leaf_candidates(o, d, prims, winner[..., None], t_min)
    t_safe = jnp.where(hit, t_re[..., 0], 0.0)
    position = o + t_safe[..., None] * d
    normal = isect.shading_normal(prims, winner, o, d, position)
    return isect.Hit(
        hit=hit,
        t=t_safe,
        index=jnp.where(hit, prims.index[winner], isect.NO_INDEX),
        position=position,
        normal=normal,
        emission=prims.emission[winner],
        reflectance=prims.reflectance[winner],
        material=prims.material[winner],
    )
