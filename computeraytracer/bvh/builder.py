"""Host-side BVH builder -> flattened skip-link arrays.

The reference has no acceleration structure at all — every ray linearly
scans all primitives twice per bounce
(reference/src/shaders/ComputeShader.wgsl:503-518). A BVH is what
makes the mesh configs (BASELINE.md configs 2-5, up to ~1M triangles)
feasible, so this component is new:

- **Skip-link ("threaded") layout.** Nodes are stored in depth-first
  order; each node carries the index of the node to visit when its
  subtree is skipped (its DFS escape). Traversal then needs NO stack:
  `node = hit && !leaf ? node+1 : miss[node]` — one int per ray of
  traversal state (bvh/traverse.py).
- **Fixed-width leaves.** Each leaf stores up to `max_leaf` primitive
  ids, padded with -1 (`leaf_prims (N, K)`), so the in-leaf test is a
  static K-wide vector op instead of a variable-length loop.
- **Binned SAH** (16 bins over the centroid extent, largest axis) with
  median-split fallback; builds ~70K-triangle meshes in NumPy in
  seconds. The C++ builder (native/) handles the ~1M-triangle config.
- **Refit.** The topology is built once from concrete geometry;
  `make_refit` recomputes every node box from traced vertices (jnp), so
  a training step that moves vertices keeps the boxes tight without a
  host rebuild.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

N_BINS = 16
DEFAULT_MAX_LEAF = 4
# Scenes with more primitives than this trace through the BVH from every
# entry point (tracer/api.py, train/optimize.py); smaller ones keep the
# brute scan. On the H100 the XLA brute scan beat the BVH at every count
# timed, 26 to 326 primitives (0.185 s vs 0.472 s per 1024^2 sample at
# 326; benchmarks/tracer_crossover.py, PERF.md); the two lines cross
# near 1000 when extrapolated.
BVH_MIN_PRIMS = 1024


class BVHArrays(NamedTuple):
    """Flattened BVH; a pytree of arrays (jit-traceable as-is).

    bbox_min/max: (N, 3) f32 node bounds
    miss:         (N,) i32 DFS escape index (N = terminate)
    leaf_prims:   (N, K) i32 primitive ids, -1 padded; inner nodes all -1
    """

    bbox_min: np.ndarray
    bbox_max: np.ndarray
    miss: np.ndarray
    leaf_prims: np.ndarray

    @property
    def n_nodes(self) -> int:
        return self.bbox_min.shape[0]


def primitive_bounds(category, data1, data2, data3, xp=np):
    """Per-primitive AABBs for the tagged SoA layout (scene/data.py).

    patch: hull of {origin, +e1, +e2, +e1+e2}; triangle: hull of its
    three vertices {v0, v1, v2}; sphere: center +- radius. xp is numpy
    (host build) or jax.numpy (refit); both round identically in f32.
    """
    category = xp.asarray(category)
    d1 = xp.asarray(data1, xp.float32)
    d2 = xp.asarray(data2, xp.float32)
    d3 = xp.asarray(data3, xp.float32)
    corners = xp.stack([d1, d1 + d2, d1 + d3, d1 + d2 + d3], axis=1)
    lo = corners.min(axis=1)
    hi = corners.max(axis=1)
    is_tri = (category == 2)[:, None]
    lo = xp.where(is_tri, xp.minimum(xp.minimum(d1, d2), d3), lo)
    hi = xp.where(is_tri, xp.maximum(xp.maximum(d1, d2), d3), hi)
    is_sphere = category == 1
    r = d2[:, 0:1]
    lo = xp.where(is_sphere[:, None], d1 - r, lo)
    hi = xp.where(is_sphere[:, None], d1 + r, hi)
    return lo.astype(xp.float32), hi.astype(xp.float32)


class _Node:
    __slots__ = ("lo", "hi", "left", "right", "prims")

    def __init__(self, lo, hi, prims=None):
        self.lo, self.hi = lo, hi
        self.left = self.right = None
        self.prims = prims


def _build_node(ids, lo, hi, cent, max_leaf):
    node_lo = lo[ids].min(axis=0)
    node_hi = hi[ids].max(axis=0)
    n = len(ids)
    if n <= max_leaf:
        return _Node(node_lo, node_hi, prims=ids)

    c = cent[ids]
    c_lo, c_hi = c.min(axis=0), c.max(axis=0)
    axis = int(np.argmax(c_hi - c_lo))
    extent = c_hi[axis] - c_lo[axis]

    split_ids = None
    if extent > 1e-12:
        # binned SAH over the largest centroid axis
        rel = (c[:, axis] - c_lo[axis]) / extent
        bins = np.minimum((rel * N_BINS).astype(np.int32), N_BINS - 1)
        counts = np.bincount(bins, minlength=N_BINS)
        # per-bin bounds -> prefix/suffix areas
        b_lo = np.full((N_BINS, 3), np.inf, np.float32)
        b_hi = np.full((N_BINS, 3), -np.inf, np.float32)
        np.minimum.at(b_lo, bins, lo[ids])
        np.maximum.at(b_hi, bins, hi[ids])
        pre_lo = np.minimum.accumulate(b_lo, axis=0)
        pre_hi = np.maximum.accumulate(b_hi, axis=0)
        suf_lo = np.minimum.accumulate(b_lo[::-1], axis=0)[::-1]
        suf_hi = np.maximum.accumulate(b_hi[::-1], axis=0)[::-1]

        def area(alo, ahi):
            d = np.maximum(ahi - alo, 0.0)
            return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]

        n_left = np.cumsum(counts)[:-1]
        n_right = n - n_left
        cost = (area(pre_lo, pre_hi)[:-1] * n_left
                + area(suf_lo, suf_hi)[1:] * n_right)
        valid = (n_left > 0) & (n_right > 0)
        if valid.any():
            cost = np.where(valid, cost, np.inf)
            best = int(np.argmin(cost))
            go_left = bins <= best
            split_ids = (ids[go_left], ids[~go_left])

    if split_ids is None:
        # median split (degenerate centroids / no valid SAH split)
        order = np.argsort(c[:, axis], kind="stable")
        half = n // 2
        split_ids = (ids[order[:half]], ids[order[half:]])

    node = _Node(node_lo, node_hi)
    node.left = _build_node(split_ids[0], lo, hi, cent, max_leaf)
    node.right = _build_node(split_ids[1], lo, hi, cent, max_leaf)
    return node


def _flatten(root, max_leaf):
    """Emit depth-first order with per-node DFS escape ("miss") links.

    A node's miss link is where traversal resumes when the node's box is
    not hit (or a leaf is done): the left child escapes to its right
    sibling, the right child inherits its parent's escape, the root
    escapes to N (terminate)."""
    bmin, bmax, miss, leafp = [], [], [], []
    sizes = _subtree_sizes(root)

    # iterative DFS; escape=None marks "patch with final N" (root spine)
    stack = [(root, None)]
    while stack:
        node, escape = stack.pop()
        i = len(bmin)
        bmin.append(node.lo)
        bmax.append(node.hi)
        miss.append(escape)
        if node.prims is not None:
            row = np.full(max_leaf, -1, np.int32)
            row[: len(node.prims)] = node.prims
            leafp.append(row)
        else:
            leafp.append(np.full(max_leaf, -1, np.int32))
            right_start = i + 1 + sizes[id(node.left)]
            # LIFO: push right first so left is emitted at i+1
            stack.append((node.right, escape))
            stack.append((node.left, right_start))

    n = len(bmin)
    miss_arr = np.asarray([n if e is None else e for e in miss], np.int32)
    return BVHArrays(
        bbox_min=np.asarray(bmin, np.float32),
        bbox_max=np.asarray(bmax, np.float32),
        miss=miss_arr,
        leaf_prims=np.asarray(leafp, np.int32),
    )


def _subtree_sizes(root) -> dict:
    """id(node) -> node count of its subtree, one post-order pass."""
    sizes = {}
    stack = [(root, False)]
    while stack:
        node, expanded = stack.pop()
        if node.prims is not None:
            sizes[id(node)] = 1
        elif expanded:
            sizes[id(node)] = (1 + sizes[id(node.left)]
                               + sizes[id(node.right)])
        else:
            stack.append((node, True))
            stack.append((node.left, False))
            stack.append((node.right, False))
    return sizes


def build_bvh(category, data1, data2, data3,
              max_leaf: int = DEFAULT_MAX_LEAF) -> BVHArrays:
    """Build a BVH over tagged primitives; returns flattened arrays."""
    import sys

    lo, hi = primitive_bounds(category, data1, data2, data3)
    cent = 0.5 * (lo + hi)
    ids = np.arange(lo.shape[0], dtype=np.int32)
    limit = sys.getrecursionlimit()
    try:
        sys.setrecursionlimit(max(limit, 10000))
        root = _build_node(ids, lo, hi, cent, max_leaf)
        return _flatten(root, max_leaf)
    finally:
        sys.setrecursionlimit(limit)


def scene_bvh(scene, max_leaf: int = DEFAULT_MAX_LEAF,
              backend: str = "auto") -> BVHArrays:
    """Build the scene BVH. backend: "numpy", "native" (C++), or "auto"
    (native above 20K primitives, where Python per-node overhead bites;
    see native/bvh_builder.cpp)."""
    p = scene.primitives
    args = (np.asarray(p.category), np.asarray(p.data1),
            np.asarray(p.data2), np.asarray(p.data3))
    n = args[0].shape[0]
    if backend == "native" or (backend == "auto" and n >= 20_000):
        try:
            from computeraytracer import native
            return native.build_bvh_native(*args, max_leaf=max_leaf)
        except Exception:
            if backend == "native":
                raise
    return build_bvh(*args, max_leaf)


def auto_bvh(scene):
    """The scene's BVH when it has more than BVH_MIN_PRIMS primitives,
    else None (brute scan)."""
    n = int(np.asarray(scene.primitives.category).shape[0])
    return scene_bvh(scene) if n > BVH_MIN_PRIMS else None


def _refit_levels(bvh: BVHArrays):
    """Inner nodes grouped by depth, deepest first, as (parents, left
    children, right children) index arrays. In the skip-link layout an
    inner node i has its left child at i + 1 and its right child at the
    left child's escape link."""
    miss = np.asarray(bvh.miss)
    inner = np.asarray(bvh.leaf_prims)[:, 0] < 0
    n = miss.shape[0]
    depth = np.zeros(n, np.int32)
    for i in np.nonzero(inner)[0]:  # DFS order: parents before children
        depth[i + 1] = depth[miss[i + 1]] = depth[i] + 1
    levels = []
    for lev in range(int(depth.max()), -1, -1):
        parents = np.nonzero(inner & (depth == lev))[0].astype(np.int32)
        if parents.size:
            levels.append((parents, parents + 1, miss[parents + 1]))
    return tuple(levels)


def make_refit(bvh: BVHArrays):
    """refit(primitives) -> BVHArrays with the topology of `bvh` and node
    boxes recomputed from the given (possibly traced) geometry.

    Boxes are exact unions of the primitive bounds, so at the geometry
    the BVH was built from the refit reproduces the built boxes bit for
    bit. Traversal treats the boxes as non-differentiable, so callers
    pass stop_gradient'ed primitives."""
    import jax.numpy as jnp

    levels = _refit_levels(bvh)
    leaf_prims = np.asarray(bvh.leaf_prims)
    valid = (leaf_prims >= 0)[..., None]
    safe = np.maximum(leaf_prims, 0)

    def refit(prims) -> BVHArrays:
        lo, hi = primitive_bounds(prims.category, prims.data1, prims.data2,
                                  prims.data3, xp=jnp)
        bmin = jnp.where(valid, lo[safe], jnp.inf).min(axis=1)
        bmax = jnp.where(valid, hi[safe], -jnp.inf).max(axis=1)
        for parents, left, right in levels:
            bmin = bmin.at[parents].set(jnp.minimum(bmin[left], bmin[right]))
            bmax = bmax.at[parents].set(jnp.maximum(bmax[left], bmax[right]))
        return BVHArrays(bbox_min=bmin, bbox_max=bmax,
                         miss=jnp.asarray(bvh.miss),
                         leaf_prims=jnp.asarray(leaf_prims))

    return refit
