"""C++ BVH builder (native/bvh_builder.cpp) vs the NumPy builder.

Both emit the same BVHArrays layout; topology may legally differ
(tie-breaks inside SAH), so parity is checked at the SEMANTIC level:
same closest hits for random rays, plus structural invariants."""

import numpy as np
import jax.numpy as jnp
import pytest

from computeraytracer import bvh as bvh_mod
from computeraytracer import native
from computeraytracer.scene import mesh, presets, scene_from_dict

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="no native toolchain")


@pytest.fixture(scope="module")
def mesh_scene_small():
    scene, _ = scene_from_dict(presets.mesh_scene(32, 32, subdivisions=3))
    return scene


def _native_bvh(scene, max_leaf=4):
    p = scene.primitives
    return native.build_bvh_native(
        np.asarray(p.category), np.asarray(p.data1), np.asarray(p.data2),
        np.asarray(p.data3), max_leaf=max_leaf)


def test_partition_invariant(mesh_scene_small):
    bvh = _native_bvh(mesh_scene_small)
    leaf = np.asarray(bvh.leaf_prims)
    ids = leaf[leaf >= 0]
    n = mesh_scene_small.primitives.count
    assert sorted(ids.tolist()) == list(range(n))
    assert (np.asarray(bvh.miss) >= 0).all()
    assert (np.asarray(bvh.miss) <= bvh.n_nodes).all()
    # DFS skip links strictly advance (no cycles)
    assert (np.asarray(bvh.miss) > np.arange(bvh.n_nodes)).all()


def test_bounds_contain_primitives(mesh_scene_small):
    p = mesh_scene_small.primitives
    bvh = _native_bvh(mesh_scene_small)
    lo, hi = bvh_mod.builder.primitive_bounds(
        p.category, p.data1, p.data2, p.data3)
    leaf = np.asarray(bvh.leaf_prims)
    bmin = np.asarray(bvh.bbox_min)
    bmax = np.asarray(bvh.bbox_max)
    for node in range(bvh.n_nodes):
        pids = leaf[node][leaf[node] >= 0]
        if len(pids):
            assert (bmin[node] <= lo[pids].min(0) + 1e-4).all()
            assert (bmax[node] >= hi[pids].max(0) - 1e-4).all()


def test_same_hits_as_numpy_builder(mesh_scene_small):
    from computeraytracer.scene import data as scene_data

    scene = scene_data.as_jax(mesh_scene_small)
    bvh_np = bvh_mod.scene_bvh(mesh_scene_small, backend="numpy")
    bvh_cc = _native_bvh(mesh_scene_small)

    r = np.random.default_rng(0)
    o = jnp.asarray(r.uniform(-100, 650, size=(512, 3)).astype(np.float32))
    d = r.normal(size=(512, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d = jnp.asarray(d)
    exclude = jnp.full(512, -1, jnp.int32)

    h_np = bvh_mod.intersect_bvh(o, d, exclude, scene.primitives, bvh_np)
    h_cc = bvh_mod.intersect_bvh(o, d, exclude, scene.primitives, bvh_cc)
    np.testing.assert_array_equal(np.asarray(h_cc.hit), np.asarray(h_np.hit))
    hit = np.asarray(h_np.hit)
    np.testing.assert_array_equal(np.asarray(h_cc.index)[hit],
                                  np.asarray(h_np.index)[hit])


def test_scene_bvh_auto_dispatch(mesh_scene_small):
    # small scene -> numpy path; explicit native -> native path; both load
    b1 = bvh_mod.scene_bvh(mesh_scene_small, backend="numpy")
    b2 = bvh_mod.scene_bvh(mesh_scene_small, backend="native")
    assert b1.n_nodes > 0 and b2.n_nodes > 0


def test_large_mesh_build_speed():
    """~80K tris must build in well under a second natively."""
    import time

    v, f = mesh.displaced_blob(subdivisions=5)  # 20480 tris
    cols = mesh.mesh_arrays(v, f, 0, 4, 0)
    t0 = time.time()
    bvh = native.build_bvh_native(cols["category"], cols["data1"],
                                  cols["data2"], cols["data3"])
    dt = time.time() - t0
    assert bvh.n_nodes > 1000
    assert dt < 2.0, f"native build too slow: {dt:.2f}s"
