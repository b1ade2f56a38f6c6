"""BVH: builder invariants + traversal parity vs the brute-force scan.

The BVH must be a pure accelerator: same closest hit (incl. the
reference's last-wins tie semantics, SURVEY.md §2.2) as the linear scan,
and identical renders/gradients when plugged into the XLA tracer."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from computeraytracer import bvh as bvh_mod
from computeraytracer.ops import intersect as isect
from computeraytracer.scene import mesh, presets, scene_from_dict
from computeraytracer.tracer import xla as xla_tracer


@pytest.fixture(scope="module")
def mesh_doc():
    return presets.mesh_scene(32, 32, subdivisions=2)  # 320 tris


@pytest.fixture(scope="module")
def mesh_scene_small(mesh_doc):
    scene, _ = scene_from_dict(mesh_doc)
    return scene


def test_builder_partitions_primitives(mesh_scene_small):
    bvh = bvh_mod.scene_bvh(mesh_scene_small)
    p = np.asarray(bvh.leaf_prims)
    ids = p[p >= 0]
    n = mesh_scene_small.primitives.count
    assert sorted(ids.tolist()) == list(range(n))  # each prim exactly once
    # skip links terminate and stay in range
    assert (np.asarray(bvh.miss) >= 0).all()
    assert (np.asarray(bvh.miss) <= bvh.n_nodes).all()


def test_builder_bounds_contain_primitives(mesh_scene_small):
    prims = mesh_scene_small.primitives
    bvh = bvh_mod.scene_bvh(mesh_scene_small)
    lo, hi = bvh_mod.builder.primitive_bounds(
        prims.category, prims.data1, prims.data2, prims.data3)
    leaf = np.asarray(bvh.leaf_prims)
    for node in range(bvh.n_nodes):
        pids = leaf[node][leaf[node] >= 0]
        if len(pids) == 0:
            continue
        assert (np.asarray(bvh.bbox_min)[node] <= lo[pids].min(0) + 1e-4).all()
        assert (np.asarray(bvh.bbox_max)[node] >= hi[pids].max(0) - 1e-4).all()


def _random_rays(scene, n, seed=0):
    r = np.random.default_rng(seed)
    lo = np.asarray(scene.primitives.data1).min(0) - 50.0
    hi = np.asarray(scene.primitives.data1).max(0) + 50.0
    o = r.uniform(lo, hi, size=(n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def _assert_hits_match(scene, bvh, o, d, exclude):
    from computeraytracer.scene import data as scene_data
    scene = scene_data.as_jax(scene)
    brute = isect.intersect_brute(o, d, exclude, scene.primitives)
    fast = bvh_mod.intersect_bvh(o, d, exclude, scene.primitives, bvh)
    np.testing.assert_array_equal(np.asarray(fast.hit), np.asarray(brute.hit))
    hit = np.asarray(brute.hit)
    np.testing.assert_array_equal(np.asarray(fast.index)[hit],
                                  np.asarray(brute.index)[hit])
    np.testing.assert_allclose(np.asarray(fast.t)[hit],
                               np.asarray(brute.t)[hit], rtol=1e-5, atol=1e-4)


def test_traversal_matches_brute_mesh(mesh_scene_small):
    bvh = bvh_mod.scene_bvh(mesh_scene_small)
    o, d = _random_rays(mesh_scene_small, 512)
    exclude = jnp.full(512, -1, jnp.int32)
    _assert_hits_match(mesh_scene_small, bvh, o, d, exclude)


def test_traversal_matches_brute_cornell(cornell_scene):
    # mixed patches+spheres, incl. the coplanar ceiling/light tie
    bvh = bvh_mod.scene_bvh(cornell_scene)
    o, d = _random_rays(cornell_scene, 512, seed=1)
    exclude = jnp.full(512, -1, jnp.int32)
    _assert_hits_match(cornell_scene, bvh, o, d, exclude)


def test_traversal_respects_exclusion(cornell_scene):
    bvh = bvh_mod.scene_bvh(cornell_scene)
    o, d = _random_rays(cornell_scene, 256, seed=2)
    exclude = jnp.asarray(
        np.random.default_rng(3).integers(
            0, cornell_scene.primitives.count, 256, dtype=np.int32))
    _assert_hits_match(cornell_scene, bvh, o, d, exclude)


def test_render_with_bvh_matches_brute(mesh_scene_small):
    bvh = bvh_mod.scene_bvh(mesh_scene_small)
    w = h = 16
    want = np.asarray(xla_tracer.render_sample(
        mesh_scene_small, w, h, 1, max_depth=3))
    got = np.asarray(xla_tracer.render_sample(
        mesh_scene_small, w, h, 1, max_depth=3, bvh=bvh))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_gradients_through_bvh(mesh_scene_small):
    bvh = bvh_mod.scene_bvh(mesh_scene_small)
    w = h = 8

    def loss(spectra, use_bvh):
        s = mesh_scene_small._replace(spectra=spectra)
        img = xla_tracer.render_sample(s, w, h, 1, max_depth=2,
                                      bvh=bvh if use_bvh else None)
        return jnp.sum(img ** 2)

    spectra = jnp.asarray(mesh_scene_small.spectra)
    g_bvh = np.asarray(jax.grad(loss)(spectra, True))
    g_brt = np.asarray(jax.grad(loss)(spectra, False))
    assert np.isfinite(g_bvh).all()
    np.testing.assert_allclose(g_bvh, g_brt, rtol=1e-3, atol=1e-6)


def _moved(scene, offset):
    """mesh_scene with its triangles (rows 6+) shifted by `offset`."""
    p = scene.primitives
    shift = jnp.zeros_like(jnp.asarray(p.data1)).at[6:].add(
        jnp.asarray(offset, jnp.float32))
    return scene._replace(primitives=p._replace(
        data1=jnp.asarray(p.data1) + shift,
        data2=jnp.asarray(p.data2) + shift,
        data3=jnp.asarray(p.data3) + shift))


def test_refit_reproduces_built_boxes(mesh_scene_small):
    """At the geometry it was built from, the refit gives the builder's
    boxes bit for bit."""
    bvh = bvh_mod.scene_bvh(mesh_scene_small, backend="numpy")
    r = bvh_mod.make_refit(bvh)(mesh_scene_small.primitives)
    np.testing.assert_array_equal(np.asarray(r.bbox_min), bvh.bbox_min)
    np.testing.assert_array_equal(np.asarray(r.bbox_max), bvh.bbox_max)
    np.testing.assert_array_equal(np.asarray(r.miss), bvh.miss)


def test_refit_boxes_bound_moved_triangles(mesh_scene_small):
    """After a vertex move every node box contains every primitive of
    its subtree, and a stale box would not."""
    bvh = bvh_mod.scene_bvh(mesh_scene_small)
    moved = _moved(mesh_scene_small, (40.0, -25.0, 10.0))
    r = bvh_mod.make_refit(bvh)(moved.primitives)
    p = moved.primitives
    lo, hi = bvh_mod.primitive_bounds(p.category, p.data1, p.data2, p.data3)
    bmin, bmax = np.asarray(r.bbox_min), np.asarray(r.bbox_max)
    leaf = np.asarray(bvh.leaf_prims)
    stale = False
    for i in range(bvh.n_nodes):
        ids = leaf[i:bvh.miss[i]].reshape(-1)
        ids = ids[ids >= 0]
        assert (bmin[i] <= lo[ids]).all() and (bmax[i] >= hi[ids]).all()
        stale |= bool((bvh.bbox_max[i] < hi[ids]).any())
    assert stale  # the move really invalidated the built boxes


def test_refit_render_and_gradient_match_brute(mesh_scene_small):
    """Render and spectra/vertex gradient through the refit BVH match
    the brute scan after a vertex move (the trainer's situation)."""
    bvh = bvh_mod.scene_bvh(mesh_scene_small)
    refit = bvh_mod.make_refit(bvh)
    moved = _moved(mesh_scene_small, (30.0, 0.0, -20.0))
    w = h = 8

    def loss(spectra, d1, use_bvh):
        s = moved._replace(spectra=spectra, primitives=moved.primitives
                           ._replace(data1=d1))
        b = refit(jax.lax.stop_gradient(s.primitives)) if use_bvh else None
        return jnp.sum(xla_tracer.render_sample(s, w, h, 1, max_depth=2,
                                                bvh=b) ** 2)

    args = (jnp.asarray(moved.spectra), jnp.asarray(moved.primitives.data1))
    vb, gb = jax.value_and_grad(loss, argnums=(0, 1))(*args, True)
    vr, gr = jax.value_and_grad(loss, argnums=(0, 1))(*args, False)
    np.testing.assert_allclose(float(vb), float(vr), rtol=1e-5)
    for a, b in zip(gb, gr):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-3, atol=1e-6)


@pytest.fixture(scope="module")
def mesh_scene_large():
    """More primitives than BVH_MIN_PRIMS: 6 walls + 1,280 triangles."""
    from computeraytracer.bvh import builder

    scene, _ = scene_from_dict(presets.mesh_scene(8, 8, subdivisions=3))
    assert int(scene.primitives.count) > builder.BVH_MIN_PRIMS
    return scene


def test_auto_bvh_by_primitive_count(cornell_scene, mesh_scene_small,
                                     mesh_scene_large):
    assert bvh_mod.auto_bvh(cornell_scene) is None
    # 326 primitives: the brute scan is the faster of the two there
    assert bvh_mod.auto_bvh(mesh_scene_small) is None
    assert bvh_mod.auto_bvh(mesh_scene_large) is not None


def test_api_render_mesh_goes_through_bvh(mesh_scene_large, monkeypatch):
    """render() on a mesh-size scene traverses the BVH, never the brute
    scan, and matches the brute image."""
    from computeraytracer.ops import intersect as isect
    from computeraytracer.tracer import api

    w = h = 8
    want = np.asarray(xla_tracer.render_accumulate(
        mesh_scene_large, w, h, 1, max_depth=2))

    def no_brute(*a, **k):
        raise AssertionError("brute scan used for a mesh scene")

    monkeypatch.setattr(isect, "intersect_brute", no_brute)
    out = api.render(mesh_scene_large, width=w, height=h, spp=1,
                     max_depth=2)
    np.testing.assert_allclose(np.asarray(out["accum_xyz"]), want,
                               rtol=1e-4, atol=1e-5)


def test_obj_roundtrip(tmp_path):
    v, f = mesh.icosphere(1)
    path = tmp_path / "ico.obj"
    lines = ["v %f %f %f" % tuple(p) for p in v]
    lines += ["f %d %d %d" % tuple(i + 1 for i in face) for face in f]
    path.write_text("\n".join(lines))
    v2, f2 = mesh.load_obj(str(path))
    np.testing.assert_allclose(v2, v, rtol=1e-5)
    np.testing.assert_array_equal(f2, f)
