"""Scene representation: SoA jnp arrays, registered as JAX pytrees.

Replaces the reference's packed GPU storage buffers
(reference/src/main.js:138-296). Instead of byte-packed stride-80
structs, primitives live as structure-of-arrays so intersection runs as
vector code over rays, and every float leaf is a differentiable input.

Layout convention (mirrors the tagged Primitive struct, main.js:211-246):
- category 0 (patch):    data1=origin, data2=edge1, data3=edge2
- category 1 (sphere):   data1=center, data2=(r, r, r), data3 unused
- category 2 (triangle): data1=v0, data2=v1, data3=v2   [extension]

Triangles store VERTICES (not edge vectors like patches): the
watertight intersection test (ops/intersect.py) needs shared-edge
endpoints to be bitwise identical across adjacent triangles, which
v0 + fl(v1 - v0) reconstruction cannot guarantee in f32.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax.numpy as jnp


class ScenePrimitives(NamedTuple):
    category: jnp.ndarray     # (P,) int32
    data1: jnp.ndarray        # (P, 3) f32
    data2: jnp.ndarray        # (P, 3) f32
    data3: jnp.ndarray        # (P, 3) f32
    emission: jnp.ndarray     # (P,) int32 spectrum index
    reflectance: jnp.ndarray  # (P,) int32 spectrum index
    material: jnp.ndarray     # (P,) int32 (config.DIFFUSE/LIGHT/GLASS/...)
    index: jnp.ndarray        # (P,) int32 stable global index

    @property
    def count(self) -> int:
        return self.category.shape[0]


class SceneLights(NamedTuple):
    """Emissive primitives, extracted like main.js:255-296.

    Only indices are stored; light geometry is gathered from
    `Scene.primitives` at trace time so vertex gradients have a single
    source of truth. Only rectangular patch lights are supported (as in
    the reference, whose sampler assumes origin+u*edge1+v*edge2).
    """

    prim_index: jnp.ndarray  # (L,) int32 global primitive index
    emission: jnp.ndarray    # (L,) int32 spectrum index

    @property
    def count(self) -> int:
        return self.prim_index.shape[0]


class CameraSpec(NamedTuple):
    eye: jnp.ndarray     # (3,)
    lookat: jnp.ndarray  # (3,)
    up: jnp.ndarray      # (3,)
    fov: jnp.ndarray     # () vertical FOV in radians ("focalLength")


class Scene(NamedTuple):
    primitives: ScenePrimitives
    lights: SceneLights
    camera: CameraSpec
    spectra: jnp.ndarray  # (S, 301) f32; by convention the LAST row is the
    #                       Beer-Lambert extinction spectrum (wgsl:176)
    cie: jnp.ndarray      # (3, 471) f32

    @property
    def n_spectra(self) -> int:
        return self.spectra.shape[0]


def as_jax(scene: Scene) -> Scene:
    """Convert NumPy leaves to jnp (no-op for tracers/arrays).

    Loaders produce NumPy leaves so scene construction never touches the
    device; tracers call this at entry so mixed np/traced pytrees index
    cleanly."""
    import jax

    return jax.tree_util.tree_map(jnp.asarray, scene)


def build_primitives(patches, spheres, triangles=None,
                     mesh_parts=None) -> ScenePrimitives:
    """Flatten typed primitive lists into one tagged SoA list.

    Mirrors the reference's flattening (main.js:114-137): patches first,
    then spheres (then triangles — extension), with a stable global index.
    Each entry: dict with geometry + emission/reflectance/material ints.
    mesh_parts: optional list of SoA column dicts (scene.mesh.mesh_arrays)
    appended wholesale — the vectorized path for large meshes.
    """
    cats, d1, d2, d3, emi, ref, mat = [], [], [], [], [], [], []
    for p in patches:
        cats.append(0)
        d1.append(p["origin"]); d2.append(p["edge1"]); d3.append(p["edge2"])
        emi.append(p["emission"]); ref.append(p["reflectance"]); mat.append(p["material"])
    for s in spheres:
        cats.append(1)
        r = float(s["radius"])
        d1.append(s["center"]); d2.append([r, r, r]); d3.append([0.0, 0.0, 0.0])
        emi.append(s["emission"]); ref.append(s["reflectance"]); mat.append(s["material"])
    for t in (triangles or []):
        cats.append(2)
        d1.append(np.asarray(t["v0"], np.float32))
        d2.append(np.asarray(t["v1"], np.float32))
        d3.append(np.asarray(t["v2"], np.float32))
        emi.append(t["emission"]); ref.append(t["reflectance"]); mat.append(t["material"])
    cols = dict(
        category=np.asarray(cats, np.int32).reshape(-1),
        data1=np.asarray(d1, np.float32).reshape(-1, 3),
        data2=np.asarray(d2, np.float32).reshape(-1, 3),
        data3=np.asarray(d3, np.float32).reshape(-1, 3),
        emission=np.asarray(emi, np.int32).reshape(-1),
        reflectance=np.asarray(ref, np.int32).reshape(-1),
        material=np.asarray(mat, np.int32).reshape(-1),
    )
    for part in (mesh_parts or []):
        cols = {k: np.concatenate([cols[k], np.asarray(part[k])])
                for k in cols}
    n = len(cols["category"])
    if n == 0:
        raise ValueError("scene has no primitives")
    # NumPy leaves: scene construction must not touch the device (the
    # loader runs host-side; jnp conversion happens lazily on first use)
    return ScenePrimitives(index=np.arange(n, dtype=np.int32), **cols)


def extract_lights(prims: ScenePrimitives, light_material: int = 1) -> SceneLights:
    """Filter emissive patches into the light list (main.js:255-260)."""
    mat = np.asarray(prims.material)
    cat = np.asarray(prims.category)
    sel = np.nonzero(mat == light_material)[0]
    if len(sel) == 0:
        raise ValueError("scene has no lights")
    if not np.all(cat[sel] == 0):
        raise ValueError("only planar-patch lights are supported")
    return SceneLights(
        prim_index=sel.astype(np.int32),
        emission=np.asarray(prims.emission)[sel],
    )
