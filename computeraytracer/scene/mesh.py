"""Triangle meshes: procedural generators + OBJ loading.

The reference supports only planar patches and spheres
(reference/src/shaders/ComputeShader.wgsl:520-632); triangle
meshes are the extension required by BASELINE.md configs 3-5 (~70K-tri
"bunny" and ~1M-tri scenes). With zero network egress there is no
Stanford-bunny asset in the image, so the test meshes are procedural:
a subdivided icosahedron, optionally displaced by a deterministic
multi-octave sinusoidal field to get a bunny-like irregular closed
surface at any triangle budget.
"""

from __future__ import annotations

import numpy as np


def icosahedron():
    """Unit icosahedron (12 verts, 20 faces)."""
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.array([
        [-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
        [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
        [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1],
    ], np.float64)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], np.int64)
    return v, f


def subdivide(verts, faces):
    """One loop of 1->4 midpoint subdivision, projected to the sphere."""
    verts = list(map(tuple, verts))
    cache = {}

    def midpoint(a, b):
        key = (a, b) if a < b else (b, a)
        if key not in cache:
            m = 0.5 * (np.asarray(verts[a]) + np.asarray(verts[b]))
            m /= np.linalg.norm(m)
            cache[key] = len(verts)
            verts.append(tuple(m))
        return cache[key]

    out = []
    for a, b, c in faces:
        ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
        out += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
    return np.asarray(verts, np.float64), np.asarray(out, np.int64)


def icosphere(subdivisions: int):
    """Unit icosphere: 20 * 4^s faces (s=6 -> 81920, the ~70K config)."""
    v, f = icosahedron()
    for _ in range(subdivisions):
        v, f = subdivide(v, f)
    return v, f


def displaced_blob(subdivisions: int = 6, amplitude: float = 0.25,
                   seed: int = 7):
    """Bunny-stand-in: icosphere radially displaced by a deterministic
    sum of random-direction sinusoids (smooth, closed, irregular)."""
    v, f = icosphere(subdivisions)
    rng = np.random.default_rng(seed)
    r = np.ones(len(v))
    for octave in range(4):
        freq = 1.5 * (2.0 ** octave)
        for _ in range(3):
            dirn = rng.normal(size=3)
            dirn /= np.linalg.norm(dirn)
            phase = rng.uniform(0, 2 * np.pi)
            r += (amplitude / (2.0 ** octave) / 3.0) * np.sin(
                freq * v @ dirn + phase)
    return v * r[:, None], f


def transform(verts, scale=1.0, translate=(0.0, 0.0, 0.0)):
    return np.asarray(verts, np.float64) * float(scale) + np.asarray(
        translate, np.float64)


def mesh_triangles(verts, faces, reflectance: int, emission: int,
                   material: int):
    """Faces -> the triangle-dict list build_primitives consumes."""
    verts = np.asarray(verts, np.float32)
    out = []
    for a, b, c in np.asarray(faces):
        out.append({
            "v0": verts[a], "v1": verts[b], "v2": verts[c],
            "reflectance": reflectance, "emission": emission,
            "material": material,
        })
    return out


def mesh_arrays(verts, faces, reflectance: int, emission: int,
                material: int):
    """Vectorized alternative to mesh_triangles for large meshes:
    returns SoA columns (category, d1, d2, d3, emi, ref, mat)."""
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces)
    n = len(faces)
    return dict(
        category=np.full(n, 2, np.int32),
        data1=verts[faces[:, 0]],
        data2=verts[faces[:, 1]],
        data3=verts[faces[:, 2]],
        emission=np.full(n, emission, np.int32),
        reflectance=np.full(n, reflectance, np.int32),
        material=np.full(n, material, np.int32),
    )


def load_obj(path: str):
    """Minimal OBJ: v / f lines (triangulates polygon faces as a fan)."""
    verts, faces = [], []
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "f":
                idx = [int(p.split("/")[0]) for p in parts[1:]]
                idx = [i - 1 if i > 0 else len(verts) + i for i in idx]
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return np.asarray(verts, np.float64), np.asarray(faces, np.int64)
