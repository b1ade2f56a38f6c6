"""Bundled scenes, generated programmatically (reference-schema dicts).

The reference ships a single Cornell-box JSON
(reference/src/scenes/cornell.json: 5 walls, rect area light, two
boxes, a diffuse and a glass sphere, 7 named spectra). These builders
produce scenes of the same shape from code; pass the result to
scene_from_dict, or json.dump it for an on-disk scene file.

Spectra are smooth approximations of the published Cornell-box
reflectance curves (the estimator-parity tests compare this framework's
own tracer implementations against each other, so exact spectral values
are not load-bearing).
"""

from __future__ import annotations

import math

import numpy as np


def _cornell_spectra() -> dict:
    """Named spectra in insertion order white, green, red, light, dark,
    extinction — the LAST entry is consumed as the Beer-Lambert
    extinction spectrum (ComputeShader.wgsl:176)."""
    return {
        "white": {
            "wavelength": [400, 450, 500, 550, 600, 650, 700],
            "value": [0.34, 0.61, 0.70, 0.73, 0.74, 0.73, 0.72],
        },
        "green": {
            "wavelength": [400, 450, 500, 530, 560, 600, 650, 700],
            "value": [0.09, 0.10, 0.31, 0.46, 0.39, 0.22, 0.15, 0.16],
        },
        "red": {
            "wavelength": [400, 450, 500, 550, 600, 650, 700],
            "value": [0.04, 0.05, 0.06, 0.09, 0.38, 0.60, 0.64],
        },
        "light": {
            "wavelength": [400, 500, 600, 700],
            "value": [15.0, 18.0, 15.6, 18.4],
        },
        "dark": {"wavelength": [400, 700], "value": [0.0, 0.0]},
        "extinction": {
            "wavelength": [400, 500, 600, 700],
            "value": [0.0, 0.01, 0.1, 0.01],
        },
    }


def _patch(origin, edge1, edge2, reflectance="white", emission="dark",
           type_="diffuse"):
    return {
        "origin": list(map(float, origin)),
        "edge1": list(map(float, edge1)),
        "edge2": list(map(float, edge2)),
        "emission": emission,
        "reflectance": reflectance,
        "type": type_,
    }


def _box_patches(base_corner, size, angle_deg, reflectance="white"):
    """Five faces (no bottom) of a y-rotated box, as planar patches."""
    sx, sy, sz = size
    a = math.radians(angle_deg)
    c, s = math.cos(a), math.sin(a)

    def rot(p):
        x, _, z = p
        return np.array(
            [base_corner[0] + c * x + s * z, base_corner[1] + p[1],
             base_corner[2] - s * x + c * z], np.float64)

    p000, p100 = rot((0, 0, 0)), rot((sx, 0, 0))
    p001, p101 = rot((0, 0, sz)), rot((sx, 0, sz))
    up = np.array([0.0, sy, 0.0])
    patches = []
    # top
    patches.append(_patch(p000 + up, p100 - p000, p001 - p000, reflectance))
    # four sides
    for q0, q1 in [(p000, p100), (p100, p101), (p101, p001), (p001, p000)]:
        patches.append(_patch(q0, q1 - q0, up, reflectance))
    return patches


def cornell_box(width: int = 512, height: int = 512) -> dict:
    """Classic 555-unit Cornell box: 5 walls + area light + two boxes +
    diffuse/glass spheres (18 primitives, like the reference scene)."""
    S = 555.0
    patches = [
        # floor, ceiling
        _patch([0, 0, 0], [0, 0, S], [S, 0, 0], "white"),
        _patch([0, S, 0], [S, 0, 0], [0, 0, S], "white"),
        # area light, coplanar with the ceiling (the reference relies on
        # last-primitive-wins tie-breaking to make it visible)
        _patch([213, S, 227], [130, 0, 0], [0, 0, 105], "white", "light", "light"),
        # back wall, right (red) wall, left (green) wall
        _patch([0, 0, S], [S, 0, 0], [0, S, 0], "white"),
        _patch([S, 0, 0], [0, S, 0], [0, 0, S], "red"),
        _patch([0, 0, 0], [0, 0, S], [0, S, 0], "green"),
    ]
    patches += _box_patches((130, 0, 65), (165, 165, 165), -18.0)
    patches += _box_patches((265, 0, 295), (165, 330, 165), 15.0)
    spheres = [
        {"center": [188.0, 300.0, 300.0], "radius": 60.0,
         "emission": "dark", "reflectance": "red", "type": "diffuse"},
        {"center": [188.0, 240.0, 140.0], "radius": 75.0,
         "emission": "dark", "reflectance": "white", "type": "glass"},
    ]
    return {
        "camera": {
            "eye": [278, 273, -800], "lookat": [278, 273, 0],
            "up": [0, 1, 0], "focalLength": 0.7,
            "width": width, "height": height,
        },
        "objects": {"patches": patches, "spheres": spheres},
        "spectra": _cornell_spectra(),
    }


def simple_scene(width: int = 256, height: int = 256) -> dict:
    """Few-primitive scene for BASELINE config 1: floor + back wall +
    one diffuse sphere + one rect light."""
    return {
        "camera": {
            "eye": [0, 1.0, 4.0], "lookat": [0, 1.0, 0],
            "up": [0, 1, 0], "focalLength": 0.9,
            "width": width, "height": height,
        },
        "objects": {
            "patches": [
                _patch([-3, 0, -3], [0, 0, 6], [6, 0, 0], "white"),
                _patch([-3, 0, -3], [6, 0, 0], [0, 4, 0], "white"),
                _patch([-0.8, 3.2, -1.2], [1.6, 0, 0], [0, 0, 1.6],
                       "white", "light", "light"),
            ],
            "spheres": [
                {"center": [0.0, 1.0, 0.0], "radius": 0.8,
                 "emission": "dark", "reflectance": "red", "type": "diffuse"},
            ],
        },
        "spectra": _cornell_spectra(),
    }


def unoccluded_scene(width: int = 256, height: int = 256) -> dict:
    """Floor + back wall + out-of-frustum rect light, NO occluders.

    Every visibility edge is outside the camera frustum (the light sits
    above the visible sky line, so even its direct-hit silhouette is
    gone) and nothing shadows anything: the rendered image is a smooth
    function of vertex positions — the scene where interior (AD) vertex
    gradients must equal finite differences (test_gradients.py)."""
    doc = simple_scene(width, height)
    doc["objects"]["spheres"] = []
    # oversized floor/wall so every patch boundary stays far outside the
    # frustum (a primary ray grazing a patch edge is a visibility edge)
    doc["objects"]["patches"] = [
        _patch([-5, 0, -3], [0, 0, 10], [10, 0, 0], "white"),
        _patch([-5, 0, -3], [10, 0, 0], [0, 9, 0], "white"),
        _patch([-1.2, 5.0, -1.6], [2.4, 0, 0], [0, 0, 2.4],
               "white", "light", "light"),
    ]
    return doc


def occluder_scene(width: int = 256, height: int = 256) -> dict:
    """Floating diffuse occluder between light and floor: the scene for
    visibility-GRADIENT tests (ops/warp.py).

    Translating the occluder moves two visibility boundaries whose
    image-derivative interior AD misses entirely:
    - its screen silhouette (dim camera-facing front against the lit
      back wall), a solid mid-image block — the "screen" warp domain;
    - its soft shadow on the floor in front of it, bottom rows — the
      "light" (NEE shadow ray) and "hemi" (MIS bounce-to-light)
      domains.
    Geometry keeps the two bands separated: the occluder is a vertical
    camera-facing patch floating at y in [1.1, 1.9], z = 0.6, and its
    shadow (cast by the y=3.2 light) lands on floor z > 0.5 (bottom
    image rows); the wall behind the silhouette block is unshadowed, so
    each band isolates its warp domains. No glass, no spheres: every
    boundary term is a diffuse silhouette the warped-area estimator
    covers."""
    doc = simple_scene(width, height)
    doc["objects"]["spheres"] = []
    doc["objects"]["patches"] = [
        # oversized floor + back wall (their own edges stay off-screen)
        _patch([-5, 0, -3], [0, 0, 10], [10, 0, 0], "white"),
        _patch([-5, 0, -3], [10, 0, 0], [0, 9, 0], "white"),
        # compact light, fully outside the frustum: crisp shadow, no
        # direct-glare pixels
        _patch([-0.4, 3.2, -1.0], [0.8, 0, 0], [0, 0, 0.8],
               "white", "light", "light"),
        # the occluder: vertical camera-facing patch under the light
        _patch([-0.4, 1.1, 0.6], [0.8, 0, 0], [0, 0.8, 0], "red"),
    ]
    return doc


def mesh_scene(width: int = 1024, height: int = 1024,
               subdivisions: int = 6) -> dict:
    """BASELINE config-3 style scene: Cornell walls + a ~70K-triangle
    procedural blob (the bunny stand-in; scene/mesh.py) on the floor.

    subdivisions=6 -> 81,920 triangles; 4 -> 5,120 (test-sized)."""
    from computeraytracer.scene import mesh as mesh_ops

    doc = cornell_box(width, height)
    doc["objects"]["spheres"] = []
    # drop the boxes; keep walls + light (first 6 patches)
    doc["objects"]["patches"] = doc["objects"]["patches"][:6]
    verts, faces = mesh_ops.displaced_blob(subdivisions)
    verts = mesh_ops.transform(verts, scale=140.0,
                               translate=(278.0, 180.0, 280.0))
    doc["objects"]["meshes"] = [{
        "vertices": verts.tolist(), "faces": faces.tolist(),
        "emission": "dark", "reflectance": "white", "type": "diffuse",
    }]
    return doc


def cornell_box_glassless(width: int = 512, height: int = 512) -> dict:
    """Cornell variant without glass (pure-diffuse estimator tests)."""
    doc = cornell_box(width, height)
    doc["objects"]["spheres"] = [s for s in doc["objects"]["spheres"]
                                 if s["type"] != "glass"]
    return doc


def multi_material_box(width: int = 512, height: int = 512) -> dict:
    """Cornell walls + area light + diffuse, glass AND mirror spheres:
    every BSDF the tracer implements (BASELINE config 4's scene)."""
    doc = cornell_box(width, height)
    doc["objects"]["spheres"] = [
        {"center": [420.0, 90.0, 150.0], "radius": 90.0,
         "emission": "dark", "reflectance": "red", "type": "diffuse"},
        {"center": [160.0, 90.0, 145.0], "radius": 90.0,
         "emission": "dark", "reflectance": "white", "type": "glass"},
        {"center": [290.0, 420.0, 380.0], "radius": 85.0,
         "emission": "dark", "reflectance": "white", "type": "mirror"},
    ]
    return doc
