"""Scene ingestion: the reference's JSON schema -> Scene pytree.

Loads the unchanged schema of reference/src/scenes/cornell.json:
{camera: {eye, lookat, up, focalLength, width, height},
 objects: {patches: [...], spheres: [...], meshes: [...](extension)},
 spectra: {name: {wavelength: [...], value: [...]}}}

Semantics reproduced from reference/src/main.js:
- primitive flattening with stable global index, patches then spheres
  (:114-137); triangles (extension) appended last;
- spectrum name->index assignment by insertion order (:157-164) and the
  material enum diffuse=0/light=1/glass=2 (:166-170);
- spectra resampled to 301 samples at 1nm over 400-700nm (:334-378);
- the LAST spectrum doubles as the Beer-Lambert extinction coefficient
  (ComputeShader.wgsl:176).

A CIE.json-format file ({CIE_X: [...471], CIE_Y, CIE_Z}) may be supplied;
otherwise the analytic CIE fit is used (ops/spectrum.py).
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np
import jax.numpy as jnp

from computeraytracer import config as C
from computeraytracer.ops import spectrum as spec_ops
from computeraytracer.scene import data as sd
from computeraytracer.scene import mesh as mesh_ops

_MATERIALS = {"diffuse": C.DIFFUSE, "light": C.LIGHT, "glass": C.GLASS,
              "mirror": C.MIRROR}


def _spectra_table(spectra_dict) -> tuple[np.ndarray, dict]:
    """Insertion-order name->index map + dense (S, 301) table."""
    name_to_index = {name: i for i, name in enumerate(spectra_dict)}
    rows = [
        spec_ops.resample_spectrum(s["wavelength"], s["value"])
        for s in spectra_dict.values()
    ]
    return np.stack(rows).astype(np.float32), name_to_index


def scene_from_dict(doc: dict, cie: Optional[np.ndarray] = None) -> tuple:
    """Build (Scene, meta) from a parsed scene JSON document.

    meta: {"width", "height", "spectrum_index": {name: idx}}.
    """
    spectra, name_to_index = _spectra_table(doc["spectra"])

    def prim_common(obj):
        return dict(
            emission=name_to_index[obj["emission"]],
            reflectance=name_to_index[obj["reflectance"]],
            material=_MATERIALS[obj["type"]],
        )

    objects = doc.get("objects", {})
    patches = [
        dict(origin=p["origin"], edge1=p["edge1"], edge2=p["edge2"],
             **prim_common(p))
        for p in objects.get("patches", [])
    ]
    spheres = [
        dict(center=s["center"], radius=s["radius"], **prim_common(s))
        for s in objects.get("spheres", [])
    ]
    mesh_parts = []
    for m in objects.get("meshes", []):
        common = prim_common(m)
        mesh_parts.append(mesh_ops.mesh_arrays(
            m["vertices"], m["faces"], reflectance=common["reflectance"],
            emission=common["emission"], material=common["material"]))

    prims = sd.build_primitives(patches, spheres, mesh_parts=mesh_parts)
    lights = sd.extract_lights(prims, C.LIGHT)

    cam = doc["camera"]
    camera = sd.CameraSpec(
        eye=np.asarray(cam["eye"], np.float32),
        lookat=np.asarray(cam["lookat"], np.float32),
        up=np.asarray(cam["up"], np.float32),
        fov=np.float32(cam["focalLength"]),
    )

    if cie is None:
        cie = spec_ops.cie_1931_tables()
    # NumPy leaves throughout: no device transfer at load time; jax
    # converts on first use inside jit
    scene = sd.Scene(
        primitives=prims,
        lights=lights,
        camera=camera,
        spectra=np.asarray(spectra, np.float32),
        cie=np.asarray(cie, np.float32),
    )
    meta = {
        "width": int(cam["width"]),
        "height": int(cam["height"]),
        "spectrum_index": name_to_index,
    }
    return scene, meta


def load_scene(path: str, cie_path: Optional[str] = None):
    """Load a scene JSON file (reference schema). Returns (Scene, meta)."""
    with open(path) as f:
        doc = json.load(f)
    cie = None
    if cie_path is not None:
        with open(cie_path) as f:
            cie_doc = json.load(f)
        cie = np.stack(
            [cie_doc["CIE_X"], cie_doc["CIE_Y"], cie_doc["CIE_Z"]]
        ).astype(np.float32)
    return scene_from_dict(doc, cie)
