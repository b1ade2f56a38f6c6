#!/usr/bin/env python
"""Where each tracer wins, by primitive count, on the GPU.

    python benchmarks/tracer_crossover.py \
        [--kernel-prims 10 26 46] [--xla-prims 26 86 166 326]

Scenes: the five walls and the light of presets.mesh_scene plus the
first k triangles of its blob, N = 6 + k primitives, rendered at
1024x1024, 1 spp, depth 8. For each N it times

  triton      the forward megakernel (tracer/pallas.py), which unrolls
              its primitive scan at build time
  xla_brute   the XLA tracer's linear scan over every primitive
  xla_bvh     the XLA tracer through the skip-link BVH

and prints one JSON line per (tracer, N): first-call seconds (compile
plus one run), best of 3 steady seconds, Mpaths/s, and the card's name
and power limit. These readings set kernels/megakernel.MAX_UNROLLED_PRIMS
and bvh/builder.BVH_MIN_PRIMS (PERF.md). Run it twice in a row to see
what the persistent compile cache (utils/compile_cache.py) saves.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

W = H = 1024
DEPTH = 8
WALLS = 6  # mesh_scene keeps the Cornell walls and light


def scene_with(n_prims: int):
    """mesh_scene's walls and light plus n_prims - 6 blob triangles."""
    from computeraytracer.scene import presets, scene_from_dict

    k = n_prims - WALLS
    subdivisions = 0
    while 20 * 4 ** subdivisions < k:
        subdivisions += 1
    doc = presets.mesh_scene(W, H, subdivisions=subdivisions)
    mesh = doc["objects"]["meshes"][0]
    mesh["faces"] = mesh["faces"][:k]
    scene, _ = scene_from_dict(doc)
    assert int(scene.primitives.count) == n_prims
    return scene


def timed(fn, iters=3):
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return first, best


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel-prims", type=int, nargs="*",
                    default=[10, 26, 46])
    ap.add_argument("--xla-prims", type=int, nargs="*",
                    default=[26, 86, 166, 326])
    args = ap.parse_args(argv)

    import jax

    from computeraytracer.bvh import builder
    from computeraytracer.tracer import pallas as pallas_tracer
    from computeraytracer.tracer import xla as xla_tracer
    from computeraytracer.utils import compile_cache

    if jax.devices()[0].platform != "gpu":
        raise SystemExit("tracer_crossover: needs a GPU")
    compile_cache.enable()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]

    def emit(tracer, n, first, best):
        print(json.dumps({
            "tracer": tracer, "n_prims": n, "first_call_seconds": first,
            "seconds": best, "mpaths_per_s": W * H / best / 1e6,
            "width": W, "height": H, "spp": 1, "depth": DEPTH,
            "card": card}), flush=True)

    for n in args.kernel_prims:
        scene = scene_with(n)
        emit("triton", n, *timed(lambda: pallas_tracer.render_accumulate(
            scene, W, H, 1, DEPTH)))
    for n in args.xla_prims:
        scene = scene_with(n)
        bvh = builder.scene_bvh(scene)
        emit("xla_brute", n, *timed(lambda: xla_tracer.render_accumulate(
            scene, W, H, 1, DEPTH)))
        emit("xla_bvh", n, *timed(lambda: xla_tracer.render_accumulate(
            scene, W, H, 1, DEPTH, bvh=bvh)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
