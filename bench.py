#!/usr/bin/env python
"""Headline benchmark: Cornell-box spectral path tracing on one device.

Prints ONE JSON line:
  {"metric": "xla_fwdbwd_mpaths_per_s", "value": N, "unit": "Mpaths/s",
   "tracer": "xla", "device": {"platform": ..., "kind": ..., "count": N},
   ...}

- Default: value_and_grad of an image loss w.r.t. spectra and vertex
  data (the trainer's step) at 1024x1024, max_depth=8, through the XLA
  tracer — the BASELINE.json north-star workload. One "path" = one
  camera sample. Each timed dispatch scans --spp samples (default 4),
  the way the training loop batches them.
- --forward: the forward render only; --kernel triton measures the
  forward megakernel instead of the XLA tracer.
- --mesh: the ~82K-triangle mesh scene (BASELINE config 3) through the
  BVH.

Times are the best of --iters runs after a compile run, each ending in
block_until_ready. A run with no accelerator is refused.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _time(fn, iters: int = 3) -> float:
    import jax

    jax.block_until_ready(fn())  # compile
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--spp", type=int, default=4,
                    help="samples per timed dispatch (lax.scan)")
    ap.add_argument("--forward", action="store_true",
                    help="forward render instead of fwd+bwd")
    ap.add_argument("--kernel", choices=["xla", "triton"], default="xla",
                    help="forward tracer (triton implies --forward)")
    ap.add_argument("--mesh", action="store_true",
                    help="~82K-tri mesh scene through the BVH instead of "
                    "the Cornell box")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from computeraytracer.bvh import builder
    from computeraytracer.scene import presets, scene_from_dict
    from computeraytracer.tracer import xla as xla_tracer
    from computeraytracer.utils import compile_cache

    compile_cache.enable()
    dev = jax.devices()[0]
    if dev.platform == "cpu":
        print("bench.py measures an accelerator; JAX found only the CPU",
              file=sys.stderr)
        return 2

    w = h = args.size
    doc = (presets.mesh_scene(w, h, subdivisions=6) if args.mesh
           else presets.cornell_box(w, h))
    scene, _ = scene_from_dict(doc)
    bvh = builder.auto_bvh(scene)
    spp = args.spp
    paths = w * h * spp
    forward = args.forward or args.kernel == "triton"

    if args.kernel == "triton":
        from computeraytracer.tracer import pallas as tracer_mod
        render = tracer_mod.render_sample
    else:
        def render(s, *a, **kw):
            return xla_tracer.render_sample(s, *a, bvh=bvh, **kw)

    def accumulate(s):
        def body(acc, k):
            return acc + render(s, w, h, k, max_depth=args.depth), None

        img, _ = jax.lax.scan(body, jnp.zeros((h, w, 3), jnp.float32),
                              jnp.arange(1, spp + 1, dtype=jnp.uint32))
        return img / spp

    if forward:
        fn = jax.jit(accumulate)
        seconds = _time(lambda: fn(scene), args.iters)
    else:
        def loss(spectra, d1):
            s = scene._replace(
                spectra=spectra,
                primitives=scene.primitives._replace(data1=d1))
            return jnp.mean(accumulate(s) ** 2)

        g = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))
        spectra = jnp.asarray(scene.spectra)
        d1 = jnp.asarray(scene.primitives.data1)
        seconds = _time(lambda: g(spectra, d1), args.iters)

    print(json.dumps({
        "metric": f"{args.kernel}_{'fwd' if forward else 'fwdbwd'}"
                  f"{'_mesh' if args.mesh else ''}_mpaths_per_s",
        "value": paths / seconds / 1e6,
        "unit": "Mpaths/s",
        "tracer": args.kernel,
        "seconds": seconds,
        "size": w, "depth": args.depth, "spp": spp,
        "n_prims": int(scene.primitives.count),
        "bvh": bvh is not None,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
