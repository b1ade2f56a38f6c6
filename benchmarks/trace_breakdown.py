#!/usr/bin/env python
"""Capture a profiler trace of one render and print the top device ops.

The quick answer to "where does device time go" without TensorBoard:
runs a few warmed iterations under jax.profiler.trace
(utils/profiling.py) and sums the device planes' event durations from
the trace's .xplane.pb.

    python benchmarks/trace_breakdown.py --size 1024 --depth 8 --grad
"""

from __future__ import annotations

import argparse
import collections
import glob
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def summarize(logdir: str, top: int = 25) -> None:
    import jax

    paths = sorted(glob.glob(
        os.path.join(logdir, "plugins/profile/*/*.xplane.pb")))
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {logdir}")
    data = jax.profiler.ProfileData.from_file(paths[-1])
    dur = collections.Counter()
    for plane in data.planes:
        if not plane.name.startswith("/device:"):
            continue  # host threads: not device cost
        for line in plane.lines:
            for e in line.events:
                dur[e.name] += e.duration_ns
    total = sum(dur.values())
    print(f"device total: {total / 1e6:.2f} ms (all iterations, all "
          "device lines)")
    for name, d in dur.most_common(top):
        print(f"{d / 1e6:10.2f} ms  {100 * d / total:5.1f}%  {name[:100]}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--grad", action="store_true",
                    help="trace value_and_grad instead of forward")
    ap.add_argument("--kernel", choices=["xla", "triton"], default="xla",
                    help="forward tracer")
    ap.add_argument("--mesh", type=int, default=0, metavar="SUB",
                    help="trace the mesh scene (subdivisions=SUB)")
    ap.add_argument("--logdir", default=None)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from computeraytracer.bvh import builder
    from computeraytracer.scene import presets, scene_from_dict
    from computeraytracer.tracer import api
    from computeraytracer.utils import compile_cache, profiling

    compile_cache.enable()
    W = H = args.size
    if args.mesh:
        scene, _ = scene_from_dict(
            presets.mesh_scene(W, H, subdivisions=args.mesh))
    else:
        scene, _ = scene_from_dict(presets.cornell_box(W, H))
    bvh = builder.auto_bvh(scene)

    def image(s):
        return api.render_sample(s, W, H, 1, max_depth=args.depth,
                                 kernel=args.kernel, bvh=bvh)

    if args.grad:
        g = jax.jit(jax.value_and_grad(
            lambda sp: jnp.mean(image(scene._replace(spectra=sp)) ** 2)))
        spectra = jnp.asarray(scene.spectra)
        run = lambda: jax.block_until_ready(g(spectra))
    else:
        f = jax.jit(lambda s: image(s).sum())
        run = lambda: jax.block_until_ready(f(scene))

    run(), run()  # compile + warm
    logdir = args.logdir or tempfile.mkdtemp(prefix="crt_trace_")
    with profiling.trace(logdir):
        for _ in range(args.iters):
            run()
    print(f"trace: {logdir}")
    summarize(logdir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
