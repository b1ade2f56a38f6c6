"""Command-line entry points: render / train / info.

The reference's user interface is "edit the scene JSON, reload the
browser page" (SURVEY.md §1 L1); here it is a CLI over the same JSON
schema:

    python -m computeraytracer render --preset cornell_box --spp 16 \
        --out cornell.png
    python -m computeraytracer render --scene my_scene.json \
        --spp 64 --out out.png
    python -m computeraytracer train --preset cornell_box --steps 50
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _load(args):
    from computeraytracer.scene import load_scene, presets, scene_from_dict

    if args.scene:
        scene, meta = load_scene(args.scene, getattr(args, "cie", None))
    else:
        w = args.width or 256
        h = args.height or 256
        doc = getattr(presets, args.preset)(w, h)
        scene, meta = scene_from_dict(doc)
    w = args.width or meta["width"]
    h = args.height or meta["height"]
    return scene, w, h


def cmd_render(args) -> int:
    import jax
    import numpy as np

    from computeraytracer.bvh import builder
    from computeraytracer.ops import color
    from computeraytracer.utils.image import write_png
    from computeraytracer.utils.metrics import RenderMeter

    from computeraytracer.tracer import api

    scene, w, h = _load(args)
    args.kernel = api.resolve_kernel(scene, args.kernel, w * h * args.spp)
    print(f"tracer: {args.kernel}", file=sys.stderr)
    bvh = None
    if args.kernel == "xla":
        t0 = time.perf_counter()
        bvh = builder.auto_bvh(scene)
        if bvh is not None:
            print(f"BVH: {bvh.n_nodes} nodes "
                  f"({time.perf_counter() - t0:.2f}s)", file=sys.stderr)
    if args.sharded:
        from computeraytracer.parallel import mesh as mesh_mod
        from computeraytracer.parallel import render_sharded
        mesh = mesh_mod.make_mesh()

        def accumulate(*a, **kw):
            return render_sharded.render_accumulate_sharded(
                *a, mesh=mesh, bvh=bvh, kernel=args.kernel, **kw)
    elif args.kernel == "triton":
        from computeraytracer.tracer import pallas as tracer_mod
        accumulate = tracer_mod.render_accumulate
    else:
        from computeraytracer.tracer import xla as tracer_mod

        def accumulate(*a, **kw):
            return tracer_mod.render_accumulate(*a, bvh=bvh, **kw)

    profile_cm = None
    if args.profile:
        from computeraytracer.utils import profiling
        profile_cm = profiling.trace(args.profile)
        profile_cm.__enter__()
        print(f"tracing to {args.profile} (view: tensorboard --logdir)",
              file=sys.stderr)

    meter = RenderMeter(jsonl_path=args.metrics)
    meter.start()
    if args.progressive:
        # the reference's defining behavior is live progressive
        # refinement: 1 spp per animation frame into a never-cleared
        # accumulator, blitted every frame (main.js:584-623). The CLI
        # analogue renders in --progressive N sample chunks, rewriting
        # --out from the running accumulator after each chunk — the
        # image sharpens in place while total spp climbs. Counter-based
        # seeding makes the chunked accumulation bit-identical to one
        # --spp shot (tests/test_utils_cli.py pins it).
        accum = None
        done = 0
        while done < args.spp:
            n = min(args.progressive, args.spp - done)
            part = jax.block_until_ready(accumulate(
                scene, w, h, spp=n, max_depth=args.depth,
                first_sample=done + 1))
            accum = part if accum is None else accum + part
            done += n
            mean = np.asarray(accum) / done
            srgb = np.asarray(color.xyz_to_srgb(mean, args.exposure))
            write_png(args.out, srgb)
            print(f"progressive: {done}/{args.spp} spp -> {args.out}",
                  file=sys.stderr)
    else:
        accum = accumulate(scene, w, h, spp=args.spp, max_depth=args.depth)
    accum = jax.block_until_ready(accum)
    if profile_cm is not None:
        profile_cm.__exit__(None, None, None)
    rec = meter.stop(paths=w * h * args.spp, width=w, height=h,
                     spp=args.spp, kernel=args.kernel)
    print(json.dumps(rec), file=sys.stderr)

    mean = np.asarray(accum) / args.spp
    srgb = np.asarray(color.xyz_to_srgb(mean, args.exposure))
    write_png(args.out, srgb)
    print(f"wrote {args.out} ({w}x{h}, {args.spp} spp, "
          f"{rec['mpaths_per_s']} Mpaths/s)")
    return 0


def cmd_train(args) -> int:
    import jax.numpy as jnp
    import numpy as np

    from computeraytracer.bvh import builder
    from computeraytracer.train import optimize as opt

    scene, w, h = _load(args)
    w, h = min(w, args.max_side), min(h, args.max_side)
    print(f"rendering target at {w}x{h} spp={args.spp} ...", file=sys.stderr)
    target = opt.render_mean_xyz(scene, w, h, spp=args.spp,
                                 max_depth=args.depth,
                                 bvh=builder.auto_bvh(scene))
    # Demo inverse problem: dim one albedo spectrum, recover it. Only
    # that row trains: Adam moves every element by ~lr whatever its
    # gradient, and a step of that size in the extinction row changes
    # the glass transmission several-fold.
    perturbed = scene._replace(
        spectra=jnp.asarray(scene.spectra).at[args.perturb_row].mul(0.3))
    _, losses = opt.optimize(
        perturbed, target, w, h, trainable=tuple(args.trainable),
        steps=args.steps, learning_rate=args.lr, spp=args.spp,
        max_depth=args.depth, checkpoint_dir=args.checkpoint_dir,
        spectra_rows=(args.perturb_row,),
        callback=lambda i, loss, p: print(
            f"step {i:4d}  loss {loss:.6e}", file=sys.stderr))
    print(json.dumps({"initial_loss": losses[0], "final_loss": losses[-1],
                      "steps": len(losses)}))
    return 0 if losses[-1] < losses[0] else 1


def cmd_info(args) -> int:
    import numpy as np

    scene, w, h = _load(args)
    p = scene.primitives
    cats = np.asarray(p.category)
    print(json.dumps({
        "resolution": [w, h],
        "primitives": int(cats.shape[0]),
        "patches": int((cats == 0).sum()),
        "spheres": int((cats == 1).sum()),
        "triangles": int((cats == 2).sum()),
        "lights": int(np.asarray(scene.lights.prim_index).shape[0]),
        "spectra": int(np.asarray(scene.spectra).shape[0]),
    }, indent=2))
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="computeraytracer")
    sub = ap.add_subparsers(dest="command", required=True)

    def common(p):
        p.add_argument("--scene", help="scene JSON (reference schema)")
        p.add_argument("--cie", help="CIE.json (reference schema)")
        p.add_argument("--preset", default="cornell_box",
                       help="preset name when --scene absent")
        p.add_argument("--width", type=int)
        p.add_argument("--height", type=int)
        p.add_argument("--spp", type=int, default=16)
        p.add_argument("--depth", type=int, default=8)

    r = sub.add_parser("render", help="render a scene to PNG")
    common(r)
    r.add_argument("--out", default="out.png")
    r.add_argument("--kernel", choices=["auto", "xla", "triton"],
                   default="auto",
                   help="xla: the XLA tracer (large scenes through the "
                   "BVH); triton: the forward megakernel (GPU only, small "
                   "scenes; ~25x faster once compiled, but its compile "
                   "takes about a minute); auto: triton on a GPU when the "
                   "scene is small and the render long enough to pay for "
                   "the compile")
    r.add_argument("--sharded", action="store_true",
                   help="shard film rows and samples over all visible "
                   "devices (parallel/render_sharded.py), with either tracer")
    r.add_argument("--exposure", type=float, default=2.2)
    r.add_argument("--progressive", type=int, default=0, metavar="N",
                   help="rewrite --out every N samples from the running "
                   "accumulator (the reference's rAF refinement loop)")
    r.add_argument("--metrics", help="append metrics JSONL here")
    r.add_argument("--profile", help="capture an XProf trace to this dir")
    r.set_defaults(fn=cmd_render)

    t = sub.add_parser("train", help="gradient-based scene optimization")
    common(t)
    t.add_argument("--steps", type=int, default=30)
    t.add_argument("--lr", type=float, default=0.05)
    t.add_argument("--trainable", nargs="+", default=["spectra"])
    t.add_argument("--perturb-row", type=int, default=2)
    t.add_argument("--max-side", type=int, default=128)
    t.add_argument("--checkpoint-dir")
    t.set_defaults(fn=cmd_train)

    i = sub.add_parser("info", help="print scene summary")
    common(i)
    i.set_defaults(fn=cmd_info)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)
