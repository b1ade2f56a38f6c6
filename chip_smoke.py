#!/usr/bin/env python
"""On-card smoke test: the renderer and the trainer end to end on a GPU.

    python chip_smoke.py            # one card
    python chip_smoke.py --multi    # the sharded path over four cards

Runs the main path through the entry points a user calls, at full size
(Cornell box 1024x1024, depth 8; the 82K-triangle mesh scene), checks
the results and prints one JSON line per phase with its seconds,
Mpaths/s, peak device memory and the card's name and power limit:

  gate       a GPU is present (exits nonzero otherwise, before anything
             else is imported)
  render     `python -m computeraytracer render` with the default
             tracer choice (the XLA tracer at this size) and with
             --kernel triton, 1024^2, 64 spp, depth 8, end to end with
             compilation: finite, and the Cornell layout (red wall left,
             green wall right, light at the top)
  train      make_train_step, 1024^2, depth 8, 4 spp/step, gradients
             w.r.t. spectra and vertices: finite, loss falls; plus the
             `train` CLI
  cpu_parity the same programs on the card and on the CPU backend at
             128^2: image and spectra gradient agree
  kernel     the Triton megakernel against the XLA tracer at 1024^2
             depth 8: parity and both timings
  mesh       mesh_scene(subdivisions=6) through render() (BVH) and one
             vertex+spectra training step (refit BVH)
  watertight the closed-surface leak checks of tests/test_watertight.py
             on the card, through every intersector that runs there

--multi runs only the sharded render on (4,1) and (2,2) meshes through
both tracers and one sharded training step, each against the
single-card result.

The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
Any failed check raises, so the script exits nonzero and prints no
such line.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
W = H = 1024
DEPTH = 8
PARITY_SIDE = 128
MESH_SUBDIVISIONS = 6  # 81,920 triangles


def require_gpu():
    """The first JAX device, which must be a GPU; else SystemExit(1)."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (first device: "
              f"{dev.platform}); nothing to check", file=sys.stderr)
        raise SystemExit(1)
    return dev


def card_info() -> str:
    """`name, power.limit` of the card as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class Phases:
    """Times each phase and prints its JSON line."""

    def __init__(self, card: str):
        self.card = card

    def emit(self, phase: str, seconds: float, paths: int = 0, **checks):
        import jax

        stats = jax.devices()[0].memory_stats() or {}
        rec = {"phase": phase, "seconds": seconds,
               "mpaths_per_s": paths / seconds / 1e6 if paths else None,
               "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
               "card": self.card, **checks}
        print(json.dumps(rec), flush=True)


def _timed(fn, iters=3):
    """(first result, compile+first-run seconds, best steady seconds)."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return out, first, best


def _check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def _match_fraction(got, want, tol):
    import numpy as np

    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-2)
    return float((rel < tol).all(axis=-1).mean())


# Two programs that round differently (another backend, another tracer)
# agree on almost every path, but a Russian-roulette, light-choice or
# Fresnel draw within rounding of its threshold sends a path elsewhere
# (3.5e-4 of paths, Triton vs XLA at 1024^2 on the card). A pixel of
# spp samples matches to 1e-3 relative unless one of its paths flipped,
# so the bound allows 1e-3 flipped paths: at least 1 - spp * 1e-3 of the
# pixels match. An error in a branch that many paths take moves far
# more pixels than that and fails the bound. The image means agree to
# 1e-2: one flipped path through the glass can carry ~100x a pixel's
# mean, so at 128^2 x 4 spp the means of two correct programs differ by
# ~2e-3.
PATH_FLIP_RATE = 1e-3


def _check_image_parity(name, got, want, spp):
    import numpy as np

    frac = _match_fraction(got, want, 1e-3)
    mean_rel = float(abs(got.mean() - want.mean()) / abs(want.mean()))
    _check(np.isfinite(got).all(), f"{name}: non-finite image")
    _check(frac >= 1.0 - spp * PATH_FLIP_RATE and mean_rel < 1e-2,
           f"{name}: {frac} of pixels match, mean rel diff {mean_rel}")
    return {"frac_pixels_1e_3": frac, "mean_rel_diff": mean_rel}


def check_cornell_layout(srgb):
    """Red wall on the left, green wall on the right, light at the top
    (the camera basis mirrors world-x, as in the real Cornell box)."""
    import numpy as np

    img = np.asarray(srgb, np.float64)
    h, w, _ = img.shape
    mid = slice(h // 3, 2 * h // 3)
    left = img[mid, : w // 16].mean(axis=(0, 1))
    right = img[mid, -w // 16:].mean(axis=(0, 1))
    top = img[: h // 5, w // 4: 3 * w // 4].mean(axis=-1).max()
    _check(left[0] > max(left[1], left[2]), f"left wall not red: {left}")
    _check(right[1] > max(right[0], right[2]),
           f"right wall not green: {right}")
    _check(top > 2 * img.mean(), f"no bright light at the top: {top}")


def phase_render(ph, out_dir):
    import numpy as np

    from computeraytracer import cli
    from computeraytracer.scene import presets, scene_from_dict
    from computeraytracer.tracer import api
    from computeraytracer.utils.image import read_png

    scene, _ = scene_from_dict(presets.cornell_box(W, H))
    for flag in ("auto", "triton"):
        kernel = api.resolve_kernel(scene, flag, W * H * 64)
        png = os.path.join(out_dir, f"cornell_1024_{kernel}.png")
        t0 = time.perf_counter()
        rc = cli.main(["render", "--preset", "cornell_box", "--width",
                       str(W), "--height", str(H), "--spp", "64", "--depth",
                       str(DEPTH), "--kernel", flag, "--out", png])
        seconds = time.perf_counter() - t0
        _check(rc == 0, f"render CLI ({kernel}) returned {rc}")
        img = read_png(png)
        _check(img.shape == (H, W, 3), f"PNG shape {img.shape}")
        check_cornell_layout(img.astype(np.float64) / 255.0)
        ph.emit("render", seconds, W * H * 64, flag=flag, kernel=kernel,
                png=png, spp=64, depth=DEPTH,
                note="seconds: the whole CLI call, compilation included")


def _train_setup(scene, w, h, spp, trainable, perturb_row=2):
    """(step, params, opt_state, target) for a perturbed-spectra
    recovery: the target is the unperturbed render.

    Only the perturbed spectra row trains (make_train_step's
    spectra_rows), with Adam. Geometry takes plain gradient steps, and
    rows 1 and 2 of the presets used here — the ceiling and the area
    light, which lie in one plane and show the light only through the
    last-wins tie rule — stay put: any move of either, however small,
    hides the light or lifts it off the ceiling, a jump the gradient
    does not see (a 2e-4 move took the 1024^2 loss from 4e-4 to 2.15 on
    the card)."""
    import jax.numpy as jnp
    import optax

    from computeraytracer.bvh import builder
    from computeraytracer.train import optimize as opt

    target = opt.render_mean_xyz(scene, w, h, spp, DEPTH,
                                 bvh=builder.auto_bvh(scene))
    perturbed = scene._replace(
        spectra=jnp.asarray(scene.spectra).at[perturb_row].mul(0.5))
    params, static = opt.split_scene(perturbed, trainable)
    labels = {k: "spectra" if k == "spectra" else "geometry" for k in params}
    tie = jnp.asarray([1, 2])

    def hold_tie(updates, params=None):
        return {k: u if k == "spectra" else u.at[tie].set(0.0)
                for k, u in updates.items()}

    optimizer = optax.chain(
        optax.multi_transform({"spectra": optax.adam(0.01),
                               "geometry": optax.sgd(10.0)}, labels),
        optax.stateless(hold_tie))
    step = opt.make_train_step(static, optimizer, w, h, spp, DEPTH,
                               spectra_rows=(perturb_row,))
    return step, params, optimizer.init(params), target


def phase_train(ph):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from computeraytracer import cli
    from computeraytracer.scene import presets, scene_from_dict

    spp = 4
    scene, _ = scene_from_dict(presets.cornell_box(W, H))
    step, params, opt_state, target = _train_setup(
        scene, W, H, spp, ("spectra", "data1"))
    losses = []
    t0 = time.perf_counter()
    params, opt_state, loss = jax.block_until_ready(
        step(params, opt_state, target, jnp.uint32(1)))
    compile_s = time.perf_counter() - t0
    losses.append(float(loss))
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        params, opt_state, loss = jax.block_until_ready(
            step(params, opt_state, target, jnp.uint32(1)))
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    _check(np.isfinite(losses).all(), f"non-finite loss {losses}")
    _check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    _check(all(np.isfinite(np.asarray(v)).all() for v in params.values()),
           "non-finite parameters")
    ph.emit("train", min(times), W * H * spp, losses=losses,
            first_step_seconds=compile_s, spp=spp, depth=DEPTH,
            note="seconds: best steady step (fwd+bwd+Adam)")

    t0 = time.perf_counter()
    rc = cli.main(["train", "--preset", "cornell_box", "--steps", "4",
                   "--spp", "4", "--depth", str(DEPTH), "--max-side",
                   str(PARITY_SIDE)])
    _check(rc == 0, f"train CLI returned {rc} (loss did not fall)")
    ph.emit("train_cli", time.perf_counter() - t0,
            size=PARITY_SIDE, note="seconds include compilation")


def phase_cpu_parity(ph):
    """The same programs on the card and on the CPU backend.

    Tolerance: the backends round differently (FMA contraction,
    transcendental implementations, reduction order), so images are held
    to the path-flip bound of _check_image_parity; the spectra gradient,
    a sum over all pixels, agrees to 1e-2 in relative L2 norm. Every f32
    contraction on the path runs at Precision.HIGHEST, so TF32 is not
    among the differences.
    """
    import jax
    import jax.numpy as jnp
    import numpy as np

    from computeraytracer.scene import presets, scene_from_dict
    from computeraytracer.tracer import api
    from computeraytracer.train import optimize as opt

    side, spp = PARITY_SIDE, 4
    scene, _ = scene_from_dict(presets.cornell_box(side, side))
    cpu = jax.devices("cpu")[0]
    gpu = jax.devices()[0]

    def on(dev, fn):
        with jax.default_device(dev):
            return np.asarray(jax.block_until_ready(
                fn(jax.device_put(scene, dev))))

    img = lambda kernel: (lambda s: api.render(
        s, width=side, height=side, spp=spp, max_depth=DEPTH,
        kernel=kernel)["mean_xyz"])
    t0 = time.perf_counter()
    want = on(cpu, img("xla"))
    results = {}
    for kernel in ("xla", "triton"):
        results[kernel] = _check_image_parity(
            f"{kernel} on the card vs CPU", on(gpu, img(kernel)), want, spp)

    target = jnp.zeros((side, side, 3), jnp.float32)

    def grad(s):
        params, static = opt.split_scene(s, ("spectra",))
        loss = opt.make_loss_fn(static, side, side, spp, DEPTH)
        return jax.grad(loss)(params, target, jnp.uint32(1))["spectra"]

    g_cpu = on(cpu, grad)
    g_gpu = on(gpu, grad)
    g_rel = float(np.linalg.norm(g_gpu - g_cpu) / np.linalg.norm(g_cpu))
    _check(np.isfinite(g_gpu).all() and g_rel < 1e-2,
           f"spectra gradient card vs CPU: relative L2 {g_rel}")
    ph.emit("cpu_parity", time.perf_counter() - t0, size=side, spp=spp,
            image=results, spectra_grad_rel_l2=g_rel,
            note="seconds include compilation on both backends")


def phase_kernel(ph):
    """Triton megakernel vs the XLA tracer, forward, at full size;
    images held to the path-flip bound of _check_image_parity."""
    import jax
    import numpy as np

    from computeraytracer.scene import presets, scene_from_dict
    from computeraytracer.tracer import pallas as pallas_tracer
    from computeraytracer.tracer import xla as xla_tracer
    from computeraytracer.utils import profiling

    # the render phase's spp: the kernel program is already compiled
    spp = 64
    scene, _ = scene_from_dict(presets.cornell_box(W, H))
    x_img, x_first, x_s = _timed(
        lambda: xla_tracer.render_accumulate(scene, W, H, spp, DEPTH))
    t_img, t_first, t_s = _timed(
        lambda: pallas_tracer.render_accumulate(scene, W, H, spp, DEPTH))
    parity = _check_image_parity("kernel vs XLA", np.asarray(t_img),
                                 np.asarray(x_img), spp)
    paths = W * H * spp
    kind = jax.devices()[0].device_kind
    if kind in profiling.DEVICE_PEAKS:
        # share of the analytic f32 roofline (utils/profiling.py) at the
        # measured mean path length
        md = profiling.measure_mean_depth(scene, 256, 256, max_depth=DEPTH)
        rl = profiling.roofline(W, H, spp, DEPTH, int(scene.primitives.count),
                                profiling.DEVICE_PEAKS[kind], mean_depth=md)
        roof = {"mean_depth": md, "roofline_bound": rl.bound,
                "triton_roofline_share": rl.fraction(t_s),
                "xla_roofline_share": rl.fraction(x_s)}
    else:
        roof = {"roofline": f"no published peaks for {kind!r}"}
    ph.emit("kernel", t_s, paths, xla_seconds=x_s,
            xla_mpaths_per_s=paths / x_s / 1e6, triton_seconds=t_s,
            speedup=x_s / t_s, **parity, xla_first_call_seconds=x_first,
            triton_first_call_seconds=t_first, spp=spp, depth=DEPTH,
            **roof)


def phase_mesh(ph):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from computeraytracer.scene import presets, scene_from_dict
    from computeraytracer.tracer import api

    scene, _ = scene_from_dict(presets.mesh_scene(
        W, H, subdivisions=MESH_SUBDIVISIONS))
    n_prims = int(scene.primitives.count)
    out, first, best = _timed(lambda: api.render(
        scene, width=W, height=H, spp=1, max_depth=DEPTH)["accum_xyz"],
        iters=1)
    _check(np.isfinite(np.asarray(out)).all(), "non-finite mesh render")
    _check(float(np.asarray(out).mean()) > 0, "black mesh render")
    ph.emit("mesh_render", best, W * H, n_prims=n_prims, spp=1,
            first_call_seconds=first, kernel="xla")

    trainable = ("spectra", "data1", "data2", "data3")
    step, params, opt_state, target = _train_setup(scene, W, H, 1,
                                                   trainable)
    t0 = time.perf_counter()
    new, opt_state, loss = jax.block_until_ready(
        step(params, opt_state, target, jnp.uint32(1)))
    seconds = time.perf_counter() - t0
    moved = float(jnp.abs(new["data1"][6:] - params["data1"][6:]).max())
    _check(np.isfinite(float(loss)), f"non-finite mesh loss {loss}")
    _check(all(np.isfinite(np.asarray(v)).all() for v in new.values()),
           "non-finite mesh parameters")
    _check(moved > 0, "mesh vertices received no update")
    ph.emit("mesh_train", seconds, W * H, n_prims=n_prims, spp=1,
            loss=float(loss), max_vertex_move=moved,
            note="seconds include compilation")


def phase_watertight(ph):
    path = os.path.join(ROOT, "tests", "test_watertight.py")
    spec = importlib.util.spec_from_file_location("watertight_checks", path)
    checks = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(checks)
    t0 = time.perf_counter()
    res = {}
    for name, fn in (("xla_brute", checks.leaks_brute),
                     ("xla_bvh", checks.leaks_bvh),
                     ("triton", lambda: checks.leaks_megakernel(False))):
        leaked, n = fn()
        res[name] = {"leaked": leaked, "rays": n}
        _check(leaked == 0, f"{name}: {leaked}/{n} edge rays leaked")
    ph.emit("watertight", time.perf_counter() - t0, checks=res)


def phase_multi(ph):
    """Sharded render on (4,1) and (2,2) meshes through both tracers, and
    one sharded training step, against the single-card XLA results with
    the same seeds.

    Tolerance: shards fuse differently from the single-card program, and
    the megakernel rounds differently from XLA, so a rare
    Russian-roulette decision can flip (parallel/render_sharded.py
    docstring): images are held to the path-flip bound of
    _check_image_parity, gradients to 1e-2 in relative L2 norm."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from computeraytracer.parallel import mesh as mesh_mod
    from computeraytracer.parallel import render_sharded
    from computeraytracer.scene import presets, scene_from_dict
    from computeraytracer.tracer import xla as xla_tracer
    from computeraytracer.train import optimize as opt

    devs = jax.devices()
    _check(len(devs) == 4, f"--multi needs 4 cards, found {len(devs)}")
    spp = 4
    scene, _ = scene_from_dict(presets.cornell_box(W, H))
    single = np.asarray(xla_tracer.render_accumulate(scene, W, H, spp,
                                                     DEPTH))
    # the kernel on one mesh: each mesh shape is another per-card ray
    # count, and so another minute of kernel compilation
    for kernel, shape in (("xla", (4, 1)), ("xla", (2, 2)),
                          ("triton", (4, 1))):
        mesh = mesh_mod.make_mesh(devs, shape)
        out, first, best = _timed(lambda: render_sharded.
                                  render_accumulate_sharded(
                                      scene, W, H, spp, mesh, DEPTH,
                                      kernel=kernel),
                                  iters=2)
        parity = _check_image_parity(f"mesh {shape}", np.asarray(out),
                                     single, spp)
        ph.emit("multi_render", best, W * H * spp, mesh=list(shape),
                kernel=kernel, **parity, first_call_seconds=first)

    mesh = mesh_mod.make_mesh(devs, (2, 2))
    target = jnp.zeros((H, W, 3), jnp.float32)
    params, static = opt.split_scene(scene, ("spectra", "data1"))
    grads = {}
    for name, m in (("single", None), ("sharded", mesh)):
        loss_fn = opt.make_loss_fn(static, W, H, spp, DEPTH, mesh=m)
        grads[name] = jax.jit(jax.grad(loss_fn))(params, target,
                                                 jnp.uint32(1))
    rel = {k: float(np.linalg.norm(np.asarray(grads["sharded"][k])
                                   - np.asarray(grads["single"][k]))
                    / np.linalg.norm(np.asarray(grads["single"][k])))
           for k in params}
    _check(all(v < 1e-2 for v in rel.values()), f"gradients differ {rel}")
    optimizer = optax.adam(0.05)
    step = opt.make_train_step(static, optimizer, W, H, spp, DEPTH,
                               mesh=mesh)
    t0 = time.perf_counter()
    _, _, loss = jax.block_until_ready(
        step(params, optimizer.init(params), target, jnp.uint32(1)))
    _check(np.isfinite(float(loss)), f"non-finite sharded loss {loss}")
    ph.emit("multi_train", time.perf_counter() - t0, W * H * spp,
            mesh=[2, 2], grad_rel_l2=rel, loss=float(loss),
            note="seconds include compilation")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the sharded path over four cards")
    ap.add_argument("--out-dir", default=os.path.join(ROOT, "chiprun_out",
                                                      "smoke"))
    args = ap.parse_args(argv)

    t0 = time.perf_counter()
    dev = require_gpu()
    card = card_info()
    print(card, flush=True)
    sys.path.insert(0, ROOT)
    from computeraytracer.utils import compile_cache

    compile_cache.enable()
    os.makedirs(args.out_dir, exist_ok=True)
    ph = Phases(card)
    ph.emit("gate", time.perf_counter() - t0, platform=dev.platform,
            kind=dev.device_kind)
    if args.multi:
        phase_multi(ph)
    else:
        phase_render(ph, args.out_dir)
        phase_train(ph)
        phase_cpu_parity(ph)
        phase_kernel(ph)
        phase_mesh(ph)
        phase_watertight(ph)
    import jax

    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
