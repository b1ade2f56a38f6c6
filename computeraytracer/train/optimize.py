"""Gradient-based scene optimization (BASELINE config 4).

The reference is forward-only; differentiability is a required new
capability (BASELINE.json north_star): pixel gradients flow to vertex
positions (primitives data1/2/3) and material parameters (spectra rows)
through the path tracer, with detached sampling (common random numbers).

A scene is split into (params, static); the loss renders the scene from
merged params and compares to a target in XYZ. Gradients are JAX AD of
the XLA tracer: kernel="triton" renders the forward in the Triton
megakernel, whose custom_vjp backward recomputes the XLA tracer
(tracer/pallas.py), so a step then costs the kernel's forward on top of
the XLA step. With a device mesh, rendering is sharded and jax.grad
transposes the forward psum into the parameter gradient all-reduce
automatically.
"""

from __future__ import annotations

from functools import partial
from typing import Iterable, Optional

import jax
import jax.numpy as jnp
import optax

from computeraytracer.bvh import builder as bvh_builder
from computeraytracer.parallel import render_sharded
from computeraytracer.tracer import xla as xla_tracer

# Leaves of Scene that may be trained.
GEOMETRY_LEAVES = ("data1", "data2", "data3")
TRAINABLE = ("spectra",) + GEOMETRY_LEAVES


def split_scene(scene, trainable: Iterable[str] = ("spectra",)):
    """Split a Scene into (params dict, static scene with zeroed params).

    trainable: subset of {"spectra", "data1", "data2", "data3"}.
    """
    trainable = tuple(trainable)
    params = {}
    for name in trainable:
        if name == "spectra":
            params[name] = scene.spectra
        elif name in GEOMETRY_LEAVES:
            params[name] = getattr(scene.primitives, name)
        else:
            raise ValueError(f"not trainable: {name}")
    return params, scene


def merge_scene(static_scene, params):
    """Re-insert trainable leaves into the scene pytree."""
    scene = static_scene
    if "spectra" in params:
        scene = scene._replace(spectra=params["spectra"])
    geom = {k: v for k, v in params.items() if k in GEOMETRY_LEAVES}
    if geom:
        scene = scene._replace(primitives=scene.primitives._replace(**geom))
    return scene


def render_mean_xyz(scene, width, height, spp, max_depth, rr_start=1,
                    first_sample=1, mesh=None, use_remat=True, bvh=None,
                    vis_grads: bool = False, kernel: str = "xla",
                    interpret: bool = False):
    """Mean XYZ over spp samples through the XLA tracer (bvh: the
    scene's BVHArrays, or None for the brute scan) or, with
    kernel="triton", the megakernel (interpret=True: the Pallas
    interpreter).

    vis_grads=True enables the warped-area visibility gradients
    (ops/warp.py): boundary-aware AD, primal bit-identical across
    vis_grads modes — but NOT to the vis_grads=False render (vis_grads
    disables pixel stratification; see tracer/xla.py:render_pixels)."""
    if kernel not in ("xla", "triton"):
        raise ValueError(f"unknown kernel {kernel!r}")
    if mesh is None:
        accum = jnp.zeros((height, width, 3), jnp.float32)
        if kernel == "triton":
            from computeraytracer.tracer import pallas as pallas_tracer
            static = pallas_tracer.SceneStatic.from_scene(scene)
            render_one = partial(pallas_tracer.render_sample,
                                 static=static, vis_grads=vis_grads,
                                 interpret=interpret)
        else:
            render_one = partial(xla_tracer.render_sample,
                                 use_remat=use_remat, bvh=bvh,
                                 vis_grads=vis_grads)

        def body(acc, s):
            return acc + render_one(scene, width, height, s, max_depth,
                                    rr_start), None

        samples = (jnp.asarray(first_sample, jnp.uint32)
                   + jnp.arange(spp, dtype=jnp.uint32))
        accum, _ = jax.lax.scan(body, accum, samples)
    else:
        accum = render_sharded.render_accumulate_sharded(
            scene, width, height, spp, mesh, max_depth, rr_start,
            first_sample, use_remat=use_remat, bvh=bvh, kernel=kernel,
            interpret=interpret)
    return accum / jnp.float32(spp)


def make_loss_fn(static_scene, width, height, spp, max_depth,
                 rr_start: int = 1, mesh=None, use_remat=True,
                 kernel: str = "xla", interpret: bool = False):
    """L2 loss in XYZ between the rendered mean and a target image.

    With the XLA tracer, mesh-size scenes (bvh.builder.BVH_MIN_PRIMS)
    trace through a BVH whose topology is built once from the initial
    geometry; every call refits its node boxes to the current (traced)
    vertices."""
    refit = None
    bvh0 = bvh_builder.auto_bvh(static_scene) if kernel == "xla" else None
    if bvh0 is not None:
        refit = bvh_builder.make_refit(bvh0)

    def loss_fn(params, target, first_sample):
        scene = merge_scene(static_scene, params)
        bvh = None
        if refit is not None:
            bvh = refit(jax.lax.stop_gradient(scene.primitives))
        img = render_mean_xyz(scene, width, height, spp, max_depth,
                              rr_start, first_sample, mesh, use_remat, bvh,
                              kernel=kernel, interpret=interpret)
        return jnp.mean((img - target) ** 2)

    return loss_fn


def make_train_step(static_scene, optimizer, width, height, spp, max_depth,
                    rr_start: int = 1, mesh=None, spectra_rows=None,
                    kernel: str = "xla", interpret: bool = False):
    """jitted (params, opt_state, target, first_sample) -> updated state.

    spectra_rows: optional sequence of spectra ROW indices to train;
    other rows are frozen (their updates zeroed). Restricting to the
    materials under optimization avoids the coupled-row drift of joint
    recovery: with every row free, unperturbed albedos absorb residual
    error along near-flat loss valleys (measured at 1024^2: the green
    row, never perturbed, drifted to 2.5x its own scale while the loss
    plateaued)."""
    loss_fn = make_loss_fn(static_scene, width, height, spp, max_depth,
                           rr_start, mesh, kernel=kernel,
                           interpret=interpret)
    row_mask = None
    if spectra_rows is not None:
        n_rows = static_scene.spectra.shape[0]
        row_mask = jnp.zeros((n_rows, 1), jnp.float32)
        for r in spectra_rows:
            row_mask = row_mask.at[int(r), 0].set(1.0)

    @jax.jit
    def step(params, opt_state, target, first_sample):
        loss, grads = jax.value_and_grad(loss_fn)(params, target,
                                                  first_sample)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        if row_mask is not None and "spectra" in updates:
            updates = dict(updates,
                           spectra=updates["spectra"] * row_mask)
        params = optax.apply_updates(params, updates)
        # projected step: spectra (reflectance/emission/extinction) are
        # physically nonnegative, and Adam's normalized step walks rows
        # with ~zero gradient (the extinction row, when nothing glass is
        # on screen) a full -lr per step regardless of gradient scale —
        # a NEGATIVE extinction makes Beer-Lambert exp(+sigma*t) blow up
        # within one step at scene-scale distances (measured: loss
        # 0.27 -> 4e22 in one 1024^2 config-4 step before this clamp)
        if "spectra" in params:
            params["spectra"] = jnp.maximum(params["spectra"], 0.0)
        return params, opt_state, loss

    return step


def optimize_config(scene, target, width, height, cfg,
                    trainable=("spectra",), mesh=None, callback=None):
    """Run `optimize` from a config.TrainConfig (the typed flag surface
    the CLI and scripts share; cfg.render supplies spp/max_depth/
    rr_start)."""
    return optimize(
        scene, target, width, height, trainable=trainable,
        steps=cfg.steps, learning_rate=cfg.learning_rate,
        spp=cfg.spp_per_step, max_depth=cfg.render.max_depth,
        rr_start=cfg.render.rr_start, mesh=mesh,
        checkpoint_dir=cfg.checkpoint_dir,
        checkpoint_every=cfg.checkpoint_every, callback=callback)


def optimize(scene, target, width, height, *, trainable=("spectra",),
             steps=50, learning_rate=0.05, spp=4, max_depth=4,
             rr_start: int = 1, mesh=None, checkpoint_dir: Optional[str] = None,
             checkpoint_every: int = 25, callback=None,
             fresh_samples: bool = False,
             lr_schedule: Optional[str] = None, spectra_rows=None,
             kernel: str = "xla", interpret: bool = False):
    """Run the material/geometry optimization loop (config 4).

    fresh_samples=False (default) uses the SAME sample set every step
    (common random numbers): the loss is a deterministic function of the
    parameters, so against a target rendered with the same seeds the MC
    noise cancels exactly. fresh_samples=True advances the sample
    counter every step (less bias from a single sample set, but the
    loss sequence carries MC noise). lr_schedule="cosine" decays the
    learning rate to ~0 over `steps` — a fixed Adam lr oscillates
    around the optimum at its step size (measured: the 1024^2 config-4
    recovery plateaus at loss ~0.02 with lr 0.06; the decay settles
    it). kernel and interpret as in render_mean_xyz. Returns (scene,
    losses).
    """
    params, static_scene = split_scene(scene, trainable)
    if lr_schedule == "cosine":
        optimizer = optax.adam(
            optax.cosine_decay_schedule(learning_rate, max(1, steps)))
    elif lr_schedule is None:
        optimizer = optax.adam(learning_rate)
    else:
        raise ValueError(f"unknown lr_schedule: {lr_schedule!r}")
    opt_state = optimizer.init(params)
    step_fn = make_train_step(static_scene, optimizer, width, height, spp,
                              max_depth, rr_start, mesh,
                              spectra_rows=spectra_rows, kernel=kernel,
                              interpret=interpret)
    losses = []
    ckpt = None
    if checkpoint_dir is not None:
        from computeraytracer.train import checkpoint as ckpt_mod
        ckpt = ckpt_mod.Checkpointer(checkpoint_dir)
        restored = ckpt.restore_latest(params, opt_state)
        if restored is not None:
            params, opt_state, start_step = restored
        else:
            start_step = 0
    else:
        start_step = 0

    for i in range(start_step, steps):
        first_sample = jnp.uint32(1 + i * spp if fresh_samples else 1)
        params, opt_state, loss = step_fn(params, opt_state, target,
                                          first_sample)
        losses.append(float(loss))
        if callback is not None:
            callback(i, float(loss), params)
        if ckpt is not None and (i + 1) % checkpoint_every == 0:
            ckpt.save(i + 1, params, opt_state)
    if ckpt is not None:
        ckpt.save(steps, params, opt_state)
    return merge_scene(static_scene, params), losses
