"""Sharded rendering: film rows over 'dp', samples over 'sp'.

Replaces the reference's single-device dispatch grid
(reference/src/main.js:606-610): shard_map over a (dp, sp) mesh
with the scene replicated on every device. Each device renders its own
film-row tile for its own slice of the sample set, through the XLA
tracer or the Triton megakernel; the only forward collective is the
psum of XYZ accumulators over the sample axis. Seeds derive from global
pixel coordinates, so the sharded render consumes exactly the same
sample set as a single-device render (equal up to f32 rounding: XLA
fuses differently per shard shape, which can flip rare Russian-roulette
decisions).

Everything here is differentiable: jax.grad through shard_map transposes
the psum automatically, producing the gradient all-reduce of SURVEY.md
§2.4 without hand-written communication.
"""

from __future__ import annotations

import functools
from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax import shard_map

from computeraytracer.parallel.mesh import DP_AXIS, SP_AXIS
from computeraytracer.tracer import xla as xla_tracer


def render_accumulate_sharded(scene, width: int, height: int, spp: int,
                              mesh, max_depth: int = 8, rr_start: int = 1,
                              first_sample: int = 1, use_remat: bool = True,
                              bvh=None, kernel: str = "xla",
                              interpret: bool = False):
    """Accumulated XYZ (H, W, 3) over spp samples, sharded over `mesh`.

    height must divide by mesh dp size; spp by mesh sp size. The result
    matches the single-device render_accumulate of the same tracer (same
    seeds, same sample set) up to f32 rounding. kernel: "xla" (bvh, the
    scene's BVHArrays replicated like the scene, switches its
    intersector to stackless BVH traversal) or "triton" (the forward
    megakernel of tracer/pallas.py on each device's tile; interpret=True
    runs it in the Pallas interpreter).
    """
    dp = mesh.shape[DP_AXIS]
    sp = mesh.shape[SP_AXIS]
    if height % dp != 0:
        raise ValueError(f"height {height} not divisible by dp={dp}")
    if spp % sp != 0:
        raise ValueError(f"spp {spp} not divisible by sp={sp}")
    static = None
    if kernel == "triton":
        if bvh is not None:
            raise ValueError("the Triton megakernel takes no BVH")
        from computeraytracer.tracer import pallas as pallas_tracer
        static = pallas_tracer.SceneStatic.from_scene(scene)
    elif kernel != "xla":
        raise ValueError(f"unknown kernel {kernel!r}")
    if bvh is not None:
        bvh = jax.tree_util.tree_map(jnp.asarray, bvh)
    fn = _sharded_program(mesh, width, height, spp, max_depth, rr_start,
                          use_remat, static, bool(interpret))
    return fn(scene, bvh, jnp.asarray(first_sample, jnp.uint32))


@functools.lru_cache(maxsize=32)
def _sharded_program(mesh, width, height, spp, max_depth, rr_start,
                     use_remat, static, interpret):
    """The jitted shard_map program, built once per configuration so
    repeated calls reuse its compilation. static: the megakernel's
    SceneStatic, or None for the XLA tracer."""
    tile_h = height // mesh.shape[DP_AXIS]
    local_spp = spp // mesh.shape[SP_AXIS]

    def render_tile(scene, bvh, px, py, s):
        if static is None:
            return xla_tracer.render_pixels(
                scene, width, height, px, py, s, max_depth, rr_start,
                use_remat, bvh=bvh)
        from computeraytracer.tracer import pallas as pallas_tracer
        return pallas_tracer.render_pixels(
            scene, width, height, px, py, s, max_depth, rr_start,
            static=static, interpret=interpret)

    # check_vma=False: the path-trace scan mixes replicated scene data
    # into device-varying carries, which trips jax's varying-manual-axes
    # typing; semantics are unaffected (pure per-shard compute + psum).
    @partial(shard_map, mesh=mesh, in_specs=(P(), P(), P()),
             out_specs=P(DP_AXIS, None, None), check_vma=False)
    def fn(scene, bvh, first_sample):
        dpi = jax.lax.axis_index(DP_AXIS)
        spi = jax.lax.axis_index(SP_AXIS)
        y0 = dpi.astype(jnp.uint32) * jnp.uint32(tile_h)
        px, py = xla_tracer.tile_coords(width, tile_h, y0)

        def body(acc, k):
            s = (first_sample + spi.astype(jnp.uint32)
                 * jnp.uint32(local_spp) + k)
            return acc + render_tile(scene, bvh, px, py, s), None

        acc0 = jnp.zeros((tile_h * width, 3), jnp.float32)
        acc, _ = jax.lax.scan(body, acc0,
                              jnp.arange(local_spp, dtype=jnp.uint32))
        acc = jax.lax.psum(acc, SP_AXIS)
        return acc.reshape(tile_h, width, 3)

    # one jitted program: without jit shard_map dispatches op by op
    return jax.jit(fn)
