"""Checkpoint / resume.

The reference's implicit resumable state is tiny: (accumulation buffer,
sample counter) — reference/src/main.js:298-311 — and rendering is
a pure fold over samples; a page reload restarts from sample 0. Here that
state (plus optimizer state for training) is saved as one `.npz` of the
flattened pytree leaves per step, and the counter-based RNG makes resume
bit-exact (SURVEY.md §5). Restoring needs a template pytree of the same
structure (the params and optimizer state the caller already builds).
"""

from __future__ import annotations

import os
from typing import Any, Optional

import jax
import numpy as np

# Geometry layout version persisted with every checkpoint. Version 2 =
# triangle rows (category 2) store ABSOLUTE VERTICES in data2/data3
# (scene/data.py); version 1 (round-1 layout) stored edge vectors. A
# version-1 checkpoint containing triangles would restore cleanly but be
# silently reinterpreted as vertices — fail loudly instead.
LAYOUT_VERSION = 2

_TREES = ("params", "opt_state", "extra")


class Checkpointer:
    """Minimal step-indexed checkpointer over pytrees of arrays."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}.npz")

    def save(self, step: int, params: Any, opt_state: Any = None,
             extra: Any = None):
        arrays = {"step": np.int64(step),
                  "layout_version": np.int64(LAYOUT_VERSION)}
        for name, tree in zip(_TREES, (params, opt_state, extra)):
            for i, leaf in enumerate(jax.tree_util.tree_leaves(tree)):
                arrays[f"{name}/{i}"] = np.asarray(leaf)
        # write-then-rename: a crash mid-save never leaves a torn file
        # under a step name
        tmp = self._path(step) + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, self._path(step))

    def latest_step(self) -> Optional[int]:
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and name.endswith(".npz"):
                try:
                    steps.append(int(name[len("step_"):-len(".npz")]))
                except ValueError:
                    pass
        return max(steps) if steps else None

    def restore(self, step: int, params_like: Any,
                opt_state_like: Any = None, extra_like: Any = None):
        path = self._path(step)
        with np.load(path, allow_pickle=False) as z:
            arrays = {k: z[k] for k in z.files}
        if "layout_version" not in arrays:
            raise ValueError(
                f"checkpoint {path} has no layout_version (pre-"
                f"v{LAYOUT_VERSION} geometry layout, or corrupt); "
                "re-create it from current scene data")
        v = int(arrays["layout_version"])
        if v != LAYOUT_VERSION:
            raise ValueError(
                f"checkpoint {path} uses geometry layout v{v}, this build "
                f"expects v{LAYOUT_VERSION} (triangle rows: absolute "
                "vertices in data2/data3)")
        out = {"step": arrays["step"], "layout_version": v}
        for name, like in zip(_TREES,
                              (params_like, opt_state_like, extra_like)):
            leaves, treedef = jax.tree_util.tree_flatten(like)
            saved = sum(k.startswith(name + "/") for k in arrays)
            if saved != len(leaves):
                raise ValueError(
                    f"checkpoint {path}: {name} has {saved} leaves, the "
                    f"template {len(leaves)}")
            out[name] = jax.tree_util.tree_unflatten(
                treedef, [arrays[f"{name}/{i}"] for i in range(saved)])
        return out

    def restore_latest(self, params_like: Any, opt_state_like: Any = None):
        """Returns (params, opt_state, step) or None if nothing saved."""
        step = self.latest_step()
        if step is None:
            return None
        r = self.restore(step, params_like, opt_state_like)
        return r["params"], r["opt_state"], int(r["step"])


def save_render_state(directory: str, accum_xyz, sample_count: int):
    """Persist the progressive-render state (accumulator + counter).

    The checkpoint step IS the sample counter (the reference's `sample`
    buffer, main.js:304-311)."""
    Checkpointer(directory).save(int(sample_count), {"accum_xyz": accum_xyz})


def load_render_state(directory: str, accum_like):
    """Returns (accum_xyz, sample_count) or None."""
    ck = Checkpointer(directory)
    step = ck.latest_step()
    if step is None:
        return None
    r = ck.restore(step, {"accum_xyz": accum_like})
    return r["params"]["accum_xyz"], step
