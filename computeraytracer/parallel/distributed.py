"""Multi-host initialization and global meshes (SURVEY.md §5).

The reference is a single browser tab with no peer transport at all
(reference/src/main.js:9 acquires one device; nothing is ever
read back). Scaling past one host means:

1. every host process calls :func:`initialize` (a thin, idempotent
   wrapper over ``jax.distributed.initialize`` that no-ops in
   single-process runs and inside test environments),
2. build one global ``Mesh`` over ``jax.devices()`` — which, after
   initialize, enumerates *all* cards of all hosts — with the
   film-plane (dp) axis spanning hosts so each host feeds only its own
   pixel rows, and
3. run the same ``shard_map`` code as single-host; XLA lowers the
   sample-axis psum and gradient all-reduce to NCCL collectives (NVLink
   within a host). No hand-written transport exists anywhere in this
   framework.

Verified without a cluster by the 8-virtual-device CPU mesh tests
(tests/test_sharding.py) per SURVEY.md §4.
"""

from __future__ import annotations

import os
from typing import Optional

import jax

from computeraytracer.parallel import mesh as mesh_mod

_initialized = False


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> bool:
    """Idempotent multi-process init. Returns True if a multi-process
    runtime was (or already had been) initialized.

    With no arguments, initializes only when the environment already
    carries a multi-process topology (a cluster JAX detects, or the
    standard JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES variables); a plain
    single-host run is left untouched so unit tests and the CLI work
    unchanged.
    """
    global _initialized
    if _initialized:
        return True

    # Decide multi-process intent from env vars / explicit args ALONE:
    # jax.distributed.initialize must run before any jax.* call that
    # instantiates a backend (jax.process_count() does), or it raises
    # RuntimeError("backends already initialized").
    env_coord = os.environ.get("JAX_COORDINATOR_ADDRESS")
    env_nproc = os.environ.get("JAX_NUM_PROCESSES")
    explicit = (coordinator_address is not None
                or num_processes is not None or process_id is not None)
    if explicit or (env_coord and env_nproc):
        coord = coordinator_address or env_coord
        nproc = (num_processes if num_processes is not None
                 else int(env_nproc) if env_nproc else None)
        if coord is None or nproc is None:
            raise ValueError(
                "multi-process init needs both a coordinator address and a "
                "process count (got coordinator_address="
                f"{coord!r}, num_processes={nproc!r}); set both arguments "
                "or JAX_COORDINATOR_ADDRESS + JAX_NUM_PROCESSES")
        pid = (process_id if process_id is not None
               else int(os.environ.get("JAX_PROCESS_ID", "0")))
        jax.distributed.initialize(coordinator_address=coord,
                                   num_processes=nproc, process_id=pid)
        _initialized = True
        return True

    # No explicit/env config. A cluster environment JAX detects may
    # still make this a multi-process run; consulting process_count() is safe now
    # because no jax.distributed.initialize call follows it.
    if jax.process_count() > 1:
        _initialized = True
        return True
    return False  # single-process: nothing to do


def global_mesh(sp: Optional[int] = None):
    """(dp, sp) mesh over every card of every host.

    dp spans hosts (contiguous device blocks per host, jax.devices()
    order) so each host's film rows live on its local cards and the
    forward pass needs no cross-host traffic; only the backward
    parameter psum crosses hosts. ``sp`` defaults to 2 when the global
    device count allows, else 1 (same policy as mesh.make_mesh).
    """
    devices = jax.devices()
    n = len(devices)
    if sp is None:
        sp = 2 if n % 2 == 0 and n > 1 else 1
    return mesh_mod.make_mesh(devices, (n // sp, sp))
