"""Multi-host launch helpers.

The reference is strictly single-device (SURVEY.md §2.4); scale-out is
new design. On a multi-host cluster each host runs the same
program; `init_multihost()` wires up jax.distributed so `jax.devices()`
is the global device list, and `global_mesh()` builds the 1-D ray/angle
mesh spanning it. Dose grids and pattern gradients are psum-reduced
by parallel.shard; nothing else is host-aware.

Typical launch (one process per host):

    from drtvam_tpu.parallel import multihost, shard
    multihost.init_multihost()              # no-op on a single host
    mesh = multihost.global_mesh()
    render = shard.make_sharded_render(mesh)
"""
from __future__ import annotations

import os

import numpy as np
import jax

from .shard import AXIS, make_mesh


def init_multihost(coordinator_address=None, num_processes=None,
                   process_id=None):
    """Initialize jax.distributed from explicit args or the standard
    environment (JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES,
    JAX_PROCESS_ID). A single-process run (no coordinator configured)
    is a no-op, so the same entry point works from laptops to
    clusters."""
    if num_processes is None:
        num_processes = int(os.environ.get("JAX_NUM_PROCESSES", "0")) or None
    if coordinator_address is None:
        coordinator_address = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if process_id is None:
        pid = os.environ.get("JAX_PROCESS_ID")
        process_id = int(pid) if pid is not None else None
    if coordinator_address is None and num_processes is None:
        return False  # single-host
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id)
    return True


def global_mesh():
    """1-D mesh over every chip in the (possibly multi-host) job."""
    return make_mesh(jax.devices())


def is_coordinator():
    return jax.process_index() == 0
