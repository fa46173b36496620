"""Multi-host (DCN-tier) scaling hooks — SURVEY.md §5's distributed row.

The reference is a single-process, single-GPU program (SURVEY.md §2e); its
only transports are PCIe copies and one CPU<->GPU fence.  This framework's
scaling story is pure data parallelism over rays (see sharding.py), which
extends across hosts unchanged: every process renders its row stripes and
the sample-axis psum crosses hosts — XLA picks the transport (NCCL), no
MPI-style backend code is needed.

This module is the *entry point* for that tier: call :func:`init_distributed`
once per process before any backend touch, then build a global mesh with
:func:`make_global_mesh`.  The initialize call is a no-op for single-process
runs, so single-host code paths never change.  (The mesh-shape logic is
unit-tested against local devices.)
"""

from __future__ import annotations

import logging

import jax
import numpy as np
from jax.sharding import Mesh

log = logging.getLogger(__name__)


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> int:
    """Initialize the JAX distributed runtime for multi-host rendering.

    Must run before any JAX backend initialization (i.e. before building a
    device scene).  Pass the coordinator address (``host:port``), process
    count and this process's id; returns the process count actually
    joined.  A single-process call (num_processes in (None,
    0, 1) with no coordinator) skips initialization entirely.
    """
    if coordinator_address is None and not num_processes:
        log.info("multihost: single-process run, skipping distributed init")
        return 1
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    n = jax.process_count()
    log.info("multihost: joined as process %d / %d", jax.process_index(), n)
    return n


def global_mesh_shape(n_devices: int, n_samples: int = 1) -> tuple[int, int]:
    """(tiles, samples) axis sizes for ``n_devices`` total chips.

    The sample axis is clamped to divide the device count; the tile (row
    stripe) axis takes the rest.  Pure function — unit-testable without a
    cluster.
    """
    if n_devices < 1:
        raise ValueError("need at least one device")
    n_samples = max(1, min(n_samples, n_devices))
    while n_devices % n_samples:
        n_samples -= 1
    return n_devices // n_samples, n_samples


def make_global_mesh(n_samples: int = 1) -> Mesh:
    """(tiles, samples) mesh over ALL devices in the job (every host's).

    On a multi-host job ``jax.devices()`` already enumerates the global
    device set; each process executes the same shard_map program and XLA
    routes the sample-axis psum between devices and hosts.  Device order
    follows jax.devices() (host-major), so a process's row stripes land on
    its local devices — framebuffer stripes never cross hosts.
    """
    devices = np.asarray(jax.devices())
    n_tiles, n_samples = global_mesh_shape(devices.size, n_samples)
    return Mesh(devices.reshape(n_tiles, n_samples),
                axis_names=("tiles", "samples"))
