"""Multi-process distributed runtime (SURVEY.md §2.8 last row).

The reference's only cross-process fabric is HTTP plus a shared SQL
database; the equivalent here is `jax.distributed.initialize` +
collectives (NCCL between GPUs). This module is the initialization seam:
every process of a multi-process deployment calls `maybe_initialize`
before first device use, after which `jax.devices()` is the GLOBAL device
list and `global_mesh()` spans all processes — `shard_map` programs
(parallel/sharded.py, build/kmeans.py) run unchanged over it. Each process
opens only its own cards (`local_device_ids`, config.MeshConfig)

Host-side array placement must go through `put_sharded` (not bare
`jax.device_put`): on a multi-host mesh a process can only address its
own devices. Every process passes the SAME host-global array and
`put_sharded` carves out the shards its local devices own via
`jax.make_array_from_callback` — do NOT pass process-local row blocks
(that was the r2 bug: feeding local blocks doubled the global shape on
multi-host meshes).

Config wiring (config.py MeshConfig → main.py): set
`mesh.coordinator` ("host0:1234"), `mesh.num_processes`, and
`mesh.process_id` on every instance. Single-host deployments skip all of
this (coordinator empty → no-op).

tests/test_distributed.py runs the initialize → global mesh →
sharded-search path in one and in two processes on the CPU; multi-DEVICE
semantics are covered by the 8-device virtual CPU mesh.
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding

from .mesh import default_mesh

_initialized = False


def maybe_initialize(
    coordinator: str,
    num_processes: int = 1,
    process_id: int = 0,
    local_device_ids: list[int] | None = None,
) -> bool:
    """Join (or form) the distributed runtime; no-op without coordinator.

    Idempotent per process. Must run before the first device use — JAX
    backends are finalized on first touch.
    """
    global _initialized
    if not coordinator or _initialized:
        return _initialized
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )
    _initialized = True
    return True


def global_mesh(n_devices: int | None = None) -> Mesh:
    """1-D data mesh over the GLOBAL device list (all hosts).

    After jax.distributed.initialize, jax.devices() IS the global list,
    so this is mesh.default_mesh — kept as a named alias (one definition;
    duplicated construction drifted once already)."""
    return default_mesh(n_devices)


def put_sharded(array: np.ndarray, sharding: NamedSharding) -> jax.Array:
    """Place a HOST-GLOBAL array onto a (possibly multi-host) sharding.

    Fully-addressable mesh (single host, incl. the virtual CPU mesh):
    plain device_put. Multi-host: every process passes the same global
    array and each contributes the slices its devices own
    (make_array_from_callback). NOT make_array_from_process_local_data —
    that interprets the input as this process's rows only and doubles
    the global shape (caught by tests/test_distributed.py's real
    two-process run).
    """
    if sharding.is_fully_addressable:
        return jax.device_put(array, sharding)
    array = np.asarray(array)
    return jax.make_array_from_callback(
        array.shape, sharding, lambda idx: array[idx]
    )
