"""Device mesh helpers.

The reference scales reads with Postgres read replicas behind strict
round-robin (database/database.go:86-103) and coordinates multi-instance
builds with row locks (server/centroids.go:33-52). The equivalents here
(SURVEY.md §2.8): a 1-D 'data' mesh whose devices hold corpus shards,
collectives for cross-shard top-k merges, and single-writer
index builds whose results are swapped in atomically.
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"


def default_mesh(n_devices: int | None = None) -> Mesh:
    """A 1-D data mesh over the first n (default: all) local devices."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (DATA_AXIS,))


def row_sharding(mesh: Mesh) -> NamedSharding:
    """Shard axis 0 (rows / clusters) over the data axis."""
    return NamedSharding(mesh, P(DATA_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
