"""Device-mesh helpers for sharded ANN.

The reference is a single-node shared-memory library (SURVEY §2: no
MPI/NCCL anywhere); its scaling axis is hugepage-backed flat arrays on one
big box. Here the scaling axis is a ``jax.sharding.Mesh``: the
dataset (vectors + graph rows) shards over the ``d`` axis, queries shard
over the ``q`` axis, and cross-shard top-k merges are collectives over
the interconnect.
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh


def make_mesh(n_devices: int | None = None, data_axis: int | None = None) -> Mesh:
    """Build a (d, q) mesh over the available devices.

    ``d`` = dataset shards, ``q`` = query shards. Defaults put all devices
    on the dataset axis (the common big-dataset regime).
    """
    devs = jax.devices()
    n = n_devices if n_devices is not None else len(devs)
    devs = devs[:n]
    d = data_axis if data_axis is not None else n
    assert n % d == 0, f"{n} devices not divisible by data axis {d}"
    arr = np.array(devs).reshape(d, n // d)
    return Mesh(arr, ("d", "q"))
