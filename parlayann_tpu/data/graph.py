"""GraphIndexData — the padded fixed-degree adjacency artifact.

Device-array equivalent of the reference's ``Graph<indexType>`` (graph.h:126):
the reference already stores a flat ``(maxDeg+1)``-stride row per vertex with
slot 0 = degree (graph.h:234-242); here that becomes two device arrays —
``neighbors (n_pad, max_degree) int32`` and ``degrees (n_pad,) int32`` — so
every row gather is a static-shape device op. Slots ``>= degree`` are padding
and must be masked by consumers. Save/load is byte-compatible with
graph.h:147-232.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from parlayann_tpu.data import io
from parlayann_tpu.data.pointset import pad_to


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["neighbors", "degrees"],
    meta_fields=["n", "max_degree"],
)
@dataclasses.dataclass
class GraphIndexData:
    neighbors: jax.Array  # (n_pad, max_degree) int32
    degrees: jax.Array  # (n_pad,) int32
    n: int
    max_degree: int

    @property
    def n_pad(self) -> int:
        return self.neighbors.shape[0]

    @staticmethod
    def empty(n: int, max_degree: int, row_pad: int = 8) -> "GraphIndexData":
        n_p = pad_to(max(n, 1), row_pad)
        return GraphIndexData(
            neighbors=jnp.zeros((n_p, max_degree), dtype=jnp.int32),
            degrees=jnp.zeros((n_p,), dtype=jnp.int32),
            n=n,
            max_degree=max_degree,
        )

    @staticmethod
    def from_numpy(neighbors: np.ndarray, degrees: np.ndarray, n=None, row_pad: int = 8):
        n = n if n is not None else neighbors.shape[0]
        max_degree = neighbors.shape[1]
        n_p = pad_to(max(n, 1), row_pad)
        if n_p != neighbors.shape[0]:
            pad = n_p - neighbors.shape[0]
            neighbors = np.concatenate(
                [neighbors, np.zeros((pad, max_degree), neighbors.dtype)]
            )
            degrees = np.concatenate([degrees, np.zeros(pad, degrees.dtype)])
        return GraphIndexData(
            neighbors=jnp.asarray(neighbors, dtype=jnp.int32),
            degrees=jnp.asarray(degrees, dtype=jnp.int32),
            n=n,
            max_degree=max_degree,
        )

    @staticmethod
    def load(path: str) -> "GraphIndexData":
        neighbors, degrees, max_deg = io.read_graph(path)
        return GraphIndexData.from_numpy(neighbors, degrees)

    def save(self, path: str) -> None:
        io.write_graph(
            path,
            np.asarray(self.neighbors[: self.n]),
            np.asarray(self.degrees[: self.n]),
        )

    def stats(self) -> tuple[float, int]:
        """Average and max degree (stats.h:47-55 graph_stats_)."""
        deg = np.asarray(self.degrees[: self.n])
        return float(deg.mean()), int(deg.max())
