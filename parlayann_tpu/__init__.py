"""parlayann_tpu — a data-parallel graph-ANN framework in JAX.

A from-scratch rebuild of the capabilities of ParlayANN (landrumb/ParlayANN):
batch-parallel construction and querying of graph-based approximate-nearest-
neighbor indices — Vamana/DiskANN, HNSW, HCNNG, pyNNDescent — plus range
search, scalar/bit/JL quantization with filtered + reranked search, exact
ground-truth tooling, and a recall/QPS benchmark harness.

Design (batch-parallel on one accelerator, not a port):
  * vectors  = device-resident ``(n_pad, d)`` matrices (one per precision
    tier)
  * graphs   = padded fixed-degree ``(n_pad, R)`` int32 adjacency + degrees
  * search   = batched masked frontier loop: gather neighbor ids, batched
    distance compute, top-k merge — thousands of queries per step
  * builders = batch-synchronous jitted steps (prefix-doubling insertion,
    vectorized occlusion pruning, sort-based reverse-edge exchange)
  * scaling  = dataset shards over a ``jax.sharding.Mesh``; per-shard search
    with all-gathered top-k merges over the interconnect

Reference behavior parity targets are cited throughout as
``<path>:<line>`` in the reference repository.
"""

from parlayann_tpu.types import BuildParams, QueryParams, RangeParams, Metric
from parlayann_tpu.data.pointset import PointSet
from parlayann_tpu.data.graph import GraphIndexData
from parlayann_tpu.api import (
    build_vamana_index,
    build_hcnng_index,
    build_pynndescent_index,
    build_hnsw_index,
    build_cluster_index,
    load_index,
    Index,
)

__version__ = "0.1.0"

__all__ = [
    "BuildParams",
    "QueryParams",
    "RangeParams",
    "Metric",
    "PointSet",
    "GraphIndexData",
    "build_vamana_index",
    "build_hcnng_index",
    "build_pynndescent_index",
    "build_hnsw_index",
    "build_cluster_index",
    "load_index",
    "Index",
]
