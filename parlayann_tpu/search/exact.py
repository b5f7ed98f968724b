"""Exact k-NN (ground truth) — one big tiled matmul + streaming top-k.

Replaces the reference's per-query linear scan with a top-k buffer
(data_tools/compute_groundtruth.cpp:22-60): the scan is a sequence of
(B, d) x (d, C) matmuls over dataset chunks with a running top-k merge,
driven by ``lax.scan`` so memory stays at one chunk.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from parlayann_tpu.types import Metric
from parlayann_tpu.data.pointset import PointSet
from parlayann_tpu.ops import distance


def exact_knn(
    queries: jax.Array | np.ndarray,
    points: PointSet,
    k: int,
    chunk: int = 32768,
):
    """Exact top-k for each query row -> (ids (B,k) int32, dists (B,k) f32).

    Delegates to the flat-search scan with the exact two-level lane-sort
    select and a HIGHEST-precision matmul (search/flat.py), so the
    distances are full float32 (no TF32 rounding)."""
    from parlayann_tpu.search.flat import flat_search_batch

    q = jnp.asarray(queries)
    return flat_search_batch(
        q, points.data, k=k, metric=points.metric, n_valid=points.n,
        chunk=min(chunk, points.n_pad), select="sort", precision="exact",
    )


def compute_groundtruth(
    base: PointSet, queries: np.ndarray, k: int, query_batch: int = 8192
):
    """Host-driver over query batches (compute_groundtruth.cpp:104).

    The tail batch is zero-padded to ``query_batch`` so every batch runs
    the same compiled program (an odd tail shape costs a fresh compile)."""
    nq = len(queries)
    out_i, out_d = [], []
    for lo in range(0, nq, query_batch):
        qb = np.asarray(queries[lo : lo + query_batch])
        if len(qb) < query_batch and lo > 0:
            qb = np.pad(qb, ((0, query_batch - len(qb)), (0, 0)))
        ids, dists = exact_knn(qb, base, k)
        take = min(query_batch, nq - lo)
        out_i.append(np.asarray(ids)[:take])
        out_d.append(np.asarray(dists)[:take])
    return np.concatenate(out_i), np.concatenate(out_d)


def compute_range_groundtruth(
    base: PointSet, queries: np.ndarray, radius: float, query_batch: int = 2048
):
    """Exact range ground truth: all base ids within ``radius`` of each
    query (data_tools/compute_range_groundtruth.cpp). Returns a list of id
    arrays."""
    out = []
    qn = len(queries)
    for lo in range(0, qn, query_batch):
        q = jnp.asarray(queries[lo : lo + query_batch])
        d = distance.all_pairs(q, base.data, base.metric)
        d = np.asarray(d)[:, : base.n_pad]
        valid = np.arange(base.n_pad) < base.n
        for row in d:
            out.append(np.flatnonzero((row <= radius) & valid).astype(np.int32))
    return out
