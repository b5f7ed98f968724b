"""Random cluster trees — the shared partitioning engine of HCNNG and
pyNNDescent.

Reference: clusterEdge.h:66-153 (random_clustering: pick two random pivots,
partition points to the nearer pivot, recurse via par_do until leaves have
<= cluster_size points; multiple_clustertrees repeats num_clusters times)
and clusterPynn.h:52-175.

Data-parallel redesign: the fork-join recursion becomes a
*level-synchronous* loop over all points at once. Each point carries a
cluster label; one level =

  1. sort points by (label, random key) — the first two points of each
     label segment are that cluster's two random pivots,
  2. one batched distance computation point-vs-its-two-pivots,
  3. new label = 2*segment_start + nearer-pivot bit (segment starts are
     unique per cluster and < n, so labels never overflow), with a
     rank-parity split when the pivots coincide (the duplicate-pivot
     fallback, clusterEdge.h:108-127).

Clusters at or below cluster_size freeze. The permutation is carried
through the scan (points stay in sorted order) so no scatter is needed;
the final (ids, labels) pairing is returned as-is.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from parlayann_tpu.types import Metric
from parlayann_tpu.ops import distance


@partial(jax.jit, static_argnames=("metric", "cluster_size", "max_levels", "n_valid"))
def cluster_tree_labels(
    points_data: jax.Array,  # (n_pad, d)
    key: jax.Array,  # PRNG key
    *,
    metric: Metric,
    cluster_size: int,
    max_levels: int = 24,
    n_valid: int,
):
    """One random cluster tree -> (ids (n_pad,), labels (n_pad,)) pairs.

    ``labels[i]`` is the leaf label of point ``ids[i]``; pad rows carry
    label -1 and sort last. Sibling leaves never share a label.
    """
    n_pad = points_data.shape[0]
    pos = jnp.arange(n_pad, dtype=jnp.int32)
    BIG = jnp.int32(2**30)

    def level(state):
        ids, labels, active, key, lvl = state
        key, sub = jax.random.split(key)
        rnd = jax.random.bits(sub, (n_pad,), jnp.uint32).astype(jnp.int32)
        slab, _, ids, active = jax.lax.sort(
            (jnp.where(labels < 0, BIG, labels), rnd, ids,
             active.astype(jnp.int32)),
            num_keys=2,
        )
        active = active.astype(bool)
        first = jnp.concatenate([jnp.ones(1, bool), slab[1:] != slab[:-1]])
        seg_start = jax.lax.cummax(jnp.where(first, pos, 0))
        rank = pos - seg_start
        # segment ends via one reverse cummin, not searchsorted: XLA
        # lowers searchsorted to a log2(n)-step binary-search while loop
        # of gather fusions
        nxt_first = jnp.concatenate([first[1:], jnp.ones(1, bool)])
        right = jax.lax.cummin(
            jnp.where(nxt_first, pos + 1, n_pad), reverse=True
        )
        seg_size = right - seg_start

        p1 = jnp.take(points_data, jnp.take(ids, seg_start), axis=0)
        p2_pos = jnp.minimum(seg_start + 1, n_pad - 1)
        p2 = jnp.take(points_data, jnp.take(ids, p2_pos), axis=0)
        pts = jnp.take(points_data, ids, axis=0)
        d1 = distance.gathered(pts, p1[:, None, :], metric)[:, 0]
        d2 = distance.gathered(pts, p2[:, None, :], metric)[:, 0]
        tie = d1 == d2  # duplicate-pivot fallback (clusterEdge.h:108-127)
        bit = jnp.where(tie, rank % 2, (d2 < d1).astype(jnp.int32))

        split = active & (seg_size > cluster_size) & (slab < BIG)
        new_labels = jnp.where(
            split, seg_start * 2 + bit,
            jnp.where(slab < BIG, seg_start * 2, -1),
        )
        return (ids, new_labels, split, key, lvl + 1)

    state = (
        pos,
        jnp.where(pos < n_valid, 0, -1).astype(jnp.int32),
        pos < n_valid,
        key,
        jnp.int32(0),
    )

    # while_loop, not a fixed-depth scan: the tree needs ~log2(n/S)+skew
    # levels (8-10 at 100K/S=1000) but the static bound is 24 — a scan
    # runs every level's full sort+gather even after all clusters froze.
    # Stop as soon as no cluster split, with max_levels as the runaway
    # bound.
    def cond(state):
        _, _, active, _, lvl = state
        return jnp.any(active) & (lvl < max_levels)

    ids, labels, _, _, _ = jax.lax.while_loop(cond, level, state)
    return ids, labels


def leaf_members(ids: np.ndarray, labels: np.ndarray, cluster_size: int):
    """Host helper: (ids, labels) pairs -> (n_leaves, cluster_size) member
    matrix padded with -1, plus (n_leaves,) sizes."""
    ids, labels = np.asarray(ids), np.asarray(labels)
    order = np.argsort(labels, kind="stable")
    ids, labels = ids[order], labels[order]
    keep = labels >= 0
    ids, labels = ids[keep], labels[keep]
    starts = np.flatnonzero(np.concatenate([[True], labels[1:] != labels[:-1]]))
    ends = np.concatenate([starts[1:], [len(labels)]])
    n_leaves = len(starts)
    out = np.full((n_leaves, cluster_size), -1, dtype=np.int32)
    sizes = np.zeros(n_leaves, dtype=np.int32)
    for i, (s, e) in enumerate(zip(starts, ends)):
        m = min(e - s, cluster_size)
        out[i, :m] = ids[s : s + m]
        sizes[i] = m
    return out, sizes
