"""HCNNG builder — hierarchical-cluster nearest-neighbor graph.

Reference: HCNNG/hcnng_index.h + clusterEdge.h. ``num_clusters`` random
cluster trees; at each leaf (<= cluster_size points) a degree-bounded MST
(Kruskal over each point's top-10 candidate edges, hcnng_index.h:134-229)
whose edges are added in both directions; max total degree =
num_clusters * MST_deg (types.h:211); duplicate edges removed at the end.

Device mapping:
  * cluster trees     -> level-synchronous labeling (build/cluster.py)
  * leaf candidates   -> batched (leaves, S, S) pairwise distance tensors
                         by matmul + per-point top-m (device)
  * per-leaf Kruskal  -> native C++ union-find, parallel across leaves
                         (parlayann_tpu/native.py; the reference's
                         sequential-island structure)
  * edge assembly     -> vectorized numpy grouping on host
"""

from __future__ import annotations

import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from parlayann_tpu.types import BuildParams, Metric
from parlayann_tpu.data.pointset import PointSet
from parlayann_tpu.data.graph import GraphIndexData
from parlayann_tpu.ops.distance import INF
from parlayann_tpu.build.prune import _pairwise
from parlayann_tpu.build.cluster import cluster_tree_labels, leaf_members
from parlayann_tpu import native

_CAND_PER_POINT = 10  # reference m=10 candidate edges/point (hcnng_index.h:144)


@partial(jax.jit, static_argnames=("S", "m", "metric"))
def _leaf_candidate_edges(points_data, members, sizes, *, S: int, m: int,
                          metric: Metric):
    """(Lc, S) leaf member ids -> per-leaf weight-sorted candidate edges
    (u_local, v_local) of shape (Lc, S*m); invalid slots are -1."""
    Lc = members.shape[0]
    vecs = jnp.take(points_data, jnp.clip(members, 0, points_data.shape[0] - 1),
                    axis=0)  # (Lc, S, d)
    D = _pairwise(vecs.astype(jnp.float32), metric)  # (Lc, S, S)
    col = jnp.arange(S, dtype=jnp.int32)
    valid = col[None, :] < sizes[:, None]  # (Lc, S)
    D = jnp.where(valid[:, None, :] & valid[:, :, None], D, INF)
    eye = col[None, :, None] == col[None, None, :]
    D = jnp.where(eye, INF, D)
    # m exact argmin/min reduction passes, not a select sort: the grouped
    # select's lane sorts dominated the program; m=10 masked reductions
    # over the same (Lc*S, S) tile are plain streams (same result, in
    # ascending order)
    Dr = D.reshape(Lc * S, S)
    lane = col[None, :]
    w_l, v_l = [], []
    for _ in range(m):
        am = jnp.argmin(Dr, axis=1).astype(jnp.int32)[:, None]
        w_l.append(jnp.min(Dr, axis=1, keepdims=True))
        v_l.append(am)
        Dr = jnp.where(lane == am, INF, Dr)
    w = jnp.concatenate(w_l, axis=1).reshape(Lc, S, m)
    vloc = jnp.concatenate(v_l, axis=1).reshape(Lc, S, m)
    u = jnp.broadcast_to(col[None, :, None], (Lc, S, m))
    w = w.reshape(Lc, S * m)
    u = u.reshape(Lc, S * m).astype(jnp.int32)
    v = vloc.reshape(Lc, S * m).astype(jnp.int32)
    sw, su, sv = jax.lax.sort((w, u, v), num_keys=1, is_stable=True)
    # pack (u, v) into one int32 word: HALVES the device->host readback.
    # -1 = invalid; host unpacks with shift/mask.
    sp = 1 << (S - 1).bit_length()
    assert sp * sp < 2**31, f"cluster_size {S} too large to pack"
    return jnp.where(sw < INF, su * sp + sv, -1)


def build_hcnng_graph(points: PointSet, bp: BuildParams, verbose: bool = False):
    """Build the HCNNG graph. Returns (GraphIndexData, build_seconds)."""
    n = points.n
    S = bp.cluster_size
    mst_deg = bp.MST_deg
    max_deg = bp.max_degree  # num_clusters * MST_deg (types.h:211)
    m = min(_CAND_PER_POINT, max(S - 1, 1))
    t0 = time.perf_counter()

    srcs, dsts = [], []
    keys = jax.random.split(jax.random.key(bp.seed), bp.num_clusters)

    # ---- phase A: ALL label trees enqueued back-to-back, ONE stacked
    # readback. Enqueues are async, so the trees pipeline on device. ----
    lab = [
        cluster_tree_labels(points.data, keys[t], metric=points.metric,
                            cluster_size=S, n_valid=n)
        for t in range(bp.num_clusters)
    ]
    lab_h = np.asarray(jnp.stack([jnp.stack(o) for o in lab]))  # (T,2,n_pad)
    del lab

    # ---- phase B: queue every tree's candidate chunks (packed (u,v)
    # words), then drain: chunk i+1 computes on device while the host
    # runs Kruskal on chunk i (np.asarray is the only fence) ----
    sp = 1 << (S - 1).bit_length()
    queued = []
    for t in range(bp.num_clusters):
        members, sizes = leaf_members(lab_h[t, 0], lab_h[t, 1], S)
        n_leaves = len(members)
        chunk = max(1, min(n_leaves, (1 << 25) // (S * S)))  # ~128MB tensors
        parts = []
        for lo in range(0, n_leaves, chunk):
            mem = members[lo : lo + chunk]
            sz = sizes[lo : lo + chunk]
            if len(mem) < chunk:
                pad = chunk - len(mem)
                mem = np.concatenate([mem, np.full((pad, S), -1, np.int32)])
                sz = np.concatenate([sz, np.zeros(pad, np.int32)])
            parts.append(_leaf_candidate_edges(
                points.data, jnp.asarray(mem), jnp.asarray(sz),
                S=S, m=m, metric=points.metric,
            ))
        # one (sum_chunks, S*m) array per tree -> ONE readback per tree
        queued.append((members, sizes,
                       parts[0] if len(parts) == 1
                       else jnp.concatenate(parts, axis=0)))
        if verbose:
            print(f"hcnng: tree {t+1}/{bp.num_clusters} queued "
                  f"({n_leaves} leaves)", flush=True)
    for members, sizes, suv in queued:
        suv = np.asarray(suv)[: len(members)]
        su = np.where(suv >= 0, suv >> int(np.log2(sp)), -1).astype(np.int32)
        sv = np.where(suv >= 0, suv & (sp - 1), -1).astype(np.int32)
        # sequential island: degree-bounded Kruskal per leaf (C++)
        ou, ov, cnt = native.kruskal_leaves(su, sv, sizes, S, mst_deg)
        # flat-offset assembly — one mask + two fancy-index gathers per
        # tree instead of a Python loop over every leaf
        cnt = np.asarray(cnt)
        keep = np.arange(ou.shape[1])[None, :] < cnt[:, None]
        rowi = np.broadcast_to(
            np.arange(len(members))[:, None], ou.shape)[keep]
        eu = members[rowi, np.clip(ou, 0, S - 1)[keep]]
        ev = members[rowi, np.clip(ov, 0, S - 1)[keep]]
        # both directions (hcnng_index.h:208-218)
        srcs.append(np.concatenate([eu, ev]))
        dsts.append(np.concatenate([ev, eu]))

    src = np.concatenate(srcs) if srcs else np.zeros(0, np.int32)
    dst = np.concatenate(dsts) if dsts else np.zeros(0, np.int32)
    # order-preserving (src,dst) dedup, then first max_deg per src
    # (process_edges + remove_all_duplicates, hcnng_index.h:102-131)
    pairs = src.astype(np.int64) * n + dst
    _, first = np.unique(pairs, return_index=True)
    first.sort()
    src, dst = src[first], dst[first]
    order = np.argsort(src, kind="stable")
    src, dst = src[order], dst[order]
    starts = np.searchsorted(src, np.arange(n), side="left")
    ends = np.searchsorted(src, np.arange(n), side="right")
    degs = np.minimum(ends - starts, max_deg).astype(np.int32)
    rank = np.arange(len(src)) - starts[src]
    keep = rank < max_deg
    rows = np.zeros((n, max_deg), dtype=np.int32)
    rows[src[keep], rank[keep]] = dst[keep]
    g = GraphIndexData.from_numpy(rows, degs, n=n)
    return g, time.perf_counter() - t0


def build_hcnng_index(
    data,
    metric: Metric = Metric.L2,
    num_clusters: int = 30,
    cluster_size: int = 1000,
    mst_deg: int = 3,
    verbose: bool = False,
    seed: int = 0,
):
    """Convenience wrapper (python/builder.cpp:114-140; defaults from
    docs/algorithms.md:92-97)."""
    metric = Metric.coerce(metric)
    ps = data if isinstance(data, PointSet) else PointSet.from_numpy(
        np.asarray(data), metric=metric
    )
    bp = BuildParams(
        num_clusters=num_clusters, cluster_size=cluster_size, MST_deg=mst_deg,
        seed=seed,
    )
    g, dt = build_hcnng_graph(ps, bp, verbose=verbose)
    return g, ps, dt
