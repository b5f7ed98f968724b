"""pyNNDescent builder — k-NN graph via nn-descent.

Reference: pyNNDescent/pynn_index.h + clusterPynn.h. Structure:
  1. init: random cluster trees whose leaves do all-pairs, keeping each
     point's top-K merged across trees (clusterPynn.h:52-175),
  2. nn-descent rounds until #changed < delta*n (pynn_index.h:178-196),
  3. finish: union with reversed edges, then alpha-occlusion prune to K
     (undirect_and_prune, pynn_index.h:198-239).

Data-parallel redesign of the round (pynn_index.h:66-155): the
reference's push-style local join (emit candidate pairs inside each
vertex's join set, semisort by target, bounded-merge) is scatter-heavy;
here each vertex *pulls* sampled neighbors-of-neighbors over the
symmetrized graph — the same 2-hop
discovery, but every candidate list is row-aligned to its owner so a round
is: one reverse pass (sort), two sampled gathers, one fused distance block,
one row-wise merge sort. Sampling replaces the reference's "new"-flag work
bounding; convergence is still measured by changed entries per round.
"""

from __future__ import annotations

import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from parlayann_tpu.utils.arrays import segment_bounds
from parlayann_tpu.types import BuildParams, Metric
from parlayann_tpu.data.pointset import PointSet
from parlayann_tpu.data.graph import GraphIndexData
from parlayann_tpu.ops import distance
from parlayann_tpu.ops.distance import INF
from parlayann_tpu.build.prune import robust_prune_chunked, _pairwise, sort_dedup_candidates
from parlayann_tpu.build.cluster import cluster_tree_labels, leaf_members


def _merge_rows(ids_a, dists_a, ids_b, dists_b, K: int, n_valid: int):
    """Row-aligned bounded merge: keep the K closest unique ids per row
    (the reference's seq_union_bounded, union.h:13-71)."""
    ids, dists = sort_dedup_candidates(
        jnp.concatenate([ids_a, ids_b], axis=1),
        jnp.concatenate([dists_a, dists_b], axis=1),
        n_valid,
    )
    out_i = ids[:, :K]
    out_d = dists[:, :K]
    return jnp.where(out_d < INF, out_i, -1), out_d


@partial(jax.jit, static_argnames=("S", "K", "metric", "n_valid"))
def _leaf_topk(points_data, members, sizes, cur_ids, cur_dists, *, S, K,
               metric, n_valid):
    """All-pairs inside each leaf; merge each member's top-K into its
    running list (clusterPynn.h:52-87 naive_neighbors)."""
    vecs = jnp.take(points_data, jnp.clip(members, 0, points_data.shape[0] - 1),
                    axis=0)
    D = _pairwise(vecs.astype(jnp.float32), metric)
    col = jnp.arange(S, dtype=jnp.int32)
    ok = (col[None, :] < sizes[:, None])
    D = jnp.where(ok[:, None, :] & ok[:, :, None], D, INF)
    D = jnp.where(col[None, :, None] == col[None, None, :], INF, D)
    negd, loc = jax.lax.top_k(-D, min(K, S))  # (Lc, S, K)
    d = -negd
    gl = jnp.take_along_axis(
        jnp.broadcast_to(members[:, None, :], D.shape), loc, axis=2
    )
    gl = jnp.where(d < INF, gl, -1)
    # merge into the members' running lists (row-gather, merge, scatter rows)
    rows = members.reshape(-1)
    safe = jnp.clip(rows, 0, cur_ids.shape[0] - 1)
    mi = jnp.take(cur_ids, safe, axis=0)
    md = jnp.take(cur_dists, safe, axis=0)
    new_i, new_d = _merge_rows(
        mi, md, gl.reshape(-1, gl.shape[2]), d.reshape(-1, d.shape[2]),
        K, n_valid,
    )
    wt = jnp.where((rows >= 0) & (col[None, :] < sizes[:, None]).reshape(-1),
                   rows, cur_ids.shape[0])
    cur_ids = cur_ids.at[wt].set(new_i, mode="drop")
    cur_dists = cur_dists.at[wt].set(new_d, mode="drop")
    return cur_ids, cur_dists


@partial(jax.jit, static_argnames=("K", "metric", "n_valid"))
def _reverse_capped(nbr_ids, key, *, K, metric, n_valid):
    """Reversed adjacency, shuffled and truncated to K per target
    (pynn_index.h:157-176)."""
    n_pad, Kf = nbr_ids.shape
    src = jnp.repeat(jnp.arange(n_pad, dtype=jnp.int32), Kf)
    dst = nbr_ids.reshape(-1)
    valid = (dst >= 0) & (dst < n_valid) & (src < n_valid)
    dkey = jnp.where(valid, dst, n_pad)
    rnd = jax.random.bits(key, dkey.shape, jnp.uint32).astype(jnp.int32)
    sdst, _, ssrc = jax.lax.sort((dkey, rnd, src), num_keys=2)
    pos = jnp.arange(sdst.shape[0], dtype=jnp.int32)
    left, _ = segment_bounds(sdst)
    rank = pos - left
    keep = (rank < K) & (sdst < n_pad)
    # row-scatter the first K of each group
    wt = jnp.where(keep, sdst, n_pad)
    wc = jnp.where(keep, rank, 0)
    rev = jnp.full((n_pad, K), -1, dtype=jnp.int32)
    rev = rev.at[wt, wc].set(jnp.where(keep, ssrc, -1), mode="drop")
    return rev


@partial(jax.jit, static_argnames=("K", "metric", "n_valid", "chunk"))
def _descent_round_exact(points_data, nbr_ids, nbr_dists, rev, *, K,
                         metric, n_valid, chunk: int = 4096):
    """One EXACT 2-hop pull round: every vertex evaluates ALL J*J
    neighbors-of-join candidates (J = K fwd + K rev), row-chunked to
    bound the (chunk, J*J) distance block. A superset of the reference
    push-join's per-round coverage (pynn_index.h:105-126 pairs within
    the rev set + nbr x rev); used as the final polish round — the
    sampled rounds converge the bulk, the exact round recovers the
    borderline entries sampling misses (measured +2-3pp end-to-end
    navigability on quasi-uniform data at equal K)."""
    n_pad, _ = nbr_ids.shape
    join = jnp.concatenate([nbr_ids, rev], axis=1)  # (n, J)
    J = join.shape[1]
    me = points_data.astype(jnp.float32)

    def one(args):
        rows, my_ids, my_d = args  # (chunk,), (chunk, K), (chunk, K)
        j1 = jnp.take(join, jnp.clip(rows, 0, n_pad - 1), axis=0)
        j2 = jnp.take(join, jnp.clip(j1, 0, n_pad - 1), axis=0)
        cand = jnp.where((j1 >= 0)[:, :, None], j2, -1).reshape(
            rows.shape[0], J * J)
        vecs = jnp.take(points_data,
                        jnp.clip(cand, 0, points_data.shape[0] - 1), axis=0)
        mine = jnp.take(me, jnp.clip(rows, 0, n_pad - 1), axis=0)
        d = distance.gathered(mine, vecs.astype(jnp.float32), metric)
        bad = (cand < 0) | (cand >= n_valid) | (cand == rows[:, None])
        d = jnp.where(bad, INF, d)
        return _merge_rows(my_ids, my_d, cand, d, K, n_valid)

    rows = jnp.arange(n_pad, dtype=jnp.int32)
    nch = -(-n_pad // chunk)
    pad = nch * chunk - n_pad
    if pad:
        rows = jnp.concatenate([rows, jnp.full(pad, -1, jnp.int32)])
        nbr_ids_p = jnp.concatenate(
            [nbr_ids, jnp.full((pad, K), -1, jnp.int32)])
        nbr_dists_p = jnp.concatenate(
            [nbr_dists, jnp.full((pad, K), INF, jnp.float32)])
    else:
        nbr_ids_p, nbr_dists_p = nbr_ids, nbr_dists
    new_i, new_d = jax.lax.map(
        one,
        (rows.reshape(nch, chunk), nbr_ids_p.reshape(nch, chunk, K),
         nbr_dists_p.reshape(nch, chunk, K)),
    )
    new_i = new_i.reshape(-1, K)[:n_pad]
    new_d = new_d.reshape(-1, K)[:n_pad]
    changed = jnp.sum((new_i != nbr_ids) & (new_i >= 0))
    return new_i, new_d, changed


@partial(jax.jit, static_argnames=("s1", "s2", "K", "metric", "n_valid"))
def _descent_round(points_data, nbr_ids, nbr_dists, rev, key, *, s1, s2, K,
                   metric, n_valid):
    """One pull-style sampled neighbors-of-neighbors round."""
    n_pad, _ = nbr_ids.shape
    join = jnp.concatenate([nbr_ids, rev], axis=1)  # (n, K+K)
    J = join.shape[1]
    k1, k2 = jax.random.split(key)
    # sample without caring about duplicates (dedup handled in merge)
    c1 = jax.random.randint(k1, (n_pad, s1), 0, J)
    hop1 = jnp.take_along_axis(join, c1, axis=1)  # (n, s1)
    hop1s = jnp.clip(hop1, 0, n_pad - 1)
    j2 = jnp.take(join, hop1s, axis=0)  # (n, s1, J)
    c2 = jax.random.randint(k2, (n_pad, s1, s2), 0, J)
    cand = jnp.take_along_axis(j2, c2, axis=2)  # (n, s1, s2)
    cand = jnp.where((hop1 >= 0)[:, :, None], cand, -1).reshape(n_pad, s1 * s2)
    vecs = jnp.take(points_data, jnp.clip(cand, 0, points_data.shape[0] - 1),
                    axis=0)
    me = points_data.astype(jnp.float32)
    d = distance.gathered(me, vecs.astype(jnp.float32), metric)
    self_or_bad = (cand < 0) | (cand >= n_valid) | (
        cand == jnp.arange(n_pad, dtype=jnp.int32)[:, None]
    )
    d = jnp.where(self_or_bad, INF, d)
    new_i, new_d = _merge_rows(nbr_ids, nbr_dists, cand, d, K, n_valid)
    changed = jnp.sum((new_i != nbr_ids) & (new_i >= 0))
    return new_i, new_d, changed


def build_pynndescent_graph(points: PointSet, bp: BuildParams,
                            verbose: bool = False, polish: bool = True,
                            quantize_build: bool = False):
    """Build the pyNNDescent graph. Returns (GraphIndexData, seconds).

    ``polish``: one exact 2-hop round after the sampled rounds converge.
    Parity study (scripts/diag_pynn_parity.py): the sampled
    pull rounds match the reference push-join on kNN quality (.9996 vs
    .9929 knn-recall@10) but miss ~0.3 borderline entries/row that the
    exhaustive join finds, costing 5-7pp end-to-end recall on
    quasi-uniform data; the exact round recovers it to within ~1.5pp at
    the beam 20-40 operating points.

    ``quantize_build``: run every candidate-distance evaluation (leaf
    all-pairs, descent rounds, exact polish, final undirect prune) on a
    scalar-quantized int8 tier. The descent and polish rounds are
    row-gather bound (a polish chunk fetches (chunk, J*J) vectors), so
    int8 rows cut the build's dominant byte stream 4x; ordering is
    preserved up to quantization (the same tradeoff the Vamana builder
    ships as its default, build_vamana_index)."""
    n, n_pad = points.n, points.n_pad
    K = bp.R
    S = bp.cluster_size
    t0 = time.perf_counter()
    key = jax.random.key(bp.seed)
    build_ps = points
    if quantize_build and build_ps.data.dtype == jnp.float32:
        from parlayann_tpu.ops import quantize

        build_ps = quantize.quantize_pointset(points, bits=8)

    nbr_ids = jnp.full((n_pad, K), -1, dtype=jnp.int32)
    nbr_dists = jnp.full((n_pad, K), INF, dtype=jnp.float32)

    # --- init: cluster trees with all-pairs leaves (clusterPynn.h) ---
    for t in range(max(bp.num_clusters, 1)):
        key, sub = jax.random.split(key)
        ids, labels = cluster_tree_labels(
            build_ps.data, sub, metric=points.metric, cluster_size=S, n_valid=n
        )
        members, sizes = leaf_members(np.asarray(ids), np.asarray(labels), S)
        chunk = max(1, min(len(members), (1 << 24) // (S * S)))
        for lo in range(0, len(members), chunk):
            mem = members[lo : lo + chunk]
            sz = sizes[lo : lo + chunk]
            if len(mem) < chunk:
                pad = chunk - len(mem)
                mem = np.concatenate([mem, np.full((pad, S), -1, np.int32)])
                sz = np.concatenate([sz, np.zeros(pad, np.int32)])
            nbr_ids, nbr_dists = _leaf_topk(
                build_ps.data, jnp.asarray(mem), jnp.asarray(sz),
                nbr_ids, nbr_dists, S=S, K=K, metric=points.metric, n_valid=n,
            )
        if verbose:
            print(f"pynn init: tree {t+1}/{bp.num_clusters}", flush=True)

    # --- nn-descent rounds (pynn_index.h:178-196) ---
    d_dim = points.d
    max_rounds = max(10, int(np.ceil(np.log2(max(d_dim, 2)))))
    delta = bp.delta if bp.delta > 0 else 0.05
    s1 = s2 = 16
    for r in range(max_rounds):
        key, k1, k2 = jax.random.split(key, 3)
        rev = _reverse_capped(nbr_ids, k1, K=K, metric=points.metric, n_valid=n)
        nbr_ids, nbr_dists, changed = _descent_round(
            build_ps.data, nbr_ids, nbr_dists, rev, k2,
            s1=s1, s2=s2, K=K, metric=points.metric, n_valid=n,
        )
        ch = int(changed)
        if verbose:
            print(f"pynn round {r}: changed {ch}", flush=True)
        if ch < delta * n:
            break

    # --- exact 2-hop polish round (see build_pynndescent_graph doc) ---
    if polish:
        key, kp = jax.random.split(key)
        rev = _reverse_capped(nbr_ids, kp, K=K, metric=points.metric,
                              n_valid=n)
        nbr_ids, nbr_dists, chp = _descent_round_exact(
            build_ps.data, nbr_ids, nbr_dists, rev,
            K=K, metric=points.metric, n_valid=n)
        if verbose:
            print(f"pynn exact polish: changed {int(chp)}", flush=True)

    # --- undirect + alpha prune (pynn_index.h:198-239) ---
    key, k3 = jax.random.split(key)
    rev = _reverse_capped(nbr_ids, k3, K=K, metric=points.metric, n_valid=n)
    rev_safe = jnp.clip(rev, 0, n_pad - 1)
    me = build_ps.data.astype(jnp.float32)
    rev_d = distance.gathered(
        me, jnp.take(build_ps.data, rev_safe, axis=0).astype(jnp.float32),
        points.metric,
    )
    rev_d = jnp.where(rev >= 0, rev_d, INF)
    cand_ids = jnp.concatenate([nbr_ids, rev], axis=1)
    cand_d = jnp.concatenate([nbr_dists, rev_d], axis=1)
    pr = robust_prune_chunked(
        jnp.arange(n_pad, dtype=jnp.int32), cand_ids, cand_d, build_ps.data,
        bp.alpha if bp.alpha > 0 else 1.2,
        R=K, metric=points.metric, n_valid=n,
    )
    g = GraphIndexData(
        neighbors=pr.ids, degrees=pr.degree, n=n, max_degree=K
    )
    _ = int(jnp.sum(g.degrees))  # readback fence
    return g, time.perf_counter() - t0


def build_pynndescent_index(
    data,
    metric: Metric = Metric.L2,
    K: int = 40,
    cluster_size: int = 100,
    num_clusters: int = 10,
    alpha: float = 1.2,
    delta: float = 0.05,
    verbose: bool = False,
    seed: int = 0,
    quantize_build: bool = False,
):
    """Convenience wrapper (python/builder.cpp:158-184; defaults from
    docs/algorithms.md:110-114)."""
    metric = Metric.coerce(metric)
    ps = data if isinstance(data, PointSet) else PointSet.from_numpy(
        np.asarray(data), metric=metric
    )
    bp = BuildParams(
        R=K, cluster_size=cluster_size, num_clusters=num_clusters,
        alpha=alpha, delta=delta, seed=seed,
    )
    g, dt = build_pynndescent_graph(ps, bp, verbose=verbose,
                                    quantize_build=quantize_build)
    return g, ps, dt
