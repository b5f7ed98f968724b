"""Cluster-beam search: the query side of ClusterIndex.

The walk goes one level up from vertices: the beam holds CLUSTERS, and one
expansion scores all m members of a cluster (result candidates) plus its
Rc adjacent-cluster centroids (navigation candidates) at once. Two state
machines per query advance in lock-step over the batch:

  * the cluster beam (Lc = n_probe + 4 lanes: distance, cluster id,
    expanded flag): candidates are the expanded cluster's adjacent
    centroids; dedup compares against the beam (exact: beam eviction is
    permanent — the worst kept entry only improves — so an expanded
    cluster never re-enters and is expanded at most once);
  * the point pool (the best ``pool`` member scores, kept sorted): no
    point dedup is needed at all, because clusters partition the points
    and each cluster is expanded at most once.

``cluster_beam`` is written once and serves both the one-device index
(``cluster_search``) and the cluster-sharded mode
(parallel/cluster_sharded.py), which differ only in how a cluster's
member scores and adjacency are fetched.

Reference counterparts: the two-level QQ filter (beamSearch.h:119-146)
and beam_search_rerank (beamSearch.h:394-454), recast as one structure.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from parlayann_tpu.types import Metric
from parlayann_tpu.ops import distance, quantize
from parlayann_tpu.ops.distance import INF
from parlayann_tpu.search.flat import _select_sort, flat_search_batch
from parlayann_tpu.search.rerank import rerank_topk

# past this many centroid rows the one-tile (B, C) argmin seed stops
# paying (the tile is GBs at C ~ 200K); large-C indexes carry a
# meta-routed seed instead (ClusterIndex.seed_meta)
ARGMIN_SEED_CUTOFF = 32768


def translate_queries(q_full, slope, offset, *, tier_bits: int,
                      metric: Metric):
    """Raw f32 queries -> the tier's domain (graph_index.cpp:144-177)."""
    if tier_bits < 32 and slope is not None:
        if metric is Metric.L2:
            q = quantize.euclidean_translate(q_full, slope, offset,
                                             tier_bits)
        else:
            q = quantize.mips_translate(q_full, slope, offset, tier_bits)
        return q.astype(jnp.float32)
    return q_full.astype(jnp.float32)


def cluster_seed(q, centroids, meta=None, *, metric: Metric, C: int,
                 S: int, seed_mode: str = "argmin", seed_probes: int = 8):
    """Top-S centroids per query -> (dists (B, S) ascending, ids (B, S)).

    ``centroids``: (C_rows, d) in the tier domain (rows >= C ignored).
    ``meta``: optional (mcents, blocks, idtab) coarse router for large C.
    The argmin and stream paths run their matmul at the default precision
    (TF32 on tensor cores): the seed only picks where the walk starts,
    and every member score the search returns is computed exactly."""
    rows = centroids.shape[0]
    if seed_mode == "argmin" and S <= 4 and rows <= ARGMIN_SEED_CUTOFF:
        # small C: one (B, C) tile + S exact argmin passes (reductions
        # only; a per-group sort select costs more at these widths)
        cf = centroids.astype(jnp.float32)
        dot = jax.lax.dot_general(
            q, cf, (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        if metric is Metric.MIPS:
            dall = -dot
        else:
            dall = jnp.sum(cf * cf, axis=1)[None, :] - 2.0 * dot
        cid = jnp.arange(rows, dtype=jnp.int32)[None, :]
        dall = jnp.where(cid < C, dall, INF)
        sd_l, sid_l = [], []
        for _ in range(S):
            am = jnp.argmin(dall, axis=1).astype(jnp.int32)[:, None]
            sd_l.append(jnp.min(dall, axis=1, keepdims=True))
            sid_l.append(am)
            dall = jnp.where(cid == am, INF, dall)
        sd = jnp.concatenate(sd_l, axis=1)
        sids = jnp.concatenate(sid_l, axis=1)
        if metric is not Metric.MIPS:
            qn = jnp.sum(q * q, axis=1, keepdims=True)
            sd = jnp.where(sd < INF, jnp.maximum(sd + qn, 0.0), INF)
        return sd, sids
    if meta is not None and seed_mode in ("argmin", "meta"):
        # big C, meta-routed: scan the ~C/16 meta-centroids, score only
        # the top-P cells' centroid blocks, take the exact top-S within
        # them (the same approximation family as the build's
        # approx_assign, build/clusterindex.py)
        mcents, blocks, idtab = meta
        Cm = blocks.shape[0]
        P = max(1, min(seed_probes, Cm))
        mt_i, _ = flat_search_batch(
            q, mcents, k=P, metric=metric, n_valid=Cm,
            chunk=min(mcents.shape[0], 32768), select="sort",
        )
        ds_l, id_l = [], []
        for p in range(P):
            mi = jnp.clip(mt_i[:, p], 0, Cm - 1)
            dp = distance.gathered(q, jnp.take(blocks, mi, axis=0), metric)
            ip = jnp.take(idtab, mi, axis=0)
            dp = jnp.where((ip >= 0) & (mt_i[:, p:p + 1] >= 0), dp, INF)
            ds_l.append(dp)
            id_l.append(jnp.where(ip >= 0, ip, -1))
        return _select_sort(
            jnp.concatenate(ds_l, axis=1), jnp.concatenate(id_l, axis=1), S
        )
    # big C without a router: streamed exact top-S, the (B, C) tile never
    # materializes
    sids, sd = flat_search_batch(
        q, centroids, k=S, metric=metric, n_valid=C,
        chunk=min(rows, 8192), select="sort",
    )
    return sd, sids


def cluster_beam(q, seed_d, seed_ids, centroids, fetch, *, metric: Metric,
                 C: int, n_points: int, n_probe: int, min_probe: int,
                 cut: float, pool: int):
    """The cluster-beam loop -> (pool dists (B, pool) ascending, pool ids
    (B, pool), probes (B,)).

    ``fetch(e, act)`` -> (member dists (B, m), member ids (B, m), adjacent
    cluster ids (B, Rc)) for the clusters ``e`` (B,) being expanded by the
    rows ``act``. Adjacent clusters are scored here against
    ``centroids`` (C_rows, d), the tier-domain centroids.

    Stopping: a query expands at most ``n_probe`` clusters; with
    ``cut > 0`` (metric spaces only) it stops once no unexpanded beam
    entry is within ``cut`` x the best centroid distance seen, after a
    floor of ``min_probe`` expansions. The nearest seed is always
    expanded first."""
    B = q.shape[0]
    W = n_probe + 4  # an expanded entry holds its lane for good
    S = min(seed_ids.shape[1], W)
    lane = jnp.arange(W, dtype=jnp.int32)[None, :]
    pad = W - S
    cbd = jnp.concatenate(
        [seed_d[:, :S], jnp.full((B, pad), INF, jnp.float32)], axis=1)
    cbi = jnp.concatenate(
        [seed_ids[:, :S].astype(jnp.int32),
         jnp.full((B, pad), -1, jnp.int32)], axis=1)
    cbi = jnp.where(cbd < INF, cbi, -1)
    cbx = jnp.zeros((B, W), bool)
    pd = jnp.full((B, pool), INF, jnp.float32)
    pi = jnp.full((B, pool), -1, jnp.int32)
    nv = jnp.zeros((B,), jnp.int32)
    floor = max(min_probe, 1)

    def pick(cbd, cbi, cbx, nv):
        """First workable lane -> (cluster to expand (B,) or -1, lane)."""
        workable = ~cbx & (cbd < INF)
        if cut > 0.0 and metric.is_metric:
            workable &= (cbd < cut * cbd[:, :1]) | (nv[:, None] < floor)
        first = jnp.argmax(workable, axis=1).astype(jnp.int32)
        e = jnp.take_along_axis(cbi, first[:, None], axis=1)[:, 0]
        e = jnp.where(jnp.any(workable, axis=1) & (nv < n_probe), e, -1)
        return e, first

    def body(state):
        cbd, cbi, cbx, pd, pi, nv, e, first = state
        act = e >= 0
        md, mid, aid = fetch(e, act)

        # members -> point pool: one stable sort keeps the best `pool`
        ok = act[:, None] & (mid >= 0) & (mid < n_points)
        md = jnp.where(ok, md, INF)
        mid = jnp.where(ok, mid, -1)
        pd2, pi2 = jax.lax.sort(
            (jnp.concatenate([pd, md], axis=1),
             jnp.concatenate([pi, mid], axis=1)),
            num_keys=1, is_stable=True)
        pd2, pi2 = pd2[:, :pool], pi2[:, :pool]

        # adjacent clusters -> cluster beam (dedup against the beam)
        avalid = act[:, None] & (aid >= 0) & (aid < C)
        avec = jnp.take(centroids, jnp.clip(aid, 0, centroids.shape[0] - 1),
                        axis=0)
        ad = distance.gathered(q, avec, metric)
        dup = jnp.any(aid[:, :, None] == cbi[:, None, :], axis=2)
        ad = jnp.where(avalid & ~dup, ad, INF)
        aid = jnp.where(ad < INF, aid, -1)
        cbx_e = cbx | ((lane == first[:, None]) & act[:, None])
        nd, ni, nx = jax.lax.sort(
            (jnp.concatenate([cbd, ad], axis=1),
             jnp.concatenate([cbi, aid], axis=1),
             jnp.concatenate([cbx_e, jnp.zeros(aid.shape, bool)],
                             axis=1).astype(jnp.int32)),
            num_keys=1, is_stable=True)

        sel = act[:, None]
        cbd2 = jnp.where(sel, nd[:, :W], cbd)
        cbi2 = jnp.where(sel, ni[:, :W], cbi)
        cbx2 = jnp.where(sel, nx[:, :W] > 0, cbx)
        pd2 = jnp.where(sel, pd2, pd)
        pi2 = jnp.where(sel, pi2, pi)
        nv2 = nv + act.astype(jnp.int32)
        e2, first2 = pick(cbd2, cbi2, cbx2, nv2)
        e2 = jnp.where(act, e2, -1)  # a stopped query stays stopped
        return cbd2, cbi2, cbx2, pd2, pi2, nv2, e2, first2

    e0, first0 = pick(cbd, cbi, cbx, nv)
    state = (cbd, cbi, cbx, pd, pi, nv, e0, first0)
    state = jax.lax.while_loop(lambda s: jnp.any(s[6] >= 0), body, state)
    _, _, _, pd, pi, nv, _, _ = state
    return pd, pi, nv


@partial(
    jax.jit,
    static_argnames=("metric", "C", "m", "Rc", "n_points", "k", "n_probe",
                     "cut", "S", "pool", "tier_bits", "rerank", "min_probe",
                     "seed_mode", "seed_probes"),
)
def cluster_search(
    q_full,  # (B, d) raw f32 queries
    centroids_q,  # (C, d) centroids in the tier domain (int8 or f32)
    mvecs,  # (C, m, d) member vectors in the tier domain
    mids,  # (C, m) int32 member ids (-1 pad)
    adj,  # (C, Rc) int32 adjacent clusters (-1 pad)
    points_full,  # (n_pad, d) full precision (rerank)
    slope, offset,  # q8 domain params (None in the f32 layout)
    meta=None,  # optional (mcents, blocks, idtab) meta-routed seed
    *,
    metric: Metric,
    C: int,
    m: int,
    Rc: int,
    n_points: int,
    k: int = 10,
    n_probe: int = 8,
    min_probe: int = 0,
    cut: float = 0.0,
    S: int = 2,
    pool: int = 20,
    tier_bits: int = 8,
    rerank: str = "full",
    seed_mode: str = "argmin",
    seed_probes: int = 8,
):
    """One-device cluster search -> (ids (B,k), dists (B,k), (n_probes
    (B,), dist_cmps (B,))). ``rerank="full"`` re-scores the best ``pool``
    members at full precision; ``rerank="tier"`` returns the pool's own
    scores (exact in the f32 layout; int8-domain otherwise)."""
    q = translate_queries(q_full, slope, offset, tier_bits=tier_bits,
                          metric=metric)
    with jax.named_scope("cluster_seed"):
        sd, sids = cluster_seed(q, centroids_q, meta, metric=metric, C=C,
                                S=S, seed_mode=seed_mode,
                                seed_probes=seed_probes)

    def fetch(e, act):
        ec = jnp.clip(e, 0, mvecs.shape[0] - 1)
        md = distance.gathered(q, jnp.take(mvecs, ec, axis=0), metric)
        return md, jnp.take(mids, ec, axis=0), jnp.take(adj, ec, axis=0)

    width = k if rerank == "tier" else max(pool, k)
    with jax.named_scope("cluster_beam"):
        pd, pi, nv = cluster_beam(
            q, sd, sids, centroids_q, fetch, metric=metric, C=C,
            n_points=n_points, n_probe=n_probe, min_probe=min_probe,
            cut=cut, pool=width)
    if rerank == "tier":
        ids, dists = pi[:, :k], pd[:, :k]
    else:
        ids, dists = rerank_topk(q_full.astype(jnp.float32), points_full, pi,
                                 k=k, pool=width, metric=metric)
    return ids, dists, (nv, C + nv * (m + Rc))
