"""Reverse-edge exchange — the bidirect phase of batch insertion.

Reference: vamana/index.h:278-300 — flatten (target, source) pairs,
``group_by_key`` semisort, then per target either append (if the row stays
within the degree bound) or robustPrune with the union.

Data-parallel redesign: the semisort becomes one batched sort of the
edge list by (target, distance); group boundaries come from
first-occurrence flags + cumulative-scan segment bounds
(utils.arrays.segment_bounds — XLA's searchsorted costs log2(n) serial
gather rounds). Per-target work is then edge-row-centric with static
shapes:

  * append path (old_deg + count <= R): sort-based set-union of the old row
    and the new sources (the reference's add_neighbors_without_repeats,
    index.h:141-147 — order-free because rows are distance-sorted only at
    the end of build, index.h:180-185). Ids only — no vector gathers.
  * prune path (overflow): full robustPrune over old-row ∪ new-sources with
    carried distances. Overflow rows are compacted to the front of a
    priority permutation; ``prepare_reverse_append`` returns that
    permutation plus the exact overflow count so the *host* dispatches
    ``ceil(n_overflow / chunk)`` fixed-shape ``prune_reverse_chunk`` steps —
    every overflow target gets the true α-prune (index.h:289-300
    semantics), unlike round 1's budget-capped sort-truncate fallback.

Sorting edges by (target, dist) means each group's first ``cap`` members are
the *closest* new sources, so capping group width loses only the farthest.

``exchange_reverse_edges`` (below) keeps the fused single-call form for
HNSW, whose overflow rule really is sort-truncate (HNSW.hpp:940-988).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from parlayann_tpu.types import Metric
from parlayann_tpu.ops import distance
from parlayann_tpu.ops.distance import INF
from parlayann_tpu.build.prune import robust_prune_chunked, sort_dedup_candidates
from parlayann_tpu.utils.arrays import segment_bounds


def scatter_rows(nbrs, degs, wt, new_ids, new_deg, sorted_targets=False):
    """Write row ``new_ids[i]``/``new_deg[i]`` at vertex ``wt[i]``
    (wt == n_pad rows are dropped; targets must be unique).

    Default lowering is the XLA row scatter: an A/B (diag_build_trace,
    100K batch=4096) found the scatter FASTER than the scatter-free
    sort+searchsorted+full-rewrite alternative (per-chunk full-array
    rewrites dominate): XLA lowers unique whole-row scatters to dynamic
    row stores.
    PARLAYANN_SCATTER=0 selects the rewrite lowering for future A/B."""
    import os

    if os.environ.get("PARLAYANN_SCATTER", "1") == "1":
        nbrs = nbrs.at[wt].set(new_ids, mode="drop")
        degs = degs.at[wt].set(new_deg, mode="drop")
        return nbrs, degs
    n_pad = nbrs.shape[0]
    m = wt.shape[0]
    if sorted_targets:
        st, sidx = wt, jnp.arange(m, dtype=jnp.int32)
    else:
        st, sidx = jax.lax.sort(
            (wt, jnp.arange(m, dtype=jnp.int32)), num_keys=1
        )
    vtx = jnp.arange(n_pad, dtype=jnp.int32)
    fpos = jnp.clip(
        jnp.searchsorted(st, vtx, side="left").astype(jnp.int32), 0, m - 1
    )
    hit = jnp.take(st, fpos) == vtx
    src = jnp.take(sidx, fpos)
    nbrs = jnp.where(hit[:, None], jnp.take(new_ids, src, axis=0), nbrs)
    degs = jnp.where(hit, jnp.take(new_deg, src), degs)
    return nbrs, degs


class ReverseStats(NamedTuple):
    n_groups: jax.Array  # unique targets touched
    n_overflow: jax.Array  # targets that needed robustPrune
    n_fallback: jax.Array  # overflow targets beyond the prune budget


class ReverseCtx(NamedTuple):
    """Sorted-edge context handed from the append step to the prune chunks.

    All arrays are length M = B*R (the flattened edge list, sorted by
    (target, dist)). ``perm`` lists edge-row positions with overflow
    group-first rows compacted to the front — LARGE overflow groups
    (count > small_cap) first, then small ones — so the prune pass can run
    a wide-candidate program on the few large targets and a narrow one on
    the ~90% small targets (the α-occlusion cost is ~C² per row, so the
    split is worth ~2.5x on the overflow phase).
    """

    perm: jax.Array  # (M,) int32 priority permutation
    s_tgt: jax.Array  # (M,) sorted targets (n_pad = invalid)
    s_src: jax.Array  # (M,) sources, sorted alongside
    s_dist: jax.Array  # (M,) edge distances, sorted alongside
    count: jax.Array  # (M,) group size at each sorted position
    n_overflow: jax.Array  # () int32 — total overflow targets
    n_large: jax.Array  # () int32 — overflow targets with count > small_cap
    n_append: jax.Array  # () int32 — non-overflow targets (append rows)


def prepare_reverse_append(
    nbrs: jax.Array,  # (n_pad, R)
    degs: jax.Array,  # (n_pad,)
    batch_ids: jax.Array,  # (B,) source vertices (-1 = inactive)
    sel_ids: jax.Array,  # (B, R) their new out-edges (-1 padded)
    sel_dists: jax.Array,  # (B, R) edge distances (symmetric metrics)
    *,
    R: int,
    n_valid: int,
    cap: int = 0,
    small_cap: int = 8,
):
    """Semisort edges, append into non-overflowing targets (ids only, no
    vector traffic), and return the overflow context for the prune chunks.
    ``small_cap``: overflow targets with at most this many incoming edges
    sort after the large ones so they can be pruned with a narrow
    candidate width (see ReverseCtx).
    """
    B = batch_ids.shape[0]
    M = B * R
    n_pad = nbrs.shape[0]
    cap = cap if cap > 0 else R

    tgt = sel_ids.reshape(M)
    src = jnp.repeat(batch_ids, R)
    dist = sel_dists.reshape(M)
    valid = (tgt >= 0) & (src >= 0) & (dist < INF)
    tgt_key = jnp.where(valid, tgt, n_pad).astype(jnp.int32)

    # semisort: one batched sort by (target, distance) (index.h:278-282)
    s_tgt, s_dist, s_src = jax.lax.sort(
        (tgt_key, dist, src), num_keys=2, is_stable=True
    )
    s_valid = s_tgt < n_pad

    pos = jnp.arange(M, dtype=jnp.int32)
    fo = jnp.concatenate([jnp.ones(1, bool), s_tgt[1:] != s_tgt[:-1]]) & s_valid
    left, right = segment_bounds(s_tgt)
    count = right - left  # true group size
    old_deg_all = jnp.take(degs, jnp.clip(s_tgt, 0, n_pad - 1), axis=0)
    total = old_deg_all + count
    overflow = total > R

    is_large = fo & overflow & (count > small_cap)
    prio = jnp.where(
        is_large, 0,
        jnp.where(fo & overflow, 1, jnp.where(fo, 2, 3)),
    ).astype(jnp.int32)
    _, perm = jax.lax.sort((prio, pos), num_keys=1, is_stable=True)
    n_overflow = jnp.sum(fo & overflow).astype(jnp.int32)
    n_large = jnp.sum(is_large).astype(jnp.int32)
    n_append = jnp.sum(fo & ~overflow).astype(jnp.int32)

    # ---- append pass: chunked over the compacted append rows (perm
    # positions [n_overflow, n_overflow + n_append)), dead chunks skipped
    # by lax.cond. A full-M-width union would mostly be waste: only ~1/8
    # of M's rows are appends ----
    perm_pad = jnp.concatenate([perm, jnp.zeros((M,), jnp.int32)])
    jcol = jnp.arange(cap, dtype=jnp.int32)[None, :]
    app_chunk = min(32768, M)
    n_app_chunks = -(-M // app_chunk)

    def append_chunk(nb, dg, off):
        prows = jax.lax.dynamic_slice(perm_pad, (n_overflow + off,),
                                      (app_chunk,))
        pmask = (off + jnp.arange(app_chunk, dtype=jnp.int32)) < n_append
        pr_safe = jnp.clip(prows, 0, M - 1)
        t = jnp.where(pmask, s_tgt[pr_safe], n_pad)
        t_safe = jnp.clip(t, 0, n_pad - 1)
        old_row = jnp.take(nb, t_safe, axis=0)
        odeg = jnp.take(dg, t_safe, axis=0)
        old_ok = (jnp.arange(R, dtype=jnp.int32)[None, :] < odeg[:, None]) \
            & pmask[:, None]
        gidx = jnp.clip(prows[:, None] + jcol, 0, M - 1)
        g_src = s_src[gidx]
        g_ok = (jcol < jnp.minimum(count[pr_safe], cap)[:, None]) & (
            (prows[:, None] + jcol) < M) & pmask[:, None]
        app_ids, app_deg = _union_rows(old_row, old_ok, g_src, g_ok,
                                       n_valid, R)
        wt = jnp.where(pmask, t, n_pad)
        return scatter_rows(nb, dg, wt, app_ids, app_deg)

    # while_loop over LIVE chunks only: a lax.cond skip still copies the
    # carried (n_pad, R) graph through the identity branch — a
    # while_loop never runs the dead tail
    del n_app_chunks

    def append_body(st):
        nb, dg, off = st
        nb, dg = append_chunk(nb, dg, off)
        return nb, dg, off + app_chunk

    nbrs, degs, _ = jax.lax.while_loop(
        lambda st: st[2] < n_append, append_body,
        (nbrs, degs, jnp.zeros((), jnp.int32)),
    )

    ctx = ReverseCtx(perm, s_tgt, s_src, s_dist, count, n_overflow, n_large,
                     n_append)
    stats = ReverseStats(
        n_groups=jnp.sum(fo),
        n_overflow=n_overflow,
        n_fallback=jnp.zeros((), jnp.int32),
    )
    return nbrs, degs, ctx, stats


def prune_reverse_all(
    nbrs: jax.Array,
    degs: jax.Array,
    ctx: ReverseCtx,
    points_data: jax.Array,
    alpha,
    *,
    R: int,
    metric: Metric,
    n_valid: int,
    chunk: int = 4096,
    cap: int = 0,
    small_cap: int = 8,
):
    """α-prune EVERY overflow target, inside one trace: lax.scans over the
    static worst-case chunk schedules where chunks past the live range are
    skipped by a traced ``lax.cond`` (all-or-nothing per chunk, so the
    skip costs nothing at runtime). No host round-trips per batch.

    Two scans: the first ``ctx.n_large`` perm rows (count > small_cap) run
    with the full candidate width C = R + cap; the remaining small
    overflow rows run with C = R + small_cap. ~90% of overflow targets
    have <= 8 incoming edges (measured on synth100k), and the occlusion
    kernel's per-row cost is ~R*C² — the split cuts the dominant build
    phase ~2.5x with bit-identical results (a small group's members all
    fit the narrow cap by definition)."""
    M = ctx.perm.shape[0]
    chunk = min(chunk, M)
    # the narrow program is ~(R+small)²/(R+cap)² cheaper per row: give it
    # proportionally wider chunks to keep per-chunk cost roughly equal
    cw = cap if cap > 0 else R
    ratio = max(1, ((R + cw) * (R + cw)) // ((R + small_cap) * (R + small_cap)))
    chunk_small = min(chunk * min(ratio, 4), M)
    n_chunks = -(-M // chunk)
    n_chunks_small = -(-M // chunk_small)

    # while_loops over LIVE chunks only (a lax.cond skip copies the
    # carried (n_pad, R) graph through its identity branch, and the
    # static schedule had to assume the all-overflow worst case M)
    del n_chunks, n_chunks_small

    def run(nbrs, degs, lo, hi, width, prune_cap):
        def body(st):
            nb, dg, off = st
            nb, dg = prune_reverse_chunk(
                nb, dg, ctx, off, points_data, alpha,
                R=R, metric=metric, n_valid=n_valid, chunk=width,
                cap=prune_cap, hi=hi,
            )
            return nb, dg, off + width

        nbrs, degs, _ = jax.lax.while_loop(
            lambda st: st[2] < hi, body, (nbrs, degs, lo))
        return nbrs, degs

    nbrs, degs = run(nbrs, degs, jnp.zeros((), jnp.int32), ctx.n_large,
                     chunk, cap)
    nbrs, degs = run(nbrs, degs, ctx.n_large, ctx.n_overflow, chunk_small,
                     small_cap)
    return nbrs, degs


def prune_reverse_chunk(
    nbrs: jax.Array,
    degs: jax.Array,
    ctx: ReverseCtx,
    offset,  # traced int32 scalar: position into ctx.perm
    points_data: jax.Array,
    alpha,
    *,
    R: int,
    metric: Metric,
    n_valid: int,
    chunk: int = 4096,
    cap: int = 0,
    hi=None,
):
    """α-prune ``chunk`` overflow targets starting at ``perm[offset]``
    (index.h:289-300). Rows past ``hi`` (default ``n_overflow``) are
    masked inactive."""
    M = ctx.perm.shape[0]
    n_pad = nbrs.shape[0]
    cap = cap if cap > 0 else R
    jcol = jnp.arange(cap, dtype=jnp.int32)[None, :]

    off = jnp.asarray(offset, jnp.int32)
    prows = jax.lax.dynamic_slice(
        jnp.concatenate([ctx.perm, jnp.zeros((chunk,), jnp.int32)]),
        (off,), (chunk,),
    )
    bound = ctx.n_overflow if hi is None else hi
    pmask = (off + jnp.arange(chunk, dtype=jnp.int32)) < bound
    t = jnp.where(pmask, ctx.s_tgt[jnp.clip(prows, 0, M - 1)], n_pad)
    p_ids = jnp.where(pmask, t, -1)

    gidx = jnp.clip(prows[:, None] + jcol, 0, M - 1)
    g_src = ctx.s_src[gidx]
    g_dist = ctx.s_dist[gidx]
    g_ok = (jcol < jnp.minimum(ctx.count[jnp.clip(prows, 0, M - 1)], cap)[:, None]) & (
        (prows[:, None] + jcol) < M
    ) & pmask[:, None]

    old_row = jnp.take(nbrs, jnp.clip(t, 0, n_pad - 1), axis=0)
    odeg = jnp.take(degs, jnp.clip(t, 0, n_pad - 1), axis=0)
    old_ok = (jnp.arange(R, dtype=jnp.int32)[None, :] < odeg[:, None]) & pmask[:, None]
    t_vec = jnp.take(points_data, jnp.clip(t, 0, points_data.shape[0] - 1), axis=0)
    old_vecs = jnp.take(
        points_data, jnp.clip(old_row, 0, points_data.shape[0] - 1), axis=0
    )
    old_dists = jnp.where(old_ok, distance.gathered(t_vec, old_vecs, metric), INF)
    cand_ids = jnp.concatenate([old_row, g_src], axis=1)
    cand_d = jnp.concatenate([old_dists, jnp.where(g_ok, g_dist, INF)], axis=1)
    pr = robust_prune_chunked(
        p_ids, cand_ids, cand_d, points_data, alpha,
        R=R, metric=metric, n_valid=n_valid, chunk=chunk,
    )
    wt = jnp.where(pmask, t, n_pad)
    nbrs, degs = scatter_rows(nbrs, degs, wt, pr.ids, pr.degree)
    return nbrs, degs


def _union_rows(old_ids, old_valid, new_ids, new_valid, n_valid: int, width: int):
    """Sorted set-union of two padded id rows -> (ids, count), compacted."""
    B = old_ids.shape[0]
    C = old_ids.shape[1] + new_ids.shape[1]
    ids = jnp.concatenate([old_ids, new_ids], axis=1)
    valid = jnp.concatenate([old_valid, new_valid], axis=1)
    sent = n_valid + 1 + jnp.arange(C, dtype=jnp.int32)[None, :]
    key = jnp.where(valid, ids, sent)
    skey = jax.lax.sort(key, dimension=-1)
    dup = jnp.concatenate(
        [jnp.zeros((B, 1), dtype=bool), skey[:, 1:] == skey[:, :-1]], axis=1
    )
    uniq = (skey <= n_valid) & ~dup
    # compact unique ids to the front
    ckey = jnp.where(uniq, skey, sent)
    ckey = jax.lax.sort(
        (jnp.where(uniq, 0, 1).astype(jnp.int32), ckey), num_keys=1, is_stable=True
    )[1]
    return ckey[:, :width], jnp.sum(uniq, axis=1).astype(jnp.int32)


def exchange_reverse_edges(
    nbrs: jax.Array,  # (n_pad, R)
    degs: jax.Array,  # (n_pad,)
    batch_ids: jax.Array,  # (B,) source vertices (-1 = inactive)
    sel_ids: jax.Array,  # (B, R) their new out-edges (-1 padded)
    sel_dists: jax.Array,  # (B, R) edge distances (symmetric metrics)
    points_data: jax.Array,
    alpha,
    *,
    R: int,
    metric: Metric,
    n_valid: int,
    cap: int = 0,
    prune_budget: int = 0,
    chunk: int = 4096,
):
    """Apply reverse edges; returns (nbrs, degs, ReverseStats)."""
    B = batch_ids.shape[0]
    M = B * R
    n_pad = nbrs.shape[0]
    cap = cap if cap > 0 else R
    # prune_budget < 0 => no alpha-prune pass at all: every overflow target
    # takes the sort-truncate path (HNSW's overflow rule, HNSW.hpp:940-988)
    truncate_all = prune_budget < 0
    if truncate_all:
        prune_budget = 1
    prune_budget = prune_budget if prune_budget > 0 else max(2 * B, 1024)
    prune_budget = min(prune_budget, M)

    tgt = sel_ids.reshape(M)
    src = jnp.repeat(batch_ids, R)
    dist = sel_dists.reshape(M)
    valid = (tgt >= 0) & (src >= 0) & (dist < INF)
    tgt_key = jnp.where(valid, tgt, n_pad).astype(jnp.int32)

    # semisort: one batched sort by (target, distance) (index.h:278-282)
    s_tgt, s_dist, s_src = jax.lax.sort(
        (tgt_key, dist, src), num_keys=2, is_stable=True
    )
    s_valid = s_tgt < n_pad

    pos = jnp.arange(M, dtype=jnp.int32)
    fo = jnp.concatenate([jnp.ones(1, bool), s_tgt[1:] != s_tgt[:-1]]) & s_valid
    left, right = segment_bounds(s_tgt)
    count = right - left  # true group size
    old_deg_all = jnp.take(degs, jnp.clip(s_tgt, 0, n_pad - 1), axis=0)
    total = old_deg_all + count
    overflow = total > R

    prio = jnp.where(fo & overflow, 0, jnp.where(fo, 1, 2)).astype(jnp.int32)
    _, perm = jax.lax.sort((prio, pos), num_keys=1, is_stable=True)
    inv = jnp.zeros(M, jnp.int32).at[perm].set(pos)
    if truncate_all:
        fallback = prio == 0
    else:
        fallback = (prio == 0) & (inv >= prune_budget)

    stats = ReverseStats(
        n_groups=jnp.sum(fo),
        n_overflow=jnp.sum(fo & overflow),
        n_fallback=jnp.sum(fallback),
    )

    jcol = jnp.arange(cap, dtype=jnp.int32)[None, :]

    def group_members(rows):
        """(Q,) sorted-positions -> capped group (src ids, dists, valid)."""
        gidx = jnp.clip(rows[:, None] + jcol, 0, M - 1)
        g_src = s_src[gidx]
        g_dist = s_dist[gidx]
        ok = (jcol < jnp.minimum(count[rows], cap)[:, None]) & (
            (rows[:, None] + jcol) < M
        )
        return g_src, g_dist, ok

    # ---------- append + fallback pass over every edge row (chunked) ----------
    pad_m = (-M) % chunk
    rows_all = jnp.concatenate([pos, jnp.full(pad_m, M - 1, jnp.int32)]) if pad_m else pos
    nch = (M + pad_m) // chunk

    def append_chunk(carry, rows):
        nbrs, degs = carry
        t = s_tgt[rows]
        is_app = (prio[rows] == 1) & fo[rows]
        is_fb = fallback[rows]
        g_src, g_dist, g_ok = group_members(rows)
        old_row = jnp.take(nbrs, jnp.clip(t, 0, n_pad - 1), axis=0)  # (c, R)
        odeg = jnp.take(degs, jnp.clip(t, 0, n_pad - 1), axis=0)
        old_ok = jnp.arange(R, dtype=jnp.int32)[None, :] < odeg[:, None]

        # append: set-union, fits in R by construction (index.h:288-291)
        app_ids, app_deg = _union_rows(old_row, old_ok, g_src, g_ok, n_valid, R)

        # fallback: union sorted by distance, truncated to R
        t_vec = jnp.take(points_data, jnp.clip(t, 0, points_data.shape[0] - 1), axis=0)
        old_vecs = jnp.take(
            points_data, jnp.clip(old_row, 0, points_data.shape[0] - 1), axis=0
        )
        old_dists = jnp.where(
            old_ok, distance.gathered(t_vec, old_vecs, metric), INF
        )
        cand_ids = jnp.concatenate([old_row, g_src], axis=1)
        cand_d = jnp.concatenate([old_dists, jnp.where(g_ok, g_dist, INF)], axis=1)
        fb_ids, fb_d = sort_dedup_candidates(cand_ids, cand_d, n_valid)
        fb_ids = jnp.where(fb_d[:, :R] < INF, fb_ids[:, :R], -1)
        fb_deg = jnp.sum(fb_ids >= 0, axis=1).astype(jnp.int32)

        write = is_app | is_fb
        out_ids = jnp.where(is_fb[:, None], fb_ids, app_ids)
        out_deg = jnp.where(is_fb, fb_deg, app_deg)
        wt = jnp.where(write, t, n_pad)
        nbrs, degs = scatter_rows(nbrs, degs, wt, out_ids, out_deg)
        return (nbrs, degs), None

    (nbrs, degs), _ = jax.lax.scan(
        append_chunk, (nbrs, degs), rows_all.reshape(nch, chunk)
    )

    # ---------- prune pass over the budgeted overflow rows ----------
    if truncate_all:
        return nbrs, degs, stats
    prows = perm[:prune_budget]
    pmask = prio[prows] == 0
    t = s_tgt[prows]
    p_ids = jnp.where(pmask, t, -1)
    g_src, g_dist, g_ok = group_members(prows)
    old_row = jnp.take(nbrs, jnp.clip(t, 0, n_pad - 1), axis=0)
    odeg = jnp.take(degs, jnp.clip(t, 0, n_pad - 1), axis=0)
    old_ok = jnp.arange(R, dtype=jnp.int32)[None, :] < odeg[:, None]
    t_vec = jnp.take(points_data, jnp.clip(t, 0, points_data.shape[0] - 1), axis=0)
    old_vecs = jnp.take(
        points_data, jnp.clip(old_row, 0, points_data.shape[0] - 1), axis=0
    )
    old_dists = jnp.where(old_ok, distance.gathered(t_vec, old_vecs, metric), INF)
    cand_ids = jnp.concatenate([old_row, g_src], axis=1)
    cand_d = jnp.concatenate([old_dists, jnp.where(g_ok, g_dist, INF)], axis=1)
    pr = robust_prune_chunked(
        p_ids, cand_ids, cand_d, points_data, alpha,
        R=R, metric=metric, n_valid=n_valid, chunk=min(chunk, prune_budget),
    )
    wt = jnp.where(pmask, t, n_pad)
    nbrs, degs = scatter_rows(nbrs, degs, wt, pr.ids, pr.degree)

    return nbrs, degs, stats
