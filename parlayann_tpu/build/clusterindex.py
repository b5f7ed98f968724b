"""Cluster index: a two-level structure (build side).

Why this exists: a vertex-level graph beam is bounded below by its
termination rule — every beam entry inside the cut threshold must be
expanded, one dependent step each, so a k=10 search costs ~L>=10
lock-step rounds no matter how dense the graph (measured: R=64 and R=96
graphs need the same ~12 rounds).

So move the walk one level up: partition the points into clusters of m
(~64), store each cluster's member vectors contiguously (one (m, d) row
block) with its member ids and its Rc nearest clusters, and beam over
CLUSTERS (search/cluster.py). One expansion scores m result candidates
plus Rc navigation candidates. The result pool (point top-k) is fed as a
side effect and needs no expansions of its own, so the termination rule
prices expansions in clusters: ~4-6 rounds instead of ~12. Clusters
partition the points, so the point pool needs NO dedup at all (a cluster
is expanded at most once — the cluster beam dedups ids).

This is the DiskANN sector-layout idea (one read = one
neighborhood-sized payload) fused with an IVF partition. Reference
counterparts: the two-level QQ filter search (beamSearch.h:119-146) and
PointRange re-quantization (point_range.h), composed into one structure
rather than translated.

Build = k-means (matmul Lloyd iterations) + capacity-balanced assignment +
centroid k-NN adjacency + one gather into the member blocks: a few
full-data matmul scans, no graph refinement loop — seconds, not minutes.

Scope: like every IVF-family structure, this needs data with cluster
structure (real-world embedding distributions). On uniform high-dim
gaussians all pairwise distances concentrate, a query's true top-k
scatters across hundreds of cells, and recall ≈ fraction of points
probed (measured .06 at 32 probes on uniform 20K; the centroid cut
never triggers because distance ratios concentrate near 1). Use the
graph indexes for such data — they degrade gracefully, this degrades
to brute force.
"""

from __future__ import annotations

import dataclasses
import functools
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from parlayann_tpu.types import Metric
from parlayann_tpu.data.pointset import PointSet
from parlayann_tpu.ops import distance, quantize
from parlayann_tpu.ops.distance import INF
from parlayann_tpu.search.flat import flat_search_batch, _select_sort

from parlayann_tpu.utils.arrays import pow2 as _pow2


def _kmeans_chunk_for(C: int) -> int:
    """Point-chunk width keeping the (chunk, C) f32 distance tile under
    ~256 MB (one transient tile per lax.map step)."""
    step = 16384
    while step > 512 and step * max(C, 1) * 4 > 256 << 20:
        step //= 2
    return step


@partial(jax.jit, static_argnames=("C", "k", "metric", "n", "step"))
def _assign_all_jit(data_pad, cents, *, C, k, metric, n, step):
    """Nearest-k centroids for every point -> ((nc, step, k) ids, dists).
    ONE dispatch: a lax.map over static point chunks (each a matmul
    scan) — no per-chunk host loop."""
    nc = data_pad.shape[0] // step

    def one(blk):
        return flat_search_batch(
            blk, cents, k=k, metric=metric, n_valid=C,
            chunk=min(cents.shape[0], 32768), select="sort",
        )

    return jax.lax.map(one, data_pad.reshape(nc, step, -1))


@partial(jax.jit, static_argnames=("n", "n_pad"))
def _slice_pad_jit(data, *, n, n_pad):
    # fused under jit: ONE output buffer (eager slice-then-pad holds two
    # transient full copies — 9.6 GiB at 10M)
    return jnp.pad(data[:n], ((0, n_pad - n), (0, 0)))


def _pad_rows(data_f32, n: int, n_pad: int) -> jax.Array:
    """Slice/pad ``data_f32`` to exactly ``n_pad`` rows WITHOUT copying
    when the shape already matches — at 10M points every full copy is
    4.8 GiB of HBM, and the round-2 one-copy-per-callee discipline
    (build copy + kmeans pad + assign pad all live at once) ran out of
    device memory at that scale. Rows >= n are masked/discarded by callers."""
    data_f32 = jnp.asarray(data_f32)
    rows = data_f32.shape[0]
    if rows == n_pad:
        return data_f32
    if rows > n_pad:
        return data_f32[:n_pad]
    return _slice_pad_jit(data_f32, n=n, n_pad=n_pad)


def _pad_to_step(data_f32, n: int, step: int):
    """-> (padded view, n_pad): rows = a multiple of ``step`` covering n.
    Reuses the input buffer (with its LARGER row count) when it already
    qualifies: a ``[:n_pad]`` jnp slice ALLOCATES — at 10M the slice was
    a 4.8 GiB device copy living alongside its source for the whole
    build, and the respill stage OOM'd on the lost headroom. Extra pad
    rows are masked/discarded by every caller (2% extra scan compute at
    worst).

    CONTRACT: rows in [n, rows) of the returned buffer are LIVE
    IN-DISTRIBUTION GARBAGE (the reuse path keeps whatever the caller's
    buffer held there; `_pad_rows` zeros only what it itself pads), so
    every consumer MUST mask by row index (the `valid = base + row0 < n`
    term in `_kmeans_jit`) — never reduce over the buffer unmasked."""
    data_f32 = jnp.asarray(data_f32)
    rows = data_f32.shape[0]
    n_pad = -(-n // step) * step
    if rows >= n_pad and rows % step == 0:
        return data_f32, rows
    return _pad_rows(data_f32, n, n_pad), n_pad


def _hbm_log(tag: str) -> None:
    """Device-memory print for verbose builds (silent where the backend
    reports no memory statistics, e.g. the CPU)."""
    s = jax.local_devices()[0].memory_stats()
    if s and "bytes_in_use" in s:
        print(f"[hbm {tag}] {s['bytes_in_use'] / 2**30:.2f} GiB in use "
              f"(peak {s.get('peak_bytes_in_use', 0) / 2**30:.2f})",
              flush=True)


def _assign_all(data_f32, n, cents, C, k, metric, step=0):
    """Nearest-k centroids per point -> (ids (n, k), dists (n, k)) numpy."""
    step = step or _kmeans_chunk_for(cents.shape[0])
    data_pad, n_pad = _pad_to_step(data_f32, n, step)
    ids, ds = _assign_all_jit(
        data_pad, cents, C=C, k=k, metric=metric, n=n, step=step,
    )
    return (np.asarray(ids).reshape(n_pad, k)[:n],
            np.asarray(ds).reshape(n_pad, k)[:n])


# ---- hierarchical (meta-clustered) assignment ----------------------------
#
# The exact nearest-k centroid scan is O(n*C*d): at 10M points and
# C = 234K micro-clusters that is ~600 TFLOP *per pass* — the flat Lloyd
# loop stops being computable (the 10M attempt ran for minutes and
# never finished). Standard IVF practice at this ratio (C = n/43) is a
# coarse quantizer over the centroids; here the coarse level reuses the
# index's own machinery: cluster the C centroids into Cm ~ C/96 balanced
# meta-cells (exact kmeans — C is small), pack each cell's member
# centroids into ONE contiguous (cap, d) block, and assign a point by
# scanning the Cm meta-centroids (matmul flat scan) then scoring only its
# top-P cells' blocks (one row gather per cell). Cost per pass: n*Cm*d
# (scan) + n*P*cap*d (blocks) ~ 1/40th of exact at 10M.

def _meta_sizes(C: int, meta_m: int) -> tuple[int, int]:
    """-> (Cm meta-cell count, cap block capacity). cap carries 40%
    headroom over the mean cell size so balance_assign displaces little."""
    Cm = max(8, int(-(-C * 1.25 // meta_m)))
    cap = -(-int(C / Cm * 1.4 + 1) // 8) * 8
    while Cm * cap < C + Cm:
        cap += 8
    return Cm, cap


def _meta_quantizer(cents, C: int, metric: Metric, *, meta_m: int = 96,
                    seed: int = 0, iters: int = 4):
    """Cluster the C centroids into balanced meta-cells.
    -> (mcents (Cm, d) f32, blocks (Cm, cap, d) f32, idtab (Cm, cap) i32).

    The cell balance MUST respill: its overflow path dumps centroids
    into arbitrary (emptiest) cells, where the router never finds them —
    an arbitrary-celled centroid is INVISIBLE to every point it should
    win. Recentering rounds concentrate centroids onto dense blobs,
    which drives cell overflow up, which loses more centroids, which
    makes the next round's geometry worse: measured 1M router top-1
    agreement 82% -> 45% -> 41% over three rounds (2026-08-20) before
    this respill; the nearest-free-cell relocation keeps cells
    geometric and the router honest."""
    Cm, cap = _meta_sizes(C, meta_m)
    cj = jnp.asarray(cents, dtype=jnp.float32)[:C]
    mcents = kmeans(cj, C, Cm, metric=metric, iters=iters, seed=seed)
    ids, dd = _assign_all(cj, C, mcents, Cm, min(8, Cm), metric)
    memm = balance_assign(ids, dd, Cm, cap)
    memm = _respill_local(cj, C, memm, ids, mcents, Cm, cap, metric)
    mcents = _recenter(cj, memm, Cm)  # centers of the balanced cells
    mm = jnp.asarray(memm)
    blocks = jnp.take(
        cj, jnp.clip(mm, 0, C - 1).reshape(-1), axis=0
    ).reshape(Cm, cap, cj.shape[1])
    blocks = jnp.where((mm >= 0)[:, :, None], blocks, 0.0)
    return mcents, blocks, mm


@partial(jax.jit, static_argnames=("k", "P", "metric", "step"))
def _approx_assign_jit(data_pad, mcents, blocks, idtab, *, k, P, metric,
                       step):
    """Meta-routed nearest-k centroids -> ((nc, step, k) ids, dists)."""
    nc = data_pad.shape[0] // step
    Cm, cap, d = blocks.shape

    def one(blk):
        qf = blk.astype(jnp.float32)
        mt_i, _ = flat_search_batch(
            qf, mcents, k=P, metric=metric, n_valid=Cm,
            chunk=min(Cm, 32768), select="sort",
        )
        ds, ids = [], []
        for p in range(P):
            mi = jnp.clip(mt_i[:, p], 0, Cm - 1)
            dp = distance.gathered(qf, jnp.take(blocks, mi, axis=0),
                                   metric)
            ip = jnp.take(idtab, mi, axis=0)
            dp = jnp.where((ip >= 0) & (mt_i[:, p:p + 1] >= 0), dp, INF)
            ds.append(dp)
            ids.append(jnp.where(ip >= 0, ip, -1))
        sd, si = _select_sort(
            jnp.concatenate(ds, axis=1), jnp.concatenate(ids, axis=1), k
        )
        return si, sd

    return jax.lax.map(one, data_pad.reshape(nc, step, -1))


def approx_assign(data_f32, n, cents, C, k, metric, *, P=2, meta_m=96,
                  seed=0, quantizer=None):
    """Hierarchical nearest-k centroids -> (ids (n, k), dists (n, k)).
    Same contract as ``_assign_all`` (exact squared L2 against the true
    centroids — only the CANDIDATE SET is meta-restricted to the point's
    top-P cells). ``quantizer``: a precomputed ``_meta_quantizer`` result
    (mcents, blocks, idtab) — pass it when assigning many chunks against
    the SAME centroids so the meta k-means runs once, not per chunk."""
    mcents, blocks, idtab = quantizer if quantizer is not None else (
        _meta_quantizer(cents, C, metric, meta_m=meta_m, seed=seed)
    )
    step = _kmeans_chunk_for(blocks.shape[0])
    data_pad, n_pad = _pad_to_step(data_f32, n, step)
    ids, ds = _approx_assign_jit(
        data_pad, mcents, blocks, idtab, k=k, P=P, metric=metric, step=step,
    )
    return (np.asarray(ids).reshape(n_pad, k)[:n],
            np.asarray(ds).reshape(n_pad, k)[:n])


@partial(jax.jit, static_argnames=("C", "n", "iters", "metric", "step"))
def _kmeans_jit(data_pad, init_cents, *, C, n, iters, metric, step):
    """Full Lloyd loop in ONE dispatch. Assignment = chunked matmul flat
    scans (lax.map); update = chunked one-hot matmuls. Pad rows (>= n)
    are masked out of the update. Empty clusters keep their previous
    centroid. All matmuls run at the default precision (TF32 on tensor
    cores): they only place centroids, which the search never returns."""
    n_pad, d = data_pad.shape
    nc = n_pad // step
    chunks = data_pad.reshape(nc, step, d)
    row0 = jnp.arange(step, dtype=jnp.int32)

    def one_iter(_, cents):
        def chunk_stats(carry, xc):
            blk, base = xc
            # groupmin is EXACT at k=1 (the global min is some group's
            # min) and the per-group reduction fuses into the matmul
            # epilogue — the sort-based select materialized the
            # (step, C) tile
            aid = flat_search_batch(
                blk, cents, k=1, metric=metric, n_valid=C,
                chunk=min(cents.shape[0], 32768), select="groupmin",
            )[0][:, 0]
            valid = (base + row0) < n
            oh = (
                (aid[:, None] == jnp.arange(C, dtype=jnp.int32)[None, :])
                & valid[:, None]
            ).astype(jnp.float32)
            sums = jax.lax.dot_general(
                oh, blk, (((0,), (0,)), ((), ())),
                preferred_element_type=jnp.float32,
            )
            return (carry[0] + sums, carry[1] + jnp.sum(oh, axis=0)), None

        bases = jnp.arange(nc, dtype=jnp.int32) * step
        (sums, cnts), _ = jax.lax.scan(
            chunk_stats,
            (jnp.zeros((C, d), jnp.float32), jnp.zeros((C,), jnp.float32)),
            (chunks, bases),
        )
        new = sums / jnp.maximum(cnts, 1.0)[:, None]
        return jnp.where((cnts > 0)[:, None], new, cents)

    return jax.lax.fori_loop(0, iters, one_iter, init_cents)


def kmeans(data_f32, n: int, C: int, *, metric: Metric, iters: int = 6,
           seed: int = 0, step: int = 0) -> jax.Array:
    """Lloyd k-means -> (C, d) f32 centroids, one fused device program."""
    rng = np.random.default_rng(seed)
    cents = jnp.take(
        data_f32, jnp.asarray(rng.choice(n, C, replace=False)), axis=0
    ).astype(jnp.float32)
    step = step or _kmeans_chunk_for(C)
    n_pad = -(-n // step) * step
    data_pad = _pad_rows(data_f32, n, n_pad)
    return _kmeans_jit(
        data_pad, cents, C=C, n=n, iters=iters, metric=metric, step=step,
    )


def balance_assign(nbr_ids: np.ndarray, nbr_d: np.ndarray, C: int,
                   m: int) -> np.ndarray:
    """Capacity-balanced assignment -> members (C, m) int32, -1 padded.

    Round j places every still-unplaced point at its j-th choice centroid
    if capacity remains, accepting by distance priority within each
    cluster (everyone's first choice is honored before anyone's second —
    BFS over choice ranks). Points whose k candidates are all full spill
    to the emptiest clusters. The member layout holds a FIXED m slots per
    cluster, so the cap is hard. Fully vectorized numpy (k argsort
    passes), ~O(n k log n): the Python-loop version cost ~15 s at 1M.
    """
    n, kk = nbr_ids.shape
    order = np.argsort(nbr_d[:, 0], kind="stable").astype(np.int64)
    # native C++ path (native/balance.cpp): bit-identical semantics,
    # ~10-50x faster at 10M (this loop is the build's host hot spot)
    from parlayann_tpu import native as _native

    nm = _native.balance_assign(nbr_ids, order, C, m)
    if nm is not None:
        return nm
    members = np.full((C, m), -1, np.int32)
    fill = np.zeros(C, np.int64)
    pending = order  # in priority order, invariant kept per round
    for j in range(kk):
        if not len(pending):
            break
        c = nbr_ids[pending, j].astype(np.int64)
        valid = c >= 0
        # group by cluster, keep priority order within each group
        sidx = np.argsort(c, kind="stable")
        cs = c[sidx]
        newgrp = np.r_[True, cs[1:] != cs[:-1]]
        grp_start = np.maximum.accumulate(
            np.where(newgrp, np.arange(len(cs)), 0)
        )
        rank = np.arange(len(cs)) - grp_start
        cap = np.where(valid[sidx], m - fill[np.clip(cs, 0, C - 1)], 0)
        acc = rank < cap
        pts = pending[sidx[acc]]
        cacc = cs[acc]
        slot = fill[cacc] + rank[acc]
        members[cacc, slot] = pts
        fill += np.bincount(cacc, minlength=C)
        keep = np.ones(len(pending), bool)
        keep[sidx[acc]] = False
        pending = pending[keep]
    if len(pending):
        # spill: fill the emptiest clusters' free slots in order
        free_c = np.repeat(np.arange(C), m - fill)
        assert len(free_c) >= len(pending), "capacity < n (slack too low)"
        # emptiest first
        free_c = free_c[np.argsort(fill[free_c], kind="stable")]
        take = free_c[: len(pending)]
        for c_ in np.unique(take):
            idx = np.flatnonzero(take == c_)
            members[c_, fill[c_]: fill[c_] + len(idx)] = pending[idx]
            fill[c_] += len(idx)
    return members


def _mask_spilled(members: np.ndarray, nbr_ids: np.ndarray) -> np.ndarray:
    """-1 out member slots whose point was SPILL-placed — its cluster is
    not among its candidate centroids (balance_assign's overflow path) —
    so recentering tracks local density only. Points accepted at a
    lower-rank candidate stay: they are still near their centroid."""
    C, m = members.shape
    pts = members.reshape(-1)
    cl = np.repeat(np.arange(C, dtype=np.int32), m)
    inlist = np.zeros(len(pts), bool)
    v = np.flatnonzero(pts >= 0)
    inlist[v] = (nbr_ids[pts[v]] == cl[v, None]).any(axis=1)
    return np.where(inlist.reshape(C, m), members, -1)


def _respill_local(data_f32, n, members, nbr_ids, cents, C, m, metric,
                   *, verbose=False):
    """Re-place SPILLED points into their NEAREST cluster with free
    capacity -> members (C, m).

    balance_assign's overflow path dumps points whose candidate clusters
    are all full into the globally EMPTIEST clusters — arbitrary
    geometry. A query never probes an arbitrary cluster, so coverage
    (and recall ceiling) ≈ 1 - spill_rate: the 1.6M/10M hier collapse
    (recall flat ~.62/.47, diag_hier_repro.py) was a 34% spill. Here the
    spilled points are searched against the free-capacity clusters only
    and placed by the same distance-priority rank rounds, widening the
    candidate count until everyone fits (total capacity = slack*n >= n
    guarantees termination)."""
    local = _mask_spilled(members, nbr_ids)
    n_spill = int((members >= 0).sum() - (local >= 0).sum())
    if n_spill == 0:
        return members
    smask = (members >= 0) & (local < 0)
    pending = members[smask].astype(np.int64)
    members = local
    # compact each row's survivors left (slot order is not meaningful)
    ordr = np.argsort(members < 0, axis=1, kind="stable")
    members = np.take_along_axis(members, ordr, axis=1)
    fill = (members >= 0).sum(axis=1).astype(np.int64)
    cents = jnp.asarray(cents, dtype=jnp.float32)
    k = 8
    it = 0
    while len(pending):
        it += 1
        free = np.flatnonzero(fill < m).astype(np.int32)
        kk = int(min(k, len(free)))
        sub = jnp.take(cents, jnp.asarray(free), axis=0)
        # chunk the pending gather+assign: at 10M-scale spills (millions
        # of points) an unchunked pvec plus its step-padded copy is
        # multiple GiB of transient HBM on top of the data itself
        ch = 1 << 21
        # (sub, free) are fixed for the whole pass: build the meta
        # quantizer ONCE, not per chunk (the per-chunk rebuild reran
        # exact kmeans over up to ~234K free centroids every 2M points)
        quant = (_meta_quantizer(sub, len(free), metric, seed=it)
                 if float(min(ch, len(pending))) * len(free) > 4e10
                 else None)
        if quant is None:
            # FIXED-SHAPE passes: bucket the free-centroid count and the
            # pending list to powers of two. The raw data-dependent
            # shapes recompiled _assign_all once per pass per build (the
            # whole uniform-vs-clustered build gap at 100K: the FLOPs are
            # identical, clustered data just never spills). Centroid pad
            # rows sit at 1e15 so their distances (~1e32) can never be
            # selected.
            Cf = 1 << max(3, int(len(free) - 1).bit_length())
            sub = jnp.concatenate(
                [sub, jnp.full((Cf - len(free), sub.shape[1]), 1e15,
                               sub.dtype)], axis=0)
            npend = 1 << max(10, int(len(pending) - 1).bit_length())
            pend_pad = np.pad(pending, (0, npend - len(pending)),
                              mode="edge")
        else:
            pend_pad = pending
        ids_l, d_l = [], []
        for off in range(0, len(pend_pad), ch):
            pc = pend_pad[off:off + ch]
            pvec = jnp.take(data_f32, jnp.asarray(pc, dtype=np.int32),
                            axis=0)
            if quant is not None and float(len(pc)) * len(free) > 4e10:
                i_, d_ = approx_assign(pvec, len(pc), sub, len(free),
                                       kk, metric, seed=it, quantizer=quant)
            else:
                i_, d_ = _assign_all(pvec, len(pc), sub, int(sub.shape[0]),
                                     kk, metric)
            ids_l.append(i_)
            d_l.append(d_)
        ids = np.concatenate(ids_l)[: len(pending)]
        d = np.concatenate(d_l)[: len(pending)]
        gids = free[np.clip(ids, 0, len(free) - 1)]
        gids = np.where((ids >= 0) & (ids < len(free)), gids,
                        -1).astype(np.int64)
        order = np.argsort(d[:, 0], kind="stable")
        placed = np.zeros(len(pending), bool)
        for j in range(kk):
            rem = order[~placed[order]]
            if not len(rem):
                break
            c = gids[rem, j]
            valid = c >= 0
            sidx = np.argsort(c, kind="stable")
            cs = c[sidx]
            newgrp = np.r_[True, cs[1:] != cs[:-1]]
            grp_start = np.maximum.accumulate(
                np.where(newgrp, np.arange(len(cs)), 0)
            )
            rank = np.arange(len(cs)) - grp_start
            cap = np.where(valid[sidx], m - fill[np.clip(cs, 0, C - 1)], 0)
            acc = rank < cap
            cacc = cs[acc]
            slot = fill[cacc] + rank[acc]
            members[cacc, slot] = pending[rem[sidx[acc]]]
            fill += np.bincount(cacc, minlength=C)
            placed[rem[sidx[acc]]] = True
        if verbose:
            print(f"respill pass {it} (k={kk}): {n_spill} -> "
                  f"{int((~placed).sum())} left", flush=True)
        if not placed.any() and kk >= min(1024, len(free)):
            # no progress at the widest candidate set the selector
            # supports (k <= 1024, search/flat._select_sort): place the
            # pathological tail into the emptiest free slots directly —
            # termination over locality for a vanishing fraction
            pending = pending[~placed]
            free_c = np.repeat(np.arange(C), m - fill)
            free_c = free_c[np.argsort(fill[free_c], kind="stable")]
            take = free_c[: len(pending)]
            for c_ in np.unique(take):
                idx = np.flatnonzero(take == c_)
                members[c_, fill[c_]: fill[c_] + len(idx)] = pending[idx]
                fill[c_] += len(idx)
            pending = pending[:0]
            break
        pending = pending[~placed]
        k = min(k * 4, 1024)
    return members


@partial(jax.jit, static_argnames=("block",))
def _assigned_dist_jit(data_f32, cents, pt2c, *, block):
    """Chunked ||x_i - c_assign(i)||^2 -> (n_pad,) f32."""
    n_pad = pt2c.shape[0]

    def one(idx):
        x = jnp.take(data_f32, idx, axis=0)
        c = jnp.take(cents, jnp.clip(jnp.take(pt2c, idx), 0, None), axis=0)
        d = x - c
        return jnp.sum(d * d, axis=1)

    ids = jnp.arange(n_pad, dtype=jnp.int32).reshape(n_pad // block, block)
    return jax.lax.map(one, ids).reshape(n_pad)


def _polish_misassigned(data_f32, n, members: np.ndarray, cents, C: int,
                        m: int, metric: Metric, *, frac: float = 0.15,
                        kc: int = 8, verbose: bool = False) -> np.ndarray:
    """EXACT-reassignment polish for the router's error tail -> members.

    The hier build assigns through a meta-restricted candidate router
    whose top-1 accuracy tops out ~.92 at 10M — the ~8% of points that
    never saw their true nearest centroids get balanced into far
    clusters no query probes, and that error is the measured probe-FLAT
    recall ceiling (exact-seed .9533 at slack 2.0 while coverage-style
    accounting predicted higher). Misrouted points are conspicuous: their
    assigned-centroid distance is inflated. So: flag the worst ``frac``
    by assigned distance, EXACT-scan only the flagged subset against all
    C centroids (a tail scan is ~frac of the full O(n C d) Lloyd pass —
    seconds, not minutes), and move each flagged point into its exact
    nearest cluster WITH FREE CAPACITY by the same distance-priority
    rank rounds the balancer uses. Points whose exact candidates are all
    full fall back to their current (vacated) slot — capacity-displaced,
    not misrouted — via a last-priority candidate column; only the rare
    mover whose vacated slot was meanwhile taken by a sibling mover
    lands in the emptiest free cluster."""
    pt2c = np.full(data_f32.shape[0], -1, np.int32)
    rowsc = np.repeat(np.arange(C, dtype=np.int32), members.shape[1])
    vmask = members.reshape(-1) >= 0
    pt2c[members.reshape(-1)[vmask]] = rowsc[vmask]
    block = 1 << 16  # largest pow2 <= 64K dividing the row count
    while block > 8 and data_f32.shape[0] % block:
        block //= 2
    if data_f32.shape[0] % block:
        block = 1
    ad = np.asarray(_assigned_dist_jit(
        data_f32, jnp.asarray(cents), jnp.asarray(pt2c), block=block,
    ))[:n]
    qidx = int(n * (1 - frac))
    thr = np.partition(ad, qidx)[qidx]
    flagged = np.flatnonzero((ad >= thr) & (pt2c[:n] >= 0)).astype(np.int64)
    if not len(flagged):
        return members
    # exact scan in query-sized batches through the SAME streamed
    # flat-search config the stream seed uses (chunk=8192 group sorts)
    # rather than _assign_all's (step, C) tile pattern, which at C=312K
    # sorts very wide rows (see search/flat._select_sort)
    cj = jnp.asarray(cents)
    eb = 16384
    ids_l, d_l = [], []
    fl_pad = np.pad(flagged, (0, (-len(flagged)) % eb), mode="edge")
    for off in range(0, len(fl_pad), eb):
        fvb = jnp.take(data_f32,
                       jnp.asarray(fl_pad[off:off + eb], np.int32), axis=0)
        ib, db = flat_search_batch(
            fvb, cj, k=kc, metric=metric, n_valid=C,
            chunk=min(cj.shape[0], 8192), select="sort",
        )
        ids_l.append(np.asarray(ib))
        d_l.append(np.asarray(db))
    eids = np.concatenate(ids_l)[: len(flagged)]
    ed = np.concatenate(d_l)[: len(flagged)]
    movers = eids[:, 0] != pt2c[flagged]
    flagged = flagged[movers]
    eids, ed = eids[movers], ed[movers]
    if not len(flagged):
        return members
    # free the movers' current slots (compact rows left), then rank-round
    # placement into their exact candidates under capacity; the mover's
    # CURRENT cluster is appended as a last-priority candidate column:
    # its vacated slot is router-chosen and near, strictly
    # better than an arbitrary emptiest cluster, so a mover whose exact
    # candidates are all full returns home unless siblings took the slot
    eids = np.concatenate(
        [eids, pt2c[flagged][:, None].astype(eids.dtype)], axis=1)
    is_mover = np.zeros(data_f32.shape[0], bool)
    is_mover[flagged] = True
    keep = ~((members >= 0) & is_mover[np.clip(members, 0, None)])
    members = np.where(keep, members, -1)
    ordr = np.argsort(members < 0, axis=1, kind="stable")
    members = np.take_along_axis(members, ordr, axis=1)
    fill = (members >= 0).sum(axis=1).astype(np.int64)
    order = np.argsort(ed[:, 0], kind="stable")
    placed = np.zeros(len(flagged), bool)
    for j in range(eids.shape[1]):
        rem = order[~placed[order]]
        if not len(rem):
            break
        c = eids[rem, j].astype(np.int64)
        valid = c >= 0
        sidx = np.argsort(c, kind="stable")
        cs = c[sidx]
        newgrp = np.r_[True, cs[1:] != cs[:-1]]
        grp_start = np.maximum.accumulate(
            np.where(newgrp, np.arange(len(cs)), 0))
        rank = np.arange(len(cs)) - grp_start
        cap = np.where(valid[sidx], m - fill[np.clip(cs, 0, C - 1)], 0)
        acc = rank < cap
        cacc = cs[acc]
        slot = fill[cacc] + rank[acc]
        members[cacc, slot] = flagged[rem[sidx[acc]]]
        fill += np.bincount(cacc, minlength=C)
        placed[rem[sidx[acc]]] = True
    if not placed.all():
        # candidates full: emptiest free slots (same fallback family as
        # the respill tail; these are capacity-displaced, tiny fraction)
        pending = flagged[~placed]
        free_c = np.repeat(np.arange(C), m - fill)
        free_c = free_c[np.argsort(fill[free_c], kind="stable")]
        take = free_c[: len(pending)]
        for c_ in np.unique(take):
            idx = np.flatnonzero(take == c_)
            members[c_, fill[c_]: fill[c_] + len(idx)] = pending[idx]
            fill[c_] += len(idx)
    if verbose:
        print(f"polish: flagged {len(ad) and int((ad >= thr).sum())} "
              f"moved {int(placed.sum())} fallback "
              f"{int((~placed).sum())}", flush=True)
    return members


def _teleport_centroids(data_f32, cents, nbr_ids: np.ndarray,
                        nbr_d: np.ndarray, C: int,
                        m: int) -> tuple[jax.Array, int]:
    """Capacity-aware empty-cluster reseeding -> (cents, n_moved).

    TRIAL-balance at the true capacity m to find genuine starvation: the
    spill-placed points of a cap-m balance are exactly the mass no
    centroid region can absorb (per-cluster fill>m over-counts — a hot
    centroid's excess usually fits its blob SIBLINGS' slack, and the
    first teleport design moved 66K centroids on that signal, draining
    sparse regions into a NEW 13% spill; measured 10M 2026-08-20).
    Each starved region (keyed by the spilled points' nearest centroid)
    requests ceil(spill_mass/m) extra centroids; donors are cap-m-
    underfull clusters in no-spill regions; a donated centroid lands ON
    one of the region's spilled points (evenly spread), so the next
    round's assignment covers exactly the uncovered mass.

    This is k-means empty-cluster handling made capacity-aware: Lloyd
    means move by local gradients and cannot jump between well-separated
    dense regions, so seed-starved regions otherwise stay starved no
    matter how many rounds run (the 10M 62%-final-spill mode)."""
    trial = balance_assign(nbr_ids, nbr_d, C, m)
    local = _mask_spilled(trial, nbr_ids)
    smask = (trial >= 0) & (local < 0)
    sp_pts = trial[smask].astype(np.int64)
    if not len(sp_pts):
        return cents, 0
    region = nbr_ids[sp_pts, 0].astype(np.int64)
    ok = region >= 0
    sp_pts, region = sp_pts[ok], region[ok]
    spill_mass = np.bincount(region, minlength=C)
    need = -(-spill_mass // m)  # extra centroids per starved region
    fill = (local >= 0).sum(axis=1).astype(np.int64)
    # a donor must be TRULY redundant: trial-fill == 0 means no point
    # chose it within capacity at any candidate rank, so removing it
    # uncovers nothing. fill < m/2 looked spare but stole LOAD-BEARING
    # second centroids of modest blobs (a mass-90 blob trial-fills
    # (64, 26); taking the 26 uncovers 26 points) — measured 10M
    # 2026-08-20: 42.6K such donors re-created a 1.13M spill next round.
    donors = np.flatnonzero((fill == 0) & (need == 0))
    if not len(donors) or not need.any():
        return cents, 0
    # receivers grouped by region, largest spill first; k-th donation to
    # a region lands on an evenly-spread k-th spilled point of it
    reg_ids = np.flatnonzero(need > 0)
    reg_ids = reg_ids[np.argsort(-spill_mass[reg_ids], kind="stable")]
    lens = need[reg_ids]
    receivers = np.repeat(reg_ids, lens)
    ends = np.cumsum(lens)
    occ = np.arange(len(receivers)) - np.repeat(ends - lens, lens)
    order = np.argsort(region, kind="stable")
    sp_sorted = sp_pts[order]
    reg_sorted = region[order]
    starts = np.searchsorted(reg_sorted, np.arange(C))
    nmove = int(min(len(donors), len(receivers)))
    recv = receivers[:nmove]
    occ = occ[:nmove]
    don = donors[:nmove].astype(np.int64)
    nrep = np.repeat(lens, lens)[:nmove]
    pts = sp_sorted[starts[recv]
                    + (occ * spill_mass[recv]) // np.maximum(nrep, 1)]
    newv = jnp.take(data_f32, jnp.asarray(pts, dtype=jnp.int32), axis=0)
    cents = jnp.asarray(cents).at[jnp.asarray(don, dtype=jnp.int32)].set(
        newv
    )
    return cents, int(len(don))


@partial(jax.jit, static_argnames=("block",))
def _recenter_jit(data_f32, mm, *, block):
    n = data_f32.shape[0]
    Cp, m = mm.shape

    def one(mb):
        mv = jnp.take(
            data_f32, jnp.clip(mb, 0, n - 1).reshape(-1), axis=0
        ).reshape(block, m, -1)
        ok = (mb >= 0)[:, :, None]
        return jnp.sum(jnp.where(ok, mv, 0.0), axis=1) / jnp.maximum(
            jnp.sum(ok, axis=1), 1.0
        )

    return jax.lax.map(one, mm.reshape(Cp // block, block, m)).reshape(
        Cp, -1
    )


def _recenter(data_f32, members: np.ndarray, C: int) -> jax.Array:
    """Exact centroids of the final balanced membership -> (C, d) f32.
    Chunked over cluster blocks: the one-shot (C, m, d) f32 gather is
    ~6.4 GB at 10M points."""
    mm = jnp.asarray(members)
    block = min(8192, C)
    Cp = -(-C // block) * block
    if Cp != C:
        mm = jnp.pad(mm, ((0, Cp - C), (0, 0)), constant_values=-1)
    return _recenter_jit(data_f32, mm, block=block)[:C]


@jax.jit
def _gather_members(data, members):
    """(n_pad, d), (C, m) ids -> (C, m, d) member vectors, zero where the
    slot is empty. One jitted gather+mask, so only the output is
    allocated."""
    vecs = jnp.take(data, jnp.clip(members, 0, data.shape[0] - 1), axis=0)
    return jnp.where((members >= 0)[:, :, None], vecs,
                     jnp.zeros((), data.dtype))


def _f32_layout_fits(points: PointSet, C: int, m: int) -> bool:
    """The f32 member layout (exact pool scores, no rerank gather) costs
    4x the int8 layout. Take it when its (C, m, d) payload fits a quarter
    of the memory limit of the device that holds the points; where the
    backend reports no limit (the CPU), decide by n alone."""
    dev = next(iter(points.data.devices()))
    stats = dev.memory_stats() or {}
    limit = stats.get("bytes_limit")
    if limit is None:
        return points.n < (1 << 24)
    return C * m * points.d * 4 <= limit // 4


@dataclasses.dataclass
class ClusterIndex:
    """Two-level cluster index handle. ``search`` runs the cluster beam
    (search/cluster.py) + full-precision rerank."""

    points: PointSet  # full precision (rerank)
    qpoints: Optional[PointSet]  # q8 domain (None in the f32 layout)
    centroids_q: jax.Array  # (C, d) — the member layout's domain
    members: np.ndarray  # (C, m) int32
    adj: np.ndarray  # (C, Rc) int32
    mvecs: jax.Array  # (C, m, d) int8 or f32 member vectors
    C: int
    m: int
    Rc: int
    ext_dtype: str = "int8"
    # (mcents, blocks, idtab) in the tier domain — the meta-routed
    # query seed for large C (built by _finish past the argmin cutoff)
    seed_meta: Optional[tuple] = None

    @functools.cached_property
    def mids(self) -> jax.Array:
        """(C, m) int32 member ids on device (-1 pad), uploaded once."""
        return jnp.asarray(self.members, jnp.int32)

    @functools.cached_property
    def adj_d(self) -> jax.Array:
        """(C, Rc) int32 adjacency on device (-1 pad), uploaded once."""
        return jnp.asarray(self.adj, jnp.int32)

    @staticmethod
    def build(points: PointSet, *, m: int = 64, Rc: int = 16,
              iters: int = 6, cand: int = 8, slack: float = 1.5,
              seed: int = 0, ext_dtype: str = "auto",
              verbose: bool = False) -> "ClusterIndex":
        """``slack``: cluster-count overprovision. With C = n/m exactly,
        the capacity balancer is forced to fill every cluster and dumps
        boundary points into arbitrary far clusters — measured to cost
        ~7pp of recall ceiling at 20K (true-NN cluster rank p99 went
        145 -> single digits with 25% slack). Displacement RATE is the
        recall ceiling past that (synth100k m=64,
        diag_cluster_sweep_cov): slack 1.25 displaces 22.6% of points and
        caps coverage at .9678 by 8 probes; 1.5 displaces 16% (.9871);
        2.0 displaces 9.4% (.9972 — at ~2x member memory and C scan
        width). 1.5 is the default (.9655 recall at 3 probes on
        synth100k); pass 2.0 for the high-recall regime (.9953 at 8
        probes).

        ``ext_dtype``: the member-vector layout. "f32" stores
        full-precision member vectors, so the pool scores are EXACT (no
        rerank gather, no quantization flips) at ~4x the memory. "int8"
        is the capacity layout (+ q8 tier + f32 rerank). "auto" = f32
        when it fits (``_f32_layout_fits``), else int8."""
        import os as _os
        import time as _time

        n, d = points.n, points.d
        C = max(8, int(-(-n * slack // m)))
        # exact Lloyd is O(n*C*d) per pass: past ~4e10 point-centroid
        # pairs (≈1M x 40K) the flat scans stop being computable on one
        # device (the 10M x 234K attempt never finished) — switch to
        # the meta-routed hierarchical passes (see _meta_quantizer)
        exact_limit = float(_os.environ.get(
            "PARLAYANN_KMEANS_EXACT_LIMIT", "4e10"))
        hier = (float(n) * C) > exact_limit
        meta_m = int(_os.environ.get("PARLAYANN_META_M", "96"))
        step = _kmeans_chunk_for(
            _meta_sizes(C, meta_m)[0] if hier else C
        )
        # ONE padded f32 working copy shared by kmeans/assign/recenter
        # (each callee padding its own copy put 3x 4.8 GiB of data in
        # device memory at 10M and ran out of it); f32 input of the right
        # shape is used as-is
        data, _ = _pad_to_step(
            points.data if points.data.dtype == jnp.float32
            else points.data[:n].astype(jnp.float32),
            n, step,
        )
        # the PARTITION is always L2 (clustering by inner product is
        # degenerate — every point gravitates to the largest-norm
        # centroid; standard IVF-MIPS practice is L2 cells scored by the
        # true metric at query time, which ClusterIndex.search does)
        cmetric = Metric.L2
        if hier:
            # random centroid seeds (standard for fine quantizers at
            # C = O(n/m)), then balanced approximate-Lloyd rounds: each
            # round is the full assign -> balance -> recenter pipeline
            rng = np.random.default_rng(seed)
            cents = jnp.take(
                data,
                jnp.asarray(rng.choice(n, C, replace=False).astype(np.int32)),
                axis=0,
            )
            # 3 rounds default: relaxed -> teleport -> relaxed -> teleport
            # -> shaped; the teleports need a following round to settle
            rounds = max(1, int(_os.environ.get("PARLAYANN_HIER_ROUNDS",
                                                "3")))
            # routing accuracy is the hier path's QUALITY lever, not
            # capacity: at 200K (diag_hier2, 2026-08-20) the exact path
            # covers .991 @16 probes while hier covered .927 at P=2,
            # .954 at P=4, .977 at P=8, .989 at P=16 (recall .849 ->
            # .962) — the meta-restricted candidate set was simply
            # missing the true nearest centroids. P=16 also builds
            # faster end to end: accurate assignment leaves almost
            # nothing to respill.
            P = int(_os.environ.get("PARLAYANN_HIER_P", "16"))
            # The LLOYD rounds must be (near-)unconstrained: the exact
            # path runs 6 free Lloyd iterations and balances ONCE at the
            # end, and that freedom is what lets a centroid MIGRATE into
            # a seed-starved dense region (its mean drifts toward the
            # orphan mass over rounds). Balancing each round at the true
            # capacity m froze that migration — seed-starved regions
            # stayed starved, capacity competition compounded, and 36-42%
            # of points spilled to arbitrary clusters by round 2 (the
            # 10M/1.6M coverage collapse: recall flat ~.47/.62 at any
            # probe count, diag_hier_repro.py). Relaxed round capacity
            # (4m) keeps the recenter means ~true Lloyd means while the
            # members table stays the gather machinery.
            m_round = m * int(_os.environ.get("PARLAYANN_HIER_ROUND_CAP",
                                              "4"))
            # Capacity TAPER: the last round balances near the true m.
            # A relaxed (4m) cap everywhere lets one centroid hoard up
            # to 4m points of a dense region and recenter on them; the
            # final m-cap balance then keeps m and spills the rest to
            # arbitrary free clusters (measured 60% spill -> recall
            # flat at .65 on 10M, bench_10m log 2026-08-20). Shaping
            # the LAST round at ~1.5m spreads hoarded mass to its
            # next-nearest candidates so the recentered geometry
            # matches the capacity the final balance actually has.
            shape_mult = float(_os.environ.get(
                "PARLAYANN_HIER_SHAPE_CAP", "1.5"))
            caps = [m_round] * rounds
            if rounds > 1 and shape_mult > 0:
                # clamp: the taper must never RAISE the cap (with
                # ROUND_CAP=1, 1.5m would exceed m_round = m)
                caps[-1] = min(m_round, max(m, int(m * shape_mult)))
            elif rounds == 1 and shape_mult > 0:
                import warnings
                warnings.warn(
                    "PARLAYANN_HIER_ROUNDS=1 gets no capacity taper; "
                    "single-round hier builds risk the measured 60%-spill "
                    "coverage collapse (use rounds >= 2)")
            teleport = _os.environ.get("PARLAYANN_HIER_TELEPORT",
                                       "1") == "1"
            for r in range(rounds):
                t0 = _time.perf_counter()
                cents_in = cents  # assignment target (router probe below)
                nbr_ids, nbr_d = approx_assign(
                    data, n, cents, C, cand, cmetric, P=P, meta_m=meta_m,
                    seed=seed + r,
                )
                members = balance_assign(nbr_ids, nbr_d, C, caps[r])
                # recenter on LOCAL members only: spill-placed points
                # (balance ran out of capacity in all their candidate
                # clusters) land arbitrarily far away and would drag the
                # receiving centroid off its density
                local = _mask_spilled(members, nbr_ids)
                # keep the previous centroid where no local member remains
                # (recenter would emit a zero vector — collapsed centroids
                # at the data mean attract nothing)
                nonempty = jnp.asarray((local >= 0).any(axis=1))
                cents = jnp.where(
                    nonempty[:, None], _recenter(data, local, C), cents
                )
                moved = 0
                if teleport and r < rounds - 1:
                    # capacity-aware TELEPORT (empty-cluster reseeding):
                    # Lloyd means cannot migrate between well-separated
                    # dense regions, so seed-starved blobs stay starved
                    # (measured 10M taper run 2026-08-20: final balance
                    # still spilled 62% — random seeds give ~10% of the
                    # 100-point natural clusters 0-1 of the ~2.3 needed
                    # centroids). A trial cap-m balance finds the truly
                    # uncovered mass; underfull centroids from covered
                    # regions jump onto its spilled points.
                    cents, moved = _teleport_centroids(
                        data, cents, nbr_ids, nbr_d, C, m)
                if verbose:
                    spilled = int((members >= 0).sum() - (local >= 0).sum())
                    # router fidelity probe: exact-assign a 4K sample and
                    # report top-1 agreement + true-top1-in-candidates
                    srng = np.random.default_rng(123 + r)
                    sidx = srng.choice(n, 4096, replace=False)
                    sv = jnp.take(data, jnp.asarray(sidx, np.int32),
                                  axis=0)
                    eids, _ed = _assign_all(sv, 4096, cents_in, C, 1,
                                            cmetric)
                    agree = float(
                        (nbr_ids[sidx, 0] == eids[:, 0]).mean())
                    incand = float(
                        (nbr_ids[sidx, :cand] == eids[:, :1]).any(1)
                        .mean())
                    print(f"hier round {r + 1}/{rounds}: "
                          f"{_time.perf_counter() - t0:.1f}s "
                          f"spilled {spilled} ({spilled / n:.3f})"
                          + (f" teleported {moved}" if moved else "")
                          + f" router top1-agree {agree:.3f}"
                          f" true-top1-in-cand {incand:.3f}",
                          flush=True)
                    _hbm_log(f"hier round {r + 1}")
            # final assignment at the TRUE capacity m, against the
            # settled centroids (mirrors the exact path: kmeans then one
            # balance), then relocate any spill into nearest-with-space
            # clusters (_respill_local) and recenter on the now-all-local
            # membership — the probe ordering needs centroids on the
            # mass they actually hold.
            t0 = _time.perf_counter()
            nbr_ids, nbr_d = approx_assign(
                data, n, cents, C, cand, cmetric, P=P, meta_m=meta_m,
                seed=seed + rounds,
            )
            members = balance_assign(nbr_ids, nbr_d, C, m)
            if verbose:
                _hbm_log("pre-respill")
            members = _respill_local(data, n, members, nbr_ids, cents,
                                     C, m, cmetric, verbose=verbose)
            cents = _recenter(data, members, C)
            # exact-reassignment polish for the router's error tail (the
            # probe-flat recall ceiling at 10M — see _polish_misassigned)
            pfrac = float(_os.environ.get("PARLAYANN_POLISH", "0.15"))
            if pfrac > 0:
                t1 = _time.perf_counter()
                members = _polish_misassigned(
                    data, n, members, cents, C, m, cmetric, frac=pfrac,
                    verbose=verbose,
                )
                cents = _recenter(data, members, C)
                if verbose:
                    print(f"polish: {_time.perf_counter() - t1:.1f}s",
                          flush=True)
            if verbose:
                print(f"hier final: {_time.perf_counter() - t0:.1f}s",
                      flush=True)
                _hbm_log("hier final")
            del nbr_ids, nbr_d
        else:
            cents = kmeans(data, n, C, metric=cmetric, iters=iters,
                           seed=seed, step=step)
            nbr_ids, nbr_d = _assign_all(data, n, cents, C, cand, cmetric,
                                         step=step)
            members = balance_assign(nbr_ids, nbr_d, C, m)
            members = _respill_local(data, n, members, nbr_ids, cents,
                                     C, m, cmetric, verbose=verbose)
            del nbr_ids, nbr_d
            cents = _recenter(data, members, C)
        del data  # free the padded copy before the ext-row packing
        if float(C) * C > exact_limit:
            aid, _ = approx_assign(jnp.asarray(cents), C, cents, C, Rc + 1,
                                   cmetric, meta_m=meta_m, seed=seed + 101)
        else:
            aid, _ = _assign_all(np.asarray(cents), C, cents, C, Rc + 1,
                                 cmetric, step=8192)
        # drop self from the adjacency (it is always the nearest), then
        # compact each row's valid entries left (vectorized — the
        # per-row python loop cost ~15 s at C=234K)
        adj = np.where(
            aid[:, :] == np.arange(C, dtype=aid.dtype)[:, None], -1, aid
        )
        ordr = np.argsort(adj < 0, axis=1, kind="stable")
        adj_list = np.ascontiguousarray(
            np.take_along_axis(adj, ordr, axis=1)[:, :Rc]
        ).astype(np.int32)
        return ClusterIndex._finish(points, members, adj_list, cents,
                                    C, m, Rc, ext_dtype=ext_dtype)

    @staticmethod
    def _finish(points, members, adj, cents, C, m, Rc,
                ext_dtype: str = "auto") -> "ClusterIndex":
        """Lay out the member blocks. int8 mode quantizes points and
        centroids into ONE q8 domain (one query translation serves both
        tiers); f32 mode stores raw vectors (exact scores, no rerank)."""
        import os as _os
        from parlayann_tpu.search import cluster as _cs

        n = points.n
        if ext_dtype == "auto":
            ext_dtype = "f32" if _f32_layout_fits(points, C, m) else "int8"

        def seed_quantizer(cents_tier_f32, blocks_dtype=None):
            # past the argmin cutoff (search/cluster.py: (B, C) tile +
            # argmin passes) the query seed needs a coarse router too:
            # cluster the TIER-DOMAIN centroids once at build so every
            # search scans ~C/16 meta-centroids + top-P cell blocks
            # instead of streaming all C (the streamed scan set a
            # probe-independent QPS ceiling at 10M). L2 partition, same
            # as the build's.
            # ``blocks_dtype=int8``: the cell blocks hold q8-domain
            # integer values, so the int8 cast is exact and quarters the
            # bytes each seed reads.
            if C <= _cs.ARGMIN_SEED_CUTOFF:
                return None
            # FINE cells for the query seed (meta_m=16 vs the build
            # router's 96): the seed's accuracy bounds recall at scale —
            # the measured 10M curve was probe-FLAT at .76 with top-4 of
            # 3052 coarse cells (a wrong-blob seed is unrecoverable by
            # adjacency). The query side scans queries (10K), not points
            # (10M), so an 18K-cell scan is cheap — fine cells put mcents
            # ~on the centroids and the routing error vanishes.
            seed_mm = int(_os.environ.get("PARLAYANN_SEED_META_M", "16"))
            mc, blocks, idt = _meta_quantizer(cents_tier_f32, C, Metric.L2,
                                              meta_m=seed_mm, seed=1009,
                                              iters=3)
            if blocks_dtype is not None:
                blocks = blocks.astype(blocks_dtype)
            return mc, blocks, idt

        mm = jnp.asarray(members, jnp.int32)
        if ext_dtype == "f32":
            data = points.data if points.data.dtype == jnp.float32 else \
                points.data[:n].astype(jnp.float32)
            cf = jnp.asarray(cents, jnp.float32)[:C]
            return ClusterIndex(
                points=points, qpoints=None, centroids_q=cf,
                members=members, adj=adj, mvecs=_gather_members(data, mm),
                C=C, m=m, Rc=Rc, ext_dtype="f32",
                seed_meta=seed_quantizer(cf),
            )
        qps = quantize.quantize_pointset(points, bits=8)
        cq = quantize.euclidean_translate(
            cents, qps.quant_slope, qps.quant_offset, 8
        ) if points.metric is Metric.L2 else quantize.mips_translate(
            cents, qps.quant_slope, qps.quant_offset, 8
        )
        cq = cq[:C]
        return ClusterIndex(
            points=points, qpoints=qps, centroids_q=cq.astype(jnp.int8),
            members=members, adj=adj, mvecs=_gather_members(qps.data, mm),
            C=C, m=m, Rc=Rc, ext_dtype="int8",
            seed_meta=seed_quantizer(cq.astype(jnp.float32),
                                     blocks_dtype=jnp.int8),
        )

    def save(self, path: str) -> None:
        """Persist the structure (members + adjacency only: the packed ext
        rows, centroids, and the q8 tier are deterministic functions of
        (points, members, adj) and are rebuilt at load — the same
        build-or-load convention as the graph indexes, data/io.py)."""
        np.savez(
            path, members=self.members, adj=self.adj,
            m=np.int64(self.m), Rc=np.int64(self.Rc), C=np.int64(self.C),
            n=np.int64(self.points.n), ext_dtype=np.str_(self.ext_dtype),
        )

    @staticmethod
    def load(path: str, points: PointSet) -> "ClusterIndex":
        z = np.load(path if path.endswith(".npz") else path + ".npz")
        members = z["members"].astype(np.int32)
        adj = z["adj"].astype(np.int32)
        C, m, Rc = int(z["C"]), int(z["m"]), int(z["Rc"])
        if int(z["n"]) != points.n:
            raise ValueError(
                f"index was built on n={int(z['n'])}, points have {points.n}"
            )
        # reuse the (possibly padded) buffer: a [:n] slice ALLOCATES a
        # full copy (4.8 GiB at 10M — OOM'd the slack-2.0 load);
        # _recenter gathers by member id < n only
        data = (points.data if points.data.dtype == jnp.float32
                else points.data[: points.n].astype(jnp.float32))
        cents = _recenter(data, members, C)
        ext_dtype = str(z["ext_dtype"]) if "ext_dtype" in z else "int8"
        return ClusterIndex._finish(points, members, adj, cents, C, m, Rc,
                                    ext_dtype=ext_dtype)

    def search_timed(self, queries, *, rounds: int = 1, warmup: bool = True,
                     **kw):
        """Timed steady-state search -> (ids, dists, counters, s/round):
        ``rounds`` back-to-back searches + one fence, as in
        Index.batch_search_timed."""
        import time as _time

        from parlayann_tpu.utils.arrays import as_device

        queries = as_device(queries)
        queries.block_until_ready()
        if warmup:
            jax.block_until_ready(self.search(queries, **kw))
        t0 = _time.perf_counter()
        out = None
        for _ in range(rounds):
            out = self.search(queries, **kw)
        jax.block_until_ready(out)
        dt = (_time.perf_counter() - t0) / rounds
        return (*out, dt)

    def search(self, queries, k: int = 10, *, n_probe: int = 8,
               min_probe: int = 3, cut: float = 1.35, starts: int = 2,
               rerank_factor: int = 2, rerank: str = "auto",
               seed_mode: str = "argmin", seed_probes: int = 8):
        """-> (ids (B, k), dists (B, k), counters). ``n_probe`` bounds
        expansions per query (the visit limit); ``starts`` seeds the
        cluster beam with the exact top-S centroids (one matmul scan over
        all C centroids — C is small). ``rerank="tier"`` skips the
        full-precision gather and returns the member layout's own scores
        (see search/cluster.py).

        The adaptive default (cut=1.35 with a min_probe=3 floor) stops
        each query once the best remaining centroid is > cut x its best
        seen — WITHOUT the floor the cut freezes most queries after 1-2
        probes and costs ~10pp recall on clustered data (measured);
        cut=0.0 disables the rule and always runs n_probe probes."""
        from parlayann_tpu.search.cluster import cluster_search
        from parlayann_tpu.utils.arrays import as_device

        q_full = as_device(queries)
        pool = min(max(k * rerank_factor, k), 128)
        if rerank == "auto":
            # f32 layout: pool scores are already exact full-precision —
            # "tier" is the exact path and skips the rerank gather
            rerank = "tier" if self.ext_dtype == "f32" else "full"
        slope = self.qpoints.quant_slope if self.qpoints else None
        offset = self.qpoints.quant_offset if self.qpoints else None
        bits = self.qpoints.bits if self.qpoints else 32
        meta = None if seed_mode == "stream" else self.seed_meta
        return cluster_search(
            q_full, self.centroids_q, self.mvecs, self.mids, self.adj_d,
            self.points.data, slope, offset, meta,
            metric=self.points.metric, C=self.C, m=self.m, Rc=self.Rc,
            n_points=self.points.n, k=k, n_probe=n_probe,
            min_probe=min_probe, cut=cut, S=starts, pool=pool,
            tier_bits=bits, rerank=rerank, seed_mode=seed_mode,
            seed_probes=seed_probes,
        )
