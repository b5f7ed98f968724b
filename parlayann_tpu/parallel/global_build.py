"""Cross-shard GLOBAL Vamana build + search over a device mesh.

Unlike ``parallel.sharded`` (independent per-shard graphs, merged at query
time), this module builds ONE graph over all n points with rows sharded
over the mesh's ``d`` axis — the true distributed equivalent of the
reference's shared-memory build (vamana/index.h:188-316), with ParlayLib's
``group_by_key`` semisort replaced by collectives over the interconnect
(SURVEY §2, the communication equivalent).

Design (compute-at-data + reduce-scatter):

  * ``points``/``nbrs``/``degs`` are (D, nl, ...) arrays sharded P('d');
    global vertex v lives on shard v // nl, slot v % nl. Neighbor ids are
    GLOBAL.
  * The insert batch shards over 'd' too: each device advances B/D queries.
  * Beam-search step: expand ids are ``all_gather``\\ ed (tiny), every device
    computes neighbor ids + distances for the rows IT OWNS (gathers touch
    only local HBM — the bandwidth-bound part scales with D), and one
    ``psum_scatter`` hands each device exactly its queries' (b, E, R)
    candidate ids + distances. Queries are all-gathered once per batch.
  * Forward robustPrune runs on each device for its b queries; the (b,C,d)
    candidate vectors come through the same all_gather(ids) →
    local-gather → psum_scatter(vectors) exchange. The O(C²) occlusion
    work — the dominant build phase — is fully distributed.
  * Reverse-edge exchange: the (B, R) forward edges are all-gathered
    (replicated edge list ≈ the reference's flatten), every device runs the
    same semisort, then appends/prunes ONLY the targets it owns. This is
    the sort-based all-to-all: the sort is replicated (cheap), the row
    state never leaves its owner.
  * Overflow α-prune: LOAD-BALANCED — the replicated overflow list is
    split round-robin over devices (entry i -> device i % D), bounding
    every device's walk by ceil(n_of/D) regardless of batch skew; the
    target's row/degree/vector and its candidates' vectors come through
    the id-gather/vector-scatter exchange in fixed-shape chunks, results
    return to their owners via one all_gather + owner-masked write.
    Chunk conds key on the replicated total count, so collectives stay
    aligned by construction.

Query-side ``global_search`` reuses the same step pattern with queries
sharded over 'd' (no q axis needed — the graph is global).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from parlayann_tpu.utils.arrays import segment_bounds
from parlayann_tpu.types import BuildParams, Metric
from parlayann_tpu.ops.distance import INF
from parlayann_tpu.search.beam import _merge, _has_work
from parlayann_tpu.build.prune import robust_prune_batch
from parlayann_tpu.build.vamana import batch_schedule, _pad_pow2


def make_mesh_1d(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    n = n_devices if n_devices is not None else len(devs)
    return Mesh(np.array(devs[:n]), ("d",))


@dataclasses.dataclass
class GlobalIndex:
    """One global graph, rows sharded over the 'd' mesh axis."""

    mesh: Mesh
    points: jax.Array  # (D, nl, dim) P('d')
    nbrs: jax.Array  # (D, nl, R) P('d'), GLOBAL neighbor ids
    degs: jax.Array  # (D, nl) P('d')
    n: int
    rows_per_shard: int
    max_degree: int
    metric: Metric
    start_point: int = 0


# ---------------------------------------------------------------------------
# collective helpers (called inside shard_map bodies; axis name 'd')
# ---------------------------------------------------------------------------


def _own_rows(local, gids, shard, nl):
    """Gather local rows for global ids; zeros for ids other shards own."""
    lid = gids - shard * nl
    ok = (lid >= 0) & (lid < nl)
    rows = jnp.take(local, jnp.clip(lid, 0, nl - 1), axis=0)
    extra = (1,) * (rows.ndim - ok.ndim)
    return jnp.where(ok.reshape(ok.shape + extra), rows, 0), ok


def _exchange_rows(local, gids_mine):
    """all_gather ids -> serve owned rows -> psum_scatter back.

    ``gids_mine``: (b, ...) global ids this device needs rows for.
    ``local``: (nl, ...) this device's row shard. Returns (b, ..., row...).
    """
    shard = jax.lax.axis_index("d")
    nl = local.shape[0]
    all_ids = jax.lax.all_gather(gids_mine, "d", axis=0, tiled=True)  # (B,...)
    rows, _ = _own_rows(local, all_ids, shard, nl)
    return jax.lax.psum_scatter(rows, "d", scatter_dimension=0, tiled=True)


def _scatter_owned(local, gids, rows, deg_local, new_deg, shard, nl):
    """Write rows/degrees for ids this shard owns; others drop."""
    lid = gids - shard * nl
    ok = (lid >= 0) & (lid < nl) & (gids >= 0)
    wt = jnp.where(ok, lid, nl)
    local = local.at[wt].set(rows, mode="drop")
    deg_local = deg_local.at[wt].set(new_deg, mode="drop")
    return local, deg_local


# ---------------------------------------------------------------------------
# sharded batched beam search (the global-graph frontier loop)
# ---------------------------------------------------------------------------


def _global_beam(
    pts_l, nbrs_l, degs_l, q_mine, start_ids, self_ids,
    *, metric, n_valid, nl, k, L, R, vmax, record_visited,
):
    """Beam search for this device's (b, d) queries over the global graph.

    Per step the expansion row fetch is the collective exchange; distances
    are computed where the data lives, so each device's HBM gather traffic
    is only its owned share.
    """
    b, dim = q_mine.shape
    shard = jax.lax.axis_index("d")
    q_all = jax.lax.all_gather(q_mine, "d", axis=0, tiled=True)  # (B, dim)
    B = q_all.shape[0]

    def dist_to(vecs, q):
        # (.., d) rows vs (.., d) queries -> broadcast distance
        vf = vecs.astype(jnp.float32)
        qf = q.astype(jnp.float32)
        if metric is Metric.MIPS:
            return -jnp.sum(vf * qf, axis=-1)
        diff = vf - qf
        return jnp.sum(diff * diff, axis=-1)

    def fetch_cand(exp_ids_mine, valid_mine):
        """(b, E) expand ids -> (b, E, R) global cand ids + dists."""
        E = exp_ids_mine.shape[1]
        b_loc = exp_ids_mine.shape[0]
        ids_all = jax.lax.all_gather(exp_ids_mine, "d", axis=0, tiled=True)
        rows, own = _own_rows(nbrs_l, ids_all, shard, nl)  # (B, E, R)
        rdeg, _ = _own_rows(degs_l, ids_all, shard, nl)  # (B, E)
        # step 1: REPLICATE the candidate ids — only the expansion-row owner
        # knows them, and every vector owner needs them to serve distances
        # (+1 so absent contributions sum to 0, not to a valid id 0)
        rows_rep = jax.lax.psum(jnp.where(own[..., None], rows + 1, 0), "d") - 1
        deg_rep = jax.lax.psum(jnp.where(own, rdeg + 1, 0), "d") - 1
        rows_m = rows_rep.reshape(B, E * R)
        # step 2: compute-at-data — each shard serves distances for the
        # candidate VECTORS it owns; psum_scatter sums the disjoint
        # contributions and delivers each querying shard its (b, E*R) rows
        lid = rows_m - shard * nl
        vok = (lid >= 0) & (lid < nl) & (rows_m >= 0)
        vrows = jnp.take(pts_l, jnp.clip(lid, 0, nl - 1), axis=0)
        d = dist_to(vrows, q_all[:, None, :])
        d = jnp.where(vok, d, 0.0)
        d_m = jax.lax.psum_scatter(d, "d", scatter_dimension=0, tiled=True)
        # ids/degrees are replicated: slice this shard's queries
        cand_ids = jax.lax.dynamic_slice_in_dim(rows_m, shard * b_loc, b_loc, 0)
        deg_m = jax.lax.dynamic_slice_in_dim(
            deg_rep.reshape(B, E), shard * b_loc, b_loc, 0
        )
        slot = jnp.tile(jnp.arange(R, dtype=jnp.int32)[None, :], (1, E))
        v = (slot < jnp.repeat(deg_m, R, axis=1)) & (cand_ids >= 0)
        v &= cand_ids < n_valid
        v &= jnp.repeat(valid_mine, R, axis=1)
        if self_ids is not None:
            v &= cand_ids != self_ids[:, None]
        return cand_ids, jnp.where(v, d_m, INF), v

    E = 1
    brow = jnp.arange(L, dtype=jnp.int32)[None, :]

    # seed with the start point(s)
    s_ids = jnp.broadcast_to(start_ids[None, :], (b, start_ids.shape[0]))
    s_vecs = _exchange_rows(pts_l, s_ids)
    s_d = dist_to(s_vecs, q_mine[:, None, :])
    s_ok = (s_ids >= 0) & (s_ids < n_valid)
    beam_ids = jnp.broadcast_to(
        (n_valid + 1 + jnp.arange(L, dtype=jnp.int32))[None, :], (b, L)
    )
    beam_dists = jnp.full((b, L), INF, jnp.float32)
    beam_exp = jnp.zeros((b, L), jnp.int32)
    beam_ids, beam_dists, beam_exp = _merge(
        beam_ids, beam_dists, beam_exp,
        jnp.where(s_ok, s_ids, n_valid + 1), jnp.where(s_ok, s_d, INF), L,
    )
    num_visited = jnp.zeros((b,), jnp.int32)
    done = ~jnp.any(beam_dists < INF, axis=1)

    def body(state):
        beam_ids, beam_dists, beam_exp, num_visited, done = state
        active = ~done
        unexp = (beam_exp == 0) & (beam_dists < INF)
        budget = jnp.where(active, jnp.minimum(E, vmax - num_visited), 0)
        cum = jnp.cumsum(unexp.astype(jnp.int32), axis=1)
        newly = unexp & (cum <= budget[:, None])
        beam_exp = beam_exp + newly.astype(jnp.int32)
        n_new = jnp.sum(newly, axis=1).astype(jnp.int32)
        pos = jnp.argmax(newly, axis=1).astype(jnp.int32)[:, None]
        exp_ids = jnp.take_along_axis(beam_ids, pos, axis=1)
        exp_d = jnp.take_along_axis(beam_dists, pos, axis=1)
        valid_e = n_new[:, None] > 0
        exp_ids_c = jnp.where(valid_e, exp_ids, 0)

        cand_ids, cand_d, _ = fetch_cand(exp_ids_c, valid_e)
        worst = beam_dists[:, L - 1]
        cand_d = jnp.where(cand_d >= worst[:, None], INF, cand_d)
        cand_ids = jnp.where(
            cand_d < INF, cand_ids,
            n_valid + 1 + jnp.arange(E * R, dtype=jnp.int32)[None, :],
        )
        nb_i, nb_d, nb_e = _merge(
            beam_ids, beam_dists, beam_exp, cand_ids, cand_d, L
        )
        nv = num_visited + n_new
        new_done = done | ~_has_work(nb_d, nb_e, k, L, 1.35, metric)
        new_done |= nv >= vmax
        sel = active[:, None]
        out = (
            jnp.where(sel, nb_i, beam_ids),
            jnp.where(sel, nb_d, beam_dists),
            jnp.where(sel, nb_e, beam_exp),
            jnp.where(active, nv, num_visited),
            new_done,
        )
        return out, (exp_ids[:, 0], exp_d[:, 0], valid_e[:, 0] & active)

    state = (beam_ids, beam_dists, beam_exp, num_visited, done)
    if record_visited:
        # converging while_loop with a psum'd done flag (aligned across
        # the mesh), visited entries appended by masked one-hot column
        # writes at each query's own expansion count. The fixed-length
        # scan this replaces always ran vmax steps — and every step
        # carries the per-hop collective exchange, so the loop's
        # interconnect traffic and compute now scale with the ACTUAL
        # convergence hop count (~L) instead of the 3L/2+ bound.
        col = jnp.arange(vmax, dtype=jnp.int32)[None, :]
        vis_ids = jnp.zeros((b, vmax), jnp.int32)
        vis_d = jnp.full((b, vmax), INF, jnp.float32)

        def wcond(st):
            return jax.lax.psum(
                (~st[0][-1]).any().astype(jnp.int32), "d") > 0

        def wbody(st):
            stt, vis_ids, vis_d = st
            nv_old = stt[3]
            new_state, (vi, vd, vok) = body(stt)
            w = (col == nv_old[:, None]) & vok[:, None]
            vis_ids = jnp.where(w, vi[:, None], vis_ids)
            vis_d = jnp.where(w, vd[:, None], vis_d)
            return new_state, vis_ids, vis_d

        state, vis_ids, vis_d = jax.lax.while_loop(
            wcond, wbody, (state, vis_ids, vis_d)
        )
    else:
        # while_loop with a psum'd global done flag (aligned collectives)
        def cond(st):
            return jax.lax.psum((~st[-1]).any().astype(jnp.int32), "d") > 0

        state = jax.lax.while_loop(cond, lambda st: body(st)[0], state)
        vis_ids = jnp.zeros((b, 1), jnp.int32)
        vis_d = jnp.full((b, 1), INF, jnp.float32)

    beam_ids, beam_dists, beam_exp, num_visited, done = state
    beam_ids = jnp.where(beam_dists < INF, beam_ids, -1)
    return beam_ids, beam_dists, vis_ids, vis_d


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------


def _global_insert_step_body(
    pts_l, nbrs_l, degs_l, batch_mine, alpha, start_ids,
    *, R, L, vmax, metric, n_valid, nl, prune_chunks, prune_chunk,
):
    """shard_map body: one prefix-doubling batch, batch sharded over 'd'."""
    shard = jax.lax.axis_index("d")
    D = jax.lax.axis_size("d")
    b = batch_mine.shape[0]
    q_mine = _exchange_rows(pts_l, jnp.maximum(batch_mine, 0))

    # ---- read phase: sharded beam search, visited list recorded ----
    _, _, vis_ids, vis_d = _global_beam(
        pts_l, nbrs_l, degs_l, q_mine, start_ids, batch_mine,
        metric=metric, n_valid=n_valid, nl=nl, k=0, L=L, R=R, vmax=vmax,
        record_visited=True,
    )
    # old out-edges join the candidate set (index.h:70-76)
    old_row = _exchange_rows(nbrs_l, jnp.maximum(batch_mine, 0))  # (b, R)
    odeg = _exchange_rows(degs_l, jnp.maximum(batch_mine, 0))
    old_ok = jnp.arange(R, dtype=jnp.int32)[None, :] < odeg[:, None]
    old_vecs = _exchange_rows(
        pts_l, jnp.clip(old_row, 0, n_valid - 1).reshape(-1)
    ).reshape(b, R, -1)
    qf = q_mine.astype(jnp.float32)[:, None, :]
    of = old_vecs.astype(jnp.float32)
    if metric is Metric.MIPS:
        old_d = -jnp.sum(of * qf, axis=-1)
    else:
        old_d = jnp.sum((of - qf) ** 2, axis=-1)
    old_d = jnp.where(old_ok & (old_row >= 0), old_d, INF)
    cand_ids = jnp.concatenate([vis_ids, old_row], axis=1)
    cand_d = jnp.concatenate([vis_d, old_d], axis=1)

    # ---- forward robustPrune (distributed over the batch) ----
    cand_d = jnp.where((cand_ids >= 0) & (cand_ids < n_valid), cand_d, INF)
    C = cand_ids.shape[1]
    cvecs = _exchange_rows(
        pts_l, jnp.clip(cand_ids, 0, n_valid - 1).reshape(-1)
    ).reshape(b, C, -1)
    pr = _prune_with_vecs(batch_mine, cand_ids, cand_d, cvecs, alpha, R, metric, n_valid)

    # scatter forward rows into their owners (each device holds b rows of
    # the batch; every device must see ALL forward rows to write its own)
    sel_all = jax.lax.all_gather(pr.ids, "d", axis=0, tiled=True)  # (B, R)
    seld_all = jax.lax.all_gather(pr.dists, "d", axis=0, tiled=True)
    deg_all = jax.lax.all_gather(pr.degree, "d", axis=0, tiled=True)
    batch_all = jax.lax.all_gather(batch_mine, "d", axis=0, tiled=True)
    nbrs_l, degs_l = _scatter_owned(
        nbrs_l, batch_all, sel_all, degs_l, deg_all, shard, nl
    )

    # ---- reverse exchange: replicated semisort, owner-masked writes ----
    B = batch_all.shape[0]
    M = B * R
    tgt = sel_all.reshape(M)
    src = jnp.repeat(batch_all, R)
    dist = seld_all.reshape(M)
    valid = (tgt >= 0) & (src >= 0) & (dist < INF)
    sent = n_valid + D * nl  # beyond every shard
    tgt_key = jnp.where(valid, tgt, sent).astype(jnp.int32)
    s_tgt, s_dist, s_src = jax.lax.sort(
        (tgt_key, dist, src), num_keys=2, is_stable=True
    )
    s_valid = s_tgt < sent
    pos = jnp.arange(M, dtype=jnp.int32)
    fo = jnp.concatenate([jnp.ones(1, bool), s_tgt[1:] != s_tgt[:-1]]) & s_valid
    left, right = segment_bounds(s_tgt)
    count = right - left
    lid_t = jnp.clip(s_tgt - shard * nl, 0, nl - 1)
    old_deg_all = jnp.take(degs_l, lid_t, axis=0)
    # degrees live on the owner: broadcast via psum of owner-masked values
    own_t = (s_tgt - shard * nl >= 0) & (s_tgt - shard * nl < nl) & s_valid
    old_deg_all = jax.lax.psum(jnp.where(own_t, old_deg_all, 0), "d")
    overflow = (old_deg_all + count) > R

    # append path: union for non-overflow group-first rows owned here
    cap = R
    jcol = jnp.arange(cap, dtype=jnp.int32)[None, :]
    gidx = jnp.clip(pos[:, None] + jcol, 0, M - 1)
    g_src = s_src[gidx]
    g_ok = (jcol < jnp.minimum(count, cap)[:, None]) & ((pos[:, None] + jcol) < M)
    old_rows = jnp.take(nbrs_l, lid_t, axis=0)
    old_ok2 = jnp.arange(R, dtype=jnp.int32)[None, :] < old_deg_all[:, None]
    from parlayann_tpu.build.reverse import _union_rows

    app_ids, app_deg = _union_rows(old_rows, old_ok2, g_src, g_ok, n_valid, R)
    is_app = fo & ~overflow & own_t
    wt = jnp.where(is_app, s_tgt - shard * nl, nl)
    nbrs_l = nbrs_l.at[wt].set(app_ids, mode="drop")
    degs_l = degs_l.at[wt].set(app_deg, mode="drop")

    # overflow α-prune, LOAD-BALANCED round-robin: the overflow list is
    # REPLICATED (it derives from all-gathered arrays), and device i
    # handles entries i, i+D, i+2D, ... of it. The round-4 design was
    # owner-partitioned — zero traffic for the target's own row/vector,
    # but a skewed batch (every reverse edge landing on one shard) made
    # one device walk up to min(M, nl) targets while the rest ran masked
    # chunks: the 57.8 GB/batch worst-case term of the volume report.
    # Balancing bounds every device's list by
    # ceil(n_of/D), so the worst case equals the typical case D-fold
    # smaller; the price is three small exchanges (target row, degree,
    # vector ~ C-th of the candidate traffic) plus an all_gather of the
    # (chunk, R) results for the owner-masked write-back. Chunk conds key
    # on the REPLICATED total count, so collectives stay aligned by
    # construction.
    is_of = fo & overflow
    prio = jnp.where(is_of, 0, 1).astype(jnp.int32)
    _, perm = jax.lax.sort((prio, pos), num_keys=1, is_stable=True)
    n_of = jnp.sum(is_of).astype(jnp.int32)  # replicated
    n_my_bound = -(-n_of // D)  # ceil: replicated chunk-loop bound

    def prune_one_chunk(carry, off):
        # n_my_bound is replicated across 'd', so every device takes the
        # same branch and the collectives inside stay aligned
        return jax.lax.cond(
            off < n_my_bound, _prune_chunk_real, lambda c, o: (c, None),
            carry, off,
        )

    def _prune_chunk_real(carry, off):
        nbrs_l, degs_l = carry
        # my k-th entry is perm[k * D + shard] (round-robin)
        myk = off + jnp.arange(prune_chunk, dtype=jnp.int32)
        ppos = myk * D + shard
        pmask = ppos < n_of
        prows = jnp.take(perm, jnp.clip(ppos, 0, M - 1))
        rows_c = jnp.clip(prows, 0, M - 1)
        t = jnp.where(pmask, s_tgt[rows_c], sent)
        g_idx = jnp.clip(prows[:, None] + jcol, 0, M - 1)
        gs = s_src[g_idx]
        gd = s_dist[g_idx]
        gok = (jcol < jnp.minimum(count[rows_c], cap)[:, None]) & (
            (prows[:, None] + jcol) < M
        ) & pmask[:, None]
        # the target's graph row / degree / vector live on its OWNER —
        # three thin exchanges (R ints + 1 int + d bytes per target)
        t_c = jnp.clip(t, 0, n_valid - 1)
        o_row = _exchange_rows(nbrs_l, t_c)
        o_deg = jnp.where(pmask, _exchange_rows(degs_l, t_c), 0)
        ook = jnp.arange(R, dtype=jnp.int32)[None, :] < o_deg[:, None]
        tv = _exchange_rows(pts_l, t_c)
        ci = jnp.concatenate([o_row, gs], axis=1)
        # ONE exchange serves both the old-row distance inputs and the
        # prune's candidate vectors (the old rows are ci's first R slots)
        cv = _exchange_rows(
            pts_l, jnp.clip(ci, 0, n_valid - 1).reshape(-1)
        ).reshape(prune_chunk, ci.shape[1], -1)
        tf = tv.astype(jnp.float32)[:, None, :]
        ovf = cv[:, :R].astype(jnp.float32)
        if metric is Metric.MIPS:
            od = -jnp.sum(ovf * tf, axis=-1)
        else:
            od = jnp.sum((ovf - tf) ** 2, axis=-1)
        od = jnp.where(ook & (o_row >= 0), od, INF)
        cd = jnp.concatenate([od, jnp.where(gok, gd, INF)], axis=1)
        p_ids = jnp.where(pmask, t, -1)
        prr = _prune_with_vecs(p_ids, ci, cd, cv, alpha, R, metric, n_valid)
        # write-back at the owner: gather everyone's chunk results, each
        # shard keeps the rows it owns (ids -1 for masked lanes drop)
        t_all2 = jax.lax.all_gather(p_ids, "d", axis=0, tiled=True)
        ids_all2 = jax.lax.all_gather(prr.ids, "d", axis=0, tiled=True)
        deg_all2 = jax.lax.all_gather(prr.degree, "d", axis=0, tiled=True)
        nbrs_l, degs_l = _scatter_owned(
            nbrs_l, t_all2, ids_all2, degs_l, deg_all2, shard, nl
        )
        return (nbrs_l, degs_l), None

    offs = jnp.arange(prune_chunks, dtype=jnp.int32) * prune_chunk
    (nbrs_l, degs_l), _ = jax.lax.scan(prune_one_chunk, (nbrs_l, degs_l), offs)
    return nbrs_l, degs_l


def _prune_with_vecs(p_ids, cand_ids, cand_d, cand_vecs, alpha, R, metric, n_valid):
    """robustPrune where candidate vectors are already materialized (they
    came through the collective exchange, so no further gathers)."""
    from parlayann_tpu.build.prune import (
        sort_dedup_candidates, _occlusion_loop, PruneResult,
    )

    cand_d = jnp.where(cand_ids == p_ids[:, None], INF, cand_d)
    cand_d = jnp.where((cand_ids >= 0) & (cand_ids < n_valid), cand_d, INF)
    # sort (dist, id) with the vectors riding along via a gather-free trick:
    # sort an index payload, then take_along_axis on the vectors
    B, C = cand_ids.shape
    sent = n_valid + jnp.arange(C, dtype=jnp.int32)[None, :]
    ids = jnp.where(cand_d < INF, cand_ids, sent)
    colidx = jnp.broadcast_to(jnp.arange(C, dtype=jnp.int32)[None, :], (B, C))
    sid, sdist, scol = jax.lax.sort((ids, cand_d, colidx), num_keys=2, is_stable=True)
    dup = jnp.concatenate(
        [jnp.zeros((B, 1), bool), sid[:, 1:] == sid[:, :-1]], axis=1
    )
    sdist = jnp.where(dup, INF, sdist)
    sdist, sid, scol = jax.lax.sort((sdist, sid, scol), num_keys=2, is_stable=True)
    svecs = jnp.take_along_axis(cand_vecs, scol[:, :, None], axis=1)
    sel_ids, sel_dists = _occlusion_loop(sid, sdist, svecs, alpha, R, metric)
    inactive = (p_ids < 0)[:, None]
    sel_ids = jnp.where(inactive, -1, sel_ids)
    sel_dists = jnp.where(inactive, INF, sel_dists)
    return PruneResult(
        sel_ids, sel_dists, jnp.sum(sel_ids >= 0, axis=1).astype(jnp.int32)
    )


def build_global_vamana(
    data: np.ndarray,
    mesh: Mesh,
    bp: BuildParams,
    metric: Metric = Metric.L2,
    verbose: bool = False,
) -> GlobalIndex:
    """Build ONE Vamana graph over all rows, sharded over mesh axis 'd'."""
    metric = Metric.coerce(metric)
    D = mesh.shape["d"]
    n, dim = data.shape
    nl = -(-n // D)
    padded = np.zeros((D * nl, dim), dtype=data.dtype)
    padded[:n] = data
    pts = jax.device_put(
        padded.reshape(D, nl, dim), NamedSharding(mesh, P("d", None, None))
    )
    R, L = bp.R, bp.L
    vmax = max((3 * L) // 2, R + 16)
    nbrs = jax.device_put(
        jnp.zeros((D, nl, R), jnp.int32), NamedSharding(mesh, P("d", None, None))
    )
    degs = jax.device_put(
        jnp.zeros((D, nl), jnp.int32), NamedSharding(mesh, P("d", None))
    )

    rng = np.random.default_rng(bp.seed)
    start = jnp.zeros((1,), jnp.int32)

    @partial(
        jax.jit,
        static_argnames=("R", "L", "vmax", "metric", "n_valid", "nl",
                         "prune_chunks", "prune_chunk"),
        donate_argnums=(1, 2),
    )
    def step(pts, nbrs, degs, batch, alpha, start, *, R, L, vmax, metric,
             n_valid, nl, prune_chunks, prune_chunk):
        body = partial(
            _global_insert_step_body,
            R=R, L=L, vmax=vmax, metric=metric, n_valid=n_valid, nl=nl,
            prune_chunks=prune_chunks, prune_chunk=prune_chunk,
        )

        def local(p, nb, dg, bt, al, st):
            nb2, dg2 = body(p[0], nb[0], dg[0], bt[0], al, st)
            return nb2[None], dg2[None]

        return jax.shard_map(
            local, mesh=mesh,
            in_specs=(P("d", None, None), P("d", None, None), P("d", None),
                      P("d", None), P(), P()),
            out_specs=(P("d", None, None), P("d", None)),
            check_vma=False,
        )(pts, nbrs, degs, batch, alpha, start)

    sched, max_batch = batch_schedule(n, n, bp.batch_cap_frac)
    for p in range(bp.num_passes):
        alpha = bp.alpha if p == bp.num_passes - 1 else 1.0
        order = rng.permutation(n).astype(np.int32)
        for bi, (lo, hi) in enumerate(sched):
            batch = _pad_pow2(order[lo:hi], max_batch)
            # round the PER-DEVICE width so the batch splits evenly over 'd'
            width = -(-len(batch) // D) * D
            if width != len(batch):
                batch = np.concatenate(
                    [batch, np.full(width - len(batch), -1, np.int32)]
                )
            barr = jax.device_put(
                batch.reshape(D, width // D), NamedSharding(mesh, P("d", None))
            )
            M = width * R
            pchunk = min(M, 1024)
            # load-balanced overflow: distinct first-occurrence targets
            # <= min(M, n) split round-robin over D devices, so the
            # static chunk bound is ceil(min(M, n)/D) rows per device;
            # the runtime cond skips chunks past the actual count
            nchunks = max(1, -(-(-(-min(M, n) // D)) // pchunk))
            nbrs, degs = step(
                pts, nbrs, degs, barr, jnp.float32(alpha), start,
                R=R, L=L, vmax=vmax, metric=metric, n_valid=n, nl=nl,
                prune_chunks=nchunks, prune_chunk=pchunk,
            )
            if verbose and bi % 8 == 0:
                print(f"global pass {p}: batch {bi+1}/{len(sched)}", flush=True)

    jax.block_until_ready(nbrs)
    return GlobalIndex(
        mesh=mesh, points=pts, nbrs=nbrs, degs=degs, n=n,
        rows_per_shard=nl, max_degree=R, metric=metric,
    )


def global_search(
    idx: GlobalIndex,
    queries: np.ndarray,
    k: int = 10,
    beam_size: int = 64,
):
    """Search the global sharded graph: queries shard over 'd', every hop
    rides the all_gather + compute-at-data + psum_scatter exchange."""
    mesh = idx.mesh
    D = mesh.shape["d"]
    B0 = len(queries)
    B = -(-B0 // D) * D
    qpad = np.zeros((B, queries.shape[1]), dtype=queries.dtype)
    qpad[:B0] = queries
    qarr = jax.device_put(
        qpad.reshape(D, B // D, -1), NamedSharding(mesh, P("d", None, None))
    )
    L = max(beam_size, k)
    nl = idx.rows_per_shard

    @partial(jax.jit, static_argnames=("k", "L"))
    def run(pts, nbrs, degs, q, *, k, L):
        def local(p, nb, dg, ql):
            bi, bd, _, _ = _global_beam(
                p[0], nb[0], dg[0], ql[0],
                jnp.asarray([idx.start_point], jnp.int32), None,
                metric=idx.metric, n_valid=idx.n, nl=nl, k=k, L=L,
                R=idx.max_degree, vmax=idx.n, record_visited=False,
            )
            return bi[None, :, :k], bd[None, :, :k]

        return jax.shard_map(
            local, mesh=mesh,
            in_specs=(P("d", None, None), P("d", None, None), P("d", None),
                      P("d", None, None)),
            out_specs=(P("d", None, None), P("d", None, None)),
            check_vma=False,
        )(pts, nbrs, degs, q)

    ids, dists = run(idx.points, idx.nbrs, idx.degs, qarr, k=k, L=L)
    ids = np.asarray(ids).reshape(B, k)[:B0]
    dists = np.asarray(dists).reshape(B, k)[:B0]
    return ids, dists


def collective_volume_report(
    n: int, D: int, *, R: int, L: int, dim: int, batch: int,
    itemsize: int = 4, itemsize_vec: int | None = None,
    hops: int | None = None, overflow_targets: int | None = None,
    print_table: bool = True,
):
    """Static per-DEVICE interconnect volume estimate per max-width batch.

    Convention: bytes = ring-model per-device traffic — (D-1)/D x the
    full logical gathered array for all_gather / psum_scatter
    (reduce_scatter), 2(D-1)/D for psum. Overflow pruning is
    load-balanced round-robin (r5): every device walks at most
    ceil(n_of/D) targets whatever the batch skew, so the worst case is
    the old owner-partitioned worst case / D, plus the thin
    target-row/vector fetch and result write-back sites the balancing
    introduces.

    Knobs for honest what-ifs: ``itemsize_vec`` — bytes per vector
    component on the wire (1 for q8 builds, the canonical SIFT config);
    ``hops`` — beam hop count (default the vmax worst case; the build
    loop exits at convergence, typically ~L); ``overflow_targets`` —
    per-device overflow targets per batch (default worst case
    ceil(min(M, n)/D); typically ~batch/D first-occurrence targets).
    Returns ({site: bytes}, worst_total) and prints both the
    worst-case table and a typical-case total."""
    B = batch
    E = 1
    vmax = max((3 * L) // 2, R + 16)
    hops_wc = hops or vmax
    C = vmax + R  # forward-prune candidate width (visited + old row)
    M = B * R
    pchunk = min(M, 1024)
    of_wc = (overflow_targets if overflow_targets is not None
             else -(-min(M, n) // D))
    nchunks = max(1, -(-of_wc // pchunk))
    iv = itemsize_vec if itemsize_vec is not None else itemsize
    ag = (D - 1) / D          # ring all_gather / psum_scatter factor
    ps = 2 * (D - 1) / D      # psum = reduce_scatter + all_gather

    def make_sites(hops, nch):
        return [
            ("beam: all_gather exp ids      (B,E)", hops * ag * B * E * itemsize),
            ("beam: psum cand ids+deg   (B,E,R+1)", hops * ps * B * E * (R + 1) * itemsize),
            ("beam: psum_scatter dists    (B,E*R)", hops * ag * B * E * R * itemsize),
            ("fwd prune: all_gather ids     (B,C)", ag * B * C * itemsize),
            ("fwd prune: psum_scatter vecs (B,C,d)", ag * B * C * dim * iv),
            ("reverse: all_gather edges (B,R)x2  ", ag * B * R * 2 * itemsize),
            ("overflow: all_gather ids (D,ch,2R)", nch * ag * D * pchunk * (2 * R) * itemsize),
            ("overflow: psum_scatter vecs        ", nch * ag * D * pchunk * 2 * R * dim * iv),
            ("overflow: target row+deg+vec fetch ", nch * ag * D * pchunk * ((R + 1) * itemsize + dim * iv)),
            ("overflow: all_gather results (D,ch,R+2)", nch * ag * D * pchunk * (R + 2) * itemsize),
        ]

    sites = make_sites(hops_wc, nchunks)
    total = sum(v for _, v in sites)
    # typical case: converged hop count ~L+8, overflow targets ~B/D
    hops_ty = hops or min(vmax, L + 8)
    nch_ty = max(1, -(-(overflow_targets or -(-B // D)) // pchunk))
    total_ty = sum(v for _, v in make_sites(hops_ty, nch_ty))
    if print_table:
        print(f"interconnect volume per device per max-width batch "
              f"(B={B}, D={D}, "
              f"R={R}, L={L}, dim={dim}, vec itemsize={iv}, "
              f"hops<={hops_wc}, overflow/dev<={of_wc}):", flush=True)
        for name, v in sites:
            print(f"  {name}: {v/1e6:10.2f} MB", flush=True)
        print(f"  TOTAL (worst case): {total/1e6:.2f} MB/batch  "
              f"(~{total * (n // max(B, 1)) / 1e9:.2f} GB/pass)", flush=True)
        print(f"  TOTAL (typical: hops~{hops_ty}, overflow/dev~"
              f"{overflow_targets or -(-B // D)}): {total_ty/1e6:.2f} "
              f"MB/batch", flush=True)
    return dict(sites), total
