"""Batched beam search — the shared search kernel (L2 of the layer map).

Data-parallel re-design of ``filtered_beam_search`` (beamSearch.h:27-214):
where the reference runs one sequential best-first loop per query on one
core, here B queries advance in lock-step; each step

  1. selects the E closest unexpanded beam entries per query (the reference
     expands 1/step; E>1 amortizes merges),
  2. computes all E*R candidate distances from one row gather of the
     search tier (f32, q8 or the 1/2/4-bit packed tiers),
  3. merges beam + candidates with two batched stable lane-wise sorts: sort
     by (id, dist) masks duplicates exactly (this subsumes the reference's
     visited-hash + ``std::unique`` + ``set_union``, beamSearch.h:52-59 and
     :173-181 — no hash is needed because already-seen candidates
     are either still in the beam, caught by the dedup sort, or were
     evicted, and eviction implies dist >= the monotonically-shrinking
     beam-worst so the frontier-full cutoff re-drops them; the only cost of
     hashlessness is recomputing some distances, which the batched kernel
     computes anyway),
  4. trims to the beam size and applies the metric-only ``cut`` pruning rule
     (beamSearch.h:185-195),
  5. freezes queries whose beam has no unexpanded entries or whose visit
     budget ``limit`` is spent (beamSearch.h:107).

The loop state is updated with masks/cumsums only (no scatter), and
build-time visited recording uses `lax.scan` output stacking instead of
dynamic-slice writes.
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from parlayann_tpu.types import Metric
from parlayann_tpu.ops import distance
from parlayann_tpu.ops.distance import INF


class BeamResult(NamedTuple):
    beam_ids: jax.Array  # (B, L) int32, dist-sorted; -1 in empty slots
    beam_dists: jax.Array  # (B, L) f32 (INF in empty slots)
    visited_ids: jax.Array  # (B, vmax) int32 in expansion order (scan mode)
    visited_dists: jax.Array  # (B, vmax) f32
    num_visited: jax.Array  # (B,) int32
    dist_cmps: jax.Array  # (B,) int32
    beam_exp: jax.Array  # (B, L) int32 expanded flags (resume state)
    done: jax.Array  # (B,) bool — converged (vs stopped by ``limit``)


def _has_work(beam_dists, beam_exp, k: int, L: int, cut: float, metric: Metric):
    """Any unexpanded beam entry worth expanding (cut rule included)?"""
    unexp = (beam_exp == 0) & (beam_dists < INF)
    if k > 0 and metric.is_metric and k < L:
        thr = cut * beam_dists[:, k]
        return jnp.any(unexp & (beam_dists < jnp.minimum(thr[:, None], INF)), axis=1)
    return jnp.any(unexp, axis=1)


def _merge(beam_ids, beam_dists, beam_exp, cand_ids, cand_dists, L: int):
    """Dedup-union beam with candidates, keep L closest.

    Two batched stable sorts: (id, 1-exp) lexicographic to mask duplicate
    ids — the *expanded* copy wins so that a candidate copy whose distance
    differs by an ulp can never resurrect an
    already-expanded vertex — then (dist, id) to restore beam order. This
    is the reference's sort + unique + set_union (beamSearch.h:173-181).
    """
    with jax.named_scope("beam_merge"):
        ids = jnp.concatenate([beam_ids, cand_ids], axis=1)
        dists = jnp.concatenate([beam_dists, cand_dists], axis=1)
        exp = jnp.concatenate(
            [beam_exp, jnp.zeros_like(cand_ids, dtype=jnp.int32)], axis=1
        )
        # pack (id, unexpanded-bit) into one int32 key: halves the sort
        # operand count and makes the expanded copy sort first among
        # equal ids for free
        packed = ids * 2 + (1 - jnp.minimum(exp, 1))
        spacked, sdist = jax.lax.sort((packed, dists), num_keys=1,
                                      is_stable=True)
        sid = jax.lax.shift_right_logical(spacked, 1)
        dup = jnp.concatenate(
            [jnp.zeros_like(sid[:, :1], dtype=bool),
             sid[:, 1:] == sid[:, :-1]], axis=1
        )
        sdist = jnp.where(dup, INF, sdist)
        ndist, npacked = jax.lax.sort((sdist, spacked), num_keys=2,
                                      is_stable=True)
        nid = jax.lax.shift_right_logical(npacked, 1)
        nexp = 1 - (npacked & 1)
        return nid[:, :L], ndist[:, :L], nexp[:, :L]


@partial(
    jax.jit,
    static_argnames=(
        "metric", "n_valid", "k", "L", "cut", "limit", "degree_limit",
        "expand", "record_visited", "exclude_self", "bits",
    ),
)
def beam_search_batch(
    queries: jax.Array,  # (B, d) in the points' storage domain
    points_data: jax.Array,  # (n_pad, d)
    nbrs: jax.Array,  # (n_pad, R) int32
    degs: jax.Array,  # (n_pad,) int32
    starts: jax.Array,  # (S,) or (B, S) int32 start vertices
    self_ids: Optional[jax.Array] = None,  # (B,) id to exclude (build self)
    *,
    metric: Metric,
    n_valid: int,
    k: int = 10,
    L: int = 128,
    cut: float = 1.35,
    limit: int = 2**30,
    degree_limit: int = 2**30,
    expand: int = 1,
    record_visited: bool = False,
    exclude_self: bool = False,
    init_state: Optional[tuple] = None,
    bits: int = 32,
    filter_data: Optional[jax.Array] = None,  # (n_pad, d) cheap-tier rows
    filter_queries: Optional[jax.Array] = None,  # (B, d) tier-domain queries
) -> BeamResult:
    """(See module docstring.) ``filter_data``/``filter_queries`` enable
    the reference's mid-beam two-tier filter (beamSearch.h:119-146): a
    RUNNING MEAN of the cheap-tier distance to the frontier's worst entry
    is maintained once the frontier fills, and candidates whose
    cheap-tier distance exceeds it are dropped before the full-precision
    distance. On CPU this saves full-precision distance calls; in this
    lock-step design every lane is computed regardless, so the mode
    exists to A/B the reference's mixed-precision OPERATING POINT
    (f32 walk + cheap filter) against the cheap-walk + rerank default —
    it changes which candidates enter the beam, not the step cost."""
    B, d = queries.shape
    R = int(nbrs.shape[1])
    rwidth = min(R, degree_limit)
    E = expand
    K = E * rwidth
    limit = min(limit, n_valid)
    brow_l = jnp.arange(L, dtype=jnp.int32)[None, :]
    use_filtering = filter_data is not None and filter_queries is not None

    if starts.ndim == 1:
        starts = jnp.broadcast_to(starts[None, :], (B, starts.shape[0]))
    S = starts.shape[1]

    def xla_distances(ids, valid):
        cids = jnp.clip(ids, 0, points_data.shape[0] - 1)
        vecs = jnp.take(points_data, cids, axis=0)
        from parlayann_tpu.ops import quantize as _q

        if bits == 1:
            # packed 1-bit tier: XOR + popcount hamming (mips_point.h:625-700)
            dd = _q.hamming_distance(queries, vecs)
        elif bits == 2:
            # ternary two-bitplane neg-dot (Mips_2Bit_Point, mips_point.h:495-621)
            dd = _q.mips_2bit_distance(queries, vecs)
        elif bits == 4:
            # packed-nibble int4 neg-dot (Mips_4Bit_Point, mips_point.h:706-849)
            dd = _q.mips_4bit_distance(queries, vecs)
        else:
            dd = distance.gathered(queries, vecs, metric)
        return jnp.where(valid, dd, INF)

    if init_state is not None:
        # resume a previous (possibly compacted) search: beam + counters
        # carry over, "done" is re-derived so limit can be raised
        beam_ids, beam_dists, beam_exp, num_visited, dist_cmps = init_state
        done = ~_has_work(beam_dists, beam_exp, k, L, cut, metric)
        done |= num_visited >= limit
    else:
        # ---- init: seed beam with start points (beamSearch.h:63-72).
        # Self-exclusion applies only to neighbor candidates (the
        # reference's same_as check, beamSearch.h:133), never to seeds — a
        # point searching from itself (single_batch mode) must still expand
        # its own row. ----
        start_valid = (starts >= 0) & (starts < n_valid)
        start_dists = xla_distances(starts, start_valid)
        start_ids = jnp.where(
            start_valid, starts, n_valid + jnp.arange(S, dtype=jnp.int32)[None, :]
        )

        beam_ids = jnp.broadcast_to(
            (n_valid + S + jnp.arange(L, dtype=jnp.int32))[None, :], (B, L)
        )
        beam_dists = jnp.full((B, L), INF, dtype=jnp.float32)
        beam_exp = jnp.zeros((B, L), dtype=jnp.int32)
        beam_ids, beam_dists, beam_exp = _merge(
            beam_ids, beam_dists, beam_exp, start_ids, start_dists, L
        )

        num_visited = jnp.zeros((B,), dtype=jnp.int32)
        dist_cmps = jnp.sum(start_valid, axis=1).astype(jnp.int32)
        done = ~jnp.any(beam_dists < INF, axis=1)

    def body(state):
        if use_filtering:
            (beam_ids, beam_dists, beam_exp, num_visited, dist_cmps, done,
             f_sum, f_cnt) = state
        else:
            (beam_ids, beam_dists, beam_exp, num_visited, dist_cmps,
             done) = state
        active = ~done

        # -- 1. mark + extract the E closest unexpanded entries (no scatter:
        # cumsum picks the first E unexpanded positions in dist order) --
        unexp = (beam_exp == 0) & (beam_dists < INF)
        budget = jnp.where(active, jnp.minimum(E, limit - num_visited), 0)
        cum = jnp.cumsum(unexp.astype(jnp.int32), axis=1)
        newly = unexp & (cum <= budget[:, None])
        beam_exp = beam_exp + newly.astype(jnp.int32)
        n_new = jnp.sum(newly, axis=1).astype(jnp.int32)

        if E == 1:
            pos = jnp.argmax(newly, axis=1).astype(jnp.int32)[:, None]
            exp_ids = jnp.take_along_axis(beam_ids, pos, axis=1)
            exp_dists = jnp.take_along_axis(beam_dists, pos, axis=1)
            valid_e = n_new[:, None] > 0
        else:
            key = jnp.where(newly, brow_l, L)
            skey, sids, sdists = jax.lax.sort(
                (key, beam_ids, beam_dists), num_keys=1, is_stable=True
            )
            exp_ids = sids[:, :E]
            exp_dists = sdists[:, :E]
            valid_e = skey[:, :E] < L
        exp_ids_c = jnp.where(valid_e, exp_ids, 0)

        # -- 2. candidate ids + distances --
        rows = jnp.take(nbrs, jnp.clip(exp_ids_c, 0, nbrs.shape[0] - 1), axis=0)
        rows = rows[:, :, :rwidth]  # degree_limit (beamSearch.h:130)
        rdeg = jnp.take(degs, jnp.clip(exp_ids_c, 0, degs.shape[0] - 1), axis=0)
        slot = jnp.arange(rwidth, dtype=jnp.int32)[None, None, :]
        v = (slot < rdeg[:, :, None]) & valid_e[:, :, None]
        cand_ids = rows.reshape(B, K)
        cand_valid = v.reshape(B, K)
        cand_valid &= (cand_ids >= 0) & (cand_ids < n_valid)
        if exclude_self and self_ids is not None:
            cand_valid &= cand_ids != self_ids[:, None]
        dist_cmps_new = dist_cmps + jnp.sum(cand_valid, axis=1).astype(jnp.int32)

        if use_filtering:
            # running-mean two-tier filter (beamSearch.h:119-146): the
            # mean accumulates the cheap-tier distance to the frontier's
            # WORST entry each step once the frontier is full (the
            # reference updates the mean before filtering in the same
            # iteration), then candidates at or beyond it are dropped
            # before the full-precision distance
            frontier_full = beam_dists[:, L - 1] < INF
            back_id = jnp.clip(beam_ids[:, L - 1], 0,
                               filter_data.shape[0] - 1)
            bvec = jnp.take(filter_data, back_id, axis=0)
            cheap_back = distance.gathered(
                filter_queries, bvec[:, None, :], metric)[:, 0]
            upd = active & frontier_full
            f_sum = f_sum + jnp.where(upd, cheap_back, 0.0)
            f_cnt = f_cnt + upd.astype(jnp.int32)
            thr = f_sum / jnp.maximum(f_cnt, 1).astype(jnp.float32)
            cvec = jnp.take(
                filter_data,
                jnp.clip(cand_ids, 0, filter_data.shape[0] - 1), axis=0)
            cheap_c = distance.gathered(filter_queries, cvec, metric)
            drop = (frontier_full & (f_cnt > 0))[:, None] & (
                cheap_c >= thr[:, None])
            cand_valid &= ~drop

        with jax.named_scope("beam_candidate_distances"):
            cand_dists = xla_distances(cand_ids, cand_valid)

        # -- 3. frontier-full cutoff (beamSearch.h:150-159) --
        worst = beam_dists[:, L - 1]
        cand_dists = jnp.where(cand_dists >= worst[:, None], INF, cand_dists)
        cand_ids = jnp.where(
            cand_dists < INF, cand_ids,
            n_valid + jnp.arange(K, dtype=jnp.int32)[None, :],
        )

        nb_ids, nb_dists, nb_exp = _merge(
            beam_ids, beam_dists, beam_exp, cand_ids, cand_dists, L
        )

        # -- 4. cut rule (beamSearch.h:185-195), metric + query-time only.
        # The reference trims the frontier to entries within cut*d(k), which
        # makes the loop stop once only beyond-cut entries remain. Removing
        # entries would break the monotone beam-worst invariant that makes
        # hashless dedup exact (removed nodes could re-enter as "fresh"
        # candidates and churn), so the same semantics are realized as an
        # early-stop: a query is done when no unexpanded entry is within
        # cut*d(k). The expansion order (always the closest unexpanded) and
        # the reported top-k are unchanged.
        num_visited_new = num_visited + n_new
        new_done = done | ~_has_work(nb_dists, nb_exp, k, L, cut, metric)
        new_done |= num_visited_new >= limit

        sel = active[:, None]
        out = (
            jnp.where(sel, nb_ids, beam_ids),
            jnp.where(sel, nb_dists, beam_dists),
            jnp.where(sel, nb_exp, beam_exp),
            jnp.where(active, num_visited_new, num_visited),
            jnp.where(active, dist_cmps_new, dist_cmps),
            new_done,
        )
        if use_filtering:
            out = out + (f_sum, f_cnt)
        return out, (exp_ids, exp_dists, valid_e & active[:, None])

    state = (beam_ids, beam_dists, beam_exp, num_visited, dist_cmps, done)
    if use_filtering:
        state = state + (jnp.zeros((B,), jnp.float32),
                         jnp.zeros((B,), jnp.int32))

    if record_visited:
        # fixed trip count; scan stacks the per-step expansions -> visited
        # list in expansion order with zero scatters (build path,
        # beamSearch.h:499-521 returns the visited list for robustPrune)
        T = max(1, math.ceil(limit / E))

        def scan_body(state, _):
            return body(state)

        state, (vis_i, vis_d, vis_ok) = jax.lax.scan(
            scan_body, state, None, length=T
        )
        # (T, B, E) -> (B, T*E); invalid steps carry INF dist
        vis_ids = jnp.moveaxis(vis_i, 0, 1).reshape(B, T * E)
        vis_dists = jnp.where(
            jnp.moveaxis(vis_ok, 0, 1), jnp.moveaxis(vis_d, 0, 1), INF
        ).reshape(B, T * E)
    else:
        def while_body(state):
            return body(state)[0]

        state = jax.lax.while_loop(
            lambda s: jnp.any(~s[5]), while_body, state
        )
        vis_ids = jnp.zeros((B, 1), dtype=jnp.int32)
        vis_dists = jnp.full((B, 1), INF, dtype=jnp.float32)

    beam_ids, beam_dists, beam_exp, num_visited, dist_cmps, done = state[:6]
    converged = ~_has_work(beam_dists, beam_exp, k, L, cut, metric)
    out_ids = jnp.where(beam_dists < INF, beam_ids, -1)
    return BeamResult(out_ids, beam_dists, vis_ids, vis_dists, num_visited,
                      dist_cmps, beam_exp, converged)


def top_k_from_beam(res: BeamResult, k: int):
    """First k frontier entries -> (ids, dists); -1 id for missing."""
    return res.beam_ids[:, :k], res.beam_dists[:, :k]


def beam_search_random(
    queries,
    points_data,
    nbrs,
    degs,
    *,
    n_starts: int = 1,
    seed: int = 0,
    **kw,
) -> BeamResult:
    """beamSearchRandom parity (beamSearch.h:309-351): every query starts
    from ``n_starts`` uniformly random vertices (the reference uses one).
    Essential for graphs without a navigable entry point — a pure k-NN
    graph (pyNNDescent) has no long-range edges, so single-start beam
    search collapses at scale (measured recall 0.0006 on 100K)."""
    import numpy as _np

    B = queries.shape[0]
    n_valid = kw.get("n_valid", points_data.shape[0])
    rs = _np.random.default_rng(seed).integers(
        0, n_valid, (B, n_starts), dtype=_np.int32
    )
    return beam_search_batch(
        queries, points_data, nbrs, degs, jnp.asarray(rs), **kw
    )
