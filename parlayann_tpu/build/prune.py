"""Batched robustPrune — vectorized α-occlusion pruning.

Reference: vamana/index.h:63-120. The sequential greedy loop ("accept the
closest surviving candidate p*, then eliminate every later candidate p' with
α·d(p*,p') ≤ d(p,p')") is inherently ordered in its accept decisions but not
in its eliminations, so here it becomes R rounds of batched vector math
over B points at once:

  round r: star  = first surviving candidate per row (argmax over a mask),
           d(star, ·) = one (B, C) batched distance against the pre-gathered
           candidate vectors, eliminate by the α rule.

This is *exact* — the same neighbors the reference selects, in the same
order — at the cost of always doing R rounds of O(C·d) work per point.
Candidate lists are first sorted by (dist, id) and deduplicated by id with
two batched stable sorts (the reference's sort + unique, index.h:79-87).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from parlayann_tpu.types import Metric
from parlayann_tpu.ops import distance
from parlayann_tpu.ops.distance import INF


class PruneResult(NamedTuple):
    ids: jax.Array  # (B, R) selected neighbor ids, -1 padded, dist-ascending
    dists: jax.Array  # (B, R) their distances to p (INF padded)
    degree: jax.Array  # (B,) number selected


def sort_dedup_candidates(cand_ids, cand_dists, n_valid: int):
    """Sort rows by (dist, id) ascending with duplicate ids masked to INF.

    Invalid entries must already carry dist INF. Returns (ids, dists) with
    unique sentinel ids (>= n_valid) in masked slots.
    """
    B, C = cand_ids.shape
    sent = n_valid + jnp.arange(C, dtype=jnp.int32)[None, :]
    ids = jnp.where(cand_dists < INF, cand_ids, sent)
    sid, sdist = jax.lax.sort((ids, cand_dists), num_keys=2, is_stable=True)
    dup = jnp.concatenate(
        [jnp.zeros_like(sid[:, :1], dtype=bool), sid[:, 1:] == sid[:, :-1]], axis=1
    )
    sdist = jnp.where(dup, INF, sdist)
    sdist, sid = jax.lax.sort((sdist, sid), num_keys=2, is_stable=True)
    return sid, sdist


def _pairwise(cand_vecs: jax.Array, metric: Metric) -> jax.Array:
    """(B, C, d) -> (B, C, C) all candidate-candidate distances in ONE
    batched matmul. Precomputing moves the occlusion loop's per-round
    distance work (R re-reads of the candidate vectors) into a single
    compute-bound einsum.

    Default matmul precision (TF32 on tensor cores) on purpose: these
    distances only decide which candidates become edges; the distances
    a search returns are computed exactly at query time."""
    if cand_vecs.dtype != jnp.float32:
        cand_vecs = cand_vecs.astype(jnp.float32)
    dot = jnp.einsum(
        "bcd,bed->bce", cand_vecs, cand_vecs,
        preferred_element_type=jnp.float32,
    )
    if metric is Metric.MIPS:
        return -dot
    nrm = jnp.einsum("bcd,bcd->bc", cand_vecs, cand_vecs)
    return jnp.maximum(nrm[:, :, None] - 2.0 * dot + nrm[:, None, :], 0.0)


def _occlusion_loop(cand_ids, cand_dists, cand_vecs, alpha, R: int, metric: Metric):
    """R rounds of α-occlusion -> (sel_ids, sel_dists), both (B, R) in
    selection (= distance) order. Inputs are sorted by distance with
    duplicates masked to INF (``sort_dedup_candidates``)."""
    B, C = cand_ids.shape
    pos_c = jnp.arange(C, dtype=jnp.int32)[None, :]
    pair_d = _pairwise(cand_vecs, metric)  # (B, C, C)

    def body(r, state):
        elim, sel_ids, sel_dists = state
        alive = ~elim
        any_alive = jnp.any(alive, axis=1)
        star = jnp.argmax(alive, axis=1).astype(jnp.int32)  # first surviving
        onehot = (pos_c == star[:, None])
        star_id = jnp.sum(jnp.where(onehot, cand_ids, 0), axis=1)
        star_dist = jnp.sum(jnp.where(onehot, cand_dists, 0.0), axis=1)
        sel_ids = sel_ids.at[:, r].set(jnp.where(any_alive, star_id, -1))
        sel_dists = sel_dists.at[:, r].set(jnp.where(any_alive, star_dist, INF))
        d_sp = jnp.sum(jnp.where(onehot[:, :, None], pair_d, 0.0), axis=1)
        occl = alpha * d_sp <= cand_dists  # index.h:111-113
        elim = elim | ((occl | onehot) & any_alive[:, None])
        return elim, sel_ids, sel_dists

    elim0 = cand_dists >= INF
    sel_ids0 = jnp.full((B, R), -1, dtype=jnp.int32)
    sel_dists0 = jnp.full((B, R), INF, dtype=jnp.float32)
    with jax.named_scope("occlusion_loop"):
        elim, sel_ids, sel_dists = jax.lax.fori_loop(
            0, R, body, (elim0, sel_ids0, sel_dists0)
        )
    return sel_ids, sel_dists


def robust_prune_batch(
    p_ids: jax.Array,  # (B,) the points being pruned (-1 = inactive row)
    cand_ids: jax.Array,  # (B, C)
    cand_dists: jax.Array,  # (B, C) distances d(p, cand); INF = invalid
    points_data: jax.Array,  # (n_pad, d)
    alpha,
    *,
    R: int,
    metric: Metric,
    n_valid: int,
) -> PruneResult:
    """One fused robustPrune over B points. Candidates with dist INF are
    ignored; candidates equal to p are dropped (index.h:98-100)."""
    cand_dists = jnp.where(cand_ids == p_ids[:, None], INF, cand_dists)
    cand_dists = jnp.where(
        (cand_ids >= 0) & (cand_ids < n_valid), cand_dists, INF
    )
    sid, sdist = sort_dedup_candidates(cand_ids, cand_dists, n_valid)
    vecs = jnp.take(
        points_data, jnp.clip(sid, 0, points_data.shape[0] - 1), axis=0
    )
    sel_ids, sel_dists = _occlusion_loop(sid, sdist, vecs, alpha, R, metric)
    inactive = (p_ids < 0)[:, None]
    sel_ids = jnp.where(inactive, -1, sel_ids)
    sel_dists = jnp.where(inactive, INF, sel_dists)
    return PruneResult(sel_ids, sel_dists, jnp.sum(sel_ids >= 0, axis=1).astype(jnp.int32))


def robust_prune_chunked(
    p_ids, cand_ids, cand_dists, points_data, alpha, *, R, metric, n_valid, chunk=2048
):
    """lax.map over row-chunks to bound the (chunk, C, d) gather memory."""
    B = p_ids.shape[0]
    if B <= chunk:
        return robust_prune_batch(
            p_ids, cand_ids, cand_dists, points_data, alpha,
            R=R, metric=metric, n_valid=n_valid,
        )
    pad = (-B) % chunk
    if pad:
        p_ids = jnp.concatenate([p_ids, jnp.full(pad, -1, jnp.int32)])
        cand_ids = jnp.concatenate(
            [cand_ids, jnp.zeros((pad, cand_ids.shape[1]), jnp.int32)]
        )
        cand_dists = jnp.concatenate(
            [cand_dists, jnp.full((pad, cand_dists.shape[1]), INF, jnp.float32)]
        )
    nch = (B + pad) // chunk

    def one(args):
        p, ci, cd = args
        return robust_prune_batch(
            p, ci, cd, points_data, alpha, R=R, metric=metric, n_valid=n_valid
        )

    res = jax.lax.map(
        one,
        (
            p_ids.reshape(nch, chunk),
            cand_ids.reshape(nch, chunk, -1),
            cand_dists.reshape(nch, chunk, -1),
        ),
    )
    out = PruneResult(
        res.ids.reshape(nch * chunk, R)[:B],
        res.dists.reshape(nch * chunk, R)[:B],
        res.degree.reshape(nch * chunk)[:B],
    )
    return out
