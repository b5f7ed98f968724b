"""Range search — all points within a radius.

Reference: range_search (beamSearch.h:245-306): seed the result set with
the given starting points that lie within ``radius_2``, then BFS — expand
every in-range node, admitting neighbors with d <= radius_2 — and the
query-driven wrapper sweeping initial beams (check_range_recall.h:67-84).
The live self-join driver is vamanaRange/neighbors.h:93-117 (for every base
point, BFS from its own out-neighbors).

Device mapping: the BFS is the beam machinery with radius admission instead of
top-L trimming — state is a capped in-range set with expanded flags; each
step expands E unexpanded in-range nodes per query, one fused distance
block, one dedup merge. The result set is bounded by a static ``cap``
(the reference's is unbounded; overflow is reported so callers can raise
the cap).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from parlayann_tpu.types import Metric
from parlayann_tpu.utils.arrays import as_device
from parlayann_tpu.ops import distance
from parlayann_tpu.ops.distance import INF
from parlayann_tpu.search.beam import _merge, beam_search_batch


class RangeResult(NamedTuple):
    ids: jax.Array  # (B, cap) in-range ids, -1 padded, dist-ascending
    dists: jax.Array  # (B, cap)
    counts: jax.Array  # (B,) number found (== cap means possibly truncated)
    dist_cmps: jax.Array  # (B,)


@partial(
    jax.jit,
    static_argnames=("metric", "n_valid", "cap", "expand", "exclude_self"),
)
def range_search_batch(
    queries: jax.Array,  # (B, d)
    points_data: jax.Array,
    nbrs: jax.Array,
    degs: jax.Array,
    starts: jax.Array,  # (B, S) per-query seed sets (e.g. own graph row)
    radius_2,
    self_ids=None,
    *,
    metric: Metric,
    n_valid: int,
    cap: int = 256,
    expand: int = 2,
    exclude_self: bool = False,
) -> RangeResult:
    """Batched BFS within radius_2 (beamSearch.h:245-306)."""
    B, d = queries.shape
    R = int(nbrs.shape[1])
    E = expand
    K = E * R
    radius_2 = jnp.float32(radius_2)

    def cand_distances(ids, valid):
        vecs = jnp.take(points_data, jnp.clip(ids, 0, points_data.shape[0] - 1), axis=0)
        dd = distance.gathered(queries, vecs, metric)
        return jnp.where(valid & (dd <= radius_2), dd, INF)

    if starts.ndim == 1:
        starts = jnp.broadcast_to(starts[None, :], (B, starts.shape[0]))
    S = starts.shape[1]
    sv = (starts >= 0) & (starts < n_valid)
    if exclude_self and self_ids is not None:
        sv &= starts != self_ids[:, None]
    sd = cand_distances(starts, sv)
    sids = jnp.where(sd < INF, starts, n_valid + jnp.arange(S, dtype=jnp.int32)[None, :])

    set_ids = jnp.broadcast_to(
        (n_valid + S + jnp.arange(cap, dtype=jnp.int32))[None, :], (B, cap)
    )
    set_dists = jnp.full((B, cap), INF, dtype=jnp.float32)
    set_exp = jnp.zeros((B, cap), dtype=jnp.int32)
    set_ids, set_dists, set_exp = _merge(set_ids, set_dists, set_exp, sids, sd, cap)
    dist_cmps = jnp.sum(sv, axis=1).astype(jnp.int32)
    done = ~jnp.any((set_exp == 0) & (set_dists < INF), axis=1)
    pos_c = jnp.arange(cap, dtype=jnp.int32)[None, :]

    def body(state):
        set_ids, set_dists, set_exp, dist_cmps, done = state
        active = ~done
        unexp = (set_exp == 0) & (set_dists < INF)
        cum = jnp.cumsum(unexp.astype(jnp.int32), axis=1)
        newly = unexp & (cum <= jnp.where(active, E, 0)[:, None])
        set_exp = set_exp + newly.astype(jnp.int32)

        key = jnp.where(newly, pos_c, cap)
        skey, sidv = jax.lax.sort((key, set_ids), num_keys=1, is_stable=True)
        exp_ids = jnp.where(skey[:, :E] < cap, sidv[:, :E], 0)
        valid_e = skey[:, :E] < cap

        rows = jnp.take(nbrs, jnp.clip(exp_ids, 0, nbrs.shape[0] - 1), axis=0)
        rdeg = jnp.take(degs, jnp.clip(exp_ids, 0, degs.shape[0] - 1), axis=0)
        slot = jnp.arange(R, dtype=jnp.int32)[None, None, :]
        v = (slot < rdeg[:, :, None]) & valid_e[:, :, None]
        cand_ids = rows.reshape(B, K)
        cand_valid = v.reshape(B, K) & (cand_ids >= 0) & (cand_ids < n_valid)
        if exclude_self and self_ids is not None:
            cand_valid &= cand_ids != self_ids[:, None]
        dist_cmps = dist_cmps + jnp.where(
            active, jnp.sum(cand_valid, axis=1), 0
        ).astype(jnp.int32)
        cand_d = cand_distances(cand_ids, cand_valid)
        cand_ids = jnp.where(
            cand_d < INF, cand_ids,
            n_valid + jnp.arange(K, dtype=jnp.int32)[None, :],
        )
        ni, nd, ne = _merge(set_ids, set_dists, set_exp, cand_ids, cand_d, cap)
        new_done = done | ~jnp.any((ne == 0) & (nd < INF), axis=1)
        sel = active[:, None]
        return (
            jnp.where(sel, ni, set_ids),
            jnp.where(sel, nd, set_dists),
            jnp.where(sel, ne, set_exp),
            dist_cmps,
            new_done,
        )

    state = (set_ids, set_dists, set_exp, dist_cmps, done)
    state = jax.lax.while_loop(lambda s: jnp.any(~s[-1]), body, state)
    set_ids, set_dists, set_exp, dist_cmps, done = state
    found = set_dists < INF
    return RangeResult(
        jnp.where(found, set_ids, -1),
        set_dists,
        jnp.sum(found, axis=1).astype(jnp.int32),
        dist_cmps,
    )


def range_query(
    queries,
    points_data,
    nbrs,
    degs,
    start_point: int,
    rad: float,
    initial_beam: int = 45,
    cap: int = 256,
    *,
    metric: Metric,
    n_valid: int,
):
    """Query-file-driven range search (RangeParams, check_range_recall.h):
    a beam search of width ``initial_beam`` finds in-range seeds, then the
    BFS collects the rest of the range."""
    q = as_device(queries)
    res = beam_search_batch(
        q, points_data, nbrs, degs,
        jnp.asarray([start_point], dtype=jnp.int32),
        metric=metric, n_valid=n_valid, k=0, L=initial_beam,
    )
    seeds = jnp.where(res.beam_dists <= rad, res.beam_ids, -1)
    rr = range_search_batch(
        q, points_data, nbrs, degs, seeds, rad,
        metric=metric, n_valid=n_valid, cap=cap,
    )
    return rr


def self_join(
    points_data,
    nbrs,
    degs,
    radius: float,
    radius_2: float,
    *,
    metric: Metric,
    n_valid: int,
    cap: int = 256,
    batch: int = 4096,
):
    """Range self-join (vamanaRange/neighbors.h:93-117): for every base
    point, BFS from its own out-neighbors within radius_2, then report the
    matches within radius. Returns (list of id arrays, total_cmps)."""
    out = []
    total_cmps = 0
    n_pad = points_data.shape[0]
    for lo in range(0, n_valid, batch):
        hi = min(lo + batch, n_valid)
        idxs = jnp.arange(lo, lo + batch, dtype=jnp.int32)
        q = jnp.take(points_data, jnp.clip(idxs, 0, n_pad - 1), axis=0)
        own = jnp.take(nbrs, jnp.clip(idxs, 0, n_pad - 1), axis=0)
        deg = jnp.take(degs, jnp.clip(idxs, 0, n_pad - 1), axis=0)
        own = jnp.where(
            jnp.arange(own.shape[1], dtype=jnp.int32)[None, :] < deg[:, None],
            own, -1,
        )
        rr = range_search_batch(
            q, points_data, nbrs, degs, own, radius_2, idxs,
            metric=metric, n_valid=n_valid, cap=cap, exclude_self=True,
        )
        ids = np.asarray(rr.ids)[: hi - lo]
        ds = np.asarray(rr.dists)[: hi - lo]
        total_cmps += int(np.asarray(rr.dist_cmps)[: hi - lo].sum())
        # vectorized row split: one boolean mask + cumsum offsets per batch
        # (a per-row fancy-index loop here cost minutes at SSNPP-scale n)
        m = (ids >= 0) & (ds <= radius)
        flat = ids[m].astype(np.int32)  # row-major: rows stay contiguous
        offs = np.cumsum(m.sum(axis=1))[:-1]
        out.extend(np.split(flat, offs))
    return out, total_cmps
