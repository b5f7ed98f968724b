"""Single-dispatch graph search: translate -> beam phase 1 -> IN-JIT
straggler compaction -> beam phase 2 -> rerank, in ONE jitted program
(no host readback between phases).

Straggler economics: the lock-step batch pays its slowest query, so phase 1
caps visited at ``t1``; the unconverged tail (sorted to the front by a
done-flag sort — no host readback) resumes in a ``B//4``-wide compacted
batch (beamSearch.h has no analog; the reference's per-query loop never
pays for stragglers).

The compaction width is static: if more than B//4 queries are still
unconverged after phase 1, the overflow keeps its phase-1 result (visible
as recall loss in the sweep — tune ``t1`` up, not a silent cap: the
returned ``n_truncated`` counts them).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from parlayann_tpu.types import Metric
from parlayann_tpu.ops import quantize
from parlayann_tpu.ops.distance import INF
from parlayann_tpu.search.beam import beam_search_batch, top_k_from_beam
from parlayann_tpu.search.rerank import rerank_topk


class FusedResult(NamedTuple):
    ids: jax.Array  # (B, k)
    dists: jax.Array  # (B, k) full-precision when reranked
    num_visited: jax.Array  # (B,)
    dist_cmps: jax.Array  # (B,)
    n_truncated: jax.Array  # () queries that missed the compaction bucket


@partial(
    jax.jit,
    static_argnames=(
        "metric", "n_valid", "k", "L", "cut", "limit", "degree_limit",
        "expand", "tier_bits", "t1", "compact_w", "rerank_pool",
        "do_rerank",
    ),
)
def fused_search(
    q_full: jax.Array,  # (B, d) raw f32 queries
    tier_data: jax.Array,  # (n_pad, d) search-tier points (f32 or int8)
    points_data: jax.Array,  # (n_pad, d) full-precision points (rerank)
    nbrs: jax.Array,
    degs: jax.Array,
    start: jax.Array,
    slope: Optional[jax.Array],  # scalar-quantization params (None = full)
    offset: Optional[jax.Array],
    *,
    metric: Metric,
    n_valid: int,
    k: int,
    L: int,
    cut: float,
    limit: int,
    degree_limit: int,
    expand: int = 1,
    tier_bits: int = 32,
    t1: int = 0,  # phase-1 visit budget; 0 = single phase
    compact_w: int = 0,  # phase-2 width; 0 = single phase
    rerank_pool: int = 0,
    do_rerank: bool = False,
) -> FusedResult:
    B = q_full.shape[0]

    # ---- translate into the tier's domain (graph_index.cpp:144-177) ----
    if slope is not None and tier_bits < 32:
        if metric is Metric.L2:
            q = quantize.euclidean_translate(q_full, slope, offset, tier_bits)
        else:
            q = quantize.mips_translate(q_full, slope, offset, tier_bits)
        q = q.astype(jnp.float32)
    else:
        q = q_full

    common = dict(
        metric=metric, n_valid=n_valid, k=k, L=L, cut=cut,
        degree_limit=degree_limit, expand=expand,
    )

    two_phase = t1 > 0 and compact_w > 0 and compact_w < B and limit > t1
    with jax.named_scope("graph_beam_search"):
        res = beam_search_batch(
            q, tier_data, nbrs, degs, start,
            limit=t1 if two_phase else limit, **common,
        )
    n_trunc = jnp.zeros((), jnp.int32)
    if two_phase:
        # in-jit compaction: sort queries undone-first, resume the first
        # compact_w of them with the remaining budget, scatter back
        prio = jnp.where(res.done, 1, 0).astype(jnp.int32)
        rowid = jnp.arange(B, dtype=jnp.int32)
        sprio, rows = jax.lax.sort((prio, rowid), num_keys=1, is_stable=True)
        n_undone = jnp.sum(prio == 0)
        n_trunc = jnp.maximum(n_undone - compact_w, 0).astype(jnp.int32)
        rows_w = rows[:compact_w]
        live = sprio[:compact_w] == 0

        def take(a):
            return jnp.take(a, rows_w, axis=0)

        b_ids, b_dists, b_exp = take(res.beam_ids), take(res.beam_dists), take(res.beam_exp)
        # restore sentinel ids in empty slots (-1 was applied by phase 1)
        b_ids = jnp.where(
            b_dists < INF, b_ids,
            n_valid + jnp.arange(L, dtype=jnp.int32)[None, :],
        )
        state = (b_ids, b_dists, b_exp, take(res.num_visited), take(res.dist_cmps))
        with jax.named_scope("graph_beam_search"):
            res2 = beam_search_batch(
                take(q), tier_data, nbrs, degs, start,
                limit=limit, init_state=state, **common,
            )

        def put(full_a, a2, a1):
            upd = jnp.where(
                live.reshape((-1,) + (1,) * (a2.ndim - 1)), a2, a1
            )
            return full_a.at[rows_w].set(upd)

        res = type(res)(
            put(res.beam_ids, res2.beam_ids, take(res.beam_ids)),
            put(res.beam_dists, res2.beam_dists, b_dists),
            res.visited_ids, res.visited_dists,
            put(res.num_visited, res2.num_visited, take(res.num_visited)),
            put(res.dist_cmps, res2.dist_cmps, take(res.dist_cmps)),
            res.beam_exp, res.done,
        )

    if do_rerank:
        pool = max(rerank_pool, k)
        ids, dists = rerank_topk(
            q_full.astype(jnp.float32), points_data, res.beam_ids,
            k=k, pool=min(pool, L), metric=metric,
        )
    else:
        ids, dists = top_k_from_beam(res, k)
    return FusedResult(ids, dists, res.num_visited, res.dist_cmps, n_trunc)
