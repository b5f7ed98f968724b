"""Full-precision rerank of a quantized-search frontier.

Reference: beam_search_rerank (beamSearch.h:394-454) — beam search runs on
the 1-2 byte quantized tier, then the top ``k * rerank_factor`` frontier
entries are re-scored with full-precision distances and re-sorted. Here
the beam reads the quantized tier (4x fewer bytes per hop) and the rerank
is one batched gather + distance + top-k.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from parlayann_tpu.types import Metric
from parlayann_tpu.ops import distance, topk
from parlayann_tpu.ops.distance import INF


@partial(jax.jit, static_argnames=("k", "pool", "metric"))
def rerank_topk(
    queries_full: jax.Array,  # (B, d) full-precision queries
    points_full: jax.Array,  # (n_pad, d) full-precision vectors
    beam_ids: jax.Array,  # (B, L) quantized-tier frontier (-1 padded)
    *,
    k: int,
    pool: int,
    metric: Metric,
):
    """Re-score the top ``pool`` frontier entries at full precision and
    return the k best (ids, dists)."""
    cand = beam_ids[:, :pool]
    valid = cand >= 0
    vecs = jnp.take(
        points_full, jnp.clip(cand, 0, points_full.shape[0] - 1), axis=0
    )
    d = distance.gathered(queries_full, vecs, metric)
    d = jnp.where(valid, d, INF)
    kd, ki = topk.smallest_k(d, cand, k)
    return jnp.where(kd < INF, ki, -1), kd
