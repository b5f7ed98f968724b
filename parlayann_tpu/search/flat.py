"""Flat (brute-force) k-NN — matmul-based exact/approx search.

No reference counterpart among the index types (the reference's closest
relative is the linear scan inside data_tools/compute_groundtruth.cpp:
22-60): a dense (B, d) @ (d, N) distance matmul over 100K-1M points is a
few TFLOP per 10K-query batch, so below the memory crossover brute force
is recall 1.0 at a QPS graph traversal cannot reach. The graph indexes
take over where N*d stops fitting the FLOP/latency budget.

Design: one jitted ``lax.scan`` over dataset chunks. Each chunk computes
a distance tile by matmul and reduces it to k candidates immediately
(the (B, N) matrix is never materialized); a running (B, k) top-k is
merged per chunk with a small-lane sort. Chunk reduction strategies:

* ``select="sort"``  — exact: per-group sort keeps the k smallest of each
  group, then one (B, C/G*k)-lane sort.
* ``select="approx"`` — ``lax.approx_min_k``. Per-chunk recall_target
  0.999 keeps end-to-end recall@10 indistinguishable from exact in
  practice.
* ``select="groupmin"`` — per-group min (see the branch comment).

``precision="fast"`` runs the matmul at the default precision (TF32 on
tensor cores): only for selection that an exact score follows (build
candidate scans, k-means assignment). ``precision="exact"`` uses HIGHEST
for ground-truth work.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from parlayann_tpu.types import Metric
from parlayann_tpu.data.pointset import PointSet
from parlayann_tpu.ops.distance import INF


def _chunk_dists(q, blk, metric: Metric, precision):
    prec = (jax.lax.Precision.HIGHEST if precision == "exact"
            else jax.lax.Precision.DEFAULT)
    dot = jax.lax.dot_general(
        q, blk, (((1,), (1,)), ((), ())),
        precision=prec, preferred_element_type=jnp.float32,
    )
    if metric is Metric.MIPS:
        return -dot
    xn = jnp.sum(blk.astype(jnp.float32) ** 2, axis=1)
    # ||q||^2 omitted: constant per row, does not change the ordering
    return xn[None, :] - 2.0 * dot


def _select_sort(d, ids, k):
    """Exact k smallest of (B, C) -> (B, k) via two-level lane sorts.

    The group width G adapts to 2k (pow2, capped 2048) so every
    recursion level SHRINKS the lane count by >= 2x: with a fixed
    G=128, any k >= 128 kept whole groups and the collapse level
    recursed on an UNSHRUNK array forever (hit by the meta-respill's
    widening-k passes at 10M)."""
    B, C = d.shape
    if k > 1024:
        raise ValueError(
            f"_select_sort k={k} > 1024: widen the caller's candidate "
            "chunking instead of one full-width sort")
    G = 128
    while G < min(2 * k, C) and G < 2048:
        G *= 2
    if C <= G:
        sd, si = jax.lax.sort((d, ids), dimension=1, num_keys=1)
        return sd[:, :k], si[:, :k]
    if C % G:
        # pad to a group multiple rather than one full-width sort
        pad = G - C % G
        d = jnp.concatenate([d, jnp.full((B, pad), INF, d.dtype)], axis=1)
        ids = jnp.concatenate(
            [ids, jnp.full((B, pad), -1, ids.dtype)], axis=1)
        C += pad
    ng = C // G
    sd, si = jax.lax.sort(
        (d.reshape(B, ng, G), ids.reshape(B, ng, G)), dimension=2, num_keys=1
    )
    kk = min(k, G)
    cd = sd[:, :, :kk].reshape(B, ng * kk)
    ci = si[:, :, :kk].reshape(B, ng * kk)
    if ng * kk > 4 * G:
        # one more level collapses very wide intermediates
        return _select_sort(cd, ci, k)
    sd, si = jax.lax.sort((cd, ci), dimension=1, num_keys=1)
    return sd[:, :k], si[:, :k]


@partial(jax.jit, static_argnames=("k", "metric", "n_valid", "chunk",
                                   "select", "precision"))
def flat_search_batch(
    queries,  # (B, d) float
    points_data,  # (n_pad, d) — f32 or int8 tier
    valid_mask=None,  # optional (n_pad,) bool — dynamic per-point validity
    exclude_ids=None,  # optional (B,) int32 — per-query id to mask (self)
    *,
    k: int,
    metric: Metric,
    n_valid: int,
    chunk: int = 32768,
    select: str = "sort",
    precision: str = "fast",
):
    """-> (ids (B, k) int32, dists (B, k) f32 in the data's domain).

    L2 selection runs on ||x||^2 - 2 q.x (the per-row constant ||q||^2
    cannot change the ordering, so it is skipped for the (B, chunk)
    tiles); the returned k distances have ||q||^2 added back, i.e. they
    are true squared distances. ``valid_mask`` and ``exclude_ids``
    support the builder's exact-candidate phase (search only the
    already-inserted subset, never yourself) without recompiling per
    batch.
    """
    B, d = queries.shape
    n_pad = points_data.shape[0]
    chunk = min(chunk, n_pad)
    nch = -(-n_pad // chunk)
    pad = nch * chunk - n_pad
    if pad:
        points_data = jnp.pad(points_data, ((0, pad), (0, 0)))
        if valid_mask is not None:
            valid_mask = jnp.pad(valid_mask, (0, pad))
    qf = queries.astype(jnp.float32)

    def step(carry, ci):
        run_d, run_i = carry
        blk = jax.lax.dynamic_slice_in_dim(
            points_data, ci * chunk, chunk, 0
        ).astype(jnp.float32)
        dd = _chunk_dists(qf, blk, metric, precision)
        ids = ci * chunk + jnp.arange(chunk, dtype=jnp.int32)[None, :]
        dd = jnp.where(ids < n_valid, dd, INF)
        if valid_mask is not None:
            mblk = jax.lax.dynamic_slice_in_dim(
                valid_mask, ci * chunk, chunk, 0
            )
            dd = jnp.where(mblk[None, :], dd, INF)
        if exclude_ids is not None:
            dd = jnp.where(ids == exclude_ids[:, None], INF, dd)
        ids = jnp.broadcast_to(ids, dd.shape)
        if select == "approx":
            cd, ci_sel = jax.lax.approx_min_k(
                dd, k, recall_target=0.999, aggregate_to_topk=True
            )
            cids = jnp.take_along_axis(ids, ci_sel, axis=1)
        elif select == "groupmin":
            # per-group min+argmin is a pure REDUCTION, cheaper than a
            # sort of the (B, chunk) tile. With k likely spread across
            # groups the per-query chance that a group of 64 holds two of
            # the true top-10 is ~2%, i.e. ~99.8% expected recall@10 per
            # chunk.
            G = 64
            if dd.shape[1] % G:  # odd pad width: exact small-case fallback
                cd, cids = _select_sort(dd, ids, k)
                md = jnp.concatenate([run_d, cd], axis=1)
                mi = jnp.concatenate([run_i, cids], axis=1)
                md, mi = jax.lax.sort((md, mi), dimension=1, num_keys=1)
                return (md[:, :k], mi[:, :k]), None
            ng = dd.shape[1] // G
            dg = dd.reshape(B, ng, G)
            gmin = jnp.min(dg, axis=2)
            garg = jnp.argmin(dg, axis=2).astype(jnp.int32)
            gids = (ci * chunk
                    + jnp.arange(ng, dtype=jnp.int32)[None, :] * G + garg)
            cd, cids = _select_sort(gmin, gids, k)
        else:
            cd, cids = _select_sort(dd, ids, k)
        md = jnp.concatenate([run_d, cd], axis=1)
        mi = jnp.concatenate([run_i, cids], axis=1)
        md, mi = jax.lax.sort((md, mi), dimension=1, num_keys=1)
        return (md[:, :k], mi[:, :k]), None

    run_d = jnp.full((B, k), INF, jnp.float32)
    run_i = jnp.full((B, k), -1, jnp.int32)
    with jax.named_scope("flat_scan"):
        (run_d, run_i), _ = jax.lax.scan(
            step, (run_d, run_i), jnp.arange(nch, dtype=jnp.int32)
        )
    run_i = jnp.where(run_d < INF, run_i, -1)
    if metric is not Metric.MIPS:
        qn = jnp.sum(qf * qf, axis=1, keepdims=True)
        run_d = jnp.where(
            run_d < INF, jnp.maximum(run_d + qn, 0.0), INF
        )
    return run_i, run_d


class FlatIndex:
    """Query-side handle for brute-force search (recall 1.0 tier).

    Mirrors ``Index``'s batch_search/batch_search_timed surface so the
    harness and CLI treat it like any other index. ``quantize=True``
    searches an int8 tier (4x less HBM traffic; same top-k up to
    quantization ties) with queries translated into the tier's domain.
    """

    def __init__(self, points: PointSet, quantize: bool = False):
        self.points = points
        self.qpoints = None
        if quantize:
            from parlayann_tpu.ops import quantize as q

            self.qpoints = q.quantize_pointset(points, bits=8)

    def batch_search(self, queries, k: int = 10, select: str = "sort",
                     chunk: int = 32768, **_ignored):
        from parlayann_tpu.utils.arrays import as_device

        q = as_device(np.asarray(queries, dtype=np.float32))
        ps = self.qpoints or self.points
        if self.qpoints is not None:
            from parlayann_tpu.ops import quantize as qz

            q = qz.translate_query(q, self.qpoints).astype(jnp.float32)
        # HIGHEST: these distances (and the order they set) are returned
        ids, dists = flat_search_batch(
            q, ps.data, k=k, metric=self.points.metric, n_valid=ps.n,
            chunk=chunk, select=select, precision="exact",
        )
        return ids, dists

    def batch_search_timed(self, queries, warmup: bool = True, **kw):
        import time

        from parlayann_tpu.utils.arrays import as_device

        queries = as_device(np.asarray(queries, dtype=np.float32))
        queries.block_until_ready()
        if warmup:
            jax.block_until_ready(self.batch_search(queries, **kw))
        t0 = time.perf_counter()
        out = jax.block_until_ready(self.batch_search(queries, **kw))
        return out[0], out[1], time.perf_counter() - t0
