"""Dataset-sharded build and search over a device mesh.

Design (SURVEY §2, the communication equivalent): the dataset is
split into contiguous row blocks, one per ``d``-axis mesh slot; each shard
builds and owns an independent Vamana graph over its rows (builds are
embarrassingly parallel — every shard runs the same batch-synchronous
insert step on its local block under ``shard_map``). Queries replicate over
``d`` and shard over ``q``; each device beam-searches its local graph and
the per-shard top-k are merged with one ``all_gather`` over the
interconnect.

Local ids translate to global ids by ``shard_index * rows_per_shard`` —
shards are contiguous blocks of the original row order.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from parlayann_tpu.types import BuildParams, Metric
from parlayann_tpu.build.vamana import (
    _beam_phase_impl,
    _fwd_phase_impl,
    _sort_rows_by_distance,
    batch_schedule,
    _pad_pow2,
)
from parlayann_tpu.build.reverse import prepare_reverse_append, prune_reverse_all
from parlayann_tpu.search.beam import beam_search_batch, top_k_from_beam
from parlayann_tpu.ops import topk
from parlayann_tpu.ops.distance import INF


@dataclasses.dataclass
class ShardedIndex:
    """A dataset-sharded index: (D, nl, ...) arrays sharded over mesh 'd'."""

    mesh: Mesh
    points: jax.Array  # (D, nl, dim) sharded P('d')
    nbrs: jax.Array  # (D, nl, R)
    degs: jax.Array  # (D, nl)
    n: int  # total valid rows
    rows_per_shard: int
    max_degree: int
    metric: Metric
    start_point: int = 0


def shard_dataset(data: np.ndarray, mesh: Mesh):
    """Pad + block rows across the 'd' axis -> (D, nl, dim) device array."""
    D = mesh.shape["d"]
    n, dim = data.shape
    nl = -(-n // D)
    padded = np.zeros((D * nl, dim), dtype=data.dtype)
    padded[:n] = data
    arr = jax.device_put(
        padded.reshape(D, nl, dim), NamedSharding(mesh, P("d", None, None))
    )
    return arr, nl


def build_sharded_vamana(
    data: np.ndarray,
    mesh: Mesh,
    bp: BuildParams,
    metric: Metric = Metric.L2,
    verbose: bool = False,
) -> ShardedIndex:
    """Build one Vamana graph per dataset shard, all shards in parallel.

    Each host-side batch step runs the single-shard insert step under
    shard_map; shard i inserts only its own valid rows (pad rows get -1
    batch ids and are skipped by the masked kernels).
    """
    D = mesh.shape["d"]
    n, dim = data.shape
    points, nl = shard_dataset(data, mesh)
    R, L = bp.R, bp.L
    vmax = max((3 * L) // 2, R + 16)

    nbrs = jax.device_put(
        jnp.zeros((D, nl, R), jnp.int32), NamedSharding(mesh, P("d", None, None))
    )
    degs = jax.device_put(
        jnp.zeros((D, nl), jnp.int32), NamedSharding(mesh, P("d", None))
    )

    # per-shard valid counts and permutations
    counts = [min(nl, max(0, n - i * nl)) for i in range(D)]
    rng = np.random.default_rng(bp.seed)

    @partial(
        jax.jit,
        static_argnames=("R", "L", "vmax", "metric", "n_valid"),
        donate_argnums=(0, 1),
    )
    def step(nbrs, degs, points, batch_ids, alpha, *, R, L, vmax, metric, n_valid):
        def local(nb, dg, pts, bids):
            nb, dg = nb[0], dg[0]
            pts, bids = pts[0], bids[0]
            cand_ids, cand_d, _, _ = _beam_phase_impl(
                nb, dg, pts, bids, jnp.zeros((1,), jnp.int32),
                R=R, L=L, vmax=vmax, metric=metric, n_valid=n_valid, expand=1,
            )
            nb, dg, sel_ids, sel_dists = _fwd_phase_impl(
                nb, dg, pts, bids, cand_ids, cand_d, alpha,
                R=R, metric=metric, n_valid=n_valid, chunk=2048,
            )
            nb, dg, ctx, _ = prepare_reverse_append(
                nb, dg, bids, sel_ids, sel_dists, R=R, n_valid=n_valid,
            )
            nb, dg = prune_reverse_all(
                nb, dg, ctx, pts, alpha,
                R=R, metric=metric, n_valid=n_valid, chunk=4096,
            )
            return nb[None], dg[None]

        return jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(P("d", None, None), P("d", None), P("d", None, None),
                      P("d", None)),
            out_specs=(P("d", None, None), P("d", None)),
            check_vma=False,
        )(nbrs, degs, points, batch_ids)

    sched, max_batch = batch_schedule(nl, nl, bp.batch_cap_frac)
    for p in range(bp.num_passes):
        alpha = bp.alpha if p == bp.num_passes - 1 else 1.0
        orders = [rng.permutation(c).astype(np.int32) for c in counts]
        for lo, hi in sched:
            batches = []
            for s in range(D):
                ids = orders[s][lo:hi] if lo < counts[s] else np.empty(0, np.int32)
                b = _pad_pow2(ids, max_batch) if len(ids) else None
                batches.append(b)
            width = max((len(b) for b in batches if b is not None), default=0)
            if width == 0:
                continue
            full = np.full((D, width), -1, dtype=np.int32)
            for s, b in enumerate(batches):
                if b is not None:
                    full[s, : len(b)] = b
            batch_arr = jax.device_put(full, NamedSharding(mesh, P("d", None)))
            nbrs, degs = step(
                nbrs, degs, points, batch_arr, jnp.float32(alpha),
                R=R, L=L, vmax=vmax, metric=metric, n_valid=nl,
            )
        if verbose:
            print(f"sharded build: pass {p} done", flush=True)

    # final per-row distance sort, shard-local
    @partial(jax.jit, static_argnames=("R", "metric"), donate_argnums=(0,))
    def sortstep(nbrs, degs, points, *, R, metric):
        def local(nb, dg, pts):
            out = _sort_rows_by_distance(nb[0], dg[0], pts[0], R=R, metric=metric)
            return out[None]

        return jax.shard_map(
            local, mesh=mesh,
            in_specs=(P("d", None, None), P("d", None), P("d", None, None)),
            out_specs=P("d", None, None),
            check_vma=False,
        )(nbrs, degs, points)

    nbrs = sortstep(nbrs, degs, points, R=R, metric=metric)
    jax.block_until_ready(nbrs)
    return ShardedIndex(
        mesh=mesh, points=points, nbrs=nbrs, degs=degs, n=n,
        rows_per_shard=nl, max_degree=R, metric=metric,
    )


def sharded_search(
    idx: ShardedIndex,
    queries: np.ndarray,
    k: int = 10,
    beam_size: int = 64,
    cut: float = 1.35,
    expand: int = 1,
):
    """Search all shards, merge per-shard top-k with one all_gather.

    Queries shard over 'q' and replicate over 'd'; output is (B, k) global
    ids + distances.
    """
    mesh = idx.mesh
    Qax = mesh.shape["q"]
    B = len(queries)
    Bp = -(-B // Qax) * Qax
    qpad = np.zeros((Bp, queries.shape[1]), dtype=queries.dtype)
    qpad[:B] = queries
    qarr = jax.device_put(qpad, NamedSharding(mesh, P("q", None)))
    nl = idx.rows_per_shard

    @partial(jax.jit, static_argnames=("k", "beam_size", "cut", "expand"))
    def run(points, nbrs, degs, q, *, k, beam_size, cut, expand):
        def local(pts, nb, dg, qloc):
            pts, nb, dg = pts[0], nb[0], dg[0]
            res = beam_search_batch(
                qloc, pts, nb, dg, jnp.zeros((1,), jnp.int32),
                metric=idx.metric, n_valid=nl, k=k, L=max(beam_size, k),
                cut=cut, expand=expand,
            )
            ids, dists = top_k_from_beam(res, k)
            shard = jax.lax.axis_index("d").astype(jnp.int32)
            # the last shard's zero-pad rows are not valid points: mask them
            # out BEFORE the cross-shard merge so they cannot eat top-k slots
            local_n = jnp.clip(idx.n - shard * nl, 0, nl)
            ok = (ids >= 0) & (ids < local_n)
            dists = jnp.where(ok, dists, INF)
            gids = jnp.where(ok, ids + shard * nl, -1)
            # merge across dataset shards: one all-gather
            all_d = jax.lax.all_gather(dists, "d", axis=0)  # (D, b, k)
            all_i = jax.lax.all_gather(gids, "d", axis=0)
            D = all_d.shape[0]
            md = jnp.moveaxis(all_d, 0, 1).reshape(qloc.shape[0], D * k)
            mi = jnp.moveaxis(all_i, 0, 1).reshape(qloc.shape[0], D * k)
            md = jnp.where(mi >= 0, md, INF)
            return topk.smallest_k(md, mi, k)

        return jax.shard_map(
            local, mesh=mesh,
            in_specs=(P("d", None, None), P("d", None, None), P("d", None),
                      P("q", None)),
            out_specs=(P("q", None), P("q", None)),
            check_vma=False,
        )(points, nbrs, degs, q)

    dists, ids = run(
        idx.points, idx.nbrs, idx.degs, qarr,
        k=k, beam_size=beam_size, cut=cut, expand=expand,
    )
    ids = jnp.where(ids >= idx.n, -1, ids)  # mask pad rows (never hit in practice)
    return np.asarray(ids)[:B], np.asarray(dists)[:B]
