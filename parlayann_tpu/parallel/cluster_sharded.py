"""Cluster-sharded search over a device mesh — the capacity mode of the
two-level ClusterIndex (build/clusterindex.py).

Design (compute-at-data, the scaling-book recipe): the member-vector
payload — the term that grows with n — shards over the ``d`` mesh axis in
contiguous CLUSTER blocks and never moves. Centroids are tiny
(n/m rows) and replicate, so the navigation algebra (seed top-S, beam
merge, next-expansion choice) runs identically on every device. Each
step, a query's expanded cluster lives on exactly one device: the owner
scores its m members in the local q8 shard and the scores cross the
interconnect as a ``pmin`` of owner-masked values ((B, m) f32 + ids);
adjacency ids cross the same way, then every device scores them against
the REPLICATED centroids locally (no vector traffic). The full-precision
rerank is served by range-sharded f32 points with a ``pmin`` merge.

Interconnect volume per step: B*(m*(4+4) + Rc*4) bytes ≈ 5.8 MB at
B=10K, m=64, Rc=16 — independent of n and of d(im); the payload shard
(n/D clusters of m*dim int8) is the only term that scales.

The beam itself is search/cluster.py's ``cluster_beam``, the same loop
the one-device ClusterIndex runs; only the member fetch differs (owner
masks + collectives here). Reference counterparts: beamSearch.h:119-146
(two-level filter) recast over a mesh; the reference has no distributed
layer (SURVEY §2).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from parlayann_tpu.types import Metric
from parlayann_tpu.ops.distance import INF


@dataclasses.dataclass
class ShardedClusterIndex:
    """Cluster-sharded handle. Arrays with a leading (D, ...) axis are
    sharded over mesh axis 'd'; the rest replicate."""

    mesh: Mesh
    centroids_q: jax.Array  # (C_pad, dim) int8, replicated (q8 domain)
    mvecs: jax.Array  # (D, Cl, m, dim) int8 — member vectors, sharded
    mids: jax.Array  # (D, Cl, m) int32 — member ids (-1 pad), sharded
    adj: jax.Array  # (D, Cl, Rc) int32 — adjacent clusters (-1 pad)
    points: jax.Array  # (D, nl, dim) f32 — row-range shard (rerank)
    slope: jax.Array
    offset: jax.Array
    C: int
    m: int
    Rc: int
    n: int
    clusters_per_shard: int
    rows_per_shard: int
    metric: Metric
    tier_bits: int = 8

    @staticmethod
    def from_cluster_index(ci, mesh: Mesh) -> "ShardedClusterIndex":
        """Shard a built ClusterIndex: member payload by cluster block,
        f32 points by row range, centroids replicated."""
        D = mesh.shape["d"]
        if ci.qpoints is None:
            raise ValueError(
                "sharded capacity mode needs the int8 member layout — "
                "build the ClusterIndex with ext_dtype='int8'"
            )
        qdata = np.asarray(ci.qpoints.data)
        members = ci.members  # (C, m)
        C, m = members.shape
        Cl = -(-C // D)
        memb = np.full((D * Cl, m), -1, np.int32)
        memb[:C] = members
        adj = np.full((D * Cl, ci.Rc), -1, np.int32)
        adj[:C] = ci.adj
        mv = qdata[np.clip(memb, 0, qdata.shape[0] - 1)]
        mv[memb < 0] = 0
        dim = qdata.shape[1]

        n = ci.points.n
        nl = -(-n // D)
        pts = np.zeros((D * nl, dim), np.float32)
        pts[:n] = np.asarray(ci.points.data[:n], np.float32)

        shard = NamedSharding(mesh, P("d"))
        repl = NamedSharding(mesh, P())
        return ShardedClusterIndex(
            mesh=mesh,
            centroids_q=jax.device_put(np.asarray(ci.centroids_q), repl),
            mvecs=jax.device_put(
                mv.astype(np.int8).reshape(D, Cl, m, dim), shard),
            mids=jax.device_put(memb.reshape(D, Cl, m), shard),
            adj=jax.device_put(adj.reshape(D, Cl, ci.Rc), shard),
            points=jax.device_put(pts.reshape(D, nl, dim), shard),
            slope=jax.device_put(jnp.asarray(ci.qpoints.quant_slope), repl),
            offset=jax.device_put(jnp.asarray(ci.qpoints.quant_offset),
                                  repl),
            C=ci.C, m=m, Rc=ci.Rc, n=n, clusters_per_shard=Cl,
            rows_per_shard=nl, metric=ci.points.metric,
            tier_bits=ci.qpoints.bits,
        )

    def search(self, queries, k: int = 10, *, n_probe: int = 8,
               min_probe: int = 0, cut: float = 0.0, starts: int = 2,
               rerank_pool: int = 20):
        """-> (ids (B, k), dists (B, k) full precision, n_probes (B,))."""
        q_full = jnp.asarray(np.asarray(queries), jnp.float32)
        return _sharded_cluster_search(
            q_full, self.centroids_q, self.mvecs, self.mids, self.adj,
            self.points, self.slope, self.offset,
            mesh=self.mesh, metric=self.metric, C=self.C, m=self.m,
            Rc=self.Rc, n_points=self.n, Cl=self.clusters_per_shard,
            nl=self.rows_per_shard, k=k, n_probe=n_probe,
            min_probe=min_probe, cut=cut, S=starts,
            rerank_pool=rerank_pool, tier_bits=self.tier_bits,
        )



@partial(
    jax.jit,
    static_argnames=("mesh", "metric", "C", "n", "nl", "iters", "k"),
)
def _sharded_kmeans_assign(
    pts,  # (D, nl, dim) f32, sharded over 'd' by row range
    init_cents,  # (C, dim) f32, replicated
    *, mesh, metric, C, n, nl, iters, k,
):
    """Distributed Lloyd + final k-candidate assignment.

    Points never move: each device scores its local row block against
    the replicated centroids (matmul flat scans) and contributes one-hot
    partial sums; a psum of the (C, dim) sums + (C,) counts — the only
    interconnect traffic, independent of n — replicates the update. Returns
    ((D, nl, k) ids, dists sharded) + final centroids (replicated).

    The local block is walked in point chunks of ``_kmeans_chunk_for(C)``
    rows, as in the one-device build, so each (chunk, C) distance tile
    and one-hot block stays near 256 MB whatever nl is.
    """
    from parlayann_tpu.build.clusterindex import _kmeans_chunk_for
    from parlayann_tpu.search.flat import flat_search_batch

    dim = pts.shape[-1]
    step = min(_kmeans_chunk_for(C), nl)
    nc = -(-nl // step)
    cid = jnp.arange(C, dtype=jnp.int32)[None, :]

    def local(pts, cents):
        pts = jnp.pad(pts[0], ((0, nc * step - nl), (0, 0)))
        didx = jax.lax.axis_index("d")
        row = jnp.arange(nc * step, dtype=jnp.int32)
        valid = (row < nl) & (didx * nl + row < n)
        chunks = (pts.reshape(nc, step, dim), valid.reshape(nc, step))

        def nearest(blk, cents, kk):
            return flat_search_batch(
                blk, cents, k=kk, metric=metric, n_valid=C,
                chunk=min(cents.shape[0], 32768), select="sort",
            )

        def one_iter(_, cents):
            def part(acc, chunk):
                blk, ok = chunk
                aid = nearest(blk, cents, 1)[0]
                oh = ((aid == cid) & ok[:, None]).astype(jnp.float32)
                sums = acc[0] + jax.lax.dot_general(
                    oh, blk, (((0,), (0,)), ((), ())),
                    preferred_element_type=jnp.float32,
                )
                return (sums, acc[1] + jnp.sum(oh, axis=0)), None

            zero = (jnp.zeros((C, dim), jnp.float32),
                    jnp.zeros((C,), jnp.float32))
            (sums, cnts), _ = jax.lax.scan(part, zero, chunks)
            sums = jax.lax.psum(sums, "d")
            cnts = jax.lax.psum(cnts, "d")
            new = sums / jnp.maximum(cnts, 1.0)[:, None]
            return jnp.where((cnts > 0)[:, None], new, cents)

        cents = jax.lax.fori_loop(0, iters, one_iter, cents)
        ids, ds = jax.lax.map(lambda blk: nearest(blk, cents, k), chunks[0])
        ids = ids.reshape(nc * step, k)[:nl]
        ds = ds.reshape(nc * step, k)[:nl]
        return ids[None], ds[None], cents

    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(P("d"), P()),
        out_specs=(P("d"), P("d"), P()),
        check_vma=False,
    )(pts, init_cents)


def build_sharded_cluster(
    data: np.ndarray,
    mesh: Mesh,
    *,
    m: int = 64,
    Rc: int = 16,
    iters: int = 6,
    cand: int = 8,
    slack: float = 1.5,  # displacement rate sets the recall ceiling —
    # same default + rationale as ClusterIndex.build
    seed: int = 0,
) -> ShardedClusterIndex:
    """Distributed ClusterIndex build: the O(n) phases (Lloyd k-means +
    candidate assignment — the build's FLOP bulk) run compute-at-data
    over the mesh with psum'd centroid statistics; the O(C) finishing
    passes (capacity balancing, adjacency, quantization, payload
    sharding) run centrally, exactly as the single-device build
    (build/clusterindex.py). Returns a ready-to-search
    ShardedClusterIndex."""
    from parlayann_tpu.build.clusterindex import (
        ClusterIndex, balance_assign, _recenter,
    )
    from parlayann_tpu.data.pointset import PointSet
    from parlayann_tpu.parallel.sharded import shard_dataset

    n, dim = data.shape
    D = mesh.shape["d"]
    C = max(8, int(-(-n * slack // m)))
    pts, nl = shard_dataset(data.astype(np.float32), mesh)  # (D, nl, dim)

    rng = np.random.default_rng(seed)
    init = jnp.asarray(data[rng.choice(n, C, replace=False)], jnp.float32)
    ids, ds, cents = _sharded_kmeans_assign(
        pts, init, mesh=mesh, metric=Metric.L2, C=C, n=n, nl=nl,
        iters=iters, k=cand,
    )
    nbr_ids = np.asarray(ids).reshape(D * nl, cand)[:n]
    nbr_d = np.asarray(ds).reshape(D * nl, cand)[:n]
    members = balance_assign(nbr_ids, nbr_d, C, m)
    ps = PointSet.from_numpy(data.astype(np.float32))
    cents = _recenter(ps.data[:n].astype(jnp.float32), members, C)
    aid, _ = _assign_centroid_knn(cents, C, Rc)
    # sharding IS the capacity regime: always the int8 payload layout
    ci = ClusterIndex._finish(ps, members, aid, cents, C, m, Rc,
                              ext_dtype="int8")
    return ShardedClusterIndex.from_cluster_index(ci, mesh)


def _assign_centroid_knn(cents, C: int, Rc: int):
    """Centroid k-NN adjacency (drop self) -> ((C, Rc) int32, None)."""
    from parlayann_tpu.search.flat import flat_search_batch

    aid, _ = flat_search_batch(
        cents, cents, k=Rc + 1, metric=Metric.L2, n_valid=C,
        chunk=min(cents.shape[0], 32768), select="sort",
    )
    aid = np.asarray(aid)
    adj = np.where(aid == np.arange(C, dtype=np.int32)[:, None], -1, aid)
    adj_list = np.full((C, Rc), -1, np.int32)
    for c in range(C):
        row = adj[c][adj[c] >= 0][:Rc]
        adj_list[c, : len(row)] = row
    return adj_list, None


@partial(
    jax.jit,
    static_argnames=("mesh", "metric", "C", "m", "Rc", "n_points", "Cl",
                     "nl", "k", "n_probe", "min_probe", "cut", "S",
                     "rerank_pool", "tier_bits"),
)
def _sharded_cluster_search(
    q_full, centroids_q, mvecs, mids, adj, points, slope, offset,
    *, mesh, metric, C, m, Rc, n_points, Cl, nl, k, n_probe, min_probe,
    cut, S, rerank_pool, tier_bits,
):
    from parlayann_tpu.ops import distance
    from parlayann_tpu.search.cluster import (
        cluster_beam, cluster_seed, translate_queries,
    )

    _inf = float(INF)
    q = translate_queries(q_full, slope, offset, tier_bits=tier_bits,
                          metric=metric)
    pool = max(rerank_pool, k)

    def local(q, qf, cq, mv, mi, ad, pts):
        """Per-device program under shard_map. mv/mi/ad/pts carry the
        leading (1, ...) shard axis."""
        mv, mi, ad, pts = mv[0], mi[0], ad[0], pts[0]
        didx = jax.lax.axis_index("d")
        lo_c = didx * Cl  # first owned cluster
        lo_r = didx * nl  # first owned point row

        # seed: exact top-S centroids (replicated algebra)
        sd, sids = cluster_seed(q, cq, metric=metric, C=C, S=S)

        def fetch(e, act):
            """The owner scores the members; pmin/pmax replicate."""
            own = act & (e >= lo_c) & (e < lo_c + Cl)
            loc = jnp.clip(e - lo_c, 0, Cl - 1)
            md = distance.gathered(q, jnp.take(mv, loc, axis=0), metric)
            rid = jnp.take(mi, loc, axis=0)
            ok = own[:, None] & (rid >= 0)
            md = jax.lax.pmin(jnp.where(ok, md, _inf), "d")
            rid = jax.lax.pmax(jnp.where(ok, rid, -1), "d")
            aid = jax.lax.pmax(
                jnp.where(own[:, None], jnp.take(ad, loc, axis=0), -1), "d")
            return md, rid, aid

        pd, pi, nv = cluster_beam(
            q, sd, sids, cq, fetch, metric=metric, C=C, n_points=n_points,
            n_probe=n_probe, min_probe=min_probe, cut=cut, pool=pool)

        # --- rerank: range-sharded f32 points, pmin merge ---
        cand = pi[:, :rerank_pool]
        cin = (cand >= lo_r) & (cand < lo_r + nl)
        cvec = jnp.take(pts, jnp.clip(cand - lo_r, 0, nl - 1), axis=0)
        cd = distance.gathered(qf, cvec, metric)
        cd = jax.lax.pmin(jnp.where(cin & (cand >= 0), cd, _inf), "d")
        kd, kidx = jax.lax.top_k(-cd, k)
        ids = jnp.take_along_axis(cand, kidx, axis=1)
        dists = -kd
        ids = jnp.where(dists < _inf, ids, -1)
        return ids, dists, nv

    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(), P(), P(), P("d"), P("d"), P("d"), P("d")),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )
    return fn(q, q_full.astype(jnp.float32), centroids_q, mvecs, mids, adj,
              points)
