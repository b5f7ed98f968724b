"""Index — the query-side handle (graph + points + quantized tiers).

Parity target: ``GraphIndex`` in python/graph_index.cpp:82-305 (load points
+ graph, build quantized side-ranges, batch_search / single_search /
check_recall) and the diskannpy-style wrappers in python/wrapper.py.

Search tiers (graph_index.cpp:86-101 builds them at load): the full-
precision PointSet plus an optional 1-byte scalar-quantized tier. When the
quantized tier is active, beam search reads quantized neighbor vectors
(4x fewer bytes per hop) and the frontier is reranked at full
precision (beamSearch.h:394-454).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from parlayann_tpu.types import Metric, QueryParams
from parlayann_tpu.data.pointset import PointSet
from parlayann_tpu.data.graph import GraphIndexData
from parlayann_tpu.ops import quantize
from parlayann_tpu.search.beam import beam_search_batch, top_k_from_beam
from parlayann_tpu.search.rerank import rerank_topk
from parlayann_tpu.utils.arrays import as_device


from functools import partial as _partial


@_partial(jax.jit, static_argnames=("metric",))
def _entry_top1(q, evecs, eids, *, metric: Metric):
    """Exact nearest sampled point per query -> (B, 1) start ids. One
    (B, E) matmul with a fused row argmin. Default matmul precision (TF32
    on tensor cores) is enough: this only picks a start vertex, and every
    distance the search returns is computed exactly later."""
    qf = q.astype(jnp.float32)
    ev = evecs.astype(jnp.float32)
    dot = jax.lax.dot_general(
        qf, ev, (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    if metric is Metric.MIPS:
        dist = -dot
    else:
        dist = jnp.sum(ev * ev, axis=1)[None, :] - 2.0 * dot
    j = jnp.argmin(dist, axis=1).astype(jnp.int32)
    return jnp.take(eids, j)[:, None]


@dataclasses.dataclass
class Index:
    points: PointSet
    graph: GraphIndexData
    start_point: int = 0
    qpoints: Optional[PointSet] = None  # 1-byte tier (graph_index.cpp:86-101)
    bit_points: Optional[PointSet] = None  # packed 1-bit tier
    jl_tier: Optional[object] = None  # quantize.JLTier
    t2_points: Optional[PointSet] = None  # ternary 2-bit MIPS tier
    t4_points: Optional[PointSet] = None  # packed int4 MIPS tier
    # sampled entry tier: per-query exact top-1 over a fixed ~4K uniform
    # sample (one matmul + row argmin) replaces
    # the single-medoid start — the query enters the graph a few hops from
    # its target (the same economics as HNSW's upper levels, computed
    # dense). use_entry=False restores reference start semantics.
    entry_ids: Optional[object] = None
    entry_vecs: Optional[object] = None
    use_entry: bool = True
    entry_min_n: int = 20_000  # below this the medoid start is fine

    @staticmethod
    def load(
        graph_path: str,
        data_path: str,
        metric: Metric = Metric.L2,
        dtype=None,
        quantize_bits: int = 8,
        auto_tier: bool = True,
    ) -> "Index":
        ps = PointSet.from_file(data_path, dtype=dtype, metric=Metric.coerce(metric))
        g = GraphIndexData.load(graph_path)
        idx = Index(points=ps, graph=g)
        # uint8 input (BIGANN/SIFT-u8 class) also routes through the
        # q8 tier: an exact affine remap into int8
        if quantize_bits and ps.data.dtype in (jnp.float32, jnp.uint8):
            idx.qpoints = quantize.quantize_pointset(ps, bits=quantize_bits)
        if auto_tier:
            # the reference auto-builds aggressive side-tiers at load
            # (graph_index.cpp:86-101): Euclid d>800 -> JL bit tier;
            # MIPS d>200 -> 2-bit ternary tier
            if ps.metric is Metric.L2 and ps.d > 800:
                idx.enable_jl(jl_dims=1024, bits=1)
            elif ps.metric is Metric.MIPS and ps.d > 200:
                idx.enable_mips_2bit()
        return idx

    def save(self, graph_path: str) -> None:
        self.graph.save(graph_path)

    def enable_quantized(self, bits: int = 8, trim: float = 0.0) -> "Index":
        """Build the scalar-quantized search tier (graph_index.cpp:86-101)."""
        self.qpoints = quantize.quantize_pointset(self.points, bits=bits, trim=trim)
        return self

    def enable_bit_tier(self) -> "Index":
        """Build the packed 1-bit tier (Euclidean_Bit_Point /
        Mips_Bit_Point, euclidian_point.h:332-420, mips_point.h:625-700):
        beam search runs on hamming distances, rerank restores precision."""
        self.bit_points = quantize.bit_quantize(self.points)
        return self

    def enable_jl(self, jl_dims: int = 64, bits: int = 8, seed: int = 0,
                  sparse_nnz: int = 0) -> "Index":
        """Build a JL search tier (jl_point.h; graph_index.cpp:86-101):
        beam search runs on quantized random projections, rerank restores
        precision. ``bits=1`` -> sign-bit hamming variant."""
        self.jl_tier = quantize.JLTier(
            self.points, jl_dims=jl_dims, bits=bits, seed=seed,
            sparse_nnz=sparse_nnz,
        )
        return self

    def enable_mips_2bit(self) -> "Index":
        """Ternary 2-bit MIPS tier (Mips_2Bit_Point, mips_point.h:495-621)."""
        self.t2_points = quantize.mips_2bit_quantize(self.points)
        return self

    def enable_mips_4bit(self, trim: float = 0.0) -> "Index":
        """Packed int4 MIPS tier (Mips_4Bit_Point, mips_point.h:706-849)."""
        self.t4_points = quantize.mips_4bit_quantize(self.points, trim=trim)
        return self

    def build_entry_cache(self, E: int = 4096, seed: int = 0):
        """Fixed uniform sample for the entry tier (see field docstring).
        Vectors are gathered once from the full-precision points; the
        per-search cost is one (B, E) matmul + row argmin."""
        E = min(E, self.points.n)
        if self.entry_ids is not None and self.entry_ids.shape[0] == E:
            return
        ids = np.random.default_rng(seed).choice(
            self.points.n, E, replace=False
        ).astype(np.int32)
        self.entry_ids = jnp.asarray(ids)
        self.entry_vecs = jnp.take(self.points.data, self.entry_ids, axis=0)

    # ------------------------------------------------------------------
    def batch_search(
        self,
        queries,
        k: int = 10,
        beam_size: int = 128,
        cut: float = 1.35,
        limit: Optional[int] = None,
        degree_limit: Optional[int] = None,
        expand: int = 1,
        rerank_factor: int = 10,
        two_phase: bool = True,
        random_starts: int = 0,
        seed: int = 0,
        starts=None,
    ):
        """Search all query rows -> (ids (B,k), dists (B,k), result).

        ``starts``: optional per-query start ids, (B,) or (B, S) — used by
        layered indexes (HNSW) whose upper-level descent supplies the
        level-0 entry; takes precedence over the entry tier and
        ``start_point``.

        ``random_starts > 0``: every query starts from that many uniformly
        random vertices instead of ``start_point`` (beamSearchRandom,
        beamSearch.h:309-351 — the reference draws one). Required for
        graphs without a navigable entry, e.g. pyNNDescent's k-NN graph.

        Mirrors GraphIndex::batch_search (graph_index.cpp:192-216):
        QueryParams(k, Q, cut, visit_limit, degree_limit); runs quantized +
        rerank automatically when the quantized tier exists (the reference's
        search_dispatch, graph_index.cpp:120-190). ``rerank_factor``: the
        rerank pool is min(k*rerank_factor, beam).

        The full/q8 tier path runs as ONE jitted program
        (search/fused.py): translate -> beam -> in-jit straggler compaction
        (``two_phase``, on by default for large batches) -> rerank.
        """
        qp = QueryParams(
            k=k, beamSize=beam_size, cut=cut, limit=limit, degree_limit=degree_limit
        ).resolved(self.graph.max_degree, self.points.n)
        # never round-trip device-resident queries (as_device docstring)
        q_full = as_device(queries)
        if starts is not None:
            start_arr = jnp.asarray(starts, dtype=jnp.int32)
            if start_arr.ndim == 1:
                start_arr = start_arr[:, None]
        elif random_starts > 0:
            rs = np.random.default_rng(seed).integers(
                0, self.points.n, (q_full.shape[0], random_starts)
            )
            start_arr = jnp.asarray(rs, dtype=jnp.int32)
        elif self.use_entry and self.points.n >= self.entry_min_n:
            # entry-tier start. Never clobber a caller-built tier
            # (build_entry_cache(E=64K) at 10M was silently rebuilt at the
            # 4K default here)
            if self.entry_ids is None:
                self.build_entry_cache()
            start_arr = _entry_top1(
                q_full, self.entry_vecs, self.entry_ids,
                metric=self.points.metric,
            )
        else:
            start_arr = jnp.asarray([self.start_point], dtype=jnp.int32)
        # tier priority: 1-bit > JL > 2-bit > 4-bit > scalar-q > full.
        # Coarse tiers (bit/JL-bit/2-bit) have huge tie classes, so the
        # metric cut rule is unusable: search with k=0 (pure beam) and let
        # the mandatory rerank restore precision (beamSearch.h:394-454).
        if self.bit_points is not None:
            ps = self.bit_points
            q = quantize.bit_translate_query(q_full, ps)
            bits, search_k = 1, 0
        elif self.jl_tier is not None:
            ps = self.jl_tier.points
            q = self.jl_tier.translate_query(q_full)
            bits = 1 if self.jl_tier.bits == 1 else 32
            search_k = 0 if bits == 1 else k
        elif self.t2_points is not None:
            ps = self.t2_points
            q = quantize.mips_2bit_translate_query(q_full, ps)
            bits, search_k = 2, 0
        elif self.t4_points is not None:
            ps = self.t4_points
            q = quantize.mips_4bit_translate_query(q_full, ps)
            bits, search_k = 4, k
        else:
            # full / q8 tier: translate, beam, straggler compaction and
            # rerank in one jitted program (search/fused.py)
            from parlayann_tpu.search.fused import fused_search

            L = max(qp.beamSize, k)
            B = q_full.shape[0]
            ps = self.qpoints if self.qpoints is not None else self.points
            use_tp = two_phase and B >= 2048 and qp.limit > 2 * L
            cw = 256
            while cw < B // 4:
                cw *= 2
            res = fused_search(
                q_full.astype(jnp.float32), ps.data, self.points.data,
                self.graph.neighbors, self.graph.degrees, start_arr,
                ps.quant_slope, ps.quant_offset,
                metric=ps.metric, n_valid=ps.n, k=k, L=L, cut=qp.cut,
                limit=qp.limit, degree_limit=qp.degree_limit, expand=expand,
                tier_bits=ps.bits,
                t1=2 * L if use_tp else 0,
                compact_w=min(cw, B) if use_tp else 0,
                rerank_pool=min(max(k * rerank_factor, k), L),
                do_rerank=ps is not self.points,
            )
            return res.ids, res.dists, res
        L = max(qp.beamSize, k)
        res = beam_search_batch(
            q, ps.data, self.graph.neighbors, self.graph.degrees, start_arr,
            metric=ps.metric, n_valid=ps.n, k=search_k, L=L, cut=qp.cut,
            limit=qp.limit, degree_limit=qp.degree_limit, expand=expand,
            bits=bits,
        )
        if ps is not self.points:
            pool = min(max(k * rerank_factor, k), L)
            ids, dists = rerank_topk(
                q_full.astype(jnp.float32), self.points.data, res.beam_ids,
                k=k, pool=pool, metric=self.points.metric,
            )
        else:
            ids, dists = top_k_from_beam(res, k)
        return ids, dists, res

    def batch_search_timed(self, queries, warmup: bool = True,
                           rounds: int = 1, **kw):
        """Timed steady-state search (compile + host->device query upload
        excluded, matching the reference's query-only timer,
        check_nn_recall.h:41-50) -> (ids, dists, res, seconds-per-round).

        ``rounds``: back-to-back searches with ONE final fence, like the
        reference's time_loop (parse_results.h) — the per-round time then
        reflects sustained device throughput."""
        queries = as_device(queries)
        queries.block_until_ready()
        if warmup:
            jax.block_until_ready(self.batch_search(queries, **kw))
        t0 = time.perf_counter()
        out = None
        for _ in range(rounds):
            out = self.batch_search(queries, **kw)
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / rounds
        return (*out, dt)

    def batch_search_from_string(self, queries: bytes, k: int = 10,
                                 beam_size: int = 128,
                                 visit_limit: Optional[int] = None, **kw):
        """Search queries given as a big-ann ``.bin`` byte string
        ([u32 n][u32 d] + rows), the zero-copy convenience of
        GraphIndex::batch_search_from_string (graph_index.cpp:236-257).
        Returns (ids (n, k), dists (n, k))."""
        hdr = np.frombuffer(queries, dtype=np.uint32, count=2)
        n, d = int(hdr[0]), int(hdr[1])
        if d != self.points.d:
            raise ValueError(
                f"query dim {d} != index dim {self.points.d}"
            )
        itemsize = (len(queries) - 8) // max(n * d, 1)
        if itemsize == 1:
            # 1-byte payloads decode in the index's own dtype: an i8bin
            # query parsed as uint8 corrupts every negative component
            dt = (np.int8 if self.points.data.dtype == jnp.int8
                  else np.uint8)
        else:
            dt = np.float32
        q = np.frombuffer(queries, dtype=dt, offset=8,
                          count=n * d).reshape(n, d)
        ids, dists, _ = self.batch_search(
            q.astype(np.float32), k=k, beam_size=beam_size,
            limit=visit_limit, **kw,
        )
        return np.asarray(ids), np.asarray(dists)

    def single_search(self, query, k: int = 10, beam_size: int = 128, **kw):
        ids, dists, _ = self.batch_search(
            np.asarray(query)[None, :], k=k, beam_size=beam_size, **kw
        )
        return np.asarray(ids[0]), np.asarray(dists[0])

    def check_recall(self, queries, gt_ids, gt_dists=None, k: int = 10,
                     beam_size: int = 64, **kw):
        """Search + tie-aware recall (GraphIndex::check_recall,
        graph_index.cpp:259-305)."""
        from parlayann_tpu.harness.recall import compute_recall

        ids, _, _ = self.batch_search(queries, k=k, beam_size=beam_size, **kw)
        return compute_recall(np.asarray(ids), np.asarray(gt_ids),
                              None if gt_dists is None else np.asarray(gt_dists), k)
