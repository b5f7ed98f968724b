"""Quantized search tier + rerank (beamSearch.h:394-454 semantics)."""

import numpy as np
import pytest

from parlayann_tpu.types import BuildParams
from parlayann_tpu.data.pointset import PointSet
from parlayann_tpu.build.vamana import build_vamana_graph
from parlayann_tpu.index import Index
from parlayann_tpu.search import exact


def _recall(ids, gt):
    return sum(
        len(set(a.tolist()) & set(b.tolist())) for a, b in zip(ids, gt)
    ) / gt.size


def test_quantized_search_with_rerank(rng):
    n, d, k = 800, 24, 10
    X = rng.standard_normal((n, d)).astype(np.float32)
    Q = rng.standard_normal((30, d)).astype(np.float32)
    ps = PointSet.from_numpy(X)
    bp = BuildParams(R=16, L=32, alpha=1.2, num_passes=1, batch_cap_frac=0.25)
    g, _ = build_vamana_graph(ps, bp)
    gt, _ = exact.exact_knn(Q, ps, k, chunk=128)
    gt = np.asarray(gt)

    idx_f = Index(points=ps, graph=g)
    ids_f, _, _ = idx_f.batch_search(Q, k=k, beam_size=40)
    rec_f = _recall(np.asarray(ids_f), gt)

    idx_q = Index(points=ps, graph=g).enable_quantized(bits=8)
    assert idx_q.qpoints is not None
    ids_q, dists_q, _ = idx_q.batch_search(Q, k=k, beam_size=40, rerank_factor=10)
    rec_q = _recall(np.asarray(ids_q), gt)

    # the quantized search tier is 1 byte/dim
    assert idx_q.qpoints.data.dtype == np.int8
    # rerank restores most of the full-precision recall
    assert rec_q >= rec_f - 0.03, (rec_q, rec_f)
    # reranked dists are true full-precision distances, ascending
    dd = np.asarray(dists_q)
    assert np.all(np.diff(dd, axis=1) >= 0)
    row = np.asarray(ids_q)[0]
    want = ((X[row] - Q[0]) ** 2).sum(1)
    np.testing.assert_allclose(dd[0], want, rtol=1e-4, atol=1e-3)


def test_build_on_quantized_points(rng):
    """The reference builds the graph on the 1-byte tier (builder.cpp:60-87);
    int8 storage must flow through every build kernel."""
    from parlayann_tpu.ops import quantize
    from parlayann_tpu.build.vamana import build_vamana_graph

    n, d, k = 800, 16, 10
    X = rng.standard_normal((n, d)).astype(np.float32)
    Q = rng.standard_normal((30, d)).astype(np.float32)
    ps = PointSet.from_numpy(X)
    qps = quantize.quantize_pointset(ps, bits=8)
    bp = BuildParams(R=16, L=32, alpha=1.2, num_passes=2, batch_cap_frac=0.25)
    g, _ = build_vamana_graph(qps, bp)
    avg, mx = g.stats()
    assert avg > 6, f"degree collapsed: {avg}"

    gt, _ = exact.exact_knn(Q, ps, k, chunk=128)
    idx = Index(points=ps, graph=g, qpoints=qps)
    ids, _, _ = idx.batch_search(Q, k=k, beam_size=40)
    rec = _recall(np.asarray(ids), np.asarray(gt))
    assert rec >= 0.85, rec


def test_bit_tier_search(rng):
    """1-bit hamming beam phase + full-precision rerank."""
    n, d, k = 800, 64, 10
    X = rng.standard_normal((n, d)).astype(np.float32)
    Q = rng.standard_normal((30, d)).astype(np.float32)
    ps = PointSet.from_numpy(X)
    bp = BuildParams(R=16, L=32, alpha=1.2, num_passes=2, batch_cap_frac=0.25)
    g, _ = build_vamana_graph(ps, bp)
    gt, _ = exact.exact_knn(Q, ps, k, chunk=128)
    gt = np.asarray(gt)

    idx = Index(points=ps, graph=g).enable_bit_tier()
    assert idx.bit_points.data.dtype == np.uint32
    ids, dists, _ = idx.batch_search(Q, k=k, beam_size=64, rerank_factor=10)
    rec = _recall(np.asarray(ids), gt)
    # coarse tier + rerank: useful but below full precision
    assert rec >= 0.5, rec
    # reranked dists are true full-precision distances
    row = np.asarray(ids)[0]
    valid = row >= 0
    want = ((X[row[valid]] - Q[0]) ** 2).sum(1)
    np.testing.assert_allclose(np.asarray(dists)[0][valid], want, rtol=1e-4,
                               atol=1e-3)


def test_mips_2bit_distance_oracle(rng):
    """Ternary two-bitplane distance == numpy ternary neg-dot
    (Mips_2Bit_Point, mips_point.h:495-621)."""
    from parlayann_tpu.ops import quantize
    from parlayann_tpu.types import Metric

    n, d = 64, 100  # non-multiple of 32 exercises word padding
    X = rng.standard_normal((n, d)).astype(np.float32)
    Q = rng.standard_normal((8, d)).astype(np.float32)
    ps = PointSet.from_numpy(X, metric=Metric.MIPS)
    tps = quantize.mips_2bit_quantize(ps)
    assert tps.bits == 2 and tps.data.dtype == np.uint32

    cut = float(tps.quant_offset)

    def tern(a):
        return np.where(a > cut, 1, np.where(a < -cut, -1, 0))

    qw = quantize.mips_2bit_translate_query(Q, tps)
    cand = np.asarray(tps.data[:16])[None].repeat(8, axis=0)  # (8, 16, 2W)
    got = np.asarray(quantize.mips_2bit_distance(qw, cand))
    want = -np.einsum("qd,cd->qc", tern(Q), tern(X[:16])).astype(np.float32)
    np.testing.assert_array_equal(got, want)


def test_mips_4bit_distance_oracle(rng):
    """Packed-nibble int4 distance == numpy neg-dot of the quantized levels
    (Mips_4Bit_Point, mips_point.h:706-849)."""
    from parlayann_tpu.ops import quantize
    from parlayann_tpu.types import Metric

    n, d = 64, 33  # odd d exercises nibble padding
    X = rng.standard_normal((n, d)).astype(np.float32)
    Q = rng.standard_normal((8, d)).astype(np.float32)
    ps = PointSet.from_numpy(X, metric=Metric.MIPS)
    tps = quantize.mips_4bit_quantize(ps)
    assert tps.bits == 4 and tps.data.dtype == np.int8
    assert tps.data.shape[1] == (d + 1) // 2

    slope = float(tps.quant_slope)
    lev = lambda a: np.clip(np.round(a * slope), -7, 7)
    # unpack returns the original coord order
    unp = np.asarray(quantize.unpack_int4(tps.data))[:, :d]
    np.testing.assert_array_equal(unp, lev(X[: len(unp)]).astype(np.int8))

    qlev = quantize.mips_4bit_translate_query(Q, tps)
    cand = np.asarray(tps.data[:16])[None].repeat(8, axis=0)
    got = np.asarray(quantize.mips_4bit_distance(qlev, cand))
    want = -np.einsum("qd,cd->qc", lev(Q), lev(X[:16])).astype(np.float32)
    np.testing.assert_array_equal(got, want)


def test_mips_lowbit_tier_search(rng):
    """2-bit and 4-bit MIPS tiers end-to-end with rerank."""
    from parlayann_tpu.types import Metric

    n, d, k = 800, 64, 10
    X = rng.standard_normal((n, d)).astype(np.float32)
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    Q = X[rng.integers(0, n, 30)] + 0.05 * rng.standard_normal((30, d)).astype(np.float32)
    ps = PointSet.from_numpy(X, metric=Metric.MIPS)
    bp = BuildParams(R=16, L=32, alpha=1.0, num_passes=2, batch_cap_frac=0.25)
    g, _ = build_vamana_graph(ps, bp)
    gt, _ = exact.exact_knn(Q, ps, k, chunk=128)
    gt = np.asarray(gt)

    idx4 = Index(points=ps, graph=g).enable_mips_4bit()
    ids4, _, _ = idx4.batch_search(Q, k=k, beam_size=64, rerank_factor=10)
    rec4 = _recall(np.asarray(ids4), gt)
    assert rec4 >= 0.8, rec4

    idx2 = Index(points=ps, graph=g).enable_mips_2bit()
    ids2, _, _ = idx2.batch_search(Q, k=k, beam_size=64, rerank_factor=10)
    rec2 = _recall(np.asarray(ids2), gt)
    assert rec2 >= 0.5, rec2  # ternary is coarse; rerank saves it


def test_jl_tier_search(rng):
    """JL tier (dense + sparse pattern, 8-bit and sign-bit) with rerank."""
    n, d, k = 800, 96, 10
    X = rng.standard_normal((n, d)).astype(np.float32)
    Q = rng.standard_normal((30, d)).astype(np.float32)
    ps = PointSet.from_numpy(X)
    bp = BuildParams(R=16, L=32, alpha=1.2, num_passes=2, batch_cap_frac=0.25)
    g, _ = build_vamana_graph(ps, bp)
    gt, _ = exact.exact_knn(Q, ps, k, chunk=128)
    gt = np.asarray(gt)

    # jl_dims == d: ±1/sqrt(d) projection still carries ~1/sqrt(d) relative
    # distance distortion (it is not orthogonal), so expect good-not-perfect
    idx = Index(points=ps, graph=g).enable_jl(jl_dims=96, bits=8)
    ids, _, _ = idx.batch_search(Q, k=k, beam_size=64, rerank_factor=10)
    rec = _recall(np.asarray(ids), gt)
    assert rec >= 0.7, rec

    # aggressive 96 -> 64 reduction: lossy tier, rerank recovers most
    idxr = Index(points=ps, graph=g).enable_jl(jl_dims=64, bits=8)
    idsr, _, _ = idxr.batch_search(Q, k=k, beam_size=64, rerank_factor=10)
    recr = _recall(np.asarray(idsr), gt)
    assert recr >= 0.55, recr

    idxb = Index(points=ps, graph=g).enable_jl(jl_dims=128, bits=1)
    idsb, _, _ = idxb.batch_search(Q, k=k, beam_size=64, rerank_factor=10)
    recb = _recall(np.asarray(idsb), gt)
    assert recb >= 0.5, recb

    idxs = Index(points=ps, graph=g).enable_jl(jl_dims=64, bits=8, sparse_nnz=6)
    from parlayann_tpu.ops.quantize import JLTier
    assert (np.count_nonzero(np.asarray(idxs.jl_tier.proj), axis=0) == 6).all()
    idss, _, _ = idxs.batch_search(Q, k=k, beam_size=64, rerank_factor=10)
    recs = _recall(np.asarray(idss), gt)
    assert recs >= 0.55, recs


@pytest.mark.parametrize("tier", ["f32", "q8"])
@pytest.mark.parametrize("start", ["medoid", "entry"])
def test_index_route_matches_beam_and_rerank(rng, tier, start):
    """Index.batch_search (one jitted program: translate -> beam -> rerank)
    returns exactly what the plain pieces return when called by hand:
    the start vertex (medoid or the sampled entry tier's exact top-1),
    beam_search_batch on the search tier, then rerank_topk (q8) or the
    beam's own top-k (f32)."""
    import jax.numpy as jnp

    from parlayann_tpu.index import _entry_top1
    from parlayann_tpu.ops import quantize
    from parlayann_tpu.search.beam import beam_search_batch, top_k_from_beam
    from parlayann_tpu.search.rerank import rerank_topk
    from parlayann_tpu.types import QueryParams

    n, d, k, L = 1200, 24, 10, 40
    X = rng.standard_normal((n, d)).astype(np.float32)
    Q = rng.standard_normal((48, d)).astype(np.float32)
    ps = PointSet.from_numpy(X)
    g, _ = build_vamana_graph(
        ps, BuildParams(R=16, L=32, alpha=1.2, num_passes=1,
                        batch_cap_frac=0.25))
    idx = Index(points=ps, graph=g)
    if tier == "q8":
        idx.enable_quantized(bits=8)
    if start == "entry":
        idx.entry_min_n = 0
        idx.build_entry_cache(E=256)
    else:
        idx.use_entry = False
    ids, dists, _ = idx.batch_search(Q, k=k, beam_size=L)

    qp = QueryParams(k=k, beamSize=L).resolved(g.max_degree, n)
    qf = jnp.asarray(Q)
    starts = (_entry_top1(qf, idx.entry_vecs, idx.entry_ids, metric=ps.metric)
              if start == "entry" else jnp.asarray([0], jnp.int32))
    tps = idx.qpoints if tier == "q8" else ps
    qt = (quantize.euclidean_translate(qf, tps.quant_slope, tps.quant_offset,
                                       8).astype(jnp.float32)
          if tier == "q8" else qf)
    res = beam_search_batch(
        qt, tps.data, g.neighbors, g.degrees, starts, metric=ps.metric,
        n_valid=n, k=k, L=L, cut=qp.cut, limit=qp.limit,
        degree_limit=qp.degree_limit,
    )
    if tier == "q8":
        want_i, want_d = rerank_topk(qf, ps.data, res.beam_ids, k=k,
                                     pool=min(10 * k, L), metric=ps.metric)
    else:
        want_i, want_d = top_k_from_beam(res, k)
    np.testing.assert_array_equal(np.asarray(ids), np.asarray(want_i))
    np.testing.assert_array_equal(np.asarray(dists), np.asarray(want_d))
