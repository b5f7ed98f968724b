"""ClusterIndex (two-level cluster beam) build + search tests.

The cluster index is a structure beyond the reference's component list
(it composes the two-level QQ filter of beamSearch.h:119-146
with a partition, see build/clusterindex.py); these tests pin its
contracts: the members array is an exact partition, search recall clears
the graph-index bar on clustered data, and returned distances are true
full-precision distances.
"""

import numpy as np
import pytest

from parlayann_tpu.data.pointset import PointSet
from parlayann_tpu.build.clusterindex import ClusterIndex
from parlayann_tpu.search.exact import compute_groundtruth
from parlayann_tpu.harness.recall import compute_recall
from parlayann_tpu.utils import synthetic


@pytest.fixture(scope="module")
def built():
    X, Q = synthetic.clustered(
        5000, 64, n_queries=64, n_clusters=50, cluster_std=0.35, seed=7
    )
    ps = PointSet.from_numpy(X)
    # int8 layout pinned: the fixture tests assert the q8 member blocks
    # and the rerank-tier distinction, both int8-mode contracts
    ci = ClusterIndex.build(ps, m=64, Rc=16, iters=3, ext_dtype="int8")
    gt_ids, gt_dists = compute_groundtruth(ps, Q, k=10, query_batch=64)
    return ps, Q, ci, np.asarray(gt_ids), np.asarray(gt_dists)


def test_members_partition(built):
    ps, _, ci, _, _ = built
    mem = ci.members[ci.members >= 0]
    assert len(mem) == ps.n, "every point assigned exactly once"
    assert len(np.unique(mem)) == ps.n
    assert (ci.members < ps.n).all()
    # capacity respected
    assert ((ci.members >= 0).sum(axis=1) <= ci.m).all()


def test_adjacency_valid(built):
    _, _, ci, _, _ = built
    assert ci.adj.shape == (ci.C, ci.Rc)
    ok = ci.adj[ci.adj >= 0]
    assert (ok < ci.C).all()
    # no self loops
    self_ref = ci.adj == np.arange(ci.C, dtype=np.int32)[:, None]
    assert not self_ref.any()


def test_ext_row_layout(built):
    ps, _, ci, _, _ = built
    # member blocks: row c holds the q8 vectors of cluster c's members
    # (zero in empty slots), and the device id table equals members
    mv = np.asarray(ci.mvecs)
    q8 = np.asarray(ci.qpoints.data)
    assert mv.shape == (ci.C, ci.m, ps.d) and mv.dtype == np.int8
    np.testing.assert_array_equal(np.asarray(ci.mids), ci.members)
    np.testing.assert_array_equal(np.asarray(ci.adj_d), ci.adj)
    for c in (0, ci.C // 2, ci.C - 1):
        ok = ci.members[c] >= 0
        np.testing.assert_array_equal(mv[c][ok], q8[ci.members[c][ok]])
        assert (mv[c][~ok] == 0).all()


def test_search_recall(built):
    _, Q, ci, gt_ids, gt_dists = built
    ids, dists, (nv, cmps) = ci.search(Q, k=10, n_probe=8, cut=0.0)
    rec = compute_recall(np.asarray(ids), gt_ids, gt_dists, 10)
    assert rec >= 0.93, rec
    assert np.asarray(nv).max() <= 8


def test_search_recall_monotone_in_probes(built):
    _, Q, ci, gt_ids, gt_dists = built
    recs = []
    for npr in (2, 4, 8):
        ids, _, _ = ci.search(Q, k=10, n_probe=npr, cut=0.0)
        recs.append(compute_recall(np.asarray(ids), gt_ids, gt_dists, 10))
    assert recs[0] <= recs[1] + 0.01 and recs[1] <= recs[2] + 0.01, recs


def test_returned_dists_are_exact(built):
    ps, Q, ci, _, _ = built
    ids, dists, _ = ci.search(Q[:8], k=10, n_probe=4, cut=0.0)
    ids = np.asarray(ids)
    dists = np.asarray(dists)
    X = np.asarray(ps.data[: ps.n], np.float32)
    Qn = np.asarray(Q[:8], np.float32)
    for qi in range(8):
        for j in range(10):
            if ids[qi, j] < 0:
                continue
            true = ((X[ids[qi, j]] - Qn[qi]) ** 2).sum()
            assert abs(true - dists[qi, j]) < 1e-2 * max(1.0, true)


def test_tier_rerank_mode(built):
    """rerank="tier" skips the full-precision gather: ids stay close in
    recall (int8-domain ordering) and need no dedup (partition)."""
    _, Q, ci, gt_ids, gt_dists = built
    ids_f, _, _ = ci.search(Q, k=10, n_probe=8, cut=0.0)
    ids_t, dists_t, _ = ci.search(Q, k=10, n_probe=8, cut=0.0,
                                  rerank="tier")
    rec_f = compute_recall(np.asarray(ids_f), gt_ids, gt_dists, 10)
    rec_t = compute_recall(np.asarray(ids_t), gt_ids, gt_dists, 10)
    assert rec_t >= rec_f - 0.06, (rec_f, rec_t)
    d = np.asarray(dists_t)
    assert np.all(np.diff(d, axis=1) >= -1e-3)  # sorted tier scores


def test_adaptive_early_stop(built):
    """min_probe floors the cut rule: recall lands between the fixed
    min_probe and fixed n_probe configs, with adaptive probe counts."""
    _, Q, ci, gt_ids, gt_dists = built
    ids_lo, _, _ = ci.search(Q, k=10, n_probe=2, cut=0.0)
    ids_ad, _, (nv, _) = ci.search(Q, k=10, n_probe=12, min_probe=2,
                                   cut=1.35)
    rec_lo = compute_recall(np.asarray(ids_lo), gt_ids, gt_dists, 10)
    rec_ad = compute_recall(np.asarray(ids_ad), gt_ids, gt_dists, 10)
    assert rec_ad >= rec_lo - 1e-6, (rec_ad, rec_lo)
    nv = np.asarray(nv)
    assert nv.max() <= 12 and nv.min() >= 1


def test_no_duplicate_results(built):
    _, Q, ci, _, _ = built
    ids, _, _ = ci.search(Q, k=10, n_probe=8, cut=0.0)
    ids = np.asarray(ids)
    for row in ids:
        v = row[row >= 0]
        assert len(np.unique(v)) == len(v)


def test_save_load_roundtrip(built, tmp_path):
    ps, Q, ci, gt_ids, gt_dists = built
    p = str(tmp_path / "ci.npz")
    ci.save(p)
    ci2 = ClusterIndex.load(p, ps)
    np.testing.assert_array_equal(ci2.members, ci.members)
    np.testing.assert_array_equal(ci2.adj, ci.adj)
    np.testing.assert_array_equal(np.asarray(ci2.mvecs),
                                  np.asarray(ci.mvecs))
    ids, _, _ = ci2.search(Q, k=10, n_probe=8, cut=0.0)
    rec = compute_recall(np.asarray(ids), gt_ids, gt_dists, 10)
    assert rec >= 0.93


def test_api_validation():
    import parlayann_tpu as pt

    X = np.random.default_rng(0).normal(size=(500, 64)).astype(np.float32)
    with pytest.raises(ValueError):
        pt.build_cluster_index(X, m=63)  # not a multiple of 8
    with pytest.raises(ValueError):
        pt.build_cluster_index(X, Rc=4)  # below the 8-lane minimum
    with pytest.raises(ValueError):
        pt.build_cluster_index(X, metric="cosine")
    ci = pt.build_cluster_index(X, m=32, Rc=8, iters=2)
    assert ci.C >= 8


def test_mips_smoke():
    # clustered data: IVF-style routing on UNIFORM gaussians under MIPS is
    # intrinsically weak (the top inner products are norm outliers spread
    # over all cells — measured oracle ceiling ~.7 at 30% probes), and the
    # real MIPS tracks (bigann_mips) are clustered
    X, Q = synthetic.clustered(
        4000, 64, n_queries=32, n_clusters=40, cluster_std=0.35, seed=3
    )
    ps = PointSet.from_numpy(X, metric="mips")
    ci = ClusterIndex.build(ps, m=64, Rc=16, iters=2)
    gt_ids, gt_dists = compute_groundtruth(ps, Q, k=10, query_batch=32)
    ids, dists, _ = ci.search(Q, k=10, n_probe=12, cut=0.0)
    rec = compute_recall(
        np.asarray(ids), np.asarray(gt_ids), np.asarray(gt_dists), 10
    )
    assert rec >= 0.85, rec


def test_odd_batch_sizes(built):
    """Batches of any size return full results, identical to the same
    rows of a larger batch (queries are independent)."""
    _, Q, ci, gt_ids, gt_dists = built
    for B in (24, 40, 100):
        ids, _, _ = ci.search(Q[:B], k=10, n_probe=8, cut=0.0)
        ids = np.asarray(ids)
        assert (ids >= 0).all(), f"B={B}: missing results"
        full, _, _ = ci.search(Q, k=10, n_probe=8, cut=0.0)
        np.testing.assert_array_equal(ids, np.asarray(full)[:B])


def test_search_default_config(built):
    """Regression: the default adaptive config (cut with min_probe floor)
    must stay within a few pp of the exhaustive fixed-probe config."""
    _, Q, ci, gt_ids, gt_dists = built
    ids_d, _, _ = ci.search(Q, k=10)
    ids_f, _, _ = ci.search(Q, k=10, n_probe=8, cut=0.0)
    rec_d = compute_recall(np.asarray(ids_d), gt_ids, gt_dists, 10)
    rec_f = compute_recall(np.asarray(ids_f), gt_ids, gt_dists, 10)
    assert rec_d >= rec_f - 0.04, (rec_d, rec_f)


def test_f32_ext_mode(built, tmp_path):
    """f32 ext rows: exact pool scores (no rerank gather), recall >= the
    int8+rerank path, save/load keeps the mode."""
    ps, Q, ci8, gt_ids, gt_dists = built
    cif = ClusterIndex.build(ps, m=64, Rc=16, iters=3, ext_dtype="f32")
    assert cif.ext_dtype == "f32" and cif.qpoints is None
    ids8, _, _ = ci8.search(Q, k=10, n_probe=8, cut=0.0)
    idsf, distsf, _ = cif.search(Q, k=10, n_probe=8, cut=0.0)
    rec8 = compute_recall(np.asarray(ids8), gt_ids, gt_dists, 10)
    recf = compute_recall(np.asarray(idsf), gt_ids, gt_dists, 10)
    assert recf >= rec8 - 0.01, (recf, rec8)
    # returned distances are exact full-precision (no tier domain)
    X = np.asarray(ps.data[: ps.n], np.float32)
    Qn = np.asarray(Q, np.float32)
    idsf = np.asarray(idsf)
    distsf = np.asarray(distsf)
    for qi in range(0, len(Qn), 13):
        for j in range(10):
            if idsf[qi, j] < 0:
                continue
            true = ((X[idsf[qi, j]] - Qn[qi]) ** 2).sum()
            assert abs(true - distsf[qi, j]) < 1e-3 * max(1.0, true)
    p = str(tmp_path / "cif.npz")
    cif.save(p)
    cif2 = ClusterIndex.load(p, ps)
    assert cif2.ext_dtype == "f32"
    ids2, _, _ = cif2.search(Q, k=10, n_probe=8, cut=0.0)
    np.testing.assert_array_equal(np.asarray(ids2), idsf)


def test_native_balance_matches_numpy():
    """native/balance.cpp is bit-identical to the vectorized numpy
    balancer (which stays as fallback + oracle)."""
    from parlayann_tpu import native as natmod
    from parlayann_tpu.build import clusterindex as cim

    rng = np.random.default_rng(3)
    n, C, m, k = 20000, 400, 64, 8
    ids = rng.integers(0, C, (n, k)).astype(np.int32)
    ids[rng.random((n, k)) < 0.05] = -1
    d = rng.random((n, k)).astype(np.float32)
    order = np.argsort(d[:, 0], kind="stable").astype(np.int64)
    nm = natmod.balance_assign(ids, order, C, m)
    if nm is None:
        pytest.skip("native toolchain unavailable")
    real = natmod.balance_assign
    natmod.balance_assign = lambda *a, **kw: None
    try:
        ref = cim.balance_assign(ids, d, C, m)
    finally:
        natmod.balance_assign = real
    np.testing.assert_array_equal(nm, ref)


def test_approx_assign_matches_exact_top1():
    """Meta-routed hierarchical assignment (used past the exact-Lloyd
    FLOP limit, see ClusterIndex.build): the candidate set is restricted
    to the point's top-P meta-cells, so the top-1 centroid must agree
    with the exact scan for nearly every point, and returned distances
    must be the TRUE squared distances for the ids returned."""
    from parlayann_tpu.build.clusterindex import (
        _assign_all, approx_assign, kmeans,
    )
    import jax.numpy as jnp
    from parlayann_tpu.types import Metric

    rng = np.random.default_rng(3)
    X, _ = synthetic.clustered(
        4000, 32, n_queries=0, n_clusters=40, cluster_std=0.35, seed=3
    )
    data = jnp.asarray(X)
    C = 320
    cents = kmeans(data, 4000, C, metric=Metric.L2, iters=3, seed=0)
    eids, eds = _assign_all(data, 4000, cents, C, 4, Metric.L2)
    aids, ads = approx_assign(data, 4000, cents, C, 4, Metric.L2,
                              P=2, meta_m=48)
    agree = (eids[:, 0] == aids[:, 0]).mean()
    assert agree >= 0.97, f"top-1 agreement {agree}"
    # distances are exact for the ids chosen
    cn = np.asarray(cents)
    want = ((X - cn[aids[:, 0]]) ** 2).sum(1)
    np.testing.assert_allclose(ads[:, 0], want, rtol=1e-3, atol=1e-2)


def test_hierarchical_build_recall(monkeypatch):
    """Force the hierarchical build path at small n and check it delivers
    the same recall class as the exact path."""
    monkeypatch.setenv("PARLAYANN_KMEANS_EXACT_LIMIT", "1")
    X, Q = synthetic.clustered(
        4000, 64, n_queries=48, n_clusters=40, cluster_std=0.35, seed=11
    )
    ps = PointSet.from_numpy(X)
    ci = ClusterIndex.build(ps, m=32, Rc=16, ext_dtype="int8")
    mem = ci.members[ci.members >= 0]
    assert len(mem) == ps.n and len(np.unique(mem)) == ps.n
    gt_ids, gt_dists = compute_groundtruth(ps, Q, k=10, query_batch=48)
    ids, _, _ = ci.search(Q, k=10, n_probe=8, cut=0.0)
    rec = compute_recall(np.asarray(ids), np.asarray(gt_ids),
                         np.asarray(gt_dists), 10)
    assert rec >= 0.9, f"hierarchical-build recall {rec}"


def test_meta_seed_matches_argmin(monkeypatch):
    """Meta-routed query seed (large-C path, VERDICT r3 #2): past the
    argmin cutoff the search routes its seed through the build-side meta
    quantizer instead of streaming all C centroids. Forcing the cutoff
    tiny at small C must populate seed_meta and deliver the same recall
    class as the exact argmin seed."""
    from parlayann_tpu.search import cluster as cb

    X, Q = synthetic.clustered(
        5000, 64, n_queries=64, n_clusters=50, cluster_std=0.35, seed=7
    )
    ps = PointSet.from_numpy(X)
    ci_ref = ClusterIndex.build(ps, m=32, Rc=16, iters=3,
                                ext_dtype="int8")
    assert ci_ref.seed_meta is None  # small C: argmin seed, no router
    gt_ids, gt_dists = compute_groundtruth(ps, Q, k=10, query_batch=64)
    ids, _, _ = ci_ref.search(Q, k=10, n_probe=8, cut=0.0)
    rec_argmin = compute_recall(np.asarray(ids), np.asarray(gt_ids),
                                np.asarray(gt_dists), 10)

    from parlayann_tpu.build.clusterindex import _recenter
    import jax.numpy as jnp

    monkeypatch.setattr(cb, "ARGMIN_SEED_CUTOFF", 8)
    cents = _recenter(jnp.asarray(X), ci_ref.members, ci_ref.C)
    ci = ClusterIndex._finish(ps, ci_ref.members, ci_ref.adj, cents,
                              ci_ref.C, ci_ref.m, ci_ref.Rc,
                              ext_dtype="int8")
    assert ci.seed_meta is not None
    mc, mb, mi = ci.seed_meta
    assert mb.shape[0] == mc.shape[0] == mi.shape[0]
    ids2, d2, _ = ci.search(Q, k=10, n_probe=8, cut=0.0)
    rec_meta = compute_recall(np.asarray(ids2), np.asarray(gt_ids),
                              np.asarray(gt_dists), 10)
    assert rec_meta >= rec_argmin - 0.02, (rec_meta, rec_argmin)
    # distances still true full-precision squared distances
    d2 = np.asarray(d2)
    i2 = np.asarray(ids2)
    want = ((Q[0] - X[i2[0]]) ** 2).sum(1)
    np.testing.assert_allclose(d2[0], want, rtol=1e-3, atol=1e-2)
