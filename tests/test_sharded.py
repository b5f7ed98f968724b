"""Sharded build + search over the 8-device virtual CPU mesh."""

import numpy as np
import pytest

from parlayann_tpu.types import BuildParams, Metric
from parlayann_tpu.data.pointset import PointSet
from parlayann_tpu.parallel.mesh import make_mesh
from parlayann_tpu.parallel.sharded import build_sharded_vamana, sharded_search
from parlayann_tpu.search import exact


def test_sharded_build_and_search(rng):
    n, d, k = 800, 16, 10
    X = rng.standard_normal((n, d)).astype(np.float32)
    Q = rng.standard_normal((32, d)).astype(np.float32)
    mesh = make_mesh(8, data_axis=4)  # 4 dataset shards x 2 query shards
    bp = BuildParams(R=12, L=24, alpha=1.2, num_passes=1, batch_cap_frac=0.5)
    idx = build_sharded_vamana(X, mesh, bp)
    assert idx.rows_per_shard == 200

    ids, dists = sharded_search(idx, Q, k=k, beam_size=32)
    assert ids.shape == (32, k)
    # global ids valid and unique per row
    for row in ids:
        v = row[row >= 0]
        assert np.all(v < n)
        assert len(set(v.tolist())) == len(v)

    gt, _ = exact.exact_knn(Q, PointSet.from_numpy(X), k, chunk=128)
    gt = np.asarray(gt)
    hits = sum(len(set(a.tolist()) & set(b.tolist())) for a, b in zip(ids, gt))
    recall = hits / gt.size
    # 4 independent shard graphs searched exhaustively-ish -> high recall
    assert recall >= 0.85, recall


def test_sharded_uneven_rows(rng):
    n, d = 500, 8  # 500 over 4 shards -> nl=125, last shard padded
    X = rng.standard_normal((n, d)).astype(np.float32)
    Q = rng.standard_normal((8, d)).astype(np.float32)
    mesh = make_mesh(8, data_axis=4)
    bp = BuildParams(R=8, L=16, alpha=1.2, num_passes=1, batch_cap_frac=0.5)
    idx = build_sharded_vamana(X, mesh, bp)
    ids, _ = sharded_search(idx, Q, k=5, beam_size=16)
    assert np.all(ids < n)


def test_cluster_sharded_search(rng):
    """Cluster-sharded capacity mode: recall parity with the single-device
    ClusterIndex on an 8-shard mesh (ext payload sharded by cluster)."""
    from parlayann_tpu.build.clusterindex import ClusterIndex
    from parlayann_tpu.parallel.cluster_sharded import ShardedClusterIndex
    from parlayann_tpu.harness.recall import compute_recall
    from parlayann_tpu.utils import synthetic

    n, d, nq, k = 4000, 64, 64, 10
    X, Q = synthetic.clustered(n, d, n_queries=nq, n_clusters=40,
                               cluster_std=0.1, seed=5)
    ps = PointSet.from_numpy(X)
    gt, gtd = exact.exact_knn(Q, ps, k, chunk=512)
    gt, gtd = np.asarray(gt), np.asarray(gtd)
    ci = ClusterIndex.build(ps, m=32, Rc=16, iters=3, ext_dtype="int8")

    mesh = make_mesh(8, data_axis=8)
    sci = ShardedClusterIndex.from_cluster_index(ci, mesh)
    ids_s, dists_s, nv = sci.search(Q, k=k, n_probe=8, cut=0.0)

    # both run search/cluster.py's cluster_beam on the same index, so the
    # owner-masked fetch must reproduce the one-device answer exactly
    ids_1, dists_1, (nv_1, _) = ci.search(Q, k=k, n_probe=8, cut=0.0)
    np.testing.assert_array_equal(np.asarray(ids_s), np.asarray(ids_1))
    np.testing.assert_allclose(np.asarray(dists_s), np.asarray(dists_1),
                               rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(nv), np.asarray(nv_1))
    assert compute_recall(np.asarray(ids_s), gt, gtd, k) >= 0.9
    assert np.asarray(nv).max() <= 8
    # returned distances are true full-precision distances
    ids_np, d_np = np.asarray(ids_s), np.asarray(dists_s)
    Xf, Qf = np.asarray(ps.data[:n], np.float32), np.asarray(Q, np.float32)
    for qi in range(0, nq, 7):
        for j in range(k):
            if ids_np[qi, j] < 0:
                continue
            true = ((Xf[ids_np[qi, j]] - Qf[qi]) ** 2).sum()
            assert abs(true - d_np[qi, j]) < 1e-2 * max(1.0, true)


def test_cluster_sharded_build(rng):
    """Distributed cluster build (psum'd Lloyd): recall parity with the
    single-device build on the same data."""
    from parlayann_tpu.build.clusterindex import ClusterIndex
    from parlayann_tpu.parallel.cluster_sharded import build_sharded_cluster
    from parlayann_tpu.harness.recall import compute_recall
    from parlayann_tpu.utils import synthetic

    n, d, nq, k = 4000, 64, 64, 10
    X, Q = synthetic.clustered(n, d, n_queries=nq, n_clusters=40,
                               cluster_std=0.1, seed=6)
    ps = PointSet.from_numpy(X)
    gt, gtd = exact.exact_knn(Q, ps, k, chunk=512)
    gt, gtd = np.asarray(gt), np.asarray(gtd)

    mesh = make_mesh(8, data_axis=8)
    sci = build_sharded_cluster(X, mesh, m=32, Rc=16, iters=3)
    ids_s, _, _ = sci.search(Q, k=k, n_probe=8, cut=0.0)
    rec_s = compute_recall(np.asarray(ids_s), gt, gtd, k)

    ci = ClusterIndex.build(ps, m=32, Rc=16, iters=3)
    ids_1, _, _ = ci.search(Q, k=k, n_probe=8, cut=0.0)
    rec_1 = compute_recall(np.asarray(ids_1), gt, gtd, k)
    assert rec_s >= rec_1 - 0.03, (rec_s, rec_1)


@pytest.mark.parametrize("step", [7, 16])
def test_sharded_kmeans_chunks_match_one_chunk(monkeypatch, rng, step):
    """The distributed Lloyd loop walks each shard in point chunks (padded
    last chunk, masked rows, scan-accumulated sums); several chunks must
    give the single-chunk centroids and assignment."""
    import jax.numpy as jnp

    from parlayann_tpu.build import clusterindex
    from parlayann_tpu.parallel.cluster_sharded import _sharded_kmeans_assign
    from parlayann_tpu.parallel.sharded import shard_dataset

    n, d, C = 203, 8, 12  # 4 shards of nl=51, the last one 50 rows
    X = rng.standard_normal((n, d)).astype(np.float32)
    mesh = make_mesh(4, data_axis=4)
    pts, nl = shard_dataset(X, mesh)
    assert nl % step != 0
    init = jnp.asarray(X[rng.choice(n, C, replace=False)])

    def run(chunk):
        monkeypatch.setattr(clusterindex, "_kmeans_chunk_for", lambda c: chunk)
        _sharded_kmeans_assign.clear_cache()
        out = _sharded_kmeans_assign(pts, init, mesh=mesh, metric=Metric.L2,
                                     C=C, n=n, nl=nl, iters=4, k=3)
        return [np.asarray(a) for a in out]

    ids_1, ds_1, cents_1 = run(nl)
    ids_c, ds_c, cents_c = run(step)
    np.testing.assert_allclose(cents_c, cents_1, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(ids_c, ids_1)
    np.testing.assert_allclose(ds_c, ds_1, rtol=1e-5, atol=1e-6)
    assert ids_c.shape == (4, nl, 3)
