"""Flat (brute-force) search: exactness of every select path vs a numpy
oracle and dynamic validity masking. Reference counterpart for the
semantics:
data_tools/compute_groundtruth.cpp:22-60 (linear scan top-k)."""

import numpy as np
import jax.numpy as jnp
import pytest

from parlayann_tpu.types import Metric
from parlayann_tpu.data.pointset import PointSet
from parlayann_tpu.search.flat import FlatIndex, flat_search_batch
from parlayann_tpu.utils import synthetic


def _oracle(Q, X, k, metric):
    if metric is Metric.MIPS:
        d = -(Q.astype(np.float64) @ X.astype(np.float64).T)
    else:
        d = (
            np.sum(Q.astype(np.float64) ** 2, axis=1)[:, None]
            - 2.0 * Q.astype(np.float64) @ X.astype(np.float64).T
            + np.sum(X.astype(np.float64) ** 2, axis=1)[None, :]
        )
    ids = np.argsort(d, axis=1, kind="stable")[:, :k]
    return ids, np.take_along_axis(d, ids, axis=1)


@pytest.fixture(scope="module")
def data():
    X, Q = synthetic.clustered(3000, 32, n_queries=64, n_clusters=40, seed=3)
    return X, Q


@pytest.mark.parametrize("select", ["sort", "approx", "groupmin"])
def test_flat_matches_oracle(data, select):
    X, Q = data
    ps = PointSet.from_numpy(X)
    ids, dists = flat_search_batch(
        jnp.asarray(Q), ps.data, k=10, metric=ps.metric, n_valid=ps.n,
        chunk=1024, select=select, precision="exact",
    )
    gt_ids, gt_d = _oracle(Q, X, 10, Metric.L2)
    idn = np.asarray(ids)
    # compare by id set (distance ties can permute); approx/groupmin paths
    # must still be exact at this tiny scale (no lane-class collisions
    # beyond ties)
    rec = np.mean(
        [len(set(idn[i]) & set(gt_ids[i])) / 10 for i in range(len(Q))]
    )
    # groupmin keeps one winner per 64-lane group: at chunk=1024 that is
    # only 16 candidates/chunk, so top-10 collisions are common at this
    # tiny scale (they are ~2% at the production chunk=32768)
    assert rec > (0.85 if select == "groupmin" else 0.995)
    np.testing.assert_allclose(
        np.sort(np.asarray(dists), axis=1)[:, 0],
        gt_d[:, 0], rtol=1e-3, atol=1e-2,
    )


def test_flat_mips(data):
    X, Q = data
    ps = PointSet.from_numpy(X, metric=Metric.MIPS)
    ids, dists = flat_search_batch(
        jnp.asarray(Q), ps.data, k=5, metric=Metric.MIPS, n_valid=ps.n,
        chunk=1024, select="sort", precision="exact",
    )
    # PointSet normalizes MIPS data at load; oracle must see the same rows
    gt_ids, _ = _oracle(Q, np.asarray(ps.data)[: ps.n], 5, Metric.MIPS)
    idn = np.asarray(ids)
    rec = np.mean(
        [len(set(idn[i]) & set(gt_ids[i])) / 5 for i in range(len(Q))]
    )
    assert rec > 0.99


def test_flat_valid_mask_and_exclude(data):
    X, Q = data
    ps = PointSet.from_numpy(X)
    n = ps.n
    mask = np.zeros(ps.data.shape[0], bool)
    mask[: n // 2] = True
    ids, _ = flat_search_batch(
        jnp.asarray(Q), ps.data, jnp.asarray(mask), k=10, metric=ps.metric,
        n_valid=n, chunk=1024, select="sort",
    )
    idn = np.asarray(ids)
    assert idn.max() < n // 2
    gt_ids, _ = _oracle(Q, X[: n // 2], 10, Metric.L2)
    rec = np.mean(
        [len(set(idn[i]) & set(gt_ids[i])) / 10 for i in range(len(Q))]
    )
    assert rec > 0.995
    # exclude_ids removes exactly that id per row
    excl = jnp.asarray(gt_ids[:, 0].astype(np.int32))
    ids2, _ = flat_search_batch(
        jnp.asarray(Q), ps.data, jnp.asarray(mask), excl, k=10,
        metric=ps.metric, n_valid=n, chunk=1024, select="sort",
    )
    id2 = np.asarray(ids2)
    assert all(gt_ids[i, 0] not in id2[i] for i in range(len(Q)))


def test_flat_index_quantized(data):
    X, Q = data
    ps = PointSet.from_numpy(X)
    fi = FlatIndex(ps, quantize=True)
    ids, _ = fi.batch_search(Q, k=10)
    gt_ids, _ = _oracle(Q, X, 10, Metric.L2)
    idn = np.asarray(ids)
    rec = np.mean(
        [len(set(idn[i]) & set(gt_ids[i])) / 10 for i in range(len(Q))]
    )
    # int8 tier: quantization reorders near-ties; at d=32 the noise
    # floor is relatively high (production d>=128 tiers measure ~0.99)
    assert rec > 0.90
