"""Tests that need an NVIDIA GPU: the compiled XLA:GPU programs against
plain numpy references. Skipped elsewhere; on a GPU host run

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""

import numpy as np
import pytest

from parlayann_tpu.types import Metric

pytestmark = pytest.mark.gpu


def test_exact_groundtruth_on_gpu(gpu_device):
    """HIGHEST-precision exact scan on the card == numpy float64 (no TF32
    rounding in the distances that define ground truth)."""
    from parlayann_tpu.data.pointset import PointSet
    from parlayann_tpu.harness.recall import compute_recall
    from parlayann_tpu.search.exact import compute_groundtruth
    from parlayann_tpu.utils import synthetic

    X, Q = synthetic.clustered(50_000, 128, n_queries=256, n_clusters=500,
                               cluster_std=0.35, seed=7)
    ps = PointSet.from_numpy(X)
    assert next(iter(ps.data.devices())) == gpu_device
    ids, dists = compute_groundtruth(ps, Q, 10, query_batch=256)
    Xd, Qd = X.astype(np.float64), Q.astype(np.float64)
    d = ((Qd * Qd).sum(1)[:, None] - 2 * Qd @ Xd.T
         + (Xd * Xd).sum(1)[None, :])
    want = np.argsort(d, axis=1, kind="stable")[:, :20]
    want_d = np.take_along_axis(d, want, axis=1)
    assert compute_recall(np.asarray(ids), want, want_d, 10,
                          tie_rtol=1e-5) == 1.0
    np.testing.assert_allclose(np.asarray(dists), want_d[:, :10],
                               rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("metric", [Metric.L2, Metric.MIPS])
def test_cluster_beam_on_gpu_matches_replay(gpu_device, metric):
    """The cluster beam compiled for the card agrees exactly with the
    numpy replay (integer data: exact even where a matmul runs in TF32)."""
    import jax.numpy as jnp

    from parlayann_tpu.search.cluster import cluster_search
    from test_cluster_beam import C, D, K, M, RC, S, _replay, _structure

    cents, mvecs, mids, adj = _structure(seed=3)
    if metric is Metric.MIPS:
        cents = np.clip(cents // 3, -6, 6)
        mvecs = np.clip(mvecs // 3, -8, 8)
    rng = np.random.default_rng(5)
    Q = cents[rng.integers(0, C, 256)] + rng.integers(-6, 7, (256, D))
    ids, dists, (nv, _) = cluster_search(
        jnp.asarray(Q, jnp.float32), jnp.asarray(cents, jnp.int8),
        jnp.asarray(mvecs, jnp.int8), jnp.asarray(mids, jnp.int32),
        jnp.asarray(adj, jnp.int32), jnp.zeros((1, D), jnp.float32),
        None, None, metric=metric, C=C, m=M, Rc=RC, n_points=C * M, k=K,
        n_probe=8, S=S, pool=K, tier_bits=32, rerank="tier",
    )
    for b in range(len(Q)):
        ri, rd, rn = _replay(Q[b], cents, mvecs, mids, adj, metric, 8,
                             0.0, 0)
        np.testing.assert_array_equal(np.asarray(ids)[b], ri)
        np.testing.assert_array_equal(np.asarray(dists)[b], rd)
        assert int(np.asarray(nv)[b]) == rn
