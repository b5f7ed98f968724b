"""The α-occlusion loop (build/prune.py) against a sequential numpy
oracle of robustPrune's accept/eliminate rule (vamana/index.h:79-116).

Vectors hold small integers, so pairwise distances are exact in float32;
the α comparison is made in float32 on both sides. The two must select
the same ids in the same order."""

import numpy as np
import jax.numpy as jnp
import pytest

from parlayann_tpu.build.prune import _occlusion_loop
from parlayann_tpu.ops.distance import INF
from parlayann_tpu.types import Metric

R = 16
ALPHA = 1.2


def _dist(a, b, metric):
    if metric is Metric.MIPS:
        return np.float32(-(a * b).sum())
    return np.float32(((a - b) ** 2).sum())


def _oracle(ids, dists, vecs, metric):
    """Candidates already sorted by distance: accept the first survivor,
    eliminate every later one it α-occludes, R times."""
    alive = [d < INF for d in dists]
    out = []
    for i in range(len(ids)):
        if len(out) == R:
            break
        if not alive[i]:
            continue
        out.append((ids[i], dists[i]))
        alive[i] = False
        for j in range(len(ids)):
            if alive[j] and (np.float32(ALPHA) * _dist(vecs[i], vecs[j], metric)
                             <= dists[j]):
                alive[j] = False
    out += [(-1, np.float32(INF))] * (R - len(out))
    return [i for i, _ in out], [d for _, d in out]


@pytest.mark.parametrize("metric", [Metric.L2, Metric.MIPS])
@pytest.mark.parametrize("C", [R + 8, 2 * R])
def test_occlusion_loop_matches_oracle(metric, C):
    rng = np.random.default_rng(C)
    B, d = 24, 12
    p = rng.integers(-5, 6, (B, d))
    vecs = p[:, None, :] + rng.integers(-6, 7, (B, C, d))
    dists = np.array([[_dist(p[b], vecs[b, c], metric) for c in range(C)]
                      for b in range(B)], np.float32)
    dists[rng.random((B, C)) < 0.1] = INF  # some invalid candidates
    order = np.argsort(dists, axis=1, kind="stable")
    dists = np.take_along_axis(dists, order, axis=1)
    vecs = np.take_along_axis(vecs, order[:, :, None], axis=1)
    ids = np.where(dists < INF, 1000 + order, 10_000 + np.arange(C))
    got_i, got_d = _occlusion_loop(
        jnp.asarray(ids, jnp.int32), jnp.asarray(dists),
        jnp.asarray(vecs, jnp.float32), jnp.float32(ALPHA), R, metric)
    got_i, got_d = np.asarray(got_i), np.asarray(got_d)
    occluded = 0
    for b in range(B):
        want_i, want_d = _oracle(ids[b], dists[b], vecs[b], metric)
        np.testing.assert_array_equal(got_i[b], want_i, err_msg=f"row {b}")
        np.testing.assert_array_equal(got_d[b], want_d, err_msg=f"row {b}")
        nearest = [int(i) for i, d in zip(ids[b], dists[b]) if d < INF][:R]
        occluded += [int(i) for i in want_i if i >= 0] != nearest
    assert occluded > 0  # α occlusion changed the selection somewhere
