"""The XLA cluster beam (search/cluster.py) against a plain numpy replay.

The replay walks one query at a time with Python lists: the same seed
(exact top-S centroids), the same probe order (first workable beam entry,
nearest first), the same pool (best member scores, stable order) and the
same stopping rules (n_probe, cut, min_probe). Vectors and queries hold
small integers, so every distance is exact in float32 and the two must
agree bit for bit — ids, distances and probe counts.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from parlayann_tpu.types import Metric
from parlayann_tpu.search.cluster import cluster_search

C, M, RC, D, S = 40, 16, 8, 16, 2
K = 10


def _structure(seed):
    """Integer-valued clusters -> (cents (C, D), mvecs (C, M, D),
    mids (C, M), adj (C, RC)), with a few empty member slots."""
    rng = np.random.default_rng(seed)
    cents = rng.integers(-20, 21, (C, D))
    mvecs = cents[:, None, :] + rng.integers(-4, 5, (C, M, D))
    mids = np.arange(C * M).reshape(C, M)
    empty = rng.random((C, M)) < 0.1
    mids[empty] = -1
    mvecs[empty] = 0
    cd = ((cents[:, None, :] - cents[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(cd, np.iinfo(np.int64).max)
    adj = np.argsort(cd, axis=1, kind="stable")[:, :RC]
    adj[rng.random((C, RC)) < 0.1] = -1
    return cents, mvecs, mids, adj


def _dist(q, x, metric):
    if metric is Metric.MIPS:
        return np.float32(-(x @ q))
    return np.float32(((x - q) ** 2).sum(-1))


def _replay(q, cents, mvecs, mids, adj, metric, n_probe, cut, min_probe):
    """One query, sequentially -> (ids (K,), dists (K,), probes)."""
    W = n_probe + 4
    dc = np.array([_dist(q, c, metric) for c in cents])
    order = np.argsort(dc, kind="stable")[:S]
    beam = [[dc[c], int(c), False] for c in order]  # dist, id, expanded
    pool = []
    nv = 0
    floor = max(min_probe, 1)

    def pick():
        if nv >= n_probe:
            return None
        for lane, (d, c, x) in enumerate(beam):
            ok = not x
            if ok and cut > 0 and metric.is_metric:
                ok = (d < np.float32(cut) * beam[0][0]) or nv < floor
            if ok:
                return lane
        return None

    lane = pick()
    while lane is not None:
        e = beam[lane][1]
        beam[lane][2] = True
        new = [(_dist(q, mvecs[e, j], metric), int(mids[e, j]))
               for j in range(M) if mids[e, j] >= 0]
        pool = sorted(pool + new, key=lambda t: t[0])[:K]
        ids_in_beam = {c for _, c, _ in beam}
        cand = [[_dist(q, cents[a], metric), int(a), False]
                for a in adj[e] if a >= 0 and a not in ids_in_beam]
        beam = sorted(beam + cand, key=lambda t: t[0])[:W]
        nv += 1
        lane = pick()
    pool += [(np.float32(3.0e38), -1)] * (K - len(pool))
    return (np.array([i for _, i in pool]),
            np.array([d for d, _ in pool], np.float32), nv)


CASES = [
    (Metric.L2, "int8", 37, 6, 0.0, 0),
    (Metric.L2, "int8", 512, 6, 0.0, 0),
    (Metric.L2, "f32", 37, 6, 0.0, 0),
    (Metric.L2, "f32", 512, 6, 0.0, 0),
    (Metric.MIPS, "int8", 37, 6, 0.0, 0),
    (Metric.MIPS, "int8", 512, 6, 0.0, 0),
    (Metric.MIPS, "f32", 37, 6, 0.0, 0),
    (Metric.MIPS, "f32", 512, 6, 0.0, 0),
    (Metric.L2, "int8", 512, 12, 1.2, 3),  # cut with a min_probe floor
    (Metric.L2, "f32", 37, 12, 1.1, 0),  # cut alone
]


@pytest.mark.parametrize("metric,layout,B,n_probe,cut,min_probe", CASES)
def test_cluster_beam_matches_replay(metric, layout, B, n_probe, cut,
                                     min_probe):
    cents, mvecs, mids, adj = _structure(seed=B + n_probe)
    if metric is Metric.MIPS:
        # keep dot products inside int8 range for the int8 layout
        cents = np.clip(cents // 3, -6, 6)
        mvecs = np.clip(mvecs // 3, -8, 8)
    rng = np.random.default_rng(B)
    pick = rng.integers(0, C, B)
    Q = cents[pick] + rng.integers(-6, 7, (B, D))
    dt = jnp.int8 if layout == "int8" else jnp.float32
    ids, dists, (nv, _) = cluster_search(
        jnp.asarray(Q, jnp.float32), jnp.asarray(cents, dt),
        jnp.asarray(mvecs, dt), jnp.asarray(mids, jnp.int32),
        jnp.asarray(adj, jnp.int32), jnp.zeros((1, D), jnp.float32),
        None, None, metric=metric, C=C, m=M, Rc=RC, n_points=C * M, k=K,
        n_probe=n_probe, min_probe=min_probe, cut=cut, S=S, pool=K,
        tier_bits=32, rerank="tier",
    )
    ids, dists, nv = np.asarray(ids), np.asarray(dists), np.asarray(nv)
    for b in range(B):
        ri, rd, rn = _replay(Q[b], cents, mvecs, mids, adj, metric,
                             n_probe, cut, min_probe)
        np.testing.assert_array_equal(ids[b], ri, err_msg=f"query {b}")
        np.testing.assert_array_equal(dists[b], rd, err_msg=f"query {b}")
        assert nv[b] == rn, (b, nv[b], rn)
    if cut > 0:
        assert nv.min() < n_probe  # the cut rule fired for some queries
