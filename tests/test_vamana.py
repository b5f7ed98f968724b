"""End-to-end Vamana build + search recall on small synthetic data."""

import numpy as np
import jax.numpy as jnp

from parlayann_tpu.types import BuildParams, Metric
from parlayann_tpu.data.pointset import PointSet
from parlayann_tpu.build.vamana import build_vamana_graph, batch_schedule
from parlayann_tpu.build.prune import robust_prune_batch
from parlayann_tpu.search import exact
from parlayann_tpu.search.beam import beam_search_batch, top_k_from_beam
from parlayann_tpu.ops.distance import INF
from parlayann_tpu.harness.recall import compute_recall


def _np_robust_prune(p, cand, dists, X, alpha, R):
    """Oracle: the reference's sequential greedy (vamana/index.h:79-116)."""
    order = sorted(range(len(cand)), key=lambda i: (dists[i], cand[i]))
    cands = []
    seen = set()
    for i in order:
        if cand[i] in seen or cand[i] == p:
            continue
        seen.add(cand[i])
        cands.append([cand[i], dists[i]])
    out = []
    idx = 0
    while len(out) < R and idx < len(cands):
        star, d_star = cands[idx]
        idx += 1
        if star == -1:
            continue
        out.append(star)
        for j in range(idx, len(cands)):
            pp, d_pp = cands[j]
            if pp == -1:
                continue
            d_sp = ((X[star] - X[pp]) ** 2).sum()
            if alpha * d_sp <= d_pp:
                cands[j][0] = -1
    return out


def test_robust_prune_matches_reference_oracle(rng):
    n, d, C, R = 200, 8, 24, 6
    X = rng.standard_normal((n, d)).astype(np.float32)
    ps = PointSet.from_numpy(X)
    for trial in range(5):
        p = int(rng.integers(0, n))
        cand = rng.choice(n, C, replace=False).astype(np.int32)
        dists = ((X[cand] - X[p]) ** 2).sum(1).astype(np.float32)
        res = robust_prune_batch(
            jnp.asarray([p], dtype=jnp.int32),
            jnp.asarray(cand[None, :]),
            jnp.asarray(dists[None, :]),
            ps.data,
            1.2,
            R=R,
            metric=Metric.L2,
            n_valid=n,
        )
        got = [int(x) for x in np.asarray(res.ids[0]) if x >= 0]
        want = _np_robust_prune(p, cand.tolist(), dists.tolist(), X, 1.2, R)
        assert got == want, f"trial {trial}: {got} != {want}"


def test_batch_schedule_matches_reference():
    # index.h:206-233 with n=1000, max_fraction=.02 -> cap 20
    sched, mb = batch_schedule(1000, 1000, 0.02)
    assert mb == 20
    assert sched[0] == (0, 1)
    assert sched[1] == (1, 3)
    assert sched[2] == (3, 7)
    # doubling stops once 2^inc > 20; then fixed-size 20
    sizes = [hi - lo for lo, hi in sched]
    assert max(sizes) == 20
    assert sched[-1][1] == 1000
    # covers [0, n) exactly, no overlaps
    pos = 0
    for lo, hi in sched:
        assert lo == pos
        pos = hi
    assert pos == 1000


def test_vamana_build_and_search(rng):
    n, d, k = 1000, 24, 10
    X = rng.standard_normal((n, d)).astype(np.float32)
    Q = rng.standard_normal((50, d)).astype(np.float32)
    ps = PointSet.from_numpy(X)
    bp = BuildParams(R=16, L=32, alpha=1.2, num_passes=2, batch_cap_frac=0.25)
    graph, stats = build_vamana_graph(ps, bp)

    avg_deg, max_deg = graph.stats()
    assert max_deg <= 16
    assert avg_deg > 4  # graph is actually populated

    gt_ids, _ = exact.exact_knn(Q, ps, k, chunk=128)
    res = beam_search_batch(
        jnp.asarray(Q), ps.data, graph.neighbors, graph.degrees,
        jnp.zeros((1,), jnp.int32),
        metric=Metric.L2, n_valid=n, k=k, L=48,
    )
    ids, dists = top_k_from_beam(res, k)
    ids = np.asarray(ids)
    hits = sum(
        len(set(a.tolist()) & set(b.tolist()))
        for a, b in zip(ids, np.asarray(gt_ids))
    )
    recall = hits / (50 * k)
    assert recall >= 0.9, f"recall {recall}"

    # rows are sorted by distance (index.h:180-185)
    nb = np.asarray(graph.neighbors)
    dg = np.asarray(graph.degrees)
    i = int(np.argmax(dg >= 3))
    row = nb[i, : dg[i]]
    dr = ((X[row] - X[i]) ** 2).sum(1)
    assert np.all(np.diff(dr) >= -1e-4)
    # no self loops, no duplicates
    for v in range(0, n, 97):
        rowv = nb[v, : dg[v]].tolist()
        assert v not in rowv
        assert len(set(rowv)) == len(rowv)


def test_vamana_single_batch_mode(rng):
    """single_batch: random init edges, one batch per pass, self starts
    (index.h:156-169)."""
    n, d, k = 800, 16, 10
    X = rng.standard_normal((n, d)).astype(np.float32)
    Q = rng.standard_normal((30, d)).astype(np.float32)
    ps = PointSet.from_numpy(X)
    bp = BuildParams(R=16, L=32, alpha=1.2, num_passes=2, single_batch=8)
    graph, _ = build_vamana_graph(ps, bp)
    avg, _ = graph.stats()
    assert avg > 4
    gt, _ = exact.exact_knn(Q, ps, k, chunk=128)
    res = beam_search_batch(
        jnp.asarray(Q), ps.data, graph.neighbors, graph.degrees,
        jnp.zeros((1,), jnp.int32), metric=Metric.L2, n_valid=n, k=k, L=40,
    )
    ids, _ = top_k_from_beam(res, k)
    recall = sum(
        len(set(a.tolist()) & set(b.tolist()))
        for a, b in zip(np.asarray(ids), np.asarray(gt))
    ) / (30 * k)
    assert recall >= 0.85, recall


def test_mips_end_to_end_sparse_bytes(rng):
    """MIPS e2e regression (VERDICT r3 #7): canonical config (normalize +
    q8 build tier + alpha<=1) on SIFT-like sparse byte data must deliver
    high recall AND a connected graph. Guards the measured narrow-cone
    pathology: on DENSE all-positive bytes the alpha=0.98 occlusion rule
    on negated dots never fires and the graph fragments into islands
    (reach 83/4000) — sparse data spreads the cosines and the rule works
    (reference semantics, index.h:111 + builder.cpp:45-54)."""
    from collections import deque

    from parlayann_tpu.types import Metric
    from parlayann_tpu.ops import quantize
    from parlayann_tpu.index import Index

    n, d, nc = 3000, 64, 30
    mask = rng.random((nc, d)) < 0.35
    centers = np.where(mask, rng.gamma(1.2, 55.0, (nc, d)), 0.0)
    a = rng.integers(0, nc, n)
    X = centers[a] * rng.gamma(4.0, 0.25, (n, d))
    X = np.clip(np.round(X + rng.normal(0, 4, (n, d))), 0, 255).astype(np.uint8)
    qa = rng.integers(0, nc, 48)
    Q = centers[qa] * rng.gamma(4.0, 0.25, (48, d))
    Q = np.clip(np.round(Q + rng.normal(0, 4, (48, d))), 0, 255).astype(np.float32)
    Qn = Q / np.maximum(np.linalg.norm(Q, axis=1, keepdims=True), 1e-9)

    ps = PointSet.from_numpy(X, metric=Metric.MIPS, normalize=True)
    bps = quantize.quantize_pointset(ps, bits=8)
    g, _ = build_vamana_graph(
        bps, BuildParams(R=16, L=32, alpha=0.98, num_passes=2))
    # connectivity: BFS from 0 reaches (almost) everything
    nb = np.asarray(g.neighbors)
    dg = np.asarray(g.degrees)
    seen = np.zeros(n, bool)
    qd = deque([0])
    seen[0] = True
    while qd:
        v = qd.popleft()
        for j in nb[v][: dg[v]]:
            if j >= 0 and not seen[j]:
                seen[j] = True
                qd.append(j)
    assert seen.sum() > 0.95 * n, f"graph fragmented: reach {seen.sum()}/{n}"

    gt_i, gt_d = exact.compute_groundtruth(ps, Qn, 20)
    idx = Index(points=ps, graph=g).enable_quantized(bits=8)
    ids, _, _ = idx.batch_search(Qn, k=10, beam_size=32)
    rec = compute_recall(np.asarray(ids), np.asarray(gt_i),
                         np.asarray(gt_d), 10)
    assert rec >= 0.9, rec
