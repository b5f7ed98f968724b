"""Cluster-index coverage diagnostic (CPU): where does high-recall loss
come from — probe SELECTION (beam order vs exact top-P centroids) or
assignment COVERAGE (true neighbor's cluster simply not in any top-P)?

For each probe count P it prints:
  cov(assign)  — oracle recall ceiling of the shipped balanced
                 assignment: fraction of true top-10 whose cluster is
                 within the query's exact top-P centroids.
  cov(nat)     — same, with every point in its TRUE nearest cluster
                 (capacity ignored) — isolates the balancer's cost.
  cov(dup)     — balanced assignment + boundary DUPLICATES filled into
                 the slack capacity (each free slot takes the closest
                 unduplicated 2nd-choice point) — the multi-assign
                 upper bound at the same ext footprint.

Compare cov(assign) to the measured fused recall at the same P
(measured): the gap is what better probe selection could recover; the
cov columns bound what better assignment could.

Run: JAX_PLATFORMS=cpu python scripts/diag_cluster_coverage.py
Env: N (default 100_000), PROBES (csv).
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def coverage(pt2c, gt_ids, qtop, P, k=10):
    """pt2c: (n, A) cluster ids per point (-1 pad). qtop: (nq, Pmax)
    exact centroid ranking. -> mean fraction of the true top-k whose
    cluster set intersects the query's top-P clusters."""
    nq = gt_ids.shape[0]
    top = qtop[:, :P]  # (nq, P)
    gclu = pt2c[gt_ids[:, :k]]  # (nq, k, A)
    hit = (gclu[:, :, :, None] == top[:, None, None, :]).any(axis=(2, 3))
    return hit.mean()


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    from parlayann_tpu.build.clusterindex import (
        kmeans, _assign_all, balance_assign, _recenter)
    from parlayann_tpu.types import Metric
    from parlayann_tpu.utils import synthetic

    n = int(os.environ.get("N", 100_000))
    d, nq, k = 128, 10_000, 10
    m, cand, slack = 64, 8, 1.25
    X, Q = synthetic.clustered(n, d, n_queries=nq,
                               n_clusters=max(64, n // 100),
                               cluster_std=0.35, seed=7)
    gtpath = os.path.join(os.path.dirname(__file__), "..", "bench_cache",
                          f"gt_{n}x{d}_{nq}.npz")
    z = np.load(gtpath)
    gt_ids = z["ids"][:, :k]

    C = max(8, int(-(-n * slack // m)))
    t0 = time.perf_counter()
    data = np.asarray(X, np.float32)
    cents = kmeans(data, n, C, metric=Metric.L2, iters=6, seed=0)
    nbr_ids, nbr_d = _assign_all(data, n, cents, C, cand, Metric.L2)
    members = balance_assign(np.asarray(nbr_ids), np.asarray(nbr_d), C, m)
    cents = np.asarray(_recenter(data, members, C))
    print(f"build: C={C} ({time.perf_counter()-t0:.1f}s)", flush=True)

    # point -> clusters maps
    nbr_ids = np.asarray(nbr_ids)
    pt2c_nat = nbr_ids[:, :1]  # natural nearest (pre-balance choice list)
    pt2c_bal = np.full((n, 1), -1, np.int32)
    fill = (members >= 0).sum(axis=1)
    cc, ss = np.nonzero(members >= 0)
    pt2c_bal[members[cc, ss], 0] = cc

    # duplicates: each cluster's free slots take the closest points whose
    # balanced home is elsewhere, in global distance-priority order over
    # the candidate ranks (same BFS-over-ranks shape as balance_assign)
    free = m - fill
    dup_of = np.full(n, -1, np.int32)
    order = np.argsort(nbr_d[:, 0], kind="stable")
    nfree = free.copy()
    for j in range(cand):
        cj = nbr_ids[order, j]
        ok = (cj >= 0) & (cj != pt2c_bal[order, 0]) & (dup_of[order] < 0)
        sidx = np.argsort(cj, kind="stable")
        cs = cj[sidx]
        oks = ok[sidx]
        newgrp = np.r_[True, cs[1:] != cs[:-1]]
        grp = np.maximum.accumulate(np.where(newgrp, np.arange(len(cs)), 0))
        rank = np.cumsum(oks) - np.maximum.accumulate(
            np.where(newgrp, np.cumsum(oks) - oks, 0))
        cap = np.where(oks, nfree[np.clip(cs, 0, C - 1)], 0)
        acc = oks & (rank <= cap)
        pts = order[sidx[acc]]
        dup_of[pts] = cs[acc]
        nfree -= np.bincount(cs[acc], minlength=C)
    print(f"duplicates placed: {(dup_of >= 0).sum()} of {free.sum()} free "
          f"slots", flush=True)
    pt2c_dup = np.concatenate([pt2c_bal, dup_of[:, None]], axis=1)

    # exact centroid ranking per query (top-Pmax)
    probes = [int(x) for x in os.environ.get(
        "PROBES", "4,6,8,12,16,24,32").split(",")]
    Pmax = max(probes)
    qd = ((Q ** 2).sum(1)[:, None] + (cents ** 2).sum(1)[None, :]
          - 2.0 * Q @ cents.T)
    qtop = np.argsort(qd, axis=1)[:, :Pmax].astype(np.int32)

    print(f"{'P':>4} {'cov(assign)':>12} {'cov(nat)':>9} {'cov(dup)':>9}")
    for P in probes:
        ca = coverage(pt2c_bal, gt_ids, qtop, P, k)
        cn = coverage(pt2c_nat, gt_ids, qtop, P, k)
        cd = coverage(pt2c_dup, gt_ids, qtop, P, k)
        print(f"{P:>4} {ca:>12.4f} {cn:>9.4f} {cd:>9.4f}", flush=True)


if __name__ == "__main__":
    main()
