"""A/B: ClusterIndex slack (cluster-count overprovision) sweep.

The CPU coverage study (diag_cluster_sweep_cov.py)
showed the capacity balancer is the recall ceiling: displaced points
(22.6% at slack=1.25) sit in clusters the query never probes. More
slack means emptier cells and near-zero displacement:

    slack  C(100K)  displaced  cov@P4   cov@P6   cov@P8
    1.25    1954      .226      .9601    .9654    .9678
    1.50    2344      .163      .9798    .9854    .9871
    2.00    3125      .094      .9842    .9959    .9972

This script measures what that costs on the device: build time,
and recall/QPS at probes {3,4,6,8,12} per slack, m=64 f32 layout,
sustained timing (rounds back-to-back + one fence), best-of-3.

Run: python scripts/diag_cluster_slack.py
Env: N, SLACKS (csv), PROBES (csv), ROUNDS.
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    import jax

    from parlayann_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from parlayann_tpu.build.clusterindex import ClusterIndex
    from parlayann_tpu.data.pointset import PointSet
    from parlayann_tpu.harness.recall import compute_recall
    from parlayann_tpu.utils import synthetic

    n = int(os.environ.get("N", 100_000))
    d, nq, k = 128, 10_000, 10
    rounds = int(os.environ.get("ROUNDS", 10))
    X, Q = synthetic.clustered(n, d, n_queries=nq,
                               n_clusters=max(64, n // 100),
                               cluster_std=0.35, seed=7)
    ps = PointSet.from_numpy(X)
    gtpath = os.path.join(os.path.dirname(__file__), "..", "bench_cache",
                          f"gt_{n}x{d}_{nq}.npz")
    z = np.load(gtpath)
    gt_ids, gt_dists = z["ids"], z["dists"]
    print(f"devices: {jax.devices()}", flush=True)
    Qd = jax.device_put(np.asarray(Q))
    Qd.block_until_ready()

    slacks = [float(s) for s in os.environ.get(
        "SLACKS", "1.25,1.5,2.0").split(",")]
    probes = [int(p) for p in os.environ.get(
        "PROBES", "3,4,6,8,12").split(",")]

    for slack in slacks:
        t0 = time.perf_counter()
        ci = ClusterIndex.build(ps, m=64, slack=slack, ext_dtype="f32")
        cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        ci = ClusterIndex.build(ps, m=64, slack=slack, ext_dtype="f32")
        steady = time.perf_counter() - t0
        print(f"slack={slack} C={ci.C} build cold={cold:.2f}s "
              f"steady={steady:.2f}s", flush=True)
        for npr in probes:
            best = 1e9
            out = None
            for _ in range(3):
                out = ci.search_timed(Qd, k=k, n_probe=npr, cut=0.0,
                                      rounds=rounds)
                best = min(best, out[-1])
            rec = compute_recall(np.asarray(out[0]), gt_ids, gt_dists, k)
            print(f"  slack={slack} probes={npr:3d} recall={rec:.4f} "
                  f"QPS={nq/best:,.0f}", flush=True)


if __name__ == "__main__":
    main()
