"""Cluster-index tuning sweep: (m, starts, n_probe) grid on synth100k.

Goal: find the fastest config at recall >= .95.
Larger m scores more points per probe (fewer probes for equal coverage);
more starts seed the beam with more exact centroids (one matmul scan)
so fewer navigation hops are needed. Uses the cached bench GT.

Env: BENCH_N/BENCH_D/BENCH_Q, MS="64,96,128", ROUNDS.
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    import jax

    from parlayann_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from parlayann_tpu.data.pointset import PointSet
    from parlayann_tpu.build.clusterindex import ClusterIndex
    from parlayann_tpu.harness.recall import compute_recall
    from parlayann_tpu.utils import synthetic

    n = int(os.environ.get("BENCH_N", 100_000))
    d = int(os.environ.get("BENCH_D", 128))
    nq = int(os.environ.get("BENCH_Q", 10_000))
    rounds = int(os.environ.get("ROUNDS", 10))
    k = 10

    print(f"devices: {jax.devices()}", flush=True)
    X, Q = synthetic.clustered(n, d, n_queries=nq,
                               n_clusters=max(64, n // 100),
                               cluster_std=0.35, seed=7)
    ps = PointSet.from_numpy(X)
    cdir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "..", "bench_cache")
    z = np.load(os.path.join(cdir, f"gt_{n}x{d}_{nq}.npz"))
    gt_ids, gt_dists = z["ids"], z["dists"]

    Qd = jax.device_put(np.asarray(Q))
    Qd.block_until_ready()

    ms = [int(x) for x in os.environ.get("MS", "64,96,128").split(",")]
    s_list = [int(x) for x in os.environ.get("SS", "2,4,8").split(",")]
    p_list = [int(x) for x in os.environ.get("PROBES", "2,3,4,5,6").split(",")]
    best = (0.0, 0.0, "")
    for m in ms:
        t0 = time.perf_counter()
        ci = ClusterIndex.build(ps, m=m, Rc=16, ext_dtype="f32")
        print(f"m={m}: build {time.perf_counter()-t0:.2f}s C={ci.C}",
              flush=True)
        for S in s_list:
            for npr in p_list:
                if npr * m < 128:
                    continue
                dt = float("inf")
                out = None
                for _ in range(3):
                    *out, dt_i = ci.search_timed(
                        Qd, k=k, n_probe=npr, min_probe=0, cut=0.0,
                        starts=S, rounds=rounds)
                    dt = min(dt, dt_i)
                rec = compute_recall(np.asarray(out[0]), gt_ids, gt_dists, k)
                qps = nq / dt
                tag = f"m={m} S={S} probes={npr}"
                print(f"  [{tag}] recall={rec:.4f} QPS={qps:,.0f}",
                      flush=True)
                if rec >= 0.95 and qps > best[1]:
                    best = (rec, qps, tag)
                if rec >= 0.995:
                    break
    print(f"BEST >= .95: {best[2]} recall={best[0]:.4f} QPS={best[1]:,.0f}",
          flush=True)


if __name__ == "__main__":
    main()
