"""ClusterIndex build + n_probe sweep on the bench dataset.

Reuses bench.py's synthetic data + cached ground truth; reports QPS with
sustained timing (R back-to-back dispatches + one fence).
Env: BENCH_N/BENCH_D/BENCH_Q/BENCH_ROUNDS, CB_M, CB_RC.
"""

import os
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    import jax

    from parlayann_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from parlayann_tpu.data.pointset import PointSet
    from parlayann_tpu.build.clusterindex import ClusterIndex
    from parlayann_tpu.search import exact
    from parlayann_tpu.harness.recall import compute_recall
    from parlayann_tpu.utils import synthetic

    n = int(os.environ.get("BENCH_N", 100_000))
    d = int(os.environ.get("BENCH_D", 128))
    nq = int(os.environ.get("BENCH_Q", 10_000))
    rounds = int(os.environ.get("BENCH_ROUNDS", 10))
    m = int(os.environ.get("CB_M", 64))
    Rc = int(os.environ.get("CB_RC", 16))
    dt = os.environ.get("CB_DTYPE", "auto")
    k = 10

    log(f"devices: {jax.devices()}")
    X, Q = synthetic.clustered(n, d, n_queries=nq,
                               n_clusters=max(64, n // 100),
                               cluster_std=0.35, seed=7)
    ps = PointSet.from_numpy(X)

    cdir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "bench_cache")
    os.makedirs(cdir, exist_ok=True)
    gtpath = os.path.join(cdir, f"gt_{n}x{d}_{nq}.npz")
    if os.path.exists(gtpath):
        z = np.load(gtpath)
        gt_ids, gt_dists = z["ids"], z["dists"]
        log("ground truth: cached")
    else:
        t0 = time.perf_counter()
        gt_ids, gt_dists = exact.compute_groundtruth(ps, Q, 2 * k)
        log(f"ground truth: {time.perf_counter()-t0:.2f}s")
        np.savez(gtpath, ids=gt_ids, dists=gt_dists)

    t0 = time.perf_counter()
    ci = ClusterIndex.build(ps, m=m, Rc=Rc, ext_dtype=dt)
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    ci = ClusterIndex.build(ps, m=m, Rc=Rc, ext_dtype=dt)
    steady = time.perf_counter() - t0
    log(f"cluster build: cold {cold:.2f}s steady {steady:.2f}s "
        f"C={ci.C} m={ci.m} Rc={ci.Rc}")

    Qd = jax.device_put(np.asarray(Q))
    Qd.block_until_ready()
    best = (0, 0.0, 0.0)
    for npr in (4, 6, 8, 10, 12, 16, 24):
        dt = float("inf")
        out = None
        for _ in range(3):
            t0 = time.perf_counter()
            for _r in range(rounds):
                out = ci.search(Qd, k=k, n_probe=npr, cut=0.0)
            _ = np.asarray(out[0][:1])  # single fence
            dt = min(dt, (time.perf_counter() - t0) / rounds)
        ids = np.asarray(out[0])
        rec = compute_recall(ids, gt_ids, gt_dists, k)
        qps = nq / dt
        log(f"n_probe={npr}: recall={rec:.4f} qps={qps:,.0f} "
            f"({dt*1e3:.2f} ms/batch)")
        if rec >= 0.95 and qps > best[2]:
            best = (npr, rec, qps)
    log(f"best >=.95: n_probe={best[0]} recall={best[1]:.4f} "
        f"qps={best[2]:,.0f}")


if __name__ == "__main__":
    main()
