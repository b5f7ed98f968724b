"""Microbench flat (brute-force) search on the device.

Env: BENCH_N/BENCH_D/B/K, SELECTS=sort,approx, TIERS=f32,q8.
Prints ms per batch and QPS, plus recall vs cached GT when available.
"""

from __future__ import annotations

import os
import time

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from parlayann_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    print("devices:", jax.devices(), flush=True)

    from parlayann_tpu.data.pointset import PointSet
    from parlayann_tpu.ops import quantize
    from parlayann_tpu.search.flat import flat_search_batch
    from parlayann_tpu.utils import synthetic

    n = int(os.environ.get("BENCH_N", 100_000))
    d = int(os.environ.get("BENCH_D", 128))
    B = int(os.environ.get("B", 10240))
    k = int(os.environ.get("K", 10))

    X, Q = synthetic.clustered(n, d, n_queries=B, n_clusters=max(64, n // 100),
                               cluster_std=0.35, seed=7)
    ps = PointSet.from_numpy(X)
    qd = jnp.asarray(Q)

    gt = None
    gtp = os.path.join(os.path.dirname(__file__), "..", "bench_cache",
                       f"gt_{n}x{d}_{B}.npz")
    if os.path.exists(gtp):
        gt = np.load(gtp)["ids"][:, :k]

    tiers = os.environ.get("TIERS", "f32,q8").split(",")
    selects = os.environ.get("SELECTS", "sort,approx").split(",")
    chunks = [int(c) for c in os.environ.get("CHUNKS", "32768").split(",")]
    for tier in tiers:
        if tier == "q8":
            tps = quantize.quantize_pointset(ps, bits=8)
            data = tps.data
            q_t = quantize.translate_query(qd, tps).astype(jnp.float32)
        else:
            data = ps.data
            q_t = qd
        for select in selects:
            for chunk in chunks:
                ids, dists = flat_search_batch(
                    q_t, data, k=k, metric=ps.metric, n_valid=ps.n,
                    chunk=chunk, select=select)
                _ = np.asarray(ids[:1])
                best = float("inf")
                for _i in range(4):
                    t0 = time.perf_counter()
                    ids, dists = flat_search_batch(
                        q_t, data, k=k, metric=ps.metric, n_valid=ps.n,
                        chunk=chunk, select=select)
                    _ = np.asarray(ids[:1])
                    best = min(best, time.perf_counter() - t0)
                qps = B / best
                rec = -1.0
                if gt is not None:
                    idn = np.asarray(ids)
                    rec = np.mean([
                        len(set(idn[i, :k]) & set(gt[i])) / k
                        for i in range(min(B, len(gt)))])
                print(f"tier={tier:3s} select={select:6s} chunk={chunk:6d}: "
                      f"{best*1000:8.2f} ms  {qps:12,.0f} QPS  recall={rec:.4f}",
                      flush=True)


if __name__ == "__main__":
    main()
