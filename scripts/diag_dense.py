"""Dense-graph operating point: a denser graph (R=96/128) reads more per
hop but converges in fewer hops with higher recall per hop. Build +
sweep to find the QPS-optimal R.

Env: BENCH_N/BENCH_D/BENCH_Q, RS (comma list, default "96,128").
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

    from parlayann_tpu.build.vamana import build_vamana_graph
    from parlayann_tpu.data.graph import GraphIndexData
    from parlayann_tpu.data.pointset import PointSet
    from parlayann_tpu.harness.recall import compute_recall
    from parlayann_tpu.index import Index
    from parlayann_tpu.ops import quantize
    from parlayann_tpu.types import BuildParams
    from parlayann_tpu.utils import synthetic

    n = int(os.environ.get("BENCH_N", 100_000))
    d = int(os.environ.get("BENCH_D", 128))
    nq = int(os.environ.get("BENCH_Q", 10_000))
    k = 10

    print(f"[{jax.devices()[0].device_kind}]", flush=True)
    X, Q = synthetic.clustered(n, d, n_queries=nq,
                               n_clusters=max(64, n // 100),
                               cluster_std=0.35, seed=7)
    ps = PointSet.from_numpy(X)
    root = os.path.join(os.path.dirname(__file__), "..", "bench_cache")
    z = np.load(os.path.join(root, f"gt_{n}x{d}_{nq}.npz"))
    gt_ids, gt_dists = z["ids"], z["dists"]
    qps8 = quantize.quantize_pointset(ps, bits=8)

    for R in (int(x) for x in os.environ.get("RS", "96,128").split(",")):
        gpath = os.path.join(root, f"r{R}_{n}x{d}.graph")
        if os.path.exists(gpath):
            graph = GraphIndexData.load(gpath)
            print(f"R={R}: graph cached", flush=True)
        else:
            bp = BuildParams(R=R, L=2 * R, alpha=1.15, num_passes=2,
                             batch_cap_frac=0.04)
            t0 = time.perf_counter()
            graph, _ = build_vamana_graph(qps8, bp, verbose=False)
            dt = time.perf_counter() - t0
            avg, _ = graph.stats()
            print(f"R={R}: build {dt:.1f}s deg {avg:.2f}", flush=True)
            graph.save(gpath)
        idx = Index(points=ps, graph=graph).enable_quantized(bits=8)
        for beam in (8, 10, 12, 14, 17):
            dt = float("inf")
            rounds = int(os.environ.get("BENCH_ROUNDS", 10))
            for _ in range(3):
                ids, dists, res, dt_i = idx.batch_search_timed(
                    Q, k=k, beam_size=beam, rounds=rounds)
                dt = min(dt, dt_i)
            rec = compute_recall(np.asarray(ids), gt_ids, gt_dists, k)
            print(f"  [r{R}] Q={beam:3d} recall={rec:.4f} QPS={nq/dt:,.0f} "
                  f"cmps={np.asarray(res.dist_cmps).mean():.0f}", flush=True)
            if rec > 0.995:
                break


if __name__ == "__main__":
    main()
