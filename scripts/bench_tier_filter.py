"""Mid-beam two-tier filter A/B at 1M (SURVEY item #17).

Three operating points on the same 1M Vamana graph, all against exact GT:

  A. DEFAULT: fused q8 walk + full-precision rerank (the subsumption
     claim's side — in a cheap-tier walk the frontier-full cutoff is
     strictly tighter than the reference's running mean of PAST worsts).
  B. f32 walk (XLA gather path), no filter — the reference's baseline.
  C. f32 walk + q8 running-mean mid-beam filter (beamSearch.h:119-146)
     — the reference's distinct mixed-precision operating point, now a
     first-class beam_search_batch mode.

Run: python scripts/bench_tier_filter.py
Env: BENCH_N (1M), BENCH_Q (10K), BENCH_ROUNDS (5), QS (10,15,22,33).
"""

import os
import sys
import time
from functools import partial

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def log(*a):
    print(*a, flush=True)


def main():
    import jax
    import jax.numpy as jnp

    from parlayann_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from parlayann_tpu.types import BuildParams
    from parlayann_tpu.data.pointset import PointSet
    from parlayann_tpu.data.graph import GraphIndexData
    from parlayann_tpu.build.vamana import build_vamana_graph
    from parlayann_tpu.index import Index
    from parlayann_tpu.search import exact
    from parlayann_tpu.search.beam import beam_search_batch, top_k_from_beam
    from parlayann_tpu.search.rerank import rerank_topk
    from parlayann_tpu.harness.recall import compute_recall
    from parlayann_tpu.ops import quantize
    from parlayann_tpu.utils import synthetic

    n = int(os.environ.get("BENCH_N", 1_000_000))
    d = 128
    nq = int(os.environ.get("BENCH_Q", 10_000))
    k = 10
    rounds = int(os.environ.get("BENCH_ROUNDS", 5))
    qs = [int(x) for x in os.environ.get("QS", "10,15,22,33").split(",")]
    log(f"devices: {jax.devices()}  n={n}")

    X, Q = synthetic.clustered(n, d, n_queries=nq,
                               n_clusters=max(64, n // 100),
                               cluster_std=0.35, seed=7)
    ps = PointSet.from_numpy(X)
    qps = quantize.quantize_pointset(ps, bits=8)
    cdir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "bench_cache")
    import pickle
    gpath = os.path.join(cdir, f"tf_graph_{n}.pkl")
    if os.path.exists(gpath):
        with open(gpath, "rb") as f:
            nb, dg = pickle.load(f)
        graph = GraphIndexData(neighbors=jnp.asarray(nb),
                               degrees=jnp.asarray(dg), n=n,
                               max_degree=nb.shape[1])
        log("graph: cached")
    else:
        t0 = time.perf_counter()
        graph, _ = build_vamana_graph(
            qps, BuildParams(R=32, L=64, alpha=1.2, num_passes=2))
        log(f"graph built {time.perf_counter()-t0:.1f}s")
        with open(gpath, "wb") as f:
            pickle.dump((np.asarray(graph.neighbors),
                         np.asarray(graph.degrees)), f)
    gt = os.path.join(cdir, f"tf_gt_{n}_{nq}.npz")
    if os.path.exists(gt):
        z = np.load(gt)
        gt_ids, gt_d = z["ids"], z["dists"]
    else:
        gt_ids, gt_d = exact.compute_groundtruth(ps, Q, 2 * k)
        np.savez(gt, ids=gt_ids, dists=gt_d)

    Qd = jnp.asarray(Q)
    idx = Index(points=ps, graph=graph).enable_quantized(bits=8)
    log("== A: fused q8 walk + rerank (default) ==")
    for L in qs:
        best = 1e9
        for r in range(3):
            ids, dists, res, dt = idx.batch_search_timed(
                Qd, k=k, beam_size=L, rounds=rounds, warmup=(r == 0))
            best = min(best, dt)
        rec = compute_recall(np.asarray(ids), gt_ids, gt_d, k)
        log(f"A Q={L}: recall={rec:.4f} QPS={nq/best:,.0f}")

    qt = quantize.translate_query(Qd, qps).astype(jnp.float32)

    @partial(jax.jit, static_argnames=("L", "filt"))
    def walk(q, qtier, nbrs, degs, pts, tier, *, L, filt):
        res = beam_search_batch(
            q, pts, nbrs, degs, jnp.zeros((1,), jnp.int32),
            metric=ps.metric, n_valid=n, k=k, L=L,
            filter_data=tier if filt else None,
            filter_queries=qtier if filt else None,
        )
        return top_k_from_beam(res, k)

    for name, filt in (("B: f32 walk no filter", False),
                       ("C: f32 walk + q8 running-mean filter", True)):
        log(f"== {name} ==")
        for L in qs:
            try:
                best = 1e9
                out = walk(Qd, qt, graph.neighbors, graph.degrees,
                           ps.data, qps.data, L=L, filt=filt)
                jax.block_until_ready(out[0])
                for r in range(3):
                    t0 = time.perf_counter()
                    for _ in range(rounds):
                        out = walk(Qd, qt, graph.neighbors, graph.degrees,
                                   ps.data, qps.data, L=L, filt=filt)
                    _ = np.asarray(out[0][:1])
                    best = min(best, (time.perf_counter() - t0) / rounds)
                rec = compute_recall(np.asarray(out[0]), gt_ids, gt_d, k)
                log(f"{name[:1]} Q={L}: recall={rec:.4f} QPS={nq/best:,.0f}")
            except Exception as e:
                log(f"{name[:1]} Q={L}: FAILED {type(e).__name__} "
                    f"{str(e)[:140]}")


if __name__ == "__main__":
    main()
