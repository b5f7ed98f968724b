"""Side-benchmarks for the non-Vamana builders.

Runs HCNNG / pyNNDescent / HNSW at the reference's suggested SIFT-100K
configs (docs/algorithms.md:77-114) on the bench.py synthetic dataset,
with steady-state (second-run) build times and a small recall/QPS sweep.

Env:
  WHICH=hcnng,pynn,hnsw   which builders to run
  PYNN_GAUSS=1            also run pyNNDescent on a connected single-blob
                          gaussian (its k-NN graph is disconnected on the
                          clustered set)
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from parlayann_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from parlayann_tpu.types import BuildParams
    from parlayann_tpu.data.pointset import PointSet
    from parlayann_tpu.index import Index
    from parlayann_tpu.search import exact
    from parlayann_tpu.harness.recall import compute_recall
    from parlayann_tpu.utils import synthetic

    n, d, nq = 100_000, 128, 10_000
    X, Q = synthetic.clustered(n, d, n_queries=nq,
                               n_clusters=max(64, n // 100),
                               cluster_std=0.35, seed=7)
    ps = PointSet.from_numpy(X)
    cdir = os.path.join(os.path.dirname(__file__), "..", "bench_cache")
    os.makedirs(cdir, exist_ok=True)
    gtpath = os.path.join(cdir, f"gt_{n}x{d}_{nq}.npz")
    if os.path.exists(gtpath):
        z = np.load(gtpath)
        gt_ids, gt_dists = z["ids"], z["dists"]
        print("gt: cached", flush=True)
    else:
        t0 = time.perf_counter()
        gt_ids, gt_dists = exact.compute_groundtruth(ps, Q, 20)
        print(f"gt: {time.perf_counter() - t0:.1f}s", flush=True)
        np.savez(gtpath, ids=gt_ids, dists=gt_dists)
    which = os.environ.get("WHICH", "hcnng,pynn,hnsw").split(",")

    # sustained timing: R back-to-back searches + one fence
    rounds = int(os.environ.get("BENCH_ROUNDS", 8))

    def sweep(idx, name, beams=(30, 40, 55, 80), **kw):
        for beam in beams:
            best = 1e9
            for r in range(3):
                ids, _, _, t = idx.batch_search_timed(
                    Q, k=10, beam_size=beam, two_phase=True,
                    warmup=(r == 0), rounds=rounds, **kw)
                best = min(best, t)
            rec = compute_recall(np.asarray(ids), gt_ids, gt_dists, 10)
            print(f"{name} Q={beam}: recall={rec:.4f} QPS={nq/best:,.0f}",
                  flush=True)

    if "hcnng" in which:
        from parlayann_tpu.build.hcnng import build_hcnng_graph

        bp = BuildParams(cluster_size=1000, MST_deg=3, num_clusters=30)
        for rep in range(2):
            t0 = time.perf_counter()
            graph, _ = build_hcnng_graph(ps, bp, verbose=False)
            avg, mx = graph.stats()
            print(f"HCNNG build rep{rep}: {time.perf_counter()-t0:.2f}s "
                  f"deg {avg:.2f}/{mx}", flush=True)
        sweep(Index(points=ps, graph=graph).enable_quantized(bits=8), "hcnng")

    if "pynn" in which:
        from parlayann_tpu.build.pynndescent import build_pynndescent_graph

        bp = BuildParams(R=40, cluster_size=100, num_clusters=10,
                         alpha=1.2, delta=0.05)
        pynn_q8 = os.environ.get("PYNN_Q8", "0") == "1"
        if os.environ.get("PYNN_GAUSS", "1") == "1":
            # connected dataset: the clustered set's 1000 islands make any
            # pure k-NN graph disconnected
            key = jax.random.key(11)
            k1, k2 = jax.random.split(key)
            Xg = np.asarray(jax.random.normal(k1, (n, d), jnp.float32))
            Qg = np.asarray(jax.random.normal(k2, (nq, d), jnp.float32))
            psg = PointSet.from_numpy(Xg)
            gtg_i, gtg_d = exact.compute_groundtruth(psg, Qg, 20)
        else:
            psg, Qg, gtg_i, gtg_d = ps, Q, gt_ids, gt_dists
        for rep in range(2):
            t0 = time.perf_counter()
            graph, _ = build_pynndescent_graph(psg, bp, verbose=False,
                                               quantize_build=pynn_q8)
            avg, mx = graph.stats()
            print(f"pyNNDescent build rep{rep}: {time.perf_counter()-t0:.2f}s "
                  f"deg {avg:.2f}/{mx}", flush=True)
        idxp = Index(points=psg, graph=graph).enable_quantized(bits=8)
        for beam in (30, 55, 80):
            best = 1e9
            for r in range(3):
                ids, _, _, t = idxp.batch_search_timed(
                    Qg, k=10, beam_size=beam, two_phase=True,
                    warmup=(r == 0), rounds=rounds, random_starts=1)
                best = min(best, t)
            rec = compute_recall(np.asarray(ids), gtg_i, gtg_d, 10)
            print(f"pynn Q={beam}: recall={rec:.4f} QPS={nq/best:,.0f}",
                  flush=True)

    if "hnsw" in which:
        from parlayann_tpu.build.hnsw import build_hnsw_graph

        hnsw_q8 = os.environ.get("HNSW_Q8", "0") == "1"
        hnsw_cap = float(os.environ.get("HNSW_CAP", "0.02"))
        bp = BuildParams(R=20, L=50, alpha=0.9, m_l=0.34,
                         batch_cap_frac=hnsw_cap)
        t0 = time.perf_counter()
        idx, dt = build_hnsw_graph(ps, bp, verbose=False,
                                   quantize_build=hnsw_q8)
        print(f"HNSW build cold: {dt:.2f}s", flush=True)
        idx, dt = build_hnsw_graph(ps, bp, verbose=False,
                                   quantize_build=hnsw_q8)
        print(f"HNSW build: {dt:.2f}s", flush=True)
        for ef in (12, 16, 22, 30, 50):
            best = 1e9
            for r in range(3):
                ids, _, _, dt = idx.batch_search_timed(
                    Q, k=10, ef=ef, warmup=(r == 0), rounds=rounds)
                best = min(best, dt)
            rec = compute_recall(np.asarray(ids), gt_ids, gt_dists, 10)
            print(f"HNSW ef={ef}: recall={rec:.4f} QPS={nq/best:,.0f}",
                  flush=True)


if __name__ == "__main__":
    main()
