"""1M-scale capacity-tier benchmark.

Measures, on the same R=32 L=64 Vamana graph over 1M clustered points:
  - the q8 tier (the default) recall/QPS sweep
  - packed 1-bit tier + full-precision rerank recall/QPS sweep
  - ClusterIndex (two-level, m=64) build + recall/QPS sweep
All search timings: R back-to-back dispatches + one fence.

Artifacts cached in bench_cache/ (GT + graph): the 1M build costs ~200 s
steady, so reruns skip straight to the sweeps with BENCH_REBUILD=0.
"""

import os
import sys
import time

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
    from parlayann_tpu.build.clusterindex import ClusterIndex
    from parlayann_tpu.index import Index
    from parlayann_tpu.ops import quantize
    from parlayann_tpu.search import exact
    from parlayann_tpu.harness.recall import compute_recall
    from parlayann_tpu.utils import synthetic

    n = int(os.environ.get("BENCH_N", 1_000_000))
    d = 128
    nq = 10_000
    k = 10
    rounds = int(os.environ.get("BENCH_ROUNDS", 8))
    R, L = 32, 64

    log(f"devices: {jax.devices()}")
    t0 = time.perf_counter()
    X, Q = synthetic.clustered(n, d, n_queries=nq, n_clusters=max(64, n // 100),
                               cluster_std=0.35, seed=7)
    ps = PointSet.from_numpy(X)
    log(f"data: {n}x{d} ({time.perf_counter()-t0:.1f}s)")

    cdir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "bench_cache")
    os.makedirs(cdir, exist_ok=True)
    gtpath = os.path.join(cdir, f"gt_{n}x{d}_{nq}.npz")
    if os.path.exists(gtpath):
        z = np.load(gtpath)
        gt_ids, gt_dists = z["ids"], z["dists"]
        log("gt: cached")
    else:
        t0 = time.perf_counter()
        gt_ids, gt_dists = exact.compute_groundtruth(ps, Q, 2 * k)
        log(f"gt: {time.perf_counter()-t0:.1f}s")
        np.savez(gtpath, ids=gt_ids, dists=gt_dists)
    gt_ids = np.asarray(gt_ids)
    gt_dists = np.asarray(gt_dists)

    log(f"tiers at n={n}: f32 {n*d*4/2**30:.2f} GiB, q8 {n*d/2**30:.2f} "
        f"GiB, 1-bit {n*(d//8)/2**30:.3f} GiB, graph {n*R*4/2**30:.2f} GiB")

    gpath = os.path.join(cdir, f"r{R}_{n}x{d}.graph")
    rebuild = os.environ.get("BENCH_REBUILD", "0") == "1"
    if os.path.exists(gpath) and not rebuild:
        graph = GraphIndexData.load(gpath)
        log(f"graph: cached ({gpath})")
    else:
        qps_build = quantize.quantize_pointset(ps, bits=8)
        bp = BuildParams(R=R, L=L, alpha=1.2, num_passes=2,
                         batch_cap_frac=0.04)
        t0 = time.perf_counter()
        graph, stats = build_vamana_graph(qps_build, bp, verbose=False)
        log(f"build: {time.perf_counter()-t0:.1f}s "
            f"deg {graph.stats()[0]:.2f}/{graph.stats()[1]}")
        graph.save(gpath)

    Qd = jax.device_put(np.asarray(Q))
    Qd.block_until_ready()

    def sweep(idx, name, beams, **kw):
        rows = []
        for b in beams:
            best = 1e9
            ids = None
            for _ in range(2):
                ids, _, _, dt = idx.batch_search_timed(
                    Qd, k=k, beam_size=b, rounds=rounds, **kw)
                best = min(best, dt)
            rec = compute_recall(np.asarray(ids), gt_ids, gt_dists, k)
            log(f"  [{name}] Q={b:4d} recall={rec:.4f} QPS={nq/best:,.0f}")
            rows.append((b, rec, nq / best))
            if rec > 0.995:
                break
        return rows

    which = os.environ.get("WHICH", "q8,bit,cluster").split(",")

    def env_beams(name, default):
        v = os.environ.get(name)
        return tuple(int(x) for x in v.split(",")) if v else default

    if "q8" in which:
        idx = Index(points=ps, graph=graph)
        idx.enable_quantized(bits=8)
        log("— q8 tier —")
        sweep(idx, "q8", env_beams("BEAMS_Q8", (70, 100, 140, 190, 250)))
        del idx

    if "bit" in which:
        idx = Index(points=ps, graph=graph)
        idx.enable_bit_tier()
        log("— packed 1-bit tier + rerank —")
        # coarse tier: recall comes from the rerank pool, so sweep wider
        # beams and a deeper pool
        sweep(idx, "bit", env_beams("BEAMS_BIT", (100, 150, 220, 300, 400)),
              rerank_factor=20)
        del idx

    if "jlbit" in which:
        # JL-bit tier dim sweep: the raw d=128 sign-bit
        # tier is information-limited (recall .92 ceiling at any beam) —
        # jl_point.h:108-191 exists precisely to RAISE the bit count.
        for jd in env_beams("JL_DIMS", (256, 384, 512)):
            idx = Index(points=ps, graph=graph)
            idx.enable_jl(jl_dims=jd, bits=1)
            log(f"— JL sign-bit tier jl_dims={jd} + rerank —")
            sweep(idx, f"jl{jd}",
                  env_beams("BEAMS_JL", (100, 150, 220, 300, 400)),
                  rerank_factor=20)
            del idx

    if "cluster" in which:
        # both layouts: int8 is the capacity layout (the 10M+ story),
        # f32 trades 4x member memory for exact pool scores and no rerank
        for dt in ("int8", "f32"):
            t0 = time.perf_counter()
            ci = ClusterIndex.build(ps, m=64, ext_dtype=dt)
            log(f"cluster[{dt}] build: {time.perf_counter()-t0:.1f}s "
                f"C={ci.C}")
            t0 = time.perf_counter()
            ci = ClusterIndex.build(ps, m=64, ext_dtype=dt)
            log(f"cluster[{dt}] build steady: "
                f"{time.perf_counter()-t0:.1f}s members "
                f"{ci.mvecs.nbytes / 2**30:.2f} GiB")
            log(f"— cluster index ({dt} layout, m=64) —")
            for npr in env_beams("PROBES", (8, 12, 16, 24, 32, 48)):
                best = 1e9
                out = None
                for _ in range(2):
                    t0 = time.perf_counter()
                    for _r in range(rounds):
                        out = ci.search(Qd, k=k, n_probe=npr, cut=0.0)
                    _ = np.asarray(out[0][:1])
                    best = min(best, (time.perf_counter() - t0) / rounds)
                rec = compute_recall(np.asarray(out[0]), gt_ids,
                                     gt_dists, k)
                log(f"  [cluster-{dt}] probes={npr:3d} recall={rec:.4f} "
                    f"QPS={nq/best:,.0f}")
                if rec > 0.995:
                    break


if __name__ == "__main__":
    main()
