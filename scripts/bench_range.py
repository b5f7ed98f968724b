"""SSNPP-style range-search benchmark on device.

Synthetic SSNPP stand-in (no egress): clustered 100K/1M x 128 f32, a
radius calibrated so a minority of queries have nonempty result sets
(the SSNPP regime: most queries return nothing, hit queries return a
handful). Builds the range config's Vamana graph (R=64 L=128 alpha=1.0,
scripts/ssnpp_range parity) and runs the reference's beam-sweep range
protocol (check_range_recall.h:67-84) via harness/range_sweep.py.

Run: python scripts/bench_range.py
Env: BENCH_N (100K), BENCH_Q (10K), RADIUS_PCTL (percentile of NN dists
used to set the radius, default 20).
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

    from parlayann_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from parlayann_tpu.types import BuildParams
    from parlayann_tpu.data.pointset import PointSet
    from parlayann_tpu.build.vamana import build_vamana_graph
    from parlayann_tpu.data.graph import GraphIndexData
    from parlayann_tpu.search import exact
    from parlayann_tpu.harness.range_sweep import range_search_wrapper
    from parlayann_tpu.ops import quantize
    from parlayann_tpu.utils import synthetic

    n = int(os.environ.get("BENCH_N", 100_000))
    d = 128
    nq = int(os.environ.get("BENCH_Q", 10_000))
    log(f"devices: {jax.devices()}")
    X, Q = synthetic.clustered(n, d, n_queries=nq,
                               n_clusters=max(64, n // 100),
                               cluster_std=0.35, seed=7)
    ps = PointSet.from_numpy(X)

    cdir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "bench_cache")
    os.makedirs(cdir, exist_ok=True)

    # radius: percentile of exact NN distances — SSNPP-style sparse hits
    gtp = os.path.join(cdir, f"gt_{n}x{d}_{nq}.npz")
    if os.path.exists(gtp):
        z = np.load(gtp)
        nn_d = z["dists"][:, 0]
    else:
        gi, gd = exact.compute_groundtruth(ps, Q, 10)
        np.savez(gtp, ids=gi, dists=gd)
        nn_d = np.asarray(gd)[:, 0]
    pctl = float(os.environ.get("RADIUS_PCTL", 20))
    rad = float(np.percentile(nn_d, pctl))
    log(f"radius={rad:.4f} (p{pctl:.0f} of NN dists)")

    rgtp = os.path.join(cdir, f"rgt_{n}x{d}_{nq}_p{pctl:.0f}.npz")
    if os.path.exists(rgtp):
        z = np.load(rgtp, allow_pickle=True)
        gt = list(z["gt"])
        log("range gt: cached")
    else:
        t0 = time.perf_counter()
        gt = exact.compute_range_groundtruth(ps, Q, rad)
        log(f"range gt: {time.perf_counter()-t0:.1f}s")
        np.savez(rgtp, gt=np.asarray(gt, dtype=object))
    nz = sum(1 for g in gt if len(g))
    tot = sum(len(g) for g in gt)
    log(f"gt: {nz}/{nq} nonempty, {tot} total matches "
        f"(max {max((len(g) for g in gt), default=0)})")

    # range config graph (scripts/ssnpp_range: R=64 L=128 alpha=1.0)
    bp = BuildParams(R=64, L=128, alpha=1.0, num_passes=2,
                     batch_cap_frac=0.16)
    gpath = os.path.join(cdir, f"range_{n}x{d}_r{bp.R}.graph")
    bps = quantize.quantize_pointset(ps, bits=8)
    if os.path.exists(gpath):
        graph = GraphIndexData.load(gpath)
        log("graph: cached")
    else:
        t0 = time.perf_counter()
        graph, _ = build_vamana_graph(bps, bp)
        log(f"build: {time.perf_counter()-t0:.1f}s "
            f"deg {graph.stats()[0]:.1f}")
        graph.save(gpath)

    beams = os.environ.get("BEAMS")
    beams = ([int(b) for b in beams.split(",")] if beams
             else (10, 20, 30, 40, 50, 100, 1000))
    range_search_wrapper(
        Q, ps.data, graph.neighbors, graph.degrees, gt, rad,
        metric=ps.metric, n_valid=ps.n, beams=beams, repeats=2,
    )


if __name__ == "__main__":
    main()
