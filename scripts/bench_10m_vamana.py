"""10M-point Vamana build + search — the graph-path scale story
(reference scale axis: algorithms/vamana/scripts/
deep10M:3-5, billion-scale docs/README.md:17-37).

Device memory at 10M x 128:

  f32 data (rerank tier)              5.1 GiB
  int8 q8 tier (walk tier)            1.3 GiB
  graph (R=32 int32) + degrees        1.3 GiB

Search runs the single-program two-phase search (search/fused.py) with a
sampled entry tier (the meta-routed seed economics from the 10M cluster
result, applied to the graph walk).
Data is generated ON DEVICE with the same RNG family as
bench_10m_cluster.py, so the exact-GT cache is shared.

Run: python scripts/bench_10m_vamana.py
Env: BENCH_N (10M), BENCH_Q (10K), BENCH_ROUNDS (8), QS (10,15,22,33,50),
     VAMANA_R (32), VAMANA_L (64), CAP (0.04).
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

    from parlayann_tpu.types import Metric, BuildParams
    from parlayann_tpu.data.pointset import PointSet
    from parlayann_tpu.data.graph import GraphIndexData
    from parlayann_tpu.build.vamana import build_vamana_graph
    from parlayann_tpu.index import Index
    from parlayann_tpu.search import exact
    from parlayann_tpu.harness.recall import compute_recall
    from parlayann_tpu.ops import quantize

    n = int(os.environ.get("BENCH_N", 10_000_000))
    d = 128
    nq = int(os.environ.get("BENCH_Q", 10_000))
    k = 10
    rounds = int(os.environ.get("BENCH_ROUNDS", 8))
    R = int(os.environ.get("VAMANA_R", 32))
    L = int(os.environ.get("VAMANA_L", 64))
    cap = float(os.environ.get("CAP", "0.04"))
    qs = [int(x) for x in os.environ.get("QS", "22,50,80,120,180").split(",")]
    n_centers = max(64, n // 100)
    std = 0.35
    log(f"devices: {jax.devices()}  n={n} R={R} L={L}")

    # ---- on-device clustered data (identical RNG family to
    # bench_10m_cluster.py -> shared GT cache) ----
    gchunk = min(1 << 18, n)
    n_pad = -(-n // gchunk) * gchunk

    @partial(jax.jit, static_argnames=("rows", "nc"))
    def gen_chunk(key, centers, *, rows, nc):
        ka, kn = jax.random.split(key)
        a = jax.random.randint(ka, (rows,), 0, nc)
        x = jnp.take(centers, a, axis=0)
        return x + std * jax.random.normal(kn, (rows, d), jnp.float32)

    @partial(jax.jit, static_argnames=("rows", "nc"))
    def gen_all(keys, centers, *, rows, nc):
        return jax.lax.map(
            lambda kk: gen_chunk(kk, centers, rows=rows, nc=nc), keys
        )

    key = jax.random.key(7)
    kc, kd, kq = jax.random.split(key, 3)
    centers = jax.random.normal(kc, (n_centers, d), jnp.float32)
    t0 = time.perf_counter()
    X = gen_all(
        jax.random.split(kd, n_pad // gchunk), centers,
        rows=gchunk, nc=n_centers,
    ).reshape(n_pad, d)
    Q = gen_chunk(kq, centers, rows=nq, nc=n_centers)
    X.block_until_ready()
    log(f"data: {n}x{d} on device ({time.perf_counter()-t0:.1f}s)")
    ps = PointSet(data=X, n=n, d=d, metric=Metric.L2)

    Qn = np.asarray(Q)
    cdir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "bench_cache")
    os.makedirs(cdir, exist_ok=True)
    gtpath = os.path.join(cdir, f"gtdev_{n}x{d}_{nq}_g{gchunk}.npz")
    if os.path.exists(gtpath):
        z = np.load(gtpath)
        gt_ids, gt_dists = z["ids"], z["dists"]
        log("gt: cached")
    else:
        t0 = time.perf_counter()
        gt_ids, gt_dists = exact.compute_groundtruth(ps, Qn, 2 * k)
        log(f"gt: {time.perf_counter()-t0:.1f}s")
        np.savez(gtpath, ids=gt_ids, dists=gt_dists)
    gt_ids, gt_dists = np.asarray(gt_ids), np.asarray(gt_dists)

    # ---- q8 build tier + graph (cached across runs) ----
    t0 = time.perf_counter()
    qps = quantize.quantize_pointset(ps, bits=8)
    jax.block_until_ready(qps.data)
    log(f"q8 tier: {time.perf_counter()-t0:.1f}s")
    gname = os.path.join(cdir, f"vam10m_{n}_R{R}L{L}c{cap}.npz")
    if os.path.exists(gname):
        t0 = time.perf_counter()
        z = np.load(gname)
        graph = GraphIndexData(
            neighbors=jax.device_put(z["nbrs"]),
            degrees=jax.device_put(z["degs"]), n=n, max_degree=R)
        log(f"graph: cached ({time.perf_counter()-t0:.1f}s)")
    else:
        bp = BuildParams(R=R, L=L, alpha=1.2, num_passes=2,
                         batch_cap_frac=cap)
        t0 = time.perf_counter()
        graph, stats = build_vamana_graph(qps, bp, verbose=True)
        dt = time.perf_counter() - t0
        avg, mx = graph.stats()
        log(f"BUILD: {dt:.1f}s  avg_deg={avg:.2f} max={mx}  "
            f"stats={stats}")
        np.savez(gname, nbrs=np.asarray(graph.neighbors),
                 degs=np.asarray(graph.degrees))

    # ---- search: single-dispatch two-phase gather program + entry tier ----
    idx = Index(points=ps, graph=graph, qpoints=qps)
    # the default 4K entry sample is far too sparse for 100K natural
    # clusters (most blobs unseeded -> entry lands blobs away and the
    # walk pays it: recall .32 @ Q=10 in the first run). One
    # (B, E) matmul at E=64K is cheap next to the walk.
    entry_e = int(os.environ.get("ENTRY_E", 65536))
    idx.build_entry_cache(E=entry_e)
    Qd = jax.device_put(Qn)
    Qd.block_until_ready()
    log(f"== search sweep (gather path, entry E={entry_e}, q8 walk + "
        "rerank) ==")
    for Lq in qs:
        best = 1e9
        out = None
        for r in range(3):
            ids, dists, res, dt = idx.batch_search_timed(
                Qd, k=k, beam_size=Lq, rounds=rounds, warmup=(r == 0),
                two_phase=True)
            best = min(best, dt)
        rec = compute_recall(np.asarray(ids), gt_ids, gt_dists, k)
        log(f"Q={Lq}: recall={rec:.4f} QPS={nq/best:,.0f}")
    print('{"metric": "10m_vamana", "done": true}')


if __name__ == "__main__":
    main()
