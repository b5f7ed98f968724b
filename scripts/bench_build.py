"""Build-time breakdown on the device: where does the build time go?

Runs the r32 quickstart build twice (first run warms compiles) with
per-batch host wall timestamps, then prints the distribution of per-batch
dispatch times and the final drain. Env: BENCH_N/BENCH_D, R/L/ALPHA.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from parlayann_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from parlayann_tpu.types import BuildParams
    from parlayann_tpu.data.pointset import PointSet
    from parlayann_tpu.build import vamana as V
    from parlayann_tpu.ops import quantize
    from parlayann_tpu.utils import synthetic

    n = int(os.environ.get("BENCH_N", 100_000))
    d = int(os.environ.get("BENCH_D", 128))
    R = int(os.environ.get("R", 32))
    L = int(os.environ.get("L", 64))
    alpha = float(os.environ.get("ALPHA", 1.2))

    X, _ = synthetic.clustered(n, d, n_queries=0, n_clusters=max(64, n // 100),
                               cluster_std=0.35, seed=7)
    ps = quantize.quantize_pointset(PointSet.from_numpy(X), bits=8)
    bp = BuildParams(R=R, L=L, alpha=alpha, num_passes=2, batch_cap_frac=0.04)

    # ---- instrumented copy of the production loop ----
    def run(tag):
        nn = ps.n
        vmax = max((3 * L) // 2, R + 16)
        nbrs = jnp.zeros((ps.n_pad, R), jnp.int32)
        degs = jnp.zeros((ps.n_pad,), jnp.int32)
        rng = np.random.default_rng(bp.seed)
        start = jnp.zeros((1,), dtype=jnp.int32)
        sched, max_batch = V.batch_schedule(nn, nn, bp.batch_cap_frac)
        t0 = time.perf_counter()
        lap = t0
        times = []
        for p in range(bp.num_passes):
            a = bp.alpha if p == bp.num_passes - 1 else 1.0
            order = rng.permutation(nn).astype(np.int32)
            for (lo, hi) in sched:
                batch_j = jnp.asarray(V._pad_pow2(order[lo:hi], max_batch))
                cand_ids, cand_d, v, c = V._beam_phase(
                    nbrs, degs, ps.data, batch_j, start,
                    R=R, L=L, vmax=vmax, metric=ps.metric, n_valid=nn,
                    expand=2,
                )
                nbrs, degs, _ = V._write_batch(
                    nbrs, degs, ps.data, batch_j, cand_ids, cand_d,
                    jnp.float32(a), R=R, metric=ps.metric, n_valid=nn,
                    chunk=2048, rev_chunk=4096,
                )
                now = time.perf_counter()
                times.append((hi - lo, now - lap))
                lap = now
        t_loop = time.perf_counter() - t0
        nbrs = V._sort_rows_by_distance(nbrs, degs, ps.data, R=R,
                                        metric=ps.metric)
        _ = int(jnp.sum(degs))
        t_all = time.perf_counter() - t0
        full = [dt for (w, dt) in times if w == max_batch]
        print(f"[{tag}] total={t_all:.2f}s loop(dispatch)={t_loop:.2f}s "
              f"drain+sort={t_all-t_loop:.2f}s batches={len(times)}", flush=True)
        print(f"[{tag}] full-width batches: n={len(full)} "
              f"median={np.median(full)*1000:.0f}ms "
              f"p10={np.percentile(full,10)*1000:.0f}ms "
              f"p90={np.percentile(full,90)*1000:.0f}ms", flush=True)
        print(f"[{tag}] per-batch (width, ms): "
              + " ".join(f"({w},{dt*1000:.0f})" for w, dt in times[:40]),
              flush=True)

    run("cold")
    run("steady")
    run("steady2")


if __name__ == "__main__":
    main()
