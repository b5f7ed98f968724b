"""Device-truth trace of the PRODUCTION Vamana build path (read + write
dispatch pair, fused overflow scans) — the split-phase diag
(diag_build_trace.py) measures a different program.

Builds once, then times R repeats of the steady-state (read, write) pair
with ONE fence (amortized), and traces one pair for the per-op split.

Env: BENCH_N/BENCH_D, R/L/ALPHA, CAP (batch_cap_frac), REPS.
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from diag_build_trace import parse_trace


def main():
    import jax
    import jax.numpy as jnp

    from parlayann_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from parlayann_tpu.types import BuildParams
    from parlayann_tpu.data.pointset import PointSet
    from parlayann_tpu.build import vamana as V
    from parlayann_tpu.build.vamana import (
        _beam_phase, _write_batch, _pad_pow2, batch_schedule,
    )
    from parlayann_tpu.ops import quantize
    from parlayann_tpu.utils import synthetic

    n = int(os.environ.get("BENCH_N", 100_000))
    d = int(os.environ.get("BENCH_D", 128))
    R = int(os.environ.get("R", 32))
    L = int(os.environ.get("L", 64))
    alpha = float(os.environ.get("ALPHA", 1.2))
    cap = float(os.environ.get("CAP", 0.04))
    reps = int(os.environ.get("REPS", 8))

    print(f"devices: {jax.devices()}", flush=True)
    X, _ = synthetic.clustered(n, d, n_queries=0,
                               n_clusters=max(64, n // 100),
                               cluster_std=0.35, seed=7)
    ps = quantize.quantize_pointset(PointSet.from_numpy(X), bits=8)
    bp = BuildParams(R=R, L=L, alpha=alpha, num_passes=2,
                     batch_cap_frac=cap)

    t0 = time.perf_counter()
    graph, stats = V.build_vamana_graph(ps, bp)
    print(f"build (maybe cold): {time.perf_counter()-t0:.2f}s "
          f"(inner {stats.build_time:.2f}s)", flush=True)
    t0 = time.perf_counter()
    graph, stats = V.build_vamana_graph(ps, bp)
    print(f"build steady: {time.perf_counter()-t0:.2f}s "
          f"(inner {stats.build_time:.2f}s)", flush=True)

    vmax = max((3 * L) // 2, R + 16)
    _, max_batch = batch_schedule(n, n, cap)
    rng = np.random.default_rng(123)
    start = jnp.zeros((1,), jnp.int32)
    alpha_j = jnp.float32(alpha)

    def pair(nbrs, degs, batch_j):
        cand_ids, cand_d, v, c = _beam_phase(
            nbrs, degs, ps.data, batch_j, start,
            R=R, L=L, vmax=vmax, metric=ps.metric, n_valid=n, expand=2)
        return _write_batch(
            nbrs, degs, ps.data, batch_j, cand_ids, cand_d, alpha_j,
            R=R, metric=ps.metric, n_valid=n, chunk=2048, rev_chunk=4096)

    batches = [
        jnp.asarray(_pad_pow2(
            rng.permutation(n)[:max_batch].astype(np.int32), max_batch))
        for _ in range(reps)
    ]
    nbrs, degs = jnp.array(graph.neighbors), jnp.array(graph.degrees)
    nbrs, degs, _ = pair(nbrs, degs, batches[0])  # warm
    _ = np.asarray(degs[:1])
    t0 = time.perf_counter()
    for b in batches:
        nbrs, degs, _ = pair(nbrs, degs, b)
    _ = np.asarray(degs[:1])
    dt = (time.perf_counter() - t0) / reps
    print(f"steady production pair: {dt*1e3:.1f} ms/batch "
          f"(B={max_batch})", flush=True)

    tdir = "/tmp/build_prod_trace"
    os.makedirs(tdir, exist_ok=True)
    with jax.profiler.trace(tdir):
        nbrs, degs, _ = pair(nbrs, degs, batches[0])
        _ = np.asarray(degs[:1])
    parse_trace(tdir, "one production batch")


if __name__ == "__main__":
    main()
