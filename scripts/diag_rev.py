"""Sustained timing of the real build phase programs on real state:
beam / fwd / rev-append / overflow-prune, each as 10 back-to-back
dispatches + one fence (same protocol as batch_search_timed).
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
    from parlayann_tpu.build import vamana as V
    from parlayann_tpu.build.vamana import (
        _beam_phase, _fwd_phase, _rev_append_phase, _prune_chunk_step,
        _pad_pow2, batch_schedule,
    )
    from parlayann_tpu.ops import quantize
    from parlayann_tpu.utils import synthetic

    n = int(os.environ.get("BENCH_N", 100_000))
    d = int(os.environ.get("BENCH_D", 128))
    R, L, alpha = 32, 64, 1.2
    cap = float(os.environ.get("CAP", 0.04))
    print(f"devices: {jax.devices()}", flush=True)
    X, _ = synthetic.clustered(n, d, n_queries=0,
                               n_clusters=max(64, n // 100),
                               cluster_std=0.35, seed=7)
    ps = quantize.quantize_pointset(PointSet.from_numpy(X), bits=8)
    bp = BuildParams(R=R, L=L, alpha=alpha, num_passes=2,
                     batch_cap_frac=cap)
    graph, _ = V.build_vamana_graph(ps, bp)

    vmax = max((3 * L) // 2, R + 16)
    _, max_batch = batch_schedule(n, n, cap)
    rng = np.random.default_rng(123)
    batch = _pad_pow2(rng.permutation(n)[:max_batch].astype(np.int32),
                      max_batch)
    batch_j = jnp.asarray(batch)
    start = jnp.zeros((1,), jnp.int32)
    alpha_j = jnp.float32(alpha)
    nbrs0, degs0 = graph.neighbors, graph.degrees

    cand_ids, cand_d, v, c = _beam_phase(
        nbrs0, degs0, ps.data, batch_j, start,
        R=R, L=L, vmax=vmax, metric=ps.metric, n_valid=n, expand=2)
    jax.block_until_ready(cand_d)

    def timeit(name, fn, rounds=10):
        out = fn()
        jax.block_until_ready(jax.tree_util.tree_leaves(out)[0])
        best = 1e9
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(rounds):
                out = fn()
            jax.block_until_ready(jax.tree_util.tree_leaves(out)[0])
            best = min(best, (time.perf_counter() - t0) / rounds)
        print(f"{name}: {best*1e3:.2f} ms", flush=True)
        return out

    timeit("beam", lambda: _beam_phase(
        nbrs0, degs0, ps.data, batch_j, start,
        R=R, L=L, vmax=vmax, metric=ps.metric, n_valid=n, expand=2))
    timeit("fwd", lambda: _fwd_phase(
        nbrs0 + 0, degs0 + 0, ps.data, batch_j, cand_ids, cand_d,
        alpha_j, R=R, metric=ps.metric, n_valid=n, chunk=2048))
    nbrs1, degs1, sel_ids, sel_dists = _fwd_phase(
        nbrs0 + 0, degs0 + 0, ps.data, batch_j, cand_ids, cand_d,
        alpha_j, R=R, metric=ps.metric, n_valid=n, chunk=2048)
    timeit("rev", lambda: _rev_append_phase(
        nbrs1 + 0, degs1 + 0, batch_j, sel_ids, sel_dists, R=R, n_valid=n))
    nbrs2, degs2, ctx, rstats = _rev_append_phase(
        nbrs1 + 0, degs1 + 0, batch_j, sel_ids, sel_dists, R=R, n_valid=n)
    n_over = int(rstats.n_overflow)
    print(f"n_over={n_over}", flush=True)
    timeit("overflow chunk0 (large)", lambda: _prune_chunk_step(
        nbrs2 + 0, degs2 + 0, ctx, 0, ps.data, alpha_j,
        R=R, metric=ps.metric, n_valid=n, chunk=4096))

    def all_over():
        nb, dg = nbrs2 + 0, degs2 + 0
        for off in range(0, n_over, 4096):
            nb, dg = _prune_chunk_step(
                nb, dg, ctx, off, ps.data, alpha_j,
                R=R, metric=ps.metric, n_valid=n, chunk=4096)
        return nb

    timeit("overflow all chunks", all_over, rounds=3)


if __name__ == "__main__":
    main()
