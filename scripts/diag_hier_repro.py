"""Bisect the 10M recall collapse (flat ~.47 at any probe count).

Repro at n=1.6M (smallest scale where BOTH suspect paths engage:
n*C = 6e10 > the 4e10 exact-Lloyd limit -> hierarchical assignment, and
C = 37.5K > 32768 -> streamed centroid seed), then decompose:

  1. coverage@P oracle: exact top-P centroids per query (matmul) ->
     fraction of GT ids whose ASSIGNED cluster is among them. Flat/low
     coverage => the BUILD (hier assignment / balance) is at fault.
  2. seed check: flat_search_batch's top-S centroids vs the exact top-S
     (ids agreement + distance domain). Disagreement => the SEARCH
     (streamed seed) is at fault.
  3. end-to-end recall at a few probe counts for reference.

Run: python scripts/diag_hier_repro.py
Env: BENCH_N (default 1.6M), PROBES.
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

    from parlayann_tpu.types import Metric
    from parlayann_tpu.data.pointset import PointSet
    from parlayann_tpu.build.clusterindex import ClusterIndex
    from parlayann_tpu.search import exact
    from parlayann_tpu.search.flat import flat_search_batch
    from parlayann_tpu.harness.recall import compute_recall

    n = int(os.environ.get("BENCH_N", 1_600_000))
    d = 128
    nq = 2_000
    k = 10
    n_centers = max(64, n // 100)
    std = 0.35

    log(f"devices: {jax.devices()}")

    gchunk = min(250_000, n)
    n_pad = -(-n // gchunk) * gchunk

    @partial(jax.jit, static_argnames=("rows", "nc"))
    def gen_chunk(key, centers, *, rows, nc):
        ka, kn = jax.random.split(key)
        a = jax.random.randint(ka, (rows,), 0, nc)
        x = jnp.take(centers, a, axis=0)
        return x + std * jax.random.normal(kn, (rows, d), jnp.float32)

    key = jax.random.key(7)
    kc, kd, kq = jax.random.split(key, 3)
    centers = jax.random.normal(kc, (n_centers, d), jnp.float32)
    X = jax.lax.map(
        lambda kk: gen_chunk(kk, centers, rows=gchunk, nc=n_centers),
        jax.random.split(kd, n_pad // gchunk),
    ).reshape(n_pad, d)
    Q = gen_chunk(kq, centers, rows=nq, nc=n_centers)
    X.block_until_ready()
    log(f"data: {n}x{d} ({X.nbytes/2**30:.1f} GiB)")
    ps = PointSet(data=X, n=n, d=d, metric=Metric.L2)

    Qn = np.asarray(Q)
    t0 = time.perf_counter()
    gt_ids, gt_dists = exact.compute_groundtruth(ps, Qn, k)
    gt_ids, gt_dists = np.asarray(gt_ids), np.asarray(gt_dists)
    log(f"gt: {time.perf_counter()-t0:.1f}s")

    t0 = time.perf_counter()
    ci = ClusterIndex.build(ps, m=64, cand=6, verbose=True)
    log(f"build: {time.perf_counter()-t0:.1f}s C={ci.C} ext={ci.ext_dtype}")

    # point -> assigned cluster map
    mem = ci.members  # (C_pad?, m) host np
    C = ci.C
    assign = np.full(n, -1, np.int32)
    valid = mem >= 0
    assign[mem[valid]] = np.repeat(
        np.arange(mem.shape[0], dtype=np.int32), mem.shape[1]
    )[valid.reshape(-1)]
    log(f"assigned points: {(assign >= 0).sum()}/{n}")

    # ---- 1. coverage@P oracle (exact top-P centroids via device scan) ----
    cents_f = ci.centroids_q.astype(jnp.float32)
    # centroids are in the q8 domain for int8 ext; ordering is preserved,
    # so exact top-P over them matches the search's ideal probe order
    qd = jax.device_put(Qn)
    if ci.ext_dtype == "int8":
        from parlayann_tpu.ops import quantize
        qd = quantize.euclidean_translate(
            qd, ci.qpoints.quant_slope, ci.qpoints.quant_offset, 8
        ).astype(jnp.float32)
    Pmax = 64
    top_i, _ = flat_search_batch(
        qd, cents_f, k=Pmax, metric=Metric.L2, n_valid=C,
        chunk=8192, select="sort",
    )
    top_i = np.asarray(top_i)  # (nq, Pmax) exact probe order
    gt_cl = assign[np.clip(gt_ids, 0, n - 1)]  # (nq, k) cluster of each GT id
    for P in (4, 8, 16, 32, 64):
        cov = np.mean(gt_cl == -1)  # unassigned GT ids always miss
        hit = (gt_cl[:, :, None] == top_i[:, None, :P]).any(axis=2)
        log(f"coverage@{P}: {hit.mean():.4f} (unassigned GT frac "
            f"{np.mean(gt_cl < 0):.4f})")

    # ---- 2. streamed seed vs exact top-S ----
    S = 2
    s_i, s_d = flat_search_batch(
        qd, ci.centroids_q, k=S, metric=Metric.L2, n_valid=C,
        chunk=min(ci.centroids_q.shape[0], 8192), select="sort",
    )
    s_i = np.asarray(s_i)
    agree = (s_i[:, 0] == top_i[:, 0]).mean()
    log(f"seed top-1 agreement vs exact: {agree:.4f}")

    # ---- 3. end-to-end recall ----
    probes = os.environ.get("PROBES")
    probes = ([int(x) for x in probes.split(",")] if probes else [8, 32])
    Qd = jax.device_put(Qn)
    for npr in probes:
        out = ci.search(Qd, k=k, n_probe=npr, cut=0.0)
        rec = compute_recall(np.asarray(out[0]), gt_ids, gt_dists, k)
        log(f"e2e probes={npr}: recall={rec:.4f}")


if __name__ == "__main__":
    main()
