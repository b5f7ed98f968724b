"""10M-scale cluster-index benchmark.

Device memory at 10M x 128:

  f32  data                       5.1 GiB   (kept — rerank tier)
  int8 q8 tier                    1.3 GiB
  cluster member blocks (m=64)    ~1.9 GiB int8 / ~7.7 GiB f32

Data is generated ON DEVICE (no multi-GB host->device transfer):
clustered gaussians, 100K natural clusters of ~100 points — the same
family as the 100K/1M benches, scaled.

Run: python scripts/bench_10m_cluster.py
Env: BENCH_N (default 10M), BENCH_ROUNDS (default 8), PROBES.
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
    from parlayann_tpu.harness.recall import compute_recall

    n = int(os.environ.get("BENCH_N", 10_000_000))
    d = 128
    nq = int(os.environ.get("BENCH_Q", 10_000))
    k = 10
    rounds = int(os.environ.get("BENCH_ROUNDS", 8))
    n_centers = max(64, n // 100)
    std = 0.35

    log(f"devices: {jax.devices()}")

    # ---- on-device clustered data: centers + per-chunk assignment ----
    # 2^18 rows/chunk: the generated buffer's row count stays a multiple
    # of the cluster build's 16384-row assignment step, so the build can
    # use it as its padded working copy directly (a step-misaligned row
    # count costs a second 4.8 GiB padded copy at 10M — the OOM margin)
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
        # lax.map writes straight into ONE (nchunks, rows, d) buffer —
        # a python loop + concatenate would transiently double the 5 GiB
        return jax.lax.map(
            lambda kk: gen_chunk(kk, centers, rows=rows, nc=nc), keys
        )

    key = jax.random.key(7)
    kc, kd, kq = jax.random.split(key, 3)
    centers = jax.random.normal(kc, (n_centers, d), jnp.float32)
    t0 = time.perf_counter()
    # keep the pad rows (PointSet masks by n); slicing would copy 5 GiB
    X = gen_all(
        jax.random.split(kd, n_pad // gchunk), centers,
        rows=gchunk, nc=n_centers,
    ).reshape(n_pad, d)
    Q = gen_chunk(kq, centers, rows=nq, nc=n_centers)
    X.block_until_ready()
    log(f"data: {n}x{d} on device ({time.perf_counter()-t0:.1f}s, "
        f"{X.nbytes/2**30:.1f} GiB)")
    ps = PointSet(data=X, n=n, d=d, metric=Metric.L2)

    # ---- exact GT (flat matmul scan; ~13 TFLOP for 10K x 10M) ----
    Qn = np.asarray(Q)
    cdir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "bench_cache")
    os.makedirs(cdir, exist_ok=True)
    # distinct key from bench.py's gt_* caches: this script's dataset is
    # device-generated (different RNG family at the same (n, d, nq))
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
    gt_ids = np.asarray(gt_ids)
    gt_dists = np.asarray(gt_dists)

    # ---- cluster build (BENCH_CI_CACHE=1 reuses the saved partition:
    # search-side experiments then skip the ~15 min build) ----
    slack = float(os.environ.get("CB_SLACK", "1.5"))
    cand = int(os.environ.get("CB_CAND", "6"))
    cpath = os.path.join(cdir, f"ci_{n}x{d}_m64_s{slack}_c{cand}.npz")
    use_cache = os.environ.get("BENCH_CI_CACHE", "0") == "1"
    if use_cache and os.path.exists(cpath):
        t0 = time.perf_counter()
        ci = ClusterIndex.load(cpath, ps)
        log(f"cluster load: {time.perf_counter()-t0:.1f}s C={ci.C}")
    else:
        t0 = time.perf_counter()
        ci = ClusterIndex.build(ps, m=64, cand=cand, slack=slack,
                                verbose=True)
        log(f"cluster build: {time.perf_counter()-t0:.1f}s C={ci.C} "
            f"members {ci.mvecs.nbytes / 2**30:.2f} GiB")
        if use_cache:
            ci.save(cpath)

    Qd = jax.device_put(Qn)
    Qd.block_until_ready()
    probes = os.environ.get("PROBES")
    probes = ([int(x) for x in probes.split(",")] if probes
              else [8, 12, 16, 24, 32, 48, 64])
    sp = int(os.environ.get("SEED_PROBES", 8))
    smode = os.environ.get("SEED_MODE", "argmin")
    for npr in probes:
        best = 1e9
        out = None
        for _ in range(2):
            t0 = time.perf_counter()
            for _r in range(rounds):
                out = ci.search(Qd, k=k, n_probe=npr, cut=0.0,
                                seed_probes=sp, seed_mode=smode)
            _ = np.asarray(out[0][:1])
            best = min(best, (time.perf_counter() - t0) / rounds)
        rec = compute_recall(np.asarray(out[0]), gt_ids, gt_dists, k)
        log(f"  [cluster10M] probes={npr:3d} recall={rec:.4f} "
            f"QPS={nq/best:,.0f}")
        if rec > 0.995:
            break
    # adaptive configs at the >= .95 operating point
    for npr, mnp, ccut in ((32, 4, 1.35), (32, 6, 1.35), (48, 8, 1.35)):
        best = 1e9
        out = None
        for _ in range(2):
            t0 = time.perf_counter()
            for _r in range(rounds):
                out = ci.search(Qd, k=k, n_probe=npr, min_probe=mnp,
                                cut=ccut)
            _ = np.asarray(out[0][:1])
            best = min(best, (time.perf_counter() - t0) / rounds)
        rec = compute_recall(np.asarray(out[0]), gt_ids, gt_dists, k)
        nv = np.asarray(out[2][0])
        log(f"  [cluster10M] adapt min={mnp} cut={ccut} cap={npr} "
            f"recall={rec:.4f} avg_probes={nv.mean():.2f} "
            f"QPS={nq/best:,.0f}")


if __name__ == "__main__":
    main()
