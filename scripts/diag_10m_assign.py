"""Bisect the 10M cluster-build device fault: fence after EVERY stage
(kmeans / assign / balance / recenter) so the faulting program is
identified — enqueues are async, so the production build's first fence
(the assign readback) blames whichever stage actually faulted.

Run: python scripts/diag_10m_assign.py
Env: BENCH_N (default 10M), STAGES (comma list, default all).
"""

import os
import sys
import time
from functools import partial

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from parlayann_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from parlayann_tpu.types import Metric
    from parlayann_tpu.build import clusterindex as CI

    n = int(os.environ.get("BENCH_N", 10_000_000))
    d = 128
    m, cand = 64, 6
    slack = float(os.environ.get("CB_SLACK", 1.5))
    C = max(8, int(-(-n * slack // m)))
    n_centers = max(64, n // 100)
    std = 0.35

    print(f"devices: {jax.devices()}  n={n} C={C}", flush=True)

    gchunk = min(250_000, n)
    n_pad0 = -(-n // gchunk) * gchunk

    @partial(jax.jit, static_argnames=("rows", "nc"))
    def gen_chunk(key, centers, *, rows, nc):
        ka, kn = jax.random.split(key)
        a = jax.random.randint(ka, (rows,), 0, nc)
        x = jnp.take(centers, a, axis=0)
        return x + std * jax.random.normal(kn, (rows, d), jnp.float32)

    key = jax.random.key(7)
    kc, kd, _ = jax.random.split(key, 3)
    centers = jax.random.normal(kc, (n_centers, d), jnp.float32)
    X = jax.lax.map(
        lambda kk: gen_chunk(kk, centers, rows=gchunk, nc=n_centers),
        jax.random.split(kd, n_pad0 // gchunk),
    ).reshape(n_pad0, d)
    X.block_until_ready()
    print(f"data on device ({X.nbytes/2**30:.1f} GiB)", flush=True)

    step = CI._kmeans_chunk_for(C)
    n_pad = -(-n // step) * step
    data = CI._pad_rows(X, n, n_pad)
    data.block_until_ready()
    print(f"padded working copy: step={step} n_pad={n_pad}", flush=True)

    t0 = time.perf_counter()
    cents = CI.kmeans(data, n, C, metric=Metric.L2,
                      iters=int(os.environ.get("ITERS", 6)), seed=0,
                      step=step)
    cents.block_until_ready()
    print(f"kmeans ok: {time.perf_counter()-t0:.1f}s "
          f"cents {cents.shape}", flush=True)

    t0 = time.perf_counter()
    nbr_ids, nbr_d = CI._assign_all(data, n, cents, C, cand, Metric.L2,
                                    step=step)
    print(f"assign ok: {time.perf_counter()-t0:.1f}s "
          f"ids {nbr_ids.shape} hist0 {np.bincount(nbr_ids[:1000, 0] % 7)}",
          flush=True)

    t0 = time.perf_counter()
    members = CI.balance_assign(nbr_ids, nbr_d, C, m)
    print(f"balance ok: {time.perf_counter()-t0:.1f}s "
          f"placed {(members >= 0).sum()}", flush=True)

    t0 = time.perf_counter()
    cents2 = CI._recenter(data, members, C)
    cents2.block_until_ready()
    print(f"recenter ok: {time.perf_counter()-t0:.1f}s", flush=True)


if __name__ == "__main__":
    main()
