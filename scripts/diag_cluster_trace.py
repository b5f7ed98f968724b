"""Device-op trace of the fused cluster search: where does the FIXED
(per-dispatch, probe-independent) cost go?

The probe sweep (diag_cluster_tune) shows ~0.9 ms marginal per probe at
B=10K but ~6.5 ms of fixed cost — seeding scan, state init, pool sort,
rerank epilogue, or while_loop overhead. Traces probes=2 and probes=4
and prints per-op device totals so the diff isolates the per-step ops.

Env: BENCH_N/BENCH_D/BENCH_Q, M (cluster size), PROBES ("2,4").
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

    from parlayann_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from parlayann_tpu.data.pointset import PointSet
    from parlayann_tpu.build.clusterindex import ClusterIndex
    from parlayann_tpu.utils import synthetic

    n = int(os.environ.get("BENCH_N", 100_000))
    d = int(os.environ.get("BENCH_D", 128))
    nq = int(os.environ.get("BENCH_Q", 10_000))
    m = int(os.environ.get("M", 64))
    probes = [int(x) for x in os.environ.get("PROBES", "2,4").split(",")]

    print(f"devices: {jax.devices()}", flush=True)
    X, Q = synthetic.clustered(n, d, n_queries=nq,
                               n_clusters=max(64, n // 100),
                               cluster_std=0.35, seed=7)
    ps = PointSet.from_numpy(X)
    ci = ClusterIndex.build(ps, m=m, Rc=16, ext_dtype="f32")
    print(f"built C={ci.C}", flush=True)
    Qd = jax.device_put(np.asarray(Q))
    Qd.block_until_ready()

    for npr in probes:
        # warm + amortized time
        *out, dt = ci.search_timed(Qd, k=10, n_probe=npr, min_probe=0,
                                   cut=0.0, rounds=10)
        print(f"probes={npr}: {dt*1e3:.2f} ms/dispatch "
              f"({nq/dt:,.0f} QPS)", flush=True)
        tdir = f"/tmp/ctrace_{npr}"
        os.makedirs(tdir, exist_ok=True)
        with jax.profiler.trace(tdir):
            o = ci.search(Qd, k=10, n_probe=npr, min_probe=0, cut=0.0)
            _ = np.asarray(o[0][:1])
        parse_trace(tdir, f"probes={npr}")


if __name__ == "__main__":
    main()
