"""Device-op trace of the two HCNNG device programs (labels, candidates)
plus amortized dispatch timing of each. Env: BENCH_N/BENCH_D, S."""

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

    from parlayann_tpu.data.pointset import PointSet
    from parlayann_tpu.build.cluster import cluster_tree_labels, leaf_members
    from parlayann_tpu.build.hcnng import _leaf_candidate_edges, _CAND_PER_POINT
    from parlayann_tpu.utils import synthetic

    n = int(os.environ.get("BENCH_N", 100_000))
    d = int(os.environ.get("BENCH_D", 128))
    S = int(os.environ.get("S", 1000))
    print(f"devices: {jax.devices()} n={n} S={S}", flush=True)

    X, _ = synthetic.clustered(n, d, n_queries=0,
                               n_clusters=max(64, n // 100),
                               cluster_std=0.35, seed=7)
    ps = PointSet.from_numpy(X)
    m = min(_CAND_PER_POINT, S - 1)

    keys = [jax.random.key(i) for i in range(8)]
    # warm
    ids, labels = cluster_tree_labels(
        ps.data, keys[0], metric=ps.metric, cluster_size=S, n_valid=n)
    jax.block_until_ready(labels)

    t0 = time.perf_counter()
    outs = [cluster_tree_labels(ps.data, k, metric=ps.metric,
                                cluster_size=S, n_valid=n) for k in keys]
    jax.block_until_ready(outs[-1][1])
    print(f"labels amortized: {(time.perf_counter()-t0)/len(keys)*1e3:.1f} "
          f"ms/tree", flush=True)

    tdir = "/tmp/hcnng_lab_trace"
    os.makedirs(tdir, exist_ok=True)
    with jax.profiler.trace(tdir):
        o = cluster_tree_labels(ps.data, keys[1], metric=ps.metric,
                                cluster_size=S, n_valid=n)
        jax.block_until_ready(o[1])
    parse_trace(tdir, "one label tree")

    members, sizes = leaf_members(np.asarray(ids), np.asarray(labels), S)
    chunk = max(1, min(len(members), (1 << 25) // (S * S)))
    mem = members[:chunk]
    sz = sizes[:chunk]
    if len(mem) < chunk:
        pad = chunk - len(mem)
        mem = np.concatenate([mem, np.full((pad, S), -1, np.int32)])
        sz = np.concatenate([sz, np.zeros(pad, np.int32)])
    memj, szj = jnp.asarray(mem), jnp.asarray(sz)
    sv = _leaf_candidate_edges(ps.data, memj, szj, S=S, m=m,
                               metric=ps.metric)
    jax.block_until_ready(sv)
    t0 = time.perf_counter()
    R = 8
    for _ in range(R):
        sv = _leaf_candidate_edges(ps.data, memj, szj, S=S, m=m,
                                   metric=ps.metric)
    jax.block_until_ready(sv)
    print(f"candidates amortized: {(time.perf_counter()-t0)/R*1e3:.1f} "
          f"ms/chunk ({chunk} leaves)", flush=True)

    tdir = "/tmp/hcnng_cand_trace"
    os.makedirs(tdir, exist_ok=True)
    with jax.profiler.trace(tdir):
        sv = _leaf_candidate_edges(ps.data, memj, szj, S=S, m=m,
                                   metric=ps.metric)
        jax.block_until_ready(sv)
    parse_trace(tdir, "one candidate chunk")


if __name__ == "__main__":
    main()
