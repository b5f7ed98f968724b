"""Per-phase timing of one HCNNG cluster tree on the device: labels /
candidate edges (pairwise + top-k) / Kruskal (host C++) / assembly.

Env: BENCH_N/BENCH_D, S (cluster_size), TREES (default 2: first warms).
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

    from parlayann_tpu.data.pointset import PointSet
    from parlayann_tpu.build.cluster import cluster_tree_labels, leaf_members
    from parlayann_tpu.build.hcnng import _leaf_candidate_edges, _CAND_PER_POINT
    from parlayann_tpu import native
    from parlayann_tpu.utils import synthetic

    n = int(os.environ.get("BENCH_N", 100_000))
    d = int(os.environ.get("BENCH_D", 128))
    S = int(os.environ.get("S", 1000))
    trees = int(os.environ.get("TREES", 2))
    print(f"devices: {jax.devices()} n={n} S={S}", flush=True)

    X, _ = synthetic.clustered(n, d, n_queries=0,
                               n_clusters=max(64, n // 100),
                               cluster_std=0.35, seed=7)
    ps = PointSet.from_numpy(X)
    m = min(_CAND_PER_POINT, S - 1)
    mst_deg = 3

    key = jax.random.key(0)
    for t in range(trees):
        key, sub = jax.random.split(key)
        tl = time.perf_counter()
        ids, labels = cluster_tree_labels(
            ps.data, sub, metric=ps.metric, cluster_size=S, n_valid=n)
        ids_h, labels_h = np.asarray(ids), np.asarray(labels)
        t_lab = time.perf_counter() - tl

        tl = time.perf_counter()
        members, sizes = leaf_members(ids_h, labels_h, S)
        t_mem = time.perf_counter() - tl
        n_leaves = len(members)

        chunk = max(1, min(n_leaves, (1 << 25) // (S * S)))
        t_cand = t_krus = t_asm = 0.0
        for lo in range(0, n_leaves, chunk):
            mem = members[lo:lo + chunk]
            sz = sizes[lo:lo + chunk]
            pad = 0
            if len(mem) < chunk:
                pad = chunk - len(mem)
                mem = np.concatenate([mem, np.full((pad, S), -1, np.int32)])
                sz = np.concatenate([sz, np.zeros(pad, np.int32)])
            tl = time.perf_counter()
            suv = np.asarray(_leaf_candidate_edges(
                ps.data, jnp.asarray(mem), jnp.asarray(sz),
                S=S, m=m, metric=ps.metric))
            sp = 1 << (S - 1).bit_length()
            su = np.where(suv >= 0, suv >> int(np.log2(sp)), -1).astype(np.int32)
            sv = np.where(suv >= 0, suv & (sp - 1), -1).astype(np.int32)
            t_cand += time.perf_counter() - tl
            nl = su.shape[0] - pad
            tl = time.perf_counter()
            ou, ov, cnt = native.kruskal_leaves(
                su[:nl], sv[:nl], sizes[lo:lo + nl], S, mst_deg)
            t_krus += time.perf_counter() - tl
            tl = time.perf_counter()
            cnt = np.asarray(cnt)
            keep = np.arange(ou.shape[1])[None, :] < cnt[:, None]
            gl = members[lo:lo + nl]
            rowi = np.broadcast_to(np.arange(nl)[:, None], ou.shape)[keep]
            _ = gl[rowi, np.clip(ou, 0, S - 1)[keep]]
            t_asm += time.perf_counter() - tl
        print(f"tree {t}: labels={t_lab:.2f}s members={t_mem:.2f}s "
              f"candidates={t_cand:.2f}s kruskal={t_krus:.2f}s "
              f"assembly={t_asm:.2f}s leaves={n_leaves}", flush=True)


if __name__ == "__main__":
    main()
