"""Hier-path capacity diagnosis at small scale (fast iteration).

Forces the hier build path at n=200K (PARLAYANN_KMEANS_EXACT_LIMIT=1)
on the same blob family as the 10M bench (n/100 natural clusters of
~100) and prints, per stage: balance spill, rank distribution, fill
percentiles, and the final coverage/recall — next to the EXACT path's
numbers on identical data.

Env: N (200000), CAND (6), ROUNDS (3), CAP (4), SHAPE (1.5), TELE (1).
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

    from parlayann_tpu.types import Metric
    from parlayann_tpu.data.pointset import PointSet
    from parlayann_tpu.build.clusterindex import ClusterIndex
    from parlayann_tpu.search import exact
    from parlayann_tpu.harness.recall import compute_recall
    from parlayann_tpu.utils import synthetic

    n = int(os.environ.get("N", 200_000))
    d = 128
    nq = 2000
    k = 10
    cand = int(os.environ.get("CAND", 6))
    X, Q = synthetic.clustered(n, d, n_queries=nq,
                               n_clusters=max(64, n // 100),
                               cluster_std=0.35, seed=7)
    ps = PointSet.from_numpy(X)
    print(f"devices: {jax.devices()} n={n} cand={cand}", flush=True)
    gt_i, gt_d = exact.compute_groundtruth(ps, Q, 2 * k)
    gt_i, gt_d = np.asarray(gt_i), np.asarray(gt_d)

    def evaluate(tag, ci):
        # coverage oracle: fraction of true top-k whose cluster is among
        # the query's P nearest centroids (assignment-coverage bound)
        import jax.numpy as jnp
        from parlayann_tpu.build.clusterindex import _assign_all

        C = ci.C
        pt2c = np.full(ps.n, -1, np.int64)
        mem = ci.members
        for c in range(0):
            pass
        rows = np.repeat(np.arange(C), mem.shape[1])
        v = mem.reshape(-1) >= 0
        pt2c[mem.reshape(-1)[v]] = rows[v]
        cents = ci.centroids_q
        # query -> nearest centroids in FULL precision via recenter
        from parlayann_tpu.build.clusterindex import _recenter
        cf = np.asarray(_recenter(jnp.asarray(X), mem, C))
        qi, _ = _assign_all(jnp.asarray(Q), nq, jnp.asarray(cf), C, 16,
                            Metric.L2)
        gt_cl = pt2c[np.clip(gt_i[:, :k], 0, ps.n - 1)]
        for P in (4, 8, 16):
            hit = (gt_cl[:, :, None] == qi[:, None, :P]).any(-1).mean()
            print(f"  [{tag}] coverage@P={P}: {hit:.4f}", flush=True)
        ids, _, _ = ci.search(jnp.asarray(Q), k=k, n_probe=16, cut=0.0)
        rec = compute_recall(np.asarray(ids), gt_i, gt_d, k)
        print(f"  [{tag}] recall@16probes: {rec:.4f}", flush=True)

    # exact path (reference behavior at this n)
    if os.environ.get("SKIP_EXACT", "0") != "1":
        t0 = time.perf_counter()
        ci_e = ClusterIndex.build(ps, m=64, cand=cand, verbose=True)
        print(f"exact build: {time.perf_counter()-t0:.1f}s C={ci_e.C}",
              flush=True)
        evaluate("exact", ci_e)

    # hier path (forced)
    os.environ["PARLAYANN_KMEANS_EXACT_LIMIT"] = "1"
    t0 = time.perf_counter()
    ci_h = ClusterIndex.build(ps, m=64, cand=cand, verbose=True)
    print(f"hier build: {time.perf_counter()-t0:.1f}s C={ci_h.C}",
          flush=True)
    evaluate("hier", ci_h)


if __name__ == "__main__":
    main()
