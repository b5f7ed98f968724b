"""pyNNDescent deviation validation.

The repo's descent round is a pull-style SAMPLED 2-hop join
(build/pynndescent.py:_descent_round); the reference's is a push-style
exact local join bounded by "new" flags (pynn_index.h:87-155:
per-vertex reverse candidates filtered against current neighbors, all
pairs within them + cross pairs vs the forward list, gated on either
endpoint having changed last round, pushed into both endpoints' bounded
lists). This script runs BOTH descents from the IDENTICAL cluster-tree
init on a *connected* clustered dataset and compares:

  1. graph quality: fraction of true 10-NN present in the K=40 lists
     after descent (isolates the round semantics), and
  2. end recall@10 after undirect+prune, searched with random starts
     (beamSearchRandom parity, the reference's operating mode).

Oracle is plain numpy (exact reference semantics, no sampling); slow by
design — run at n<=20K. Env: N, D, K, NC (clusters), STD, S1/S2.
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def knn_recall(lists: np.ndarray, gt: np.ndarray) -> float:
    """Fraction of each row's true k-NN ids present in its list."""
    hits = 0
    for i in range(len(gt)):
        hits += len(np.intersect1d(lists[i], gt[i], assume_unique=False))
    return hits / gt.size


def push_descent(X, ids0, d0, K, delta, max_rounds, seed=0, verbose=True):
    """Exact reference-semantics nn-descent (pynn_index.h:66-196)."""
    rng = np.random.default_rng(seed)
    n = len(X)
    ids = [list(ids0[i][ids0[i] >= 0]) for i in range(n)]
    dst = [list(d0[i][ids0[i] >= 0]) for i in range(n)]
    changed = np.ones(n, bool)
    for r in range(max_rounds):
        t0 = time.perf_counter()
        # reverse_graph: group by target, shuffle, dedup, cap K
        rev = [[] for _ in range(n)]
        for i in range(n):
            for j in ids[i]:
                rev[j].append(i)
        for j in range(n):
            u = np.unique(np.asarray(rev[j], np.int64))
            rng.shuffle(u)
            rev[j] = u[:K]
        new_changed = np.zeros(n, bool)
        # accumulate pushed edges per round, merge at the end (the
        # reference merges per chunk; one big batch is the same fixpoint
        # up to intra-round ordering — acceptable for an oracle)
        push_t, push_s, push_d = [], [], []
        for i in range(n):
            cur = np.asarray(ids[i], np.int64)
            filt = np.setdiff1d(rev[i], np.append(cur, i),
                                assume_unique=False)
            if len(filt) == 0:
                continue
            # union block distances
            U = np.concatenate([filt, cur])
            V = X[U]
            D = ((V[:, None, :] - V[None, :, :]) ** 2).sum(-1)
            f = len(filt)
            worst = np.array([dst[int(u)][-1] if len(dst[int(u)]) >= K
                              else np.inf for u in U])
            ch = changed[U]
            # pairs within filtered candidates (l<m), gated changed[j]|changed[k]
            lu, mu = np.triu_indices(f, k=1)
            if len(lu):
                gate = ch[lu] | ch[mu]
                dd = D[lu, mu]
                ok_j = gate & (dd < worst[lu])
                ok_k = gate & (dd < worst[mu])
                push_t.append(filt[lu[ok_j]]); push_s.append(filt[mu[ok_j]])
                push_d.append(dd[ok_j])
                push_t.append(filt[mu[ok_k]]); push_s.append(filt[lu[ok_k]])
                push_d.append(dd[ok_k])
            # cross pairs (j in neighbors, k in filtered), gated changed[i]|changed[k]
            if len(cur):
                jj, kk = np.meshgrid(np.arange(len(cur)) + f,
                                     np.arange(f), indexing="ij")
                jj, kk = jj.ravel(), kk.ravel()
                gate = changed[i] | ch[kk]
                dd = D[jj, kk]
                ok_j = gate & (dd < worst[jj])
                ok_k = gate & (dd < worst[kk])
                push_t.append(cur[jj[ok_j] - f]); push_s.append(filt[kk[ok_j]])
                push_d.append(dd[ok_j])
                push_t.append(filt[kk[ok_k]]); push_s.append(cur[jj[ok_k] - f])
                push_d.append(dd[ok_k])
        if push_t:
            T = np.concatenate(push_t)
            S = np.concatenate(push_s)
            DD = np.concatenate(push_d)
            order = np.lexsort((S, DD, T))
            T, S, DD = T[order], S[order], DD[order]
            # per-target bounded union (seq_union_bounded semantics)
            bounds = np.searchsorted(T, np.unique(T))
            uniq = np.unique(T)
            bounds = np.append(bounds, len(T))
            for bi, tgt in enumerate(uniq):
                s = S[bounds[bi]:bounds[bi + 1]]
                dd = DD[bounds[bi]:bounds[bi + 1]]
                # dedup by src keeping smallest dist (already dist-sorted)
                _, first = np.unique(s, return_index=True)
                first.sort()
                s, dd = s[first], dd[first]
                ci = np.asarray(ids[tgt], np.int64)
                cd = np.asarray(dst[tgt])
                ai = np.concatenate([ci, s])
                ad = np.concatenate([cd, dd])
                o = np.lexsort((ai, ad))
                ai, ad = ai[o], ad[o]
                _, fi = np.unique(ai, return_index=True)
                fi.sort()
                ai, ad = ai[fi], ad[fi]
                o = np.argsort(ad, kind="stable")[:K]
                ni, nd = ai[o], ad[o]
                if len(ni) != len(ci) or (np.sort(ni) != np.sort(ci)).any():
                    new_changed[tgt] = True
                    ids[tgt] = list(ni)
                    dst[tgt] = list(nd)
        nch = int(new_changed.sum())
        if verbose:
            print(f"  push round {r}: changed {nch} "
                  f"({time.perf_counter()-t0:.1f}s)", flush=True)
        changed = new_changed
        if nch < delta * n:
            break
    out = np.full((n, K), -1, np.int64)
    for i in range(n):
        out[i, :len(ids[i])] = ids[i]
    return out


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from parlayann_tpu.data.pointset import PointSet
    from parlayann_tpu.types import Metric
    from parlayann_tpu.build.cluster import cluster_tree_labels, leaf_members
    from parlayann_tpu.build import pynndescent as P
    from parlayann_tpu.utils import synthetic

    n = int(os.environ.get("N", 10_000))
    d = int(os.environ.get("D", 64))
    K = int(os.environ.get("K", 40))
    nc = int(os.environ.get("NC", 50))
    std = float(os.environ.get("STD", 1.0))  # overlapping -> connected
    s1 = int(os.environ.get("S1", 16))
    s2 = int(os.environ.get("S2", 16))
    nq = 1000

    X, Q = synthetic.clustered(n, d, n_queries=nq, n_clusters=nc,
                               cluster_std=std, seed=3)
    ps = PointSet.from_numpy(X)
    # exact GT (host, small n)
    D2 = ((X[:, None, :] - X[None, :, :]) ** 2).sum(-1) if n <= 4000 else None
    if D2 is not None:
        np.fill_diagonal(D2, np.inf)
        gt = np.argsort(D2, axis=1)[:, :10]
    else:
        gt = np.empty((n, 10), np.int64)
        for lo in range(0, n, 1024):
            hi = min(n, lo + 1024)
            Db = ((X[lo:hi, None, :] - X[None, :, :]) ** 2).sum(-1)
            for i in range(lo, hi):
                Db[i - lo, i] = np.inf
            gt[lo:hi] = np.argpartition(Db, 10, axis=1)[:, :10]

    # ---- shared init: cluster trees, exactly as the builder ----
    key = jax.random.key(0)
    nbr_ids = jnp.full((ps.n_pad, K), -1, jnp.int32)
    nbr_dists = jnp.full((ps.n_pad, K), P.INF, jnp.float32)
    S = 100
    for t in range(10):
        key, sub = jax.random.split(key)
        lids, labels = cluster_tree_labels(
            ps.data, sub, metric=ps.metric, cluster_size=S, n_valid=n)
        members, sizes = leaf_members(np.asarray(lids), np.asarray(labels), S)
        chunk = max(1, min(len(members), (1 << 24) // (S * S)))
        for lo in range(0, len(members), chunk):
            mem, sz = members[lo:lo + chunk], sizes[lo:lo + chunk]
            if len(mem) < chunk:
                pad = chunk - len(mem)
                mem = np.concatenate([mem, np.full((pad, S), -1, np.int32)])
                sz = np.concatenate([sz, np.zeros(pad, np.int32)])
            nbr_ids, nbr_dists = P._leaf_topk(
                ps.data, jnp.asarray(mem), jnp.asarray(sz),
                nbr_ids, nbr_dists, S=S, K=K, metric=ps.metric, n_valid=n)
    init_ids = np.asarray(nbr_ids)[:n]
    init_d = np.asarray(nbr_dists)[:n]
    print(f"init: knn-recall@10 = {knn_recall(init_ids, gt):.4f}", flush=True)

    delta = 0.05
    max_rounds = max(10, int(np.ceil(np.log2(max(d, 2)))))

    # ---- pull-sampled descent (the repo's rounds) ----
    # Two stop rules compared: the shipped ENTRY-count delta and the
    # reference's VERTEX-count delta (pynn_index.h:182 counts vertices
    # whose list changed). Entry-count >= vertex-count, so the entry rule
    # runs more rounds and over-converges toward the pure kNN graph,
    # evicting the mid-descent long-range edges that make the pruned
    # graph navigable from random starts.
    ids_p, d_p = nbr_ids, nbr_dists
    key2 = jax.random.key(1)
    vstop_ids = None
    prev = np.asarray(ids_p)[:n]
    for r in range(max_rounds):
        key2, k1, k2 = jax.random.split(key2, 3)
        rev = P._reverse_capped(ids_p, k1, K=K, metric=ps.metric, n_valid=n)
        ids_p, d_p, changed = P._descent_round(
            ps.data, ids_p, d_p, rev, k2, s1=s1, s2=s2, K=K,
            metric=ps.metric, n_valid=n)
        ch = int(changed)
        cur = np.asarray(ids_p)[:n]
        vch = int((cur != prev).any(axis=1).sum())
        prev = cur
        print(f"  pull round {r}: changed entries {ch} vertices {vch}",
              flush=True)
        if vstop_ids is None and vch < delta * n:
            vstop_ids = cur.copy()
            print(f"  (vertex-delta stop at round {r})", flush=True)
        if ch < delta * n:
            break
    pull_ids = np.asarray(ids_p)[:n]
    if vstop_ids is None:
        vstop_ids = pull_ids
    rec_pull = knn_recall(pull_ids, gt)

    # final exact 2-hop polish rounds (until vertex-delta or 3 rounds)
    ids_e, d_e = ids_p, d_p
    for pr in range(int(os.environ.get("POLISH", 3))):
        key2, k4 = jax.random.split(key2)
        rev = P._reverse_capped(ids_e, k4, K=K, metric=ps.metric, n_valid=n)
        ids_e, d_e, che = P._descent_round_exact(
            ps.data, ids_e, d_e, rev, K=K, metric=ps.metric, n_valid=n)
        print(f"  exact polish round {pr}: changed {int(che)}", flush=True)
        if int(che) < delta * n:
            break
    exact_ids = np.asarray(ids_e)[:n]

    # ---- exact push-join oracle (reference semantics) ----
    push_ids = push_descent(X.astype(np.float64), init_ids, init_d, K,
                            delta, max_rounds)
    rec_push = knn_recall(push_ids, gt)

    print(f"\ndescent graph knn-recall@10:  pull(s1={s1},s2={s2}) "
          f"= {rec_pull:.4f}   push(exact ref) = {rec_push:.4f}   "
          f"gap = {(rec_push - rec_pull) * 100:.2f}pp", flush=True)

    # ---- end-to-end: undirect+prune + random-start search on both ----
    from parlayann_tpu.build.prune import robust_prune_chunked
    from parlayann_tpu.ops import distance
    from parlayann_tpu.data.graph import GraphIndexData
    from parlayann_tpu.index import Index
    from parlayann_tpu.harness.recall import compute_recall
    from parlayann_tpu.search import exact as EX

    gt_q_ids, gt_q_d = EX.compute_groundtruth(ps, Q, 10)

    def finish_and_search(raw_ids, extra_ids=None):
        ri = np.full((ps.n_pad, K), -1, np.int32)
        ri[:n] = raw_ids
        ii = jnp.asarray(ri)
        me = ps.data.astype(jnp.float32)

        def dists_of(idm):
            safe = jnp.clip(idm, 0, ps.n_pad - 1)
            dd = distance.gathered(
                me, jnp.take(ps.data, safe, axis=0).astype(jnp.float32),
                ps.metric)
            return jnp.where(idm >= 0, dd, P.INF)

        dd = dists_of(ii)
        k3 = jax.random.key(7)
        rev = P._reverse_capped(ii, k3, K=K, metric=ps.metric, n_valid=n)
        rev_d = dists_of(rev)
        cand_i = [ii, rev]
        cand_d = [dd, rev_d]
        if extra_ids is not None:
            ei = np.full((ps.n_pad, K), -1, np.int32)
            ei[:n] = extra_ids
            eij = jnp.asarray(ei)
            cand_i.append(eij)
            cand_d.append(dists_of(eij))
        pr = robust_prune_chunked(
            jnp.arange(ps.n_pad, dtype=jnp.int32),
            jnp.concatenate(cand_i, axis=1),
            jnp.concatenate(cand_d, axis=1),
            ps.data, 1.2, R=K, metric=ps.metric, n_valid=n)
        g = GraphIndexData(neighbors=pr.ids, degrees=pr.degree, n=n,
                           max_degree=K)
        idx = Index(points=ps, graph=g)
        rows = []
        for beam in (20, 40, 80):
            ids, _, _ = idx.batch_search(Q, k=10, beam_size=beam,
                                         random_starts=1)
            rows.append((beam, compute_recall(np.asarray(ids), gt_q_ids,
                                              gt_q_d, 10)))
        return rows

    print(f"vertex-delta stop: knn-recall@10 = "
          f"{knn_recall(vstop_ids, gt):.4f}", flush=True)
    np.savez("/tmp/pynn_state.npz", X=X, Q=Q, gt=gt,
             init_ids=init_ids, pull_ids=pull_ids, push_ids=push_ids,
             vstop_ids=vstop_ids, pull_d=np.asarray(d_p)[:n])
    rp = finish_and_search(pull_ids)
    rs = finish_and_search(exact_ids)
    rr = finish_and_search(push_ids)
    print("\nend-to-end recall@10 (random_starts=1):")
    for (b, a), (_, s), (_, o) in zip(rp, rs, rr):
        print(f"  beam {b:3d}: pull = {a:.4f}   "
              f"pull+exact = {s:.4f}   push(ref) = {o:.4f}   "
              f"gap(exact-push) = {(s - o) * 100:.2f}pp", flush=True)


if __name__ == "__main__":
    main()
