"""Bring-up check: the build-and-search path on one NVIDIA GPU.

Drives the main path through the entry points a user calls — exact ground
truth, the Vamana build + q8 graph search, the ClusterIndex build +
search, and the HNSW / HCNNG / pyNNDescent builders — on a clustered
1M x 128 float32 corpus (the SIFT1M / BIGANN-1M shape), and checks every
answer against an independent reference: the exact ground truth against
a numpy float64 brute force, every search's recall@10 against that
ground truth. Every time it prints is a bring-up timing, not a benchmark.

    python chip_smoke.py                  # one GPU, the 1M corpus
    python chip_smoke.py --n 100000       # a smaller corpus, quick check
    python chip_smoke.py --trace DIR      # + device time per former-kernel
                                          #   scope, from a profiler trace
    python chip_smoke.py --four           # the three multi-device modes on
                                          #   4 GPUs, next to one GPU

Exits non-zero on any failed check, or when JAX finds no GPU. The last
line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

K = 10
DIM = 128
SEED = 7
N_QUERIES = 10_000
N_CHECK = 1_000  # queries checked against the numpy float64 brute force
TIE_RTOL = 1e-5  # ties at the k-th distance, relative
RECALL_TARGET = 0.95
OTHER_BUILDERS_N = 100_000
OTHER_RECALL_FLOOR = 0.9
SCOPES = ("graph_beam_search", "beam_candidate_distances", "beam_merge",
          "cluster_seed", "cluster_beam", "occlusion_loop", "flat_scan")
# modules whose optimized HLO the --trace run dumps: the graph search, the
# cluster search, the exact scan and the build's phase programs
TRACE_MODULES = "jit_(fused_search|cluster_search|flat_search_batch|_lambda)"


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def require_gpu(devices) -> None:
    """Refuse to run anywhere but on a GPU: a CPU fallback would time the
    wrong machine."""
    check(len(devices) > 0 and devices[0].platform == "gpu",
          f"no GPU: JAX runs on {devices[0].platform if devices else None}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip()


def peak_gib(dev) -> str:
    s = dev.memory_stats() or {}
    return f"{s.get('peak_bytes_in_use', 0) / 2**30:.3f} GiB"


def numpy_groundtruth(X, Q, k):
    """float64 brute force -> (ids (B, k), dists (B, k)); an oracle that
    shares no code with the device path."""
    Qd = Q.astype(np.float64)
    qn = (Qd * Qd).sum(1)[:, None]
    best_d = np.full((len(Q), k), np.inf)
    best_i = np.full((len(Q), k), -1, np.int64)
    step = 50_000
    for lo in range(0, len(X), step):
        blk = X[lo:lo + step].astype(np.float64)
        d = qn - 2.0 * (Qd @ blk.T) + (blk * blk).sum(1)[None, :]
        part = np.argpartition(d, k - 1, axis=1)[:, :k]
        cd = np.take_along_axis(d, part, axis=1)
        md = np.concatenate([best_d, cd], axis=1)
        mi = np.concatenate([best_i, part + lo], axis=1)
        o = np.argsort(md, axis=1, kind="stable")[:, :k]
        best_d = np.take_along_axis(md, o, axis=1)
        best_i = np.take_along_axis(mi, o, axis=1)
    return best_i, best_d


def recall(ids, gt_ids, gt_d):
    from parlayann_tpu.harness.recall import compute_recall

    return compute_recall(np.asarray(ids), gt_ids, gt_d, K,
                          tie_rtol=TIE_RTOL)


def corpus(n):
    from parlayann_tpu.utils import synthetic

    return synthetic.clustered(n, DIM, n_queries=N_QUERIES,
                               n_clusters=max(64, n // 100),
                               cluster_std=0.35, seed=SEED)


def device_ground_truth(ps, Q, note, log):
    from parlayann_tpu.search.exact import compute_groundtruth

    t0 = time.perf_counter()
    gt_i, gt_d = compute_groundtruth(ps, Q, 2 * K)
    gt_i, gt_d = np.asarray(gt_i), np.asarray(gt_d)
    log(f"[gt] exact top-{2 * K} of {len(Q)} queries over {ps.n}: "
        f"{time.perf_counter() - t0:.3f} s ({note})")
    return gt_i, gt_d


def phase_ground_truth(X, Q, ps, note, log):
    gt_i, gt_d = device_ground_truth(ps, Q, note, log)
    t0 = time.perf_counter()
    np_i, np_d = numpy_groundtruth(X, Q[:N_CHECK], 2 * K)
    r = recall(gt_i[:N_CHECK, :K], np_i, np_d)
    log(f"[gt] device GT vs numpy float64 on {N_CHECK} queries: tie-aware "
        f"recall {r} (numpy {time.perf_counter() - t0:.1f} s)")
    check(r == 1.0, f"device ground truth disagrees with numpy: {r}")
    check(np.isfinite(gt_d[:, :K]).all(), "non-finite GT distances")
    return gt_i, gt_d


def vamana_sweep(idx, Q, gt_i, gt_d, tag, note, log, beams):
    best = 0.0
    for beam in beams:
        ids, dists, res, dt = idx.batch_search_timed(Q, k=K, beam_size=beam)
        r = recall(ids, gt_i, gt_d)
        check(np.isfinite(np.asarray(dists)[np.asarray(ids) >= 0]).all(),
              f"{tag}: non-finite distances")
        log(f"[{tag}] Q={beam} recall@10 {r:.4f} "
            f"visited {float(np.mean(np.asarray(res.num_visited))):.1f} "
            f"cmps {float(np.mean(np.asarray(res.dist_cmps))):.1f} "
            f"search {dt:.4f} s ({note})")
        best = max(best, r)
        if r >= 0.99:
            break
    return best


def phase_vamana(X, Q, ps, gt_i, gt_d, dev, note, log):
    from parlayann_tpu import api
    from parlayann_tpu.index import Index

    t0 = time.perf_counter()
    graph, ps_b, stats = api.build_vamana_index(
        ps, metric="Euclidian", R=32, L=64, alpha=1.2, two_pass=True,
        quantize_build=True, batch_cap_frac=0.16,
    )
    dt = time.perf_counter() - t0
    avg, mx = graph.stats()
    log(f"[vamana] build R=32 L=64 alpha=1.2 two passes on the q8 tier: "
        f"{dt:.2f} s incl. compile, avg/max degree {avg:.2f}/{mx}, peak "
        f"{peak_gib(dev)} ({note})")
    idx = Index(points=ps, graph=graph).enable_quantized(8)
    best = vamana_sweep(idx, Q, gt_i, gt_d, "vamana", note, log,
                        (10, 16, 24, 32, 48, 64, 100, 150, 200, 256))
    log(f"[vamana] best recall@10 {best:.4f}, peak {peak_gib(dev)}")
    check(best >= RECALL_TARGET,
          f"vamana recall {best} < {RECALL_TARGET} at Q <= 256")
    return idx, graph


def phase_cluster(Q, ps, gt_i, gt_d, dev, note, log, ext_dtype="auto"):
    import jax

    from parlayann_tpu.build.clusterindex import ClusterIndex

    t0 = time.perf_counter()
    ci = ClusterIndex.build(ps, m=64, ext_dtype=ext_dtype)
    dt = time.perf_counter() - t0
    log(f"[cluster] build m=64 Rc=16 slack=1.5 C={ci.C} layout "
        f"{ci.ext_dtype}: {dt:.2f} s incl. compile, peak {peak_gib(dev)} "
        f"({note})")
    Qd = jax.device_put(Q)
    best = 0.0
    for npr in (3, 4, 6, 8, 12, 16):
        ids, dists, (nv, cmps), dt = ci.search_timed(Qd, k=K, n_probe=npr,
                                                    cut=0.0)
        r = recall(ids, gt_i, gt_d)
        check(np.isfinite(np.asarray(dists)[np.asarray(ids) >= 0]).all(),
              "cluster: non-finite distances")
        log(f"[cluster] n_probe={npr} recall@10 {r:.4f} "
            f"probes {float(np.mean(np.asarray(nv))):.2f} "
            f"cmps {float(np.mean(np.asarray(cmps))):.1f} "
            f"search {dt:.4f} s ({note})")
        best = max(best, r)
    log(f"[cluster] best recall@10 {best:.4f}, peak {peak_gib(dev)}")
    check(best >= RECALL_TARGET,
          f"cluster recall {best} < {RECALL_TARGET} at n_probe <= 16")
    return ci


def phase_other_builders(dev, note, log):
    from parlayann_tpu import api, native
    from parlayann_tpu.data.pointset import PointSet
    from parlayann_tpu.index import Index

    n = OTHER_BUILDERS_N
    X, Q = corpus(n)
    Q = Q[:N_CHECK]
    ps = PointSet.from_numpy(X)
    gt_i, gt_d = device_ground_truth(ps, Q, note, log)
    log(f"[builders] native Kruskal library loaded: {native.loaded()}")
    builds = (
        ("hnsw", lambda: api.build_hnsw_index(ps)),
        ("hcnng", lambda: api.build_hcnng_index(ps)),
        ("pynndescent", lambda: api.build_pynndescent_index(ps)),
    )
    for name, build in builds:
        t0 = time.perf_counter()
        out, _, _ = build()
        dt = time.perf_counter() - t0
        if name == "hnsw":
            ids, _ = out.batch_search(Q, k=K, ef=64)
        else:
            ids, _, _ = Index(points=ps, graph=out).batch_search(
                Q, k=K, beam_size=64)
        r = recall(ids, gt_i, gt_d)
        log(f"[builders] {name} at {n}x{DIM}: build {dt:.2f} s incl. "
            f"compile, recall@10 {r:.4f} at beam 64, peak {peak_gib(dev)} "
            f"({note})")
        check(r >= OTHER_RECALL_FLOOR,
              f"{name} recall {r} < {OTHER_RECALL_FLOOR}")


def phase_trace(trace_dir, ps, Q, idx, graph, ci, log):
    """Device time per former-kernel scope over one warm window: a graph
    search, a cluster search, an exact scan and one steady build batch."""
    import jax

    from parlayann_tpu.harness import trace
    from parlayann_tpu.search.exact import compute_groundtruth
    from parlayann_tpu.types import BuildParams
    from parlayann_tpu.build.vamana import profile_one_batch
    from parlayann_tpu.ops import quantize

    bps = quantize.quantize_pointset(ps, bits=8)
    bp = BuildParams(R=32, L=64, alpha=1.2, num_passes=2,
                     batch_cap_frac=0.16)
    Qd = jax.device_put(Q)
    qgt = Q[:8192]

    def window():
        jax.block_until_ready(idx.batch_search(Qd, k=K, beam_size=64))
        jax.block_until_ready(ci.search(Qd, k=K, n_probe=8, cut=0.0))
        jax.block_until_ready(compute_groundtruth(ps, qgt, 2 * K))
        profile_one_batch(bps, bp, graph, repeats=0)

    window()  # compile outside the traced window
    raw = os.path.join(trace_dir, "raw")
    hlo = os.path.join(trace_dir, "hlo")
    shutil.rmtree(raw, ignore_errors=True)
    with jax.profiler.trace(raw):
        window()
    times = trace.scope_times(raw, SCOPES, hlo_dir=hlo)
    with open(os.path.join(trace_dir, "trace_sample.txt"), "w") as f:
        f.write(trace.describe(raw))
    with open(os.path.join(trace_dir, "scopes.json"), "w") as f:
        json.dump(times, f, indent=1)
    shutil.rmtree(raw, ignore_errors=True)
    shutil.rmtree(hlo, ignore_errors=True)
    for s in SCOPES:
        log(f"[trace] {s}: {times[s]:.6f} s device time")
    for mod, sec in list(times["_modules"].items())[:8]:
        log(f"[trace] module {mod}: {sec:.6f} s device time")
    log(f"[trace] window {times.get('_window', 0.0):.6f} s, device busy "
        f"{times['_busy']:.6f} s")


def one_card(args, note, log):
    import jax

    from parlayann_tpu.data.pointset import PointSet

    dev = jax.devices()[0]
    X, Q = corpus(args.n)
    ps = PointSet.from_numpy(X)
    gt_i, gt_d = phase_ground_truth(X, Q, ps, note, log)
    idx, graph = phase_vamana(X, Q, ps, gt_i, gt_d, dev, note, log)
    ci = phase_cluster(Q, ps, gt_i, gt_d, dev, note, log)
    if args.trace:
        phase_trace(args.trace, ps, Q, idx, graph, ci, log)
    del idx, graph, ci
    phase_other_builders(dev, note, log)


def shard_devices(name, arrays, log):
    devs = set()
    for a in arrays:
        devs |= {s.device for s in a.addressable_shards}
    log(f"[four] {name} shards on: {sorted(str(d) for d in devs)}")
    check(len(devs) == 4, f"{name}: shards on {len(devs)} cards, not 4")


def four_cards(args, note, log):
    """The three multi-device modes on 4 cards over the same corpus, each
    next to its one-card counterpart; the global build (the mode with the
    most collectives) first, so that a fault there shows soonest."""
    import jax

    from parlayann_tpu.build.clusterindex import ClusterIndex
    from parlayann_tpu.build.vamana import build_vamana_graph
    from parlayann_tpu.data.pointset import PointSet
    from parlayann_tpu.index import Index
    from parlayann_tpu.parallel.cluster_sharded import build_sharded_cluster
    from parlayann_tpu.parallel.global_build import (
        build_global_vamana, global_search, make_mesh_1d,
    )
    from parlayann_tpu.parallel.mesh import make_mesh
    from parlayann_tpu.parallel.sharded import (
        build_sharded_vamana, sharded_search,
    )
    from parlayann_tpu.types import BuildParams

    check(len(jax.devices()) >= 4, f"--four needs 4 GPUs, "
          f"JAX sees {len(jax.devices())}")
    X, Q = corpus(args.n)
    Q = Q[:N_CHECK]
    ps = PointSet.from_numpy(X)
    gt_i, gt_d = device_ground_truth(ps, Q, note, log)
    bp = BuildParams(R=32, L=64, alpha=1.2, num_passes=2,
                     batch_cap_frac=0.16)
    beams = (32, 64, 128)

    def one_card_graph(ps_, tag):
        t0 = time.perf_counter()
        g, _ = build_vamana_graph(ps_, bp)
        log(f"[four] one-card f32 build{tag}: {time.perf_counter() - t0:.2f}"
            f" s ({note})")
        return g

    g1 = one_card_graph(ps, "")

    # global build: one graph over all rows (on a prefix of the corpus
    # where --global-n asks for one) vs the one-card graph, medoid start
    ng = min(args.global_n or args.n, args.n)
    if ng < args.n:
        psg = PointSet.from_numpy(X[:ng])
        gtg_i, gtg_d = device_ground_truth(psg, Q, note, log)
        gg1 = one_card_graph(psg, f" at n={ng}")
    else:
        psg, gtg_i, gtg_d, gg1 = ps, gt_i, gt_d, g1
    t0 = time.perf_counter()
    gidx = build_global_vamana(X[:ng], make_mesh_1d(4), bp)
    log(f"[four] global build at n={ng}: {time.perf_counter() - t0:.2f} s "
        f"({note})")
    shard_devices("global", (gidx.points, gidx.nbrs), log)
    idx1 = Index(points=psg, graph=gg1, use_entry=False)
    for beam in beams:
        ids, _ = global_search(gidx, Q, k=K, beam_size=beam)
        ids1, _, _ = idx1.batch_search(Q, k=K, beam_size=beam)
        log(f"[four] global n={ng} Q={beam} recall@10 "
            f"{recall(ids, gtg_i, gtg_d):.4f} | one card (medoid start) "
            f"{recall(ids1, gtg_i, gtg_d):.4f}")
    del gidx, idx1, gg1, psg

    # per-shard replicas vs the one-card graph
    t0 = time.perf_counter()
    sidx = build_sharded_vamana(X, make_mesh(4), bp)
    log(f"[four] sharded build: {time.perf_counter() - t0:.2f} s ({note})")
    shard_devices("sharded", (sidx.points, sidx.nbrs), log)
    idx1 = Index(points=ps, graph=g1)
    for beam in beams:
        ids, _ = sharded_search(sidx, Q, k=K, beam_size=beam)
        ids1, _, _ = idx1.batch_search(Q, k=K, beam_size=beam)
        log(f"[four] sharded Q={beam} recall@10 {recall(ids, gt_i, gt_d):.4f}"
            f" | one card {recall(ids1, gt_i, gt_d):.4f}")
    del sidx, idx1, g1

    # cluster-sharded vs the one-card int8 ClusterIndex
    t0 = time.perf_counter()
    cs = build_sharded_cluster(X, make_mesh(4), m=64)
    log(f"[four] cluster-sharded build: {time.perf_counter() - t0:.2f} s "
        f"({note})")
    shard_devices("cluster-sharded", (cs.mvecs, cs.points), log)
    ci1 = ClusterIndex.build(ps, m=64, ext_dtype="int8")
    for npr in (4, 8, 16):
        ids, _, _ = cs.search(Q, k=K, n_probe=npr)
        ids1, _, _ = ci1.search(Q, k=K, n_probe=npr, cut=0.0)
        log(f"[four] cluster-sharded n_probe={npr} recall@10 "
            f"{recall(ids, gt_i, gt_d):.4f} | one card "
            f"{recall(ids1, gt_i, gt_d):.4f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000,
                    help="corpus size (default 1M)")
    ap.add_argument("--trace", metavar="DIR",
                    help="write per-scope device times under DIR")
    ap.add_argument("--four", action="store_true",
                    help="run the three multi-device modes on 4 GPUs")
    ap.add_argument("--global-n", type=int, default=None,
                    help="corpus prefix for the --four global build "
                         "(default: the whole corpus)")
    args = ap.parse_args(argv)

    def log(msg):
        print(msg, flush=True)

    if args.trace:
        # the traced modules must compile in this process (no persistent
        # cache), so that XLA dumps the optimized HLO which maps each
        # kernel to its named scope (harness/trace.py)
        from parlayann_tpu.harness.trace import dump_flags

        hlo = os.path.join(args.trace, "hlo")
        shutil.rmtree(hlo, ignore_errors=True)
        os.environ["XLA_FLAGS"] = " ".join(filter(None, (
            os.environ.get("XLA_FLAGS"), dump_flags(hlo, TRACE_MODULES))))
    import jax

    devices = jax.devices()
    require_gpu(devices)
    from parlayann_tpu.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    if args.trace:
        jax.config.update("jax_enable_compilation_cache", False)
        cache = "off (--trace)"
    dev = devices[0]
    card = card_line()  # one line per card
    log(f"[device] {dev.platform} {dev.device_kind} x{len(devices)}; "
        f"compile cache {cache}")
    log(f"[device] nvidia-smi: {card}")
    note = f"bring-up timing, not a benchmark; {card.splitlines()[0]}"
    t0 = time.perf_counter()
    if args.four:
        four_cards(args, note, log)
        count = 4
    else:
        one_card(args, note, log)
        count = len(devices)
    log(f"[done] {time.perf_counter() - t0:.1f} s ({note})")
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count,
    }}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
