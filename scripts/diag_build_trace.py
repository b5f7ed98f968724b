"""Device-truth trace of one steady-state Vamana build batch.

Builds the graph once (so the batch runs against realistic state), then
traces the three split phases (beam / fwd-prune+rev-append / overflow
prune) with jax.profiler and prints the top device ops per phase.

Env: BENCH_N/BENCH_D, R/L/ALPHA, CAP (batch_cap_frac).
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def parse_trace(tdir, label):
    """Sum device-op durations from the newest .trace.json.gz under tdir."""
    paths = sorted(glob.glob(os.path.join(tdir, "**", "*.trace.json.gz"),
                             recursive=True), key=os.path.getmtime)
    if not paths:
        print(f"[{label}] no trace found under {tdir}")
        return
    with gzip.open(paths[-1], "rt") as f:
        data = json.load(f)
    # device lanes: pid whose name names a device
    dev_pids = set()
    for ev in data.get("traceEvents", []):
        if ev.get("ph") == "M" and ev.get("name") == "process_name":
            nm = ev.get("args", {}).get("name", "")
            if "/device:" in nm:
                dev_pids.add(ev["pid"])
    tot = defaultdict(float)
    cnt = defaultdict(int)
    for ev in data.get("traceEvents", []):
        if ev.get("ph") == "X" and ev.get("pid") in dev_pids:
            tot[ev["name"]] += ev.get("dur", 0) / 1e3  # ms
            cnt[ev["name"]] += 1
    rows = sorted(tot.items(), key=lambda kv: -kv[1])
    all_ms = sum(tot.values())
    print(f"[{label}] device total {all_ms:.2f} ms across {len(rows)} ops")
    for name, ms in rows[:14]:
        print(f"  {ms:8.2f} ms  x{cnt[name]:<4d} {name[:100]}")


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
    R = int(os.environ.get("R", 32))
    L = int(os.environ.get("L", 64))
    alpha = float(os.environ.get("ALPHA", 1.2))
    cap = float(os.environ.get("CAP", 0.04))

    print(f"devices: {jax.devices()}", flush=True)
    X, _ = synthetic.clustered(n, d, n_queries=0,
                               n_clusters=max(64, n // 100),
                               cluster_std=0.35, seed=7)
    ps = quantize.quantize_pointset(PointSet.from_numpy(X), bits=8)
    bp = BuildParams(R=R, L=L, alpha=alpha, num_passes=2,
                     batch_cap_frac=cap)

    t0 = time.perf_counter()
    graph, stats = V.build_vamana_graph(ps, bp)
    print(f"build (maybe cold): {time.perf_counter()-t0:.2f}s", flush=True)

    # one max-width steady batch against the final graph, split phases
    vmax = max((3 * L) // 2, R + 16)
    _, max_batch = batch_schedule(n, n, cap)
    rng = np.random.default_rng(123)
    batch = _pad_pow2(rng.permutation(n)[:max_batch].astype(np.int32),
                      max_batch)
    batch_j = jnp.asarray(batch)
    start = jnp.zeros((1,), jnp.int32)
    alpha_j = jnp.float32(alpha)
    nbrs, degs = graph.neighbors, graph.degrees

    def run_once(nbrs, degs, fence=True):
        out = {}
        t = time.perf_counter()
        cand_ids, cand_d, v, c = _beam_phase(
            nbrs, degs, ps.data, batch_j, start,
            R=R, L=L, vmax=vmax, metric=ps.metric, n_valid=n, expand=2)
        np.asarray(cand_d[:1])
        out["beam"] = time.perf_counter() - t
        t = time.perf_counter()
        nbrs2, degs2, sel_ids, sel_dists = _fwd_phase(
            nbrs + 0, degs + 0, ps.data, batch_j, cand_ids, cand_d,
            alpha_j, R=R, metric=ps.metric, n_valid=n, chunk=2048)
        np.asarray(degs2[:1])
        out["fwd"] = time.perf_counter() - t
        t = time.perf_counter()
        nbrs2, degs2, ctx, rstats = _rev_append_phase(
            nbrs2, degs2, batch_j, sel_ids, sel_dists, R=R, n_valid=n)
        n_over = int(rstats.n_overflow)
        out["rev"] = time.perf_counter() - t
        t = time.perf_counter()
        for off in range(0, n_over, 4096):
            nbrs2, degs2 = _prune_chunk_step(
                nbrs2, degs2, ctx, off, ps.data, alpha_j,
                R=R, metric=ps.metric, n_valid=n, chunk=4096)
        np.asarray(degs2[:1])
        out["overflow"] = time.perf_counter() - t
        out["n_over"] = n_over
        return out

    w = run_once(nbrs, degs)  # warm compiles
    print(f"warm: {w}", flush=True)
    m = run_once(nbrs, degs)
    print(f"steady fenced: beam={m['beam']*1e3:.1f}ms fwd={m['fwd']*1e3:.1f}ms "
          f"rev={m['rev']*1e3:.1f}ms overflow={m['overflow']*1e3:.1f}ms "
          f"(n_over={m['n_over']})", flush=True)

    tdir = "/tmp/build_trace"
    os.makedirs(tdir, exist_ok=True)
    with jax.profiler.trace(tdir):
        m = run_once(nbrs, degs)
    print(f"traced: {m}", flush=True)
    parse_trace(tdir, "one steady batch (all phases)")


if __name__ == "__main__":
    main()
