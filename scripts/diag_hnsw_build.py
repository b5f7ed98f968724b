"""Device-truth profile of the HNSW build.

Steady build is ~10s at 100K (target: the <=3s Vamana class). Two views:

  1. wall-clock split by batch with one fence per batch (ramp vs steady,
     and the per-batch cost curve as the graph grows);
  2. a jax.profiler trace over a few steady batches, summed by device op
     (is it the level-0 gather beam, the robust prune, or the reverse
     exchange?).

Run: python scripts/diag_hnsw_build.py
Env: BENCH_N (100K), HNSW_Q8 (1), HNSW_CAP (0.02).
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
    paths = sorted(glob.glob(os.path.join(tdir, "**", "*.trace.json.gz"),
                             recursive=True), key=os.path.getmtime)
    if not paths:
        print(f"[{label}] no trace found under {tdir}")
        return
    with gzip.open(paths[-1], "rt") as f:
        data = json.load(f)
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
            tot[ev["name"]] += ev.get("dur", 0) / 1e3
            cnt[ev["name"]] += 1
    rows = sorted(tot.items(), key=lambda kv: -kv[1])
    all_ms = sum(tot.values())
    print(f"[{label}] device total {all_ms:.2f} ms across {len(rows)} ops",
          flush=True)
    for name, ms in rows[:16]:
        print(f"  {ms:9.2f} ms x{cnt[name]:<5d} {name[:90]}", flush=True)


def main():
    import jax

    from parlayann_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from parlayann_tpu.types import BuildParams
    from parlayann_tpu.data.pointset import PointSet
    from parlayann_tpu.build import hnsw as H
    from parlayann_tpu.utils import synthetic

    n = int(os.environ.get("BENCH_N", 100_000))
    d = 128
    q8 = os.environ.get("HNSW_Q8", "1") == "1"
    cap = float(os.environ.get("HNSW_CAP", "0.02"))
    print(f"devices: {jax.devices()}  n={n} q8={q8} cap={cap}", flush=True)
    X, _ = synthetic.clustered(n, d, n_queries=16,
                               n_clusters=max(64, n // 100),
                               cluster_std=0.35, seed=7)
    ps = PointSet.from_numpy(X)
    bp = BuildParams(R=20, L=50, alpha=0.9, m_l=0.34, batch_cap_frac=cap)

    # warm the compile cache
    idx, dt = H.build_hnsw_graph(ps, bp, verbose=False, quantize_build=q8)
    print(f"cold build: {dt:.2f}s", flush=True)

    # ---- per-batch wall clock: monkeypatch a fence into the loop via
    # a wrapper around _insert_at_level_dev ----
    t_lv = defaultdict(float)
    c_lv = defaultdict(int)
    orig_ins = H._insert_at_level_dev
    orig_desc = H._descend_dev

    def timed_ins(*a, **kw):
        t0 = time.perf_counter()
        out = orig_ins(*a, **kw)
        jax.block_until_ready(out[0])
        lvl = kw.get("n_valid", -1)
        t_lv[("ins", lvl)] += time.perf_counter() - t0
        c_lv[("ins", lvl)] += 1
        return out

    def timed_desc(*a, **kw):
        t0 = time.perf_counter()
        out = orig_desc(*a, **kw)
        jax.block_until_ready(out)
        lvl = kw.get("n_valid", -1)
        t_lv[("desc", lvl)] += time.perf_counter() - t0
        c_lv[("desc", lvl)] += 1
        return out

    H._insert_at_level_dev = timed_ins
    H._descend_dev = timed_desc
    t0 = time.perf_counter()
    idx, dt = H.build_hnsw_graph(ps, bp, verbose=False, quantize_build=q8)
    fenced = time.perf_counter() - t0
    H._insert_at_level_dev = orig_ins
    H._descend_dev = orig_desc
    print(f"fenced build: {fenced:.2f}s (fences add RTT; use the SPLIT "
          f"below, not the total)", flush=True)
    for key in sorted(t_lv, key=lambda k: -t_lv[k]):
        kind, nv = key
        print(f"  {kind} n_valid={nv:<8d} {t_lv[key]*1e3:9.1f} ms "
              f"x{c_lv[key]}", flush=True)

    # ---- steady build, unfenced (the honest number with current code) ----
    idx, dt = H.build_hnsw_graph(ps, bp, verbose=False, quantize_build=q8)
    print(f"steady build: {dt:.2f}s", flush=True)

    # ---- device trace of one more full build ----
    tdir = "/tmp/hnsw_trace"
    os.system(f"rm -rf {tdir}")
    with jax.profiler.trace(tdir):
        idx, dt = H.build_hnsw_graph(ps, bp, verbose=False,
                                     quantize_build=q8)
    print(f"traced build: {dt:.2f}s", flush=True)
    parse_trace(tdir, "full build")


if __name__ == "__main__":
    main()
