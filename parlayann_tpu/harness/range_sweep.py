"""Range-search sweep harness — per-beam range recall/QPS table.

Reference: ``range_search_wrapper`` (check_range_recall.h:67-84) sweeps
initial beams {10, 20, 30, 40, 50, 100, 1000, 2000, 3000}; per beam,
``checkRangeRecall`` (check_range_recall.h:22-63) runs the query-driven
range search and prints pointwise recall (mean per-query fraction of the
ground-truth set reported, over queries with nonempty GT), cumulative
recall (total reported / total GT) and QPS. Driven by
rangeSearch/vamanaRange/range.h:40-69.

Device notes: queries run as one batch per beam; the timer covers the fused
beam+BFS dispatches only (query upload excluded, matching the reference's
query-only timer). The BFS result set is capped; the cap auto-rises to
cover the largest GT set so a truncated set can never masquerade as a
recall loss.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

RANGE_BEAMS = (10, 20, 30, 40, 50, 100, 1000, 2000, 3000)


@dataclasses.dataclass
class RangeRow:
    initial_beam: int
    pointwise_recall: float
    cumulative_recall: float
    QPS: float
    avg_cmps: float

    def print(self) -> str:
        s = (
            f"For initial beam = {self.initial_beam}, "
            f"Pointwise Recall = {self.pointwise_recall:.6g}, "
            f"Cumulative Recall = {self.cumulative_recall:.6g}, "
            f"QPS = {self.QPS:.6g}"
        )
        print(s, flush=True)
        return s


def range_search_wrapper(
    queries,
    points_data,
    nbrs,
    degs,
    gt: list,
    rad: float,
    start_point: int = 0,
    beams=RANGE_BEAMS,
    *,
    metric,
    n_valid: int,
    cap: int = 0,
    verbose: bool = True,
    repeats: int = 1,
) -> list[RangeRow]:
    """Sweep initial beams -> list of RangeRow (printed as it goes)."""
    from parlayann_tpu.harness.recall import range_recall
    from parlayann_tpu.search.range import range_query
    from parlayann_tpu.utils.arrays import as_device

    q = as_device(np.asarray(queries, dtype=np.float32))
    nq = q.shape[0]
    max_gt = max((len(g) for g in gt), default=0)
    if cap <= 0:
        cap = 256
    while cap < max_gt:
        cap *= 2

    rows = []
    for beam in beams:
        if beam > n_valid:
            continue
        dt = float("inf")
        rr = None
        for rep in range(max(1, repeats) + 1):
            t0 = time.perf_counter()
            rr = range_query(
                q, points_data, nbrs, degs, start_point, rad,
                initial_beam=beam, cap=cap, metric=metric, n_valid=n_valid,
            )
            _ = np.asarray(rr.ids[:1])  # readback fence
            if rep > 0:  # rep 0 warms the compile cache
                dt = min(dt, time.perf_counter() - t0)
        ids = np.asarray(rr.ids)
        ds = np.asarray(rr.dists)
        reported = [
            ids[i][(ids[i] >= 0) & (ds[i] <= rad)] for i in range(nq)
        ]
        pw, cum = range_recall(reported, gt)
        row = RangeRow(
            initial_beam=beam,
            pointwise_recall=pw,
            cumulative_recall=cum,
            QPS=nq / dt,
            avg_cmps=float(np.asarray(rr.dist_cmps).mean()),
        )
        if verbose:
            row.print()
        rows.append(row)
    return rows
