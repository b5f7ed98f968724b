"""Recall measurement with tie handling + per-query statistics.

Reference: checkRecall (check_nn_recall.h:18-125) and stats.h:57-94. The
tie rule: ground-truth entries beyond position k whose distance equals the
k-th distance also count as correct matches (check_nn_recall.h:87-108).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class NNResult:
    """nn_result (parse_results.h:104-160)."""

    recall: float
    QPS: float
    avg_cmps: float
    tail_cmps: float
    avg_visited: float
    tail_visited: float
    k: int
    beamQ: int
    cut: float
    limit: int
    degree_limit: int
    num_queries: int

    def print(self) -> str:
        s = (
            f"For {self.k}@{self.k} recall = {self.recall:.6g}, QPS = {self.QPS:.6g}, "
            f"Q = {self.beamQ}, cut = {self.cut}, visited limit = {self.limit}, "
            f"degree limit: {self.degree_limit}, average visited = "
            f"{self.avg_visited:.0f}, average cmps = {self.avg_cmps:.0f}"
        )
        print(s)
        return s


def mean_p99(x: np.ndarray) -> tuple[float, float]:
    """stats.h:84-92: average + 99th percentile (sorted index 0.99n)."""
    if x.size == 0:
        return 0.0, 0.0
    xs = np.sort(x)
    return float(xs.mean()), float(xs[min(int(0.99 * len(xs)), len(xs) - 1)])


def compute_recall(
    result_ids: np.ndarray,  # (B, k)
    gt_ids: np.ndarray,  # (B, kg) with kg >= k
    gt_dists: np.ndarray | None = None,  # (B, kg) for tie resolution
    k: int = 10,
    tie_rtol: float = 0.0,
) -> float:
    """k@k recall with ties counted (check_nn_recall.h:83-109).

    A GT column beyond k counts as a tie when its distance equals the
    k-th one, or lies within ``tie_rtol`` of it (relative), for results
    computed in another precision than the GT."""
    B = result_ids.shape[0]
    assert gt_ids.shape[1] >= k, f"{k}@{k} too large for GT of size {gt_ids.shape[1]}"
    res = result_ids[:, :k]
    kg = gt_ids.shape[1]
    # valid GT columns: first k always; columns beyond k only on distance tie
    if gt_dists is not None and kg > k:
        last = gt_dists[:, k - 1 : k]
        near = gt_dists[:, k:] - last <= tie_rtol * np.abs(last)
        tie = np.concatenate([np.ones((B, k), dtype=bool), near], axis=1)
    else:
        tie = np.zeros((B, kg), dtype=bool)
        tie[:, :k] = True
    # membership: (B, k, kg)
    match = res[:, :, None] == gt_ids[:, None, :]
    match &= tie[:, None, :]
    match &= res[:, :, None] >= 0
    correct = int(match.any(axis=2).sum())
    return correct / (B * k)


def range_recall(reported: list, gt: list):
    """Pointwise + cumulative range recall (check_range_recall.h:37-53)."""
    import numpy as _np

    pointwise = 0.0
    nonzero = 0
    rep_total = 0
    gt_total = 0
    for r, g in zip(reported, gt):
        nr, ng = len(r), len(g)
        rep_total += nr
        gt_total += ng
        if ng:
            inter = len(set(_np.asarray(r).tolist()) & set(_np.asarray(g).tolist()))
            pointwise += inter / ng
            nonzero += 1
    return (
        pointwise / max(nonzero, 1),
        (rep_total / gt_total) if gt_total else 0.0,
    )
