"""Parameter structs mirroring the reference's knob vocabulary.

Reference: algorithms/utils/types.h:154-245 (BuildParams / QueryParams /
RangeParams). Same knob names so per-dataset configs translate 1:1; the
``alg_type`` inference from which knobs are set is reproduced in
``BuildParams.alg_type``.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class Metric(enum.Enum):
    """Distance metric. Reference: Euclidian_Point (euclidian_point.h:93,
    squared L2, is_metric()=True) and Mips_Point (mips_point.h:68, negated
    inner product, is_metric()=False)."""

    L2 = "Euclidian"
    MIPS = "mips"

    @property
    def is_metric(self) -> bool:
        return self is Metric.L2

    @classmethod
    def coerce(cls, value) -> "Metric":
        """Accept user-facing spellings: 'l2'/'euclidean'/'Euclidian' and
        'mips'/'ip' (the reference CLI's -dist_func vocabulary,
        bench/neighborsTime.C:146-243)."""
        if isinstance(value, cls):
            return value
        s = str(value).strip().lower()
        if s in ("l2", "euclidean", "euclidian"):
            return cls.L2
        if s in ("mips", "ip", "dot", "angular"):
            return cls.MIPS
        raise ValueError(f"unknown metric: {value!r}")


@dataclasses.dataclass
class BuildParams:
    """Union of all per-algorithm build knobs (types.h:154-215).

    Vamana:       R, L, alpha, num_passes, single_batch
    HNSW:         m_l (level factor), R (=2m at level 0), L (=efc), alpha
    HCNNG:        num_clusters, cluster_size, MST_deg
    pyNNDescent:  R, cluster_size, num_clusters, alpha, delta
    quantize:     0 none / 1 one-byte / 2 +bit-or-2bit / 3 +JL variants
                  (vamana/neighbors.h:117-186)
    """

    R: int = 0
    L: int = 0
    alpha: float = 1.0
    num_passes: int = 1
    single_batch: int = 0

    m_l: float = 0.0

    num_clusters: int = 0
    cluster_size: int = 0
    MST_deg: int = 0

    delta: float = 0.0

    quantize: int = 0
    radius: float = 0.0
    radius_2: float = 0.0
    self_: bool = False
    range_: bool = False
    Q: int = 0
    trim: float = 0.0
    rerank_factor: int = 100
    verbose: bool = False

    # no reference analog: the cap on a build batch, as a fraction of n
    batch_cap_frac: float = 0.02
    seed: int = 0

    @property
    def alg_type(self) -> str:
        """Infer algorithm from which knobs are set (types.h:196-209)."""
        if self.num_clusters > 0 and self.MST_deg > 0:
            return "HCNNG"
        if self.num_clusters > 0:
            return "pyNNDescent"
        if self.m_l > 0:
            return "HNSW"
        return "vamana"

    @property
    def max_degree(self) -> int:
        """types.h:211-214: HCNNG max total degree = num_clusters*MST_deg."""
        if self.alg_type == "HCNNG":
            return self.num_clusters * self.MST_deg
        return self.R


@dataclasses.dataclass
class QueryParams:
    """types.h:218-231. ``limit`` bounds #expanded nodes; ``degree_limit``
    bounds #neighbors considered per expansion; ``cut`` prunes the frontier
    (metric only); ``rerank_factor`` scales the rerank candidate pool."""

    k: int = 10
    beamSize: int = 128
    cut: float = 1.35
    limit: Optional[int] = None
    degree_limit: Optional[int] = None
    rerank_factor: int = 100

    def resolved(self, max_degree: int, n: int) -> "QueryParams":
        return QueryParams(
            k=self.k,
            beamSize=self.beamSize,
            cut=self.cut,
            limit=self.limit if self.limit is not None else n,
            degree_limit=(
                self.degree_limit if self.degree_limit is not None else max_degree
            ),
            rerank_factor=self.rerank_factor,
        )


@dataclasses.dataclass
class RangeParams:
    """types.h:233-245."""

    rad: float = 0.0
    initial_beam: int = 45
