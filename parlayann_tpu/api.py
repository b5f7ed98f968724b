"""High-level Python API with boundary validation (ParlayANNpy parity).

Reference: python/wrapper.py:3-116 dispatches every builder over
(metric, dtype) string pairs and raises on anything else; diskannpy's
`_common.py` (vendored in the reference tree) adds dtype canonicalization
and argument assertions. The pybind layer's per-(dtype, metric) template
instantiations collapse here into dtype-generic array ops, so this module
keeps only the part users actually depend on: loud, early errors at the
API boundary — a bad dtype/metric/shape raises ValueError *before* any
jit trace instead of failing deep inside XLA.
"""

from __future__ import annotations

import numpy as np

VALID_DTYPES = (np.float32, np.int8, np.uint8)
VALID_METRICS = ("euclidian", "l2", "mips")


def valid_dtype(dtype) -> np.dtype:
    """Canonicalize a user dtype -> one of float32/int8/uint8, or raise
    (diskannpy ``valid_dtype`` semantics)."""
    dt = np.dtype(dtype)
    for ok in VALID_DTYPES:
        if dt == np.dtype(ok):
            return np.dtype(ok)
    raise ValueError(
        f"vector dtype must be one of float32/int8/uint8, got {dt}"
    )


def valid_metric(metric):
    """Canonicalize 'Euclidian'/'l2'/'mips' (any case) or a Metric enum ->
    Metric, or raise (python/wrapper.py raises on unknown metric strings)."""
    from parlayann_tpu.types import Metric

    if isinstance(metric, Metric):
        return metric
    if isinstance(metric, str) and metric.lower() in VALID_METRICS:
        return Metric.MIPS if metric.lower() == "mips" else Metric.L2
    raise ValueError(
        f"distance_metric must be one of 'Euclidian'/'l2'/'mips', got {metric!r}"
    )


def _valid_data(data, name="data"):
    """Validate a vector batch: 2-D, nonempty, supported dtype. PointSet
    inputs pass through; array-likes are canonicalized."""
    from parlayann_tpu.data.pointset import PointSet

    if isinstance(data, PointSet):
        return data
    arr = np.asarray(data)
    if arr.ndim != 2 or arr.shape[0] == 0 or arr.shape[1] == 0:
        raise ValueError(
            f"{name} must be a nonempty 2-D array (n, d), got shape {arr.shape}"
        )
    return arr.astype(valid_dtype(arr.dtype), copy=False)


def _valid_pos(name, value, lo=1):
    if not isinstance(value, (int, np.integer)) or value < lo:
        raise ValueError(f"{name} must be an integer >= {lo}, got {value!r}")
    return int(value)


def build_vamana_index(data, metric="Euclidian", R: int = 64, L: int = 128,
                       alpha: float = 1.2, two_pass: bool = True, **kwargs):
    """Validated Vamana build (python/wrapper.py:4-24 dispatch)."""
    from parlayann_tpu.build import vamana

    data = _valid_data(data)
    _valid_pos("R", R), _valid_pos("L", L)
    if L < R:
        raise ValueError(f"L (beam {L}) must be >= R (degree {R})")
    if not (0.8 <= float(alpha) <= 4.0):
        raise ValueError(f"alpha must be in [0.8, 4], got {alpha}")
    return vamana.build_vamana_index(
        data, metric=valid_metric(metric), R=R, L=L, alpha=alpha,
        two_pass=two_pass, **kwargs,
    )


def build_hcnng_index(data, metric="Euclidian", mst_deg: int = 3,
                      num_clusters: int = 30, cluster_size: int = 1000,
                      **kwargs):
    """Validated HCNNG build (python/wrapper.py:28-48)."""
    from parlayann_tpu.build import hcnng

    data = _valid_data(data)
    _valid_pos("mst_deg", mst_deg)
    _valid_pos("num_clusters", num_clusters)
    _valid_pos("cluster_size", cluster_size, lo=2)
    return hcnng.build_hcnng_index(
        data, metric=valid_metric(metric), mst_deg=mst_deg,
        num_clusters=num_clusters, cluster_size=cluster_size, **kwargs,
    )


def build_pynndescent_index(data, metric="Euclidian", max_deg: int = 40,
                            num_clusters: int = 10, cluster_size: int = 100,
                            alpha: float = 1.2, delta: float = 0.05,
                            **kwargs):
    """Validated pyNNDescent build (python/wrapper.py:52-72)."""
    from parlayann_tpu.build import pynndescent

    data = _valid_data(data)
    _valid_pos("max_deg", max_deg)
    if not (0.0 < float(delta) < 1.0):
        raise ValueError(f"delta must be in (0, 1), got {delta}")
    return pynndescent.build_pynndescent_index(
        data, metric=valid_metric(metric), K=max_deg,
        num_clusters=num_clusters, cluster_size=cluster_size,
        alpha=alpha, delta=delta, **kwargs,
    )


def build_hnsw_index(data, metric="Euclidian", m: int = 20, efc: int = 50,
                     alpha: float = 0.9, m_l: float = 0.34, **kwargs):
    """Validated HNSW build (HNSW.hpp ctor knobs)."""
    from parlayann_tpu.build import hnsw

    data = _valid_data(data)
    _valid_pos("m", m), _valid_pos("efc", efc)
    return hnsw.build_hnsw_index(
        data, metric=valid_metric(metric), m=m, efc=efc, alpha=alpha,
        m_l=m_l, **kwargs,
    )


def build_cluster_index(data, metric="Euclidian", m: int = 64,
                        Rc: int = 16, **kwargs):
    """Validated ClusterIndex build (two-level structure, see
    build/clusterindex.py; no reference counterpart — it composes the
    two-level QQ filter of beamSearch.h:119-146 with a partition)."""
    from parlayann_tpu.build.clusterindex import ClusterIndex
    from parlayann_tpu.data.pointset import PointSet

    data = _valid_data(data)
    _valid_pos("m", m, lo=8), _valid_pos("Rc", Rc, lo=8)
    if m % 8 or Rc % 8:
        raise ValueError(f"m and Rc must be multiples of 8, got {m}, {Rc}")
    if not isinstance(data, PointSet):
        data = PointSet.from_numpy(data, metric=valid_metric(metric))
    return ClusterIndex.build(data, m=m, Rc=Rc, **kwargs)


def load_index(graph_path: str, data_path: str, metric="Euclidian",
               **kwargs):
    """Validated Index.load (graph_index.cpp ctor): both files must exist
    before any device work starts."""
    import os

    from parlayann_tpu.index import Index

    for p, name in ((graph_path, "graph_path"), (data_path, "data_path")):
        if not isinstance(p, (str, os.PathLike)) or not os.path.exists(p):
            raise ValueError(f"{name} does not exist: {p!r}")
    return Index.load(graph_path, data_path, metric=valid_metric(metric),
                      **kwargs)


class Index:  # re-exported lazily to avoid import cycles
    def __new__(cls, *args, **kwargs):
        from parlayann_tpu.index import Index as _Index

        return _Index(*args, **kwargs)
