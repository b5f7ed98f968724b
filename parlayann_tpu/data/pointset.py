"""PointSet — the device-resident vector store.

Device-array replacement for the reference's ``PointRange<Point>`` + point-type
template zoo (point_range.h:43, euclidian_point.h:93, mips_point.h:68):
vectors live as one padded ``(n_pad, d)`` device array per precision tier;
the metric and quantization parameters are plain metadata, and distance
computation lives in ``parlayann_tpu.ops.distance`` instead of per-point
methods. Row padding (to a multiple of 8 rows) replaces the reference's
64-byte row alignment (point_range.h:94-99).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from parlayann_tpu.types import Metric
from parlayann_tpu.data import io


def pad_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["data", "quant_slope", "quant_offset"],
    meta_fields=["n", "d", "metric", "bits"],
)
@dataclasses.dataclass
class PointSet:
    """A set of n d-dimensional vectors on device.

    ``data`` is ``(n_pad, d)`` in the storage dtype (float32 / uint8 / int8 /
    packed-bit uint32 planes). ``bits`` tracks the quantization tier: 32
    (full precision), 8/16 (scalar-quantized, euclidian_point.h:183-235),
    1/2 (bit planes, mips_point.h:495-700). ``quant_slope``/``quant_offset``
    are the scalar-quantization parameters (``parameters{slope, offset}``).
    """

    data: jax.Array
    n: int
    d: int
    metric: Metric
    bits: int = 32
    quant_slope: Optional[jax.Array] = None
    quant_offset: Optional[jax.Array] = None

    @property
    def n_pad(self) -> int:
        return self.data.shape[0]

    @staticmethod
    def from_numpy(
        arr: np.ndarray,
        metric: Metric = Metric.L2,
        normalize: bool = False,
        row_pad: int = 8,
    ) -> "PointSet":
        arr = np.asarray(arr)
        metric = Metric.coerce(metric)
        n, d = arr.shape
        if normalize:
            # mips auto-normalization (builder.cpp:45-54, euclidian_point.h:119)
            arr = arr.astype(np.float32)
            norms = np.linalg.norm(arr, axis=1, keepdims=True)
            arr = arr / np.maximum(norms, 1e-30)
        n_p = pad_to(max(n, 1), row_pad)
        if n_p != n:
            arr = np.concatenate([arr, np.zeros((n_p - n, d), dtype=arr.dtype)])
        return PointSet(data=jnp.asarray(arr), n=n, d=d, metric=metric)

    @staticmethod
    def from_file(
        path: str,
        dtype=None,
        metric: Metric = Metric.L2,
        normalize: bool = False,
    ) -> "PointSet":
        if path.endswith((".fvecs", ".bvecs", ".ivecs")):
            arr = io.read_vecs(path)
        elif path.endswith((".h5", ".hdf5")):
            arr = io.read_hdf5(path)
        else:
            dt = dtype if dtype is not None else io.infer_bin_dtype(path)
            arr = io.read_bin(path, dtype=dt)
        return PointSet.from_numpy(arr, metric=metric, normalize=normalize)

    def to_numpy(self) -> np.ndarray:
        return np.asarray(self.data[: self.n])

    @property
    def valid_mask(self) -> jax.Array:
        return jnp.arange(self.n_pad) < self.n
