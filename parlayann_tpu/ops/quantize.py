"""Scalar / bit / JL quantization.

Quantization tiers are explicit arrays + translate functions instead of the
reference's templated point types:

  * Euclidean scalar quantization (euclidian_point.h:183-235): global
    min/max -> ``slope = (2^bits - 1)/(max-min)``, ``q = round((x-min)*slope)``
    clamped. Distances in the quantized domain are a monotone (slope^2)
    rescale of true squared-L2, so ranking is preserved; rerank restores
    precision (beamSearch.h:394-454).
  * MIPS symmetric quantization (mips_point.h:322-489): per-dataset
    ``max_abs`` (optionally trimmed by quantile, ``trim``), symmetric int
    levels.
  * Bit tiers (1 bit/dim vs median, euclidian_point.h:332-420;
    sign-bit MIPS, mips_point.h:625-700) with XOR+popcount distances.
  * JL projections (jl_point.h): dense sign projection then quantize.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from parlayann_tpu.types import Metric
from parlayann_tpu.data.pointset import PointSet


def euclidean_params(data: jax.Array, bits: int = 8):
    """Global min/max scan (euclidian_point.h:212-235) -> (slope, offset)."""
    lo = jnp.min(data).astype(jnp.float32)
    hi = jnp.max(data).astype(jnp.float32)
    slope = (2.0**bits - 1.0) / jnp.maximum(hi - lo, 1e-30)
    return slope, lo


def euclidean_translate(x: jax.Array, slope, offset, bits: int = 8) -> jax.Array:
    """Scalar-quantize with clamping (euclidian_point.h:183-209).

    Storage deviation: the reference stores levels 0..255 as uint8; here the
    8-bit tier stores ``level - 128`` as int8 — L2 distances are differences
    so the constant shift cancels exactly, and one signed 8-bit dtype serves
    float and uint8 inputs alike.
    """
    maxval = 2.0**bits - 1.0
    q = jnp.round((x.astype(jnp.float32) - offset) * slope)
    q = jnp.clip(q, 0.0, maxval)
    if bits <= 8:
        return (q - 128.0).astype(jnp.int8)
    return q.astype(jnp.uint16)


def mips_params(data: jax.Array, bits: int = 8, trim: float = 0.0):
    """Symmetric scale from (optionally trimmed) max-abs
    (mips_point.h:433-489) -> (slope, offset=0)."""
    absd = jnp.abs(data.astype(jnp.float32))
    if trim > 0.0:
        max_abs = jnp.quantile(absd.reshape(-1), 1.0 - trim)
    else:
        max_abs = jnp.max(absd)
    levels = 2.0 ** (bits - 1) - 1.0
    slope = levels / jnp.maximum(max_abs, 1e-30)
    return slope, jnp.float32(0.0)


def mips_translate(x: jax.Array, slope, offset, bits: int = 8) -> jax.Array:
    levels = 2.0 ** (bits - 1) - 1.0
    q = jnp.clip(jnp.round(x.astype(jnp.float32) * slope), -levels, levels)
    return q.astype(jnp.int8 if bits <= 8 else jnp.int16)


from functools import partial as _partial


@_partial(jax.jit, static_argnames=("bits", "n", "l2"))
def _quantize_fused(data: jax.Array, *, bits: int, n: int, l2: bool):
    """params + translate as ONE fused program. The eager path cost a
    full-array slice copy (``data[:n]``) plus one materialized (n_pad, d)
    f32 intermediate per arithmetic op — at 10M x 128 that transient
    footprint OOM'd a 16 GiB chip whose steady state fits easily. Fused,
    the peak is input + int8 output; pad rows are masked out of the
    range scan instead of sliced away."""
    row = jax.lax.broadcasted_iota(jnp.int32, (data.shape[0], 1), 0)
    valid = row < n
    xf = data.astype(jnp.float32)
    if l2:
        lo = jnp.min(jnp.where(valid, xf, jnp.inf)).astype(jnp.float32)
        hi = jnp.max(jnp.where(valid, xf, -jnp.inf)).astype(jnp.float32)
        slope = (2.0 ** bits - 1.0) / jnp.maximum(hi - lo, 1e-30)
        offset = lo
        q = jnp.clip(jnp.round((xf - offset) * slope), 0.0, 2.0 ** bits - 1.0)
        qd = (q - 128.0).astype(jnp.int8) if bits <= 8 else q.astype(jnp.uint16)
    else:
        max_abs = jnp.max(jnp.where(valid, jnp.abs(xf), 0.0))
        levels = 2.0 ** (bits - 1) - 1.0
        slope = levels / jnp.maximum(max_abs, 1e-30)
        offset = jnp.float32(0.0)
        q = jnp.clip(jnp.round(xf * slope), -levels, levels)
        qd = q.astype(jnp.int8 if bits <= 8 else jnp.int16)
    return qd, slope, offset


def quantize_pointset(ps: PointSet, bits: int = 8, trim: float = 0.0) -> PointSet:
    """Build a quantized tier of a PointSet (the re-quantizing PointRange
    constructor, point_range.h:55-66). Returns a new PointSet whose
    ``translate_query`` counterpart is :func:`translate_query`."""
    # params over valid rows only — zero pad rows would widen the range
    # (pull lo to 0 / bias the trim quantile) and waste resolution
    if ps.metric is not Metric.L2 and trim > 0.0:
        # quantile trim keeps the eager path (rare, and jnp.quantile over
        # the flattened array is its own memory story)
        slope, offset = mips_params(ps.data[: ps.n], bits, trim)
        qdata = mips_translate(ps.data, slope, offset, bits)
    else:
        qdata, slope, offset = _quantize_fused(
            ps.data, bits=bits, n=ps.n, l2=(ps.metric is Metric.L2)
        )
    return PointSet(
        data=qdata,
        n=ps.n,
        d=ps.d,
        metric=ps.metric,
        bits=bits,
        quant_slope=jnp.asarray(slope, jnp.float32),
        quant_offset=jnp.asarray(offset, jnp.float32),
    )


def translate_query(q: jax.Array, ps: PointSet) -> jax.Array:
    """Quantize queries on the fly into ``ps``'s domain
    (graph_index.cpp:144-177)."""
    if ps.bits >= 32 or ps.quant_slope is None:
        return q
    if ps.metric is Metric.L2:
        return euclidean_translate(q, ps.quant_slope, ps.quant_offset, ps.bits)
    return mips_translate(q, ps.quant_slope, ps.quant_offset, ps.bits)


# ---------------------------------------------------------------------------
# Bit tiers: 1 bit/dim packed into uint32 lanes, hamming (XOR+popcount)
# distances. Euclidean: bit = coord > per-dim median (euclidian_point.h:
# 332-420 uses the global median; per-dim is strictly more informative and
# costs the same here). MIPS: sign bit (mips_point.h:625-700).
# These tiers matter as *smaller search tiers* (32x fewer bytes per row
# than f32); the reference's two-level filtered search (beamSearch.h:119-146)
# is subsumed by searching the cheap tier and reranking
# (beamSearch.h:394-454) — masked filtering saves nothing in batch mode.
# ---------------------------------------------------------------------------


def _pack_bits(bits: jax.Array) -> jax.Array:
    """(n, d) {0,1} -> (n, ceil(d/32)) uint32, little-endian within words."""
    n, d = bits.shape
    words = (d + 31) // 32
    pad = words * 32 - d
    if pad:
        bits = jnp.pad(bits, ((0, 0), (0, pad)))
    b = bits.reshape(n, words, 32).astype(jnp.uint32)
    shifts = jnp.arange(32, dtype=jnp.uint32)[None, None, :]
    return jnp.sum(b << shifts, axis=2, dtype=jnp.uint32)


def bit_quantize(ps: PointSet) -> PointSet:
    """1-bit tier of a PointSet; thresholds stored in quant_offset."""
    data = ps.data.astype(jnp.float32)
    if ps.metric is Metric.L2:
        thr = jnp.median(data[: ps.n], axis=0)  # (d,)
    else:
        thr = jnp.zeros((ps.d,), jnp.float32)  # sign bit
    packed = _pack_bits((data > thr[None, :]).astype(jnp.uint32))
    return PointSet(
        data=packed, n=ps.n, d=ps.d, metric=ps.metric, bits=1,
        quant_slope=None, quant_offset=thr,
    )


def bit_translate_query(q: jax.Array, bps: PointSet) -> jax.Array:
    thr = bps.quant_offset
    return _pack_bits((q.astype(jnp.float32) > thr[None, :]).astype(jnp.uint32))


def hamming_distance(q_bits: jax.Array, c_bits: jax.Array) -> jax.Array:
    """(B, W) vs (B, K, W) packed words -> (B, K) popcount distances."""
    x = jnp.bitwise_xor(q_bits[:, None, :], c_bits)
    return jnp.sum(jax.lax.population_count(x), axis=-1).astype(jnp.float32)


def hamming_all_pairs(q_bits: jax.Array, p_bits: jax.Array) -> jax.Array:
    """(B, W) vs (N, W) -> (B, N)."""
    x = jnp.bitwise_xor(q_bits[:, None, :], p_bits[None, :, :])
    return jnp.sum(jax.lax.population_count(x), axis=-1).astype(jnp.float32)


# ---------------------------------------------------------------------------
# 2-bit MIPS tier: 3-valued {-1, 0, +1} quantization as two packed bitplanes
# (Mips_2Bit_Point, mips_point.h:495-621). Plane 0 = sign (+1 -> 1), plane 1
# = nonzero (|x| > cut). Negated-dot distance over the ternary values:
#   dist = 2 * popcount(sign_p XOR sign_q AND nz) - popcount(nz_p AND nz_q)
# The cut is the 30%/70% quantile bound (mips_point.h:601-618).
# Word layout: data = (n, 2*W) uint32 = [sign words | nonzero words].
# ---------------------------------------------------------------------------


def mips_2bit_params(data: jax.Array) -> jax.Array:
    """Ternary cut = max(|q30|, q70) over all coords (mips_point.h:601-618)."""
    flat = data.astype(jnp.float32).reshape(-1)
    lo = jnp.quantile(flat, 0.3)
    hi = jnp.quantile(flat, 0.7)
    return jnp.maximum(hi, -lo)


def _pack_ternary(x: jax.Array, cut) -> jax.Array:
    """(n, d) floats -> (n, 2*W) uint32 [sign planes | nonzero planes]."""
    sign = _pack_bits((x > cut).astype(jnp.uint32))
    nz = _pack_bits((jnp.abs(x) > cut).astype(jnp.uint32))
    return jnp.concatenate([sign, nz], axis=1)


def mips_2bit_quantize(ps: PointSet) -> PointSet:
    """2-bit ternary MIPS tier; the cut lives in quant_offset."""
    cut = mips_2bit_params(ps.data[: ps.n])
    packed = _pack_ternary(ps.data.astype(jnp.float32), cut)
    return PointSet(
        data=packed, n=ps.n, d=ps.d, metric=Metric.MIPS, bits=2,
        quant_slope=None, quant_offset=jnp.asarray(cut, jnp.float32),
    )


def mips_2bit_translate_query(q: jax.Array, tps: PointSet) -> jax.Array:
    return _pack_ternary(q.astype(jnp.float32), tps.quant_offset)


def mips_2bit_distance(q_words: jax.Array, c_words: jax.Array) -> jax.Array:
    """(B, 2W) vs (B, K, 2W) -> (B, K) ternary neg-dot
    (mips_point.h:529-547)."""
    W = q_words.shape[-1] // 2
    qs, qn = q_words[:, None, :W], q_words[:, None, W:]
    cs, cn = c_words[..., :W], c_words[..., W:]
    nz = jnp.bitwise_and(qn, cn)
    neg = jnp.bitwise_and(jnp.bitwise_xor(qs, cs), nz)
    # int32 before the subtraction: popcount keeps the uint32 input dtype
    # and 2*n_neg - n_nz would wrap below zero
    n_neg = jnp.sum(jax.lax.population_count(neg).astype(jnp.int32), axis=-1)
    n_nz = jnp.sum(jax.lax.population_count(nz).astype(jnp.int32), axis=-1)
    return (2 * n_neg - n_nz).astype(jnp.float32)


# ---------------------------------------------------------------------------
# 4-bit MIPS tier: symmetric scalar quantization to [-7, 7], two nibbles
# packed per int8 byte (Mips_4Bit_Point, mips_point.h:706-849; distance_4
# at :344-354). Unpacking is (x<<4)>>4 (low) and x>>4 (high) with
# arithmetic shifts; distances run as an f32 einsum on the unpacked values
# (an int8 einsum without a cast can accumulate in 8 bits — see
# tests/test_quantized.py).
# Layout: nibble j of byte i holds coords [i] (low) and [i + d/2] (high),
# matching the reference's two-loop distance.
# ---------------------------------------------------------------------------


def mips_4bit_quantize(ps: PointSet, trim: float = 0.0) -> PointSet:
    """4-bit packed MIPS tier; scale in quant_slope."""
    slope, _ = mips_params(ps.data[: ps.n], bits=4, trim=trim)
    x = ps.data.astype(jnp.float32)
    q = jnp.clip(jnp.round(x * slope), -7, 7).astype(jnp.int32)
    n_pad, d = q.shape
    if d % 2:
        q = jnp.pad(q, ((0, 0), (0, 1)))
    half = q.shape[1] // 2
    lo = q[:, :half] & 0xF
    hi = q[:, half:] & 0xF
    packed = (lo | (hi << 4)).astype(jnp.int8)
    return PointSet(
        data=packed, n=ps.n, d=ps.d, metric=Metric.MIPS, bits=4,
        quant_slope=jnp.asarray(slope, jnp.float32),
        quant_offset=jnp.float32(0.0),
    )


def unpack_int4(packed: jax.Array) -> jax.Array:
    """(..., d/2) int8 -> (..., d) int8 in [-8, 7] ([low half | high half])."""
    x = packed.astype(jnp.int8)
    lo = jnp.left_shift(x, 4)
    lo = jnp.right_shift(lo, 4)  # arithmetic: sign-extends the low nibble
    hi = jnp.right_shift(x, 4)
    return jnp.concatenate([lo, hi], axis=-1)


def mips_4bit_translate_query(q: jax.Array, tps: PointSet) -> jax.Array:
    """Queries stay UNPACKED f32 int4-levels: the distance is an einsum
    against unpacked candidates (same rule as the 8-bit tier)."""
    lev = jnp.clip(jnp.round(q.astype(jnp.float32) * tps.quant_slope), -7, 7)
    if lev.shape[-1] % 2:
        lev = jnp.pad(lev, ((0, 0), (0, 1)))
    return lev


def mips_4bit_distance(q_levels: jax.Array, c_packed: jax.Array) -> jax.Array:
    """(B, d') f32 levels vs (B, K, d'/2) packed int8 -> (B, K) neg-dot."""
    c = unpack_int4(c_packed).astype(jnp.float32)
    return -jnp.einsum(
        "bd,bkd->bk", q_levels, c, preferred_element_type=jnp.float32
    )


# ---------------------------------------------------------------------------
# Johnson-Lindenstrauss projections (jl_point.h): random sign projection to
# jl_dims, then 8-bit or 1-bit quantization.
#   * dense ±1 rows (Mips_JL_Point, jl_point.h:22-104)
#   * sparse rows with 6 nonzeros (Mips_JL_Sparse_Point jl_point.h:193-285,
#     Euclidean_JL_Sparse_Point euclidian_point.h:244-330) — here the sparse
#     PATTERN is reproduced but materialized as a dense (d, jl_dims) matrix:
#     one dense matmul beats any sparse gather, and zeros are
#     free. The reference's sparsity only saved CPU translate time.
# bits=1 gives the sign-bit XOR-distance variants (jl_point.h:108-191).
# ---------------------------------------------------------------------------


def jl_projection_matrix(d: int, jl_dims: int, seed: int = 0,
                         sparse_nnz: int = 0) -> jax.Array:
    """(d, jl_dims) random sign projection; ``sparse_nnz`` > 0 keeps only
    that many nonzero input coords per output dim (jl_point.h:193-285)."""
    key = jax.random.key(seed)
    k_sign, k_pat = jax.random.split(key)
    signs = jax.random.rademacher(k_sign, (d, jl_dims), dtype=jnp.float32)
    if sparse_nnz and sparse_nnz < d:
        # per output dim, keep sparse_nnz random input coords
        scores = jax.random.uniform(k_pat, (d, jl_dims))
        thr = -jnp.sort(-scores, axis=0)[sparse_nnz - 1]  # kth largest per col
        signs = jnp.where(scores >= thr[None, :], signs, 0.0)
        return signs / jnp.sqrt(sparse_nnz)
    return signs / jnp.sqrt(jl_dims)


class JLTier:
    """A JL search tier: projection matrix + quantized projected points.

    ``bits``: 1 -> sign bits + hamming; 8 -> scalar-quantized projections
    with the source metric (L2 distances are JL-preserved; MIPS dots too).
    """

    def __init__(self, ps: PointSet, jl_dims: int = 64, bits: int = 8,
                 seed: int = 0, sparse_nnz: int = 0):
        self.proj = jl_projection_matrix(ps.d, jl_dims, seed, sparse_nnz)
        self.bits = bits
        self.jl_dims = jl_dims
        proj = ps.data.astype(jnp.float32) @ self.proj  # (n_pad, jl_dims)
        projected = PointSet(
            data=proj, n=ps.n, d=jl_dims, metric=ps.metric, bits=32
        )
        self.points = (
            bit_quantize(projected) if bits == 1
            else quantize_pointset(projected, bits=bits)
        )

    def translate_query(self, q: jax.Array) -> jax.Array:
        proj = q.astype(jnp.float32) @ self.proj
        if self.bits == 1:
            return bit_translate_query(proj, self.points)
        return translate_query(proj, self.points).astype(jnp.float32)


def jl_project(ps: PointSet, jl_dims: int = 64, bits: int = 8,
               seed: int = 0) -> PointSet:
    """Back-compat helper: the quantized projected PointSet of a JLTier."""
    return JLTier(ps, jl_dims=jl_dims, bits=bits, seed=seed).points
