"""Distance kernels.

One kernel family replaces the reference's per-point-type distance methods
(euclidian_point.h:45-90 squared L2; mips_point.h:43-65 negated inner
product). Two shapes matter:

  * ``all_pairs`` — (B,d) x (N,d) -> (B,N): a single matmul (used by
    exact ground truth and leaf-level all-pairs in the builders).
  * ``gathered`` — (B,K,d) candidate vectors per query -> (B,K): the beam
    search inner loop; a bandwidth-bound batched dot.

Both run at full float32 precision: their results are returned to callers
and compared with ground truth.

Both return *squared* L2 (the reference never takes sqrt) or negated dot for
MIPS, so "smaller is closer" uniformly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from parlayann_tpu.types import Metric

# Large-but-finite sentinel distance for masked slots. Finite so sorts are
# total-order stable and arithmetic on it cannot produce NaN.
INF = jnp.float32(3.0e38)


def _to_f32(x: jax.Array) -> jax.Array:
    return x.astype(jnp.float32) if x.dtype != jnp.float32 else x


def all_pairs(
    queries: jax.Array, points: jax.Array, metric: Metric
) -> jax.Array:
    """(B, d), (N, d) -> (B, N) distance matrix via one matmul.

    L2: ||q||^2 - 2 q.x + ||x||^2 (squared); MIPS: -q.x.
    """
    q = _to_f32(queries)
    x = _to_f32(points)
    dot = jax.lax.dot_general(
        q,
        x,
        (((1,), (1,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    )
    if metric is Metric.MIPS:
        return -dot
    qn = jnp.sum(q * q, axis=-1, keepdims=True)
    xn = jnp.sum(x * x, axis=-1)
    return jnp.maximum(qn - 2.0 * dot + xn[None, :], 0.0)


def gathered(
    queries: jax.Array,
    cand_vecs: jax.Array,
    metric: Metric,
    cand_norms: jax.Array | None = None,
) -> jax.Array:
    """(B, d), (B, K, d) -> (B, K) distances of per-query gathered candidates.

    ``cand_norms`` is accepted for API stability but unused. The MIPS dot
    runs at HIGHEST precision: a float32 einsum may otherwise run in TF32,
    and these scores feed ``rerank_topk``'s returned distances."""
    q = _to_f32(queries)
    c = _to_f32(cand_vecs)
    if metric is Metric.MIPS:
        return -jnp.einsum("bkd,bd->bk", c, q,
                           precision=jax.lax.Precision.HIGHEST)
    diff = c - q[:, None, :]
    return jnp.sum(diff * diff, axis=-1)


def point_to_points(
    p: jax.Array, others: jax.Array, metric: Metric
) -> jax.Array:
    """(d,), (K, d) -> (K,) distances from one point to K others."""
    return gathered(p[None, :], others[None, :, :], metric)[0]
