"""Small array helpers shared across the package."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def as_device(x) -> jax.Array:
    """Return ``x`` as a device array WITHOUT round-tripping it.

    ``jnp.asarray(np.asarray(x))`` on an already-device-resident array
    downloads then re-uploads it.
    """
    if isinstance(x, jax.Array):
        return x
    return jnp.asarray(np.asarray(x))


def pow2(x: int) -> int:
    """Smallest power of two >= x (shape-bucketing helper)."""
    p = 1
    while p < x:
        p *= 2
    return p


def segment_bounds(s: jax.Array):
    """For a SORTED 1-D key array: (left, right) segment bounds per
    element — left[i] = first position of i's equal-key run, right[i] =
    one past its last. Two O(n) cumulative scans.

    This replaces ``searchsorted(s, s)``, which XLA lowers to log2(n)
    SERIAL binary-search gather rounds.
    """
    M = s.shape[0]
    pos = jnp.arange(M, dtype=jnp.int32)
    fo = jnp.concatenate([jnp.ones(1, bool), s[1:] != s[:-1]])
    left = jax.lax.cummax(jnp.where(fo, pos, 0))
    lo = jnp.concatenate([s[:-1] != s[1:], jnp.ones(1, bool)])
    right = jnp.flip(
        jax.lax.cummin(jnp.flip(jnp.where(lo, pos + 1, M)))
    )
    return left, right
