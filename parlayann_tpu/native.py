"""ctypes loader for the native C++ runtime library.

The compute path is JAX/XLA; inherently sequential host-side stages
(per-leaf union-find Kruskal for HCNNG) live in C++ (native/kruskal.cpp),
parallel across leaves with OpenMP — mirroring the reference's
sequential-within-leaf / parallel-across-leaves structure
(hcnng_index.h:134-229). Compiled on first use with g++ (see
``lib_path``); a pure-numpy fallback keeps everything working without a
toolchain.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRCS = [os.path.join(_ROOT, "native", f)
         for f in ("kruskal.cpp", "balance.cpp")]
_FLAGS = ["-O3", "-shared", "-fPIC", "-fopenmp"]
_lock = threading.Lock()
_lib = None
_build_failed = False


def lib_path() -> str:
    """Where the build lives: the file name carries a hash of the sources,
    the compiler flags (generic code, no ``-march=native``) and the
    machine type, so a stale or foreign-architecture build is never
    loaded."""
    h = hashlib.sha256()
    for src in _SRCS:
        with open(src, "rb") as f:
            h.update(f.read())
    h.update(" ".join(_FLAGS).encode())
    h.update(platform.machine().encode())
    return os.path.join(_ROOT, "native",
                        f"libparlayann_native-{h.hexdigest()[:16]}.so")


def _load():
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            path = lib_path()
            if not os.path.exists(path):
                tmp = f"{path}.{os.getpid()}.tmp"
                subprocess.run(["g++", *_FLAGS, *_SRCS, "-o", tmp],
                               check=True, capture_output=True)
                os.replace(tmp, path)
            lib = ctypes.CDLL(path)
            lib.kruskal_leaves.argtypes = [
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int32, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
            ]
            lib.kruskal_leaves.restype = None
            lib.balance_assign.argtypes = [
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
            ]
            lib.balance_assign.restype = ctypes.c_int32
            _lib = lib
        except (OSError, subprocess.CalledProcessError):
            _build_failed = True
        return _lib


def loaded() -> bool:
    """True when the native library built (or was found) and loaded."""
    return _load() is not None


def _as_i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def kruskal_leaves(
    edges_u: np.ndarray,  # (n_leaves, E) leaf-local ids, weight-ascending
    edges_v: np.ndarray,
    leaf_sizes: np.ndarray,  # (n_leaves,)
    max_leaf_size: int,
    mst_deg: int,
):
    """Degree-bounded Kruskal per leaf -> (sel_u, sel_v, counts)."""
    n_leaves, E = edges_u.shape
    edges_u = np.ascontiguousarray(edges_u, dtype=np.int32)
    edges_v = np.ascontiguousarray(edges_v, dtype=np.int32)
    leaf_sizes = np.ascontiguousarray(leaf_sizes, dtype=np.int32)
    out_u = np.full((n_leaves, E), -1, dtype=np.int32)
    out_v = np.full((n_leaves, E), -1, dtype=np.int32)
    counts = np.zeros(n_leaves, dtype=np.int32)

    lib = _load()
    if lib is not None:
        lib.kruskal_leaves(
            _as_i32p(edges_u), _as_i32p(edges_v), _as_i32p(leaf_sizes),
            ctypes.c_int64(n_leaves), ctypes.c_int64(E),
            ctypes.c_int32(max_leaf_size), ctypes.c_int32(mst_deg),
            _as_i32p(out_u), _as_i32p(out_v), _as_i32p(counts),
        )
        return out_u, out_v, counts

    # numpy/python fallback (same semantics, slower)
    for leaf in range(n_leaves):
        s = int(leaf_sizes[leaf])
        parent = list(range(s))
        deg = [0] * s

        def find(x):
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        taken = 0
        comps = s
        for e in range(E):
            u, v = int(edges_u[leaf, e]), int(edges_v[leaf, e])
            if u < 0 or v < 0 or u >= s or v >= s or u == v:
                continue
            if deg[u] >= mst_deg or deg[v] >= mst_deg:
                continue
            ru, rv = find(u), find(v)
            if ru == rv:
                continue
            parent[ru] = rv
            deg[u] += 1
            deg[v] += 1
            out_u[leaf, taken] = u
            out_v[leaf, taken] = v
            counts[leaf] = taken = taken + 1
            comps -= 1
            if comps == 1:
                break
    return out_u, out_v, counts


def balance_assign(nbr_ids: np.ndarray, order: np.ndarray, C: int,
                   m: int):
    """Native capacity-balanced assignment (native/balance.cpp) ->
    members (C, m) int32, or None when the library is unavailable (the
    caller falls back to the vectorized numpy implementation — same
    semantics, the test oracle)."""
    lib = _load()
    if lib is None:
        return None
    n, k = nbr_ids.shape
    nbr_ids = np.ascontiguousarray(nbr_ids, dtype=np.int32)
    order = np.ascontiguousarray(order, dtype=np.int64)
    members = np.full((C, m), -1, dtype=np.int32)
    rc = lib.balance_assign(
        _as_i32p(nbr_ids),
        order.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(n), ctypes.c_int32(k), ctypes.c_int32(C),
        ctypes.c_int32(m), _as_i32p(members),
    )
    if rc != 0:
        raise AssertionError("capacity < n (slack too low)")
    return members
