"""Test config: the CPU backend with 8 virtual devices, so sharding tests
run without accelerators. A ``JAX_PLATFORMS`` already set in the
environment wins (``JAX_PLATFORMS=cuda python -m pytest -m gpu`` runs the
card-only tests on a GPU host)."""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

# XLA:CPU JIT-loads several code mappings per compiled program; the full
# suite compiles ~1000 programs in one process and hits vm.max_map_count
# (default 65530) at a DETERMINISTIC test (~#95 — measured 65347 live maps
# at the crash): the kernel then fails mmap and LLVM segfaults or aborts
# mid-compile (or mid-cache-read). Raise the limit, best-effort (root).
try:
    with open("/proc/sys/vm/max_map_count") as _f:
        _cur = int(_f.read())
    if _cur < 262144:
        with open("/proc/sys/vm/max_map_count", "w") as _f:
            _f.write("262144")
except (OSError, ValueError):
    pass

# Persistent compile cache: the full suite compiles hundreds of programs;
# caching makes reruns skip almost all compiles (and keeps the map count
# pressure lower on reruns).
from parlayann_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache(min_compile_secs=0.5)

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA GPU; skipped elsewhere (decided by the "
        "`gpu_device` fixture at run time)",
    )


@pytest.fixture()
def gpu_device():
    """The first GPU device; skips the test where JAX has none."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        pytest.skip(f"needs a GPU; JAX runs on {devs[0].platform}")
    return devs[0]


@pytest.fixture()
def rng():
    # function-scoped on purpose: a shared stream makes every test's data
    # depend on which tests ran before it (order-dependent flakiness —
    # test_jl_tier_search measured recall .69 vs .73 purely by suite order)
    return np.random.default_rng(42)
