"""Bring-up guards: the compile-cache helper, chip_smoke's device check,
the trace-to-scope reduction, and a scan that no kernel route tied to
one accelerator is left."""

import importlib.util
import os
import pathlib
import re
import types

import jax
import pytest

from parlayann_tpu.utils import compile_cache

ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_compile_cache_env_set(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, JAX's own reading of it wins
    and the helper sets nothing."""
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_env_unset(monkeypatch):
    """Without the variable the cache goes to the fixed <checkout>/.jax_cache
    (never a temp, pid or time-derived name)."""
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        got = compile_cache.enable_compile_cache()
        assert got == str(ROOT / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
        assert compile_cache.enable_compile_cache() == got  # stable
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_chip_smoke_refuses_cpu():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    with pytest.raises(smoke.SmokeFailure):
        smoke.require_gpu(jax.devices("cpu"))
    with pytest.raises(smoke.SmokeFailure):
        smoke.require_gpu([])
    smoke.require_gpu([types.SimpleNamespace(platform="gpu")])


# the character classes keep this file from matching itself
_FORBIDDEN = [
    re.compile(r"jax\.experimental[.]pallas"),
    re.compile(r"jax\.experimental import pallas"),
    re.compile(r"pallas\.t[p]u"),
    re.compile(r"\binterpret[ ]*="),
    re.compile(r"default_backend\(\)\s*[!=]=\s*[\"']t[p]u[\"']"),
]


def test_no_accelerator_specific_kernel_routes_left():
    files = [p for p in ROOT.joinpath("parlayann_tpu").rglob("*.py")]
    files += list(ROOT.joinpath("scripts").glob("*"))
    files += list(ROOT.joinpath("tests").glob("*.py"))
    files += [ROOT / "bench.py", ROOT / "chip_smoke.py"]
    hits = []
    for p in files:
        if p.suffix not in (".py", ".sh", "") or not p.is_file():
            continue
        for i, line in enumerate(p.read_text().splitlines(), 1):
            if any(rx.search(line) for rx in _FORBIDDEN):
                hits.append(f"{p.relative_to(ROOT)}:{i}: {line.strip()}")
    assert not hits, "\n".join(hits)


_HLO = """HloModule jit_f, entry_computation_layout={(f32[8]{0})->f32[8]{0}}

%fused_computation (param_0: f32[8]) -> f32[8] {
  %param_0 = f32[8]{0} parameter(0)
  %c = f32[] constant(2), metadata={op_name="jit(f)/outer/inner/mul"}
  %b = f32[8]{0} broadcast(%c), dimensions={}
  ROOT %m = f32[8]{0} multiply(%param_0, %b), metadata={op_name="jit(f)/outer/inner/mul" stack_frame_id=3}
}

ENTRY %main.4 (x.1: f32[8]) -> f32[8] {
  %x.1 = f32[8]{0} parameter(0), metadata={op_name="x"}
  %loop_fusion.2 = f32[8]{0} fusion(%x.1), kind=kLoop, calls=%fused_computation, metadata={op_name="jit(f)/outer/add"}
  ROOT %sort.1 = f32[8]{0} sort(%loop_fusion.2), dimensions={0}, metadata={op_name="jit(f)/other/sort"}
}
"""


def test_trace_hlo_join_attributes_fused_scopes():
    """A kernel is charged to every scope its instruction or the ops fused
    into it carry; a kernel outside the scopes is charged to none."""
    from parlayann_tpu.harness import trace

    table = trace.parse_hlo_text(_HLO)
    assert "jit(f)/outer/add" in table["loop_fusion.2"]
    assert "jit(f)/outer/inner/mul" in table["loop_fusion.2"]
    assert "outer" not in table["sort.1"]
    events = [(0, 1000, "loop_fusion_2 " + table["loop_fusion.2"], "jit_f"),
              (500, 1000, "sort " + table["sort.1"], "jit_f"),
              (4000, 500, "memcpy", "")]
    t = trace.attribute(events, ("outer", "inner", "other", "absent"))
    assert t["outer"] == pytest.approx(1e-6)
    assert t["inner"] == pytest.approx(1e-6)
    assert t["other"] == pytest.approx(1e-6)
    assert t["absent"] == 0.0
    # busy is the union of intervals: [0, 1500) + [4000, 4500)
    assert t["_busy"] == pytest.approx(2e-6)
    assert t["_window"] == pytest.approx(4.5e-6)
    assert t["_modules"] == {"jit_f": pytest.approx(2e-6)}


def test_trace_hlo_dump_keyed_by_program_id(tmp_path):
    """Dump files are keyed by their module number (a trace event's
    program_id) and by their module name (its hlo_module)."""
    from parlayann_tpu.harness import trace

    (tmp_path / "module_0042.jit_f.sm_9.0_gpu_after_optimizations.txt"
     ).write_text(_HLO)
    (tmp_path / "module_0042.jit_f.before_optimizations.txt").write_text(
        "HloModule jit_f\n")
    table = trace.load_hlo_dump(str(tmp_path))
    assert set(k[0] for k in table) == {42, "jit_f"}
    assert "inner" in table[(42, "loop_fusion.2")]
    # events whose program_id is unknown fall back to the module name
    assert table[("jit_f", "loop_fusion.2")] == table[(42, "loop_fusion.2")]
    flags = trace.dump_flags(str(tmp_path), "jit_f")
    assert f"--xla_dump_to={tmp_path}" in flags
    assert "--xla_dump_hlo_module_re=jit_f" in flags
