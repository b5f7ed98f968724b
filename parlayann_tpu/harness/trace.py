"""Profiler trace -> device time per named scope.

Every former hand-written kernel's XLA replacement runs under a stable
``jax.named_scope`` (graph_beam_search, beam_candidate_distances,
beam_merge, cluster_seed, cluster_beam, occlusion_loop, flat_scan). XLA
keeps the scope path in each HLO instruction's ``op_name`` metadata, but
a GPU trace names most kernels only by their instruction (``hlo_op``,
e.g. ``loop_fusion.12``) and module (``program_id``). So the reduction
joins the trace with XLA's dump of the optimized modules
(``--xla_dump_to DIR --xla_dump_hlo_as_text``, see ``dump_flags``): a
kernel belongs to a scope when its instruction, or an instruction fused
into it, carries that scope in its op_name. The device time of a scope is
the summed duration of its kernels; nested scopes are reported nested
(a parent's time includes its children's).
"""

from __future__ import annotations

import glob
import os
import re

_MODULE_FILE = re.compile(
    r"module_(\d+)\.([^.]+)\..*after_optimizations\.txt$")
_COMP_HEADER = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s.*\{\s*$")
_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s")
_OP_NAME = re.compile(r'op_name="([^"]*)"')
_CALLS = re.compile(r"calls=%?([\w.\-]+)")


def dump_flags(hlo_dir: str, module_re: str) -> str:
    """XLA_FLAGS that dump the optimized HLO of the modules whose name
    matches ``module_re`` into ``hlo_dir`` (set before JAX starts its
    backend; only modules compiled in this process are dumped)."""
    return (f"--xla_dump_to={hlo_dir} --xla_dump_hlo_as_text "
            f"--xla_dump_hlo_module_re={module_re}")


def parse_hlo_text(text: str) -> dict:
    """Optimized HLO module text -> {instruction name: op_name text}. A
    fusion's text joins its own op_name with those of every instruction
    in the computations it calls, so a kernel that fused ops of several
    scopes counts toward each of them."""
    comps: dict[str, list] = {}
    cur = None
    for line in text.splitlines():
        if cur is None or line.rstrip().endswith("{") and " = " not in line:
            m = _COMP_HEADER.match(line)
            if m:
                cur = comps.setdefault(m.group(1), [])
                continue
        m = _INSTR.match(line)
        if m and cur is not None:
            cur.append((m.group(1), " ".join(_OP_NAME.findall(line)),
                        _CALLS.findall(line)))

    def names(comp, seen):
        out = []
        for _, op, calls in comps.get(comp, ()):
            out.append(op)
            for c in calls:
                if c not in seen:
                    seen.add(c)
                    out += names(c, seen)
        return out

    table = {}
    for instrs in comps.values():
        for name, op, calls in instrs:
            parts = [op]
            for c in calls:
                parts += names(c, {c})
            table[name] = " ".join(p for p in parts if p)
    return table


def load_hlo_dump(hlo_dir: str) -> dict:
    """-> {(program_id, instruction name): op_name text} over every
    optimized module in an XLA dump directory, plus the same text under
    (module name, instruction name) for events whose program_id matches
    no dump file (the texts of all compilations of that module joined)."""
    table = {}
    for path in glob.glob(os.path.join(hlo_dir, "*after_optimizations.txt")):
        m = _MODULE_FILE.search(os.path.basename(path))
        if not m:
            continue
        with open(path) as f:
            for name, op in parse_hlo_text(f.read()).items():
                table[(int(m.group(1)), name)] = op
                key = (m.group(2), name)
                table[key] = f"{table[key]} {op}" if key in table else op
    return table


def _device_events(xplane_path: str, hlo=None):
    """-> list of (start_ns, dur_ns, text, module) for the device op
    events of a trace; ``text`` joins the event name, its string metadata
    and, where ``hlo`` (``load_hlo_dump``) knows the event's instruction,
    the op_names XLA kept for it; ``module`` is the event's hlo_module
    ("" for copies and memsets)."""
    from jax.profiler import ProfileData

    out = []
    pd = ProfileData.from_file(xplane_path)
    for plane in pd.planes:
        if not plane.name.startswith("/device:"):
            continue
        lines = list(plane.lines)
        # one line per op: the "XLA Ops" line where the backend writes
        # one, else the raw stream lines (never both: they hold the same
        # kernels twice)
        ops = [ln for ln in lines if ln.name == "XLA Ops"]
        if not ops:
            ops = [ln for ln in lines if ln.name.startswith("Stream")]
        for line in ops:
            for ev in line.events:
                stats = dict(ev.stats)
                text = [ev.name]
                text += [str(v) for v in stats.values() if isinstance(v, str)]
                module = str(stats.get("hlo_module", ""))
                if hlo and "hlo_op" in stats:
                    op = str(stats["hlo_op"])
                    pid = int(stats.get("program_id", -1))
                    text.append(hlo.get((pid, op), hlo.get((module, op), "")))
                out.append((ev.start_ns, ev.duration_ns, " ".join(text),
                            module))
    return out


def attribute(events, scopes) -> dict:
    """Sum event durations (seconds) per scope, plus ``"_busy"``: the
    union of all event intervals, ``"_window"``: first start to last
    end, and ``"_modules"``: seconds per hlo_module. ``events``:
    (start_ns, dur_ns, text, module)."""
    tot = {s: 0.0 for s in scopes}
    mods: dict[str, float] = {}
    for _, dur, text, module in events:
        for s in scopes:
            if f"/{s}/" in text or text.startswith(f"{s}/"):
                tot[s] += dur * 1e-9
        if module:
            mods[module] = mods.get(module, 0.0) + dur * 1e-9
    busy, end = 0.0, None
    for start, dur, *_ in sorted(events):
        stop = start + dur
        if end is None or start >= end:
            busy += dur
            end = stop
        elif stop > end:
            busy += stop - end
            end = stop
    tot["_busy"] = busy * 1e-9
    if events:
        first = min(e[0] for e in events)
        last = max(e[0] + e[1] for e in events)
        tot["_window"] = (last - first) * 1e-9
    tot["_modules"] = dict(sorted(mods.items(), key=lambda kv: -kv[1]))
    return tot


def find_xplane(trace_dir: str) -> str:
    paths = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                             recursive=True))
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    return paths[-1]


def scope_times(trace_dir: str, scopes, hlo_dir: str | None = None) -> dict:
    """Device seconds per scope in the newest trace under ``trace_dir``;
    ``hlo_dir``: the XLA dump of the traced modules (``dump_flags``)."""
    hlo = load_hlo_dump(hlo_dir) if hlo_dir else None
    return attribute(_device_events(find_xplane(trace_dir), hlo), scopes)


def describe(trace_dir: str, per_line: int = 5) -> str:
    """Plane/line names and a few events with their metadata, for reading
    a trace by hand before trusting the reduction."""
    from jax.profiler import ProfileData

    rows = []
    pd = ProfileData.from_file(find_xplane(trace_dir))
    for plane in pd.planes:
        lines = list(plane.lines)
        rows.append(f"PLANE {plane.name} ({len(lines)} lines)")
        if not plane.name.startswith("/device:"):
            continue
        for line in lines:
            evs = list(line.events)
            rows.append(f"  LINE {line.name} ({len(evs)} events)")
            for ev in evs[:per_line]:
                st = {k: str(v)[:160] for k, v in ev.stats}
                rows.append(f"    {ev.name[:120]} {ev.duration_ns}ns {st}")
    return "\n".join(rows)
