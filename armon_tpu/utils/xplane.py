"""Profiler-trace reduction — per-kernel DEVICE times from an XPlane dump.

The reference wraps every kernel call in profiling callbacks so its section
stats are in-loop truth (`src/profiling.jl:6-68`). The XLA analog:
`profiling=['trace']` dumps a `jax.profiler` trace of the run; this module
reads it with `jax.profiler.ProfileData` (shipped with JAX) and aggregates
per-kernel device-execution times, which `SolverLog.analyse()` then
surfaces as the in-loop section truth.

Which events are read:

- GPU: ONE device plane (`/device:GPU:<lowest>`); a second device plane of
  a mesh run repeats the same program on another shard. Kernels come from
  its `XLA Ops` line when the plane has one (one event per launched
  kernel; the plane's `Stream #N` lines then repeat the same kernels and
  would count their time twice), otherwise from its `Stream #N` lines,
  where each kernel appears once (this is what an H100 trace of a
  command-buffer program holds: one line `Stream #13(MemcpyD2H,Compute,
  MemcpyD2D)`). Program executions come from `XLA Modules` when present.
- CPU (the test backend, which has no device plane): the host plane's XLA
  executor lines, without the thread-pool bookkeeping events.

A dump that yields no kernel events raises `TraceParseError`: a traced run
whose trace cannot be read is a failure, not a silent empty result.
"""

import glob
import os
from collections import OrderedDict

OPS_LINE = "XLA Ops"
MODULES_LINE = "XLA Modules"
_CPU_EXECUTOR_LINES = ("XLAEigen", "XLAPjRtCpuClient")
_CPU_INFRA_PREFIXES = ("ThunkExecutor", "ThreadpoolListener", "end:")


class TraceParseError(RuntimeError):
    pass


def newest_dump(log_dir):
    """Path of the most recent *.xplane.pb under `log_dir`, or None."""
    files = glob.glob(os.path.join(str(log_dir), "**", "*.xplane.pb"),
                      recursive=True)
    return max(files, key=os.path.getmtime) if files else None


def _gpu_index(plane_name):
    try:
        return int(plane_name.rsplit(":", 1)[1])
    except ValueError:
        return 1 << 30


def trace_events(path):
    """{"ops": [(name, start_ns, dur_ns), ...], "modules": [...],
    "plane": plane name} from one XPlane file (see the module docstring
    for which plane and lines)."""
    from jax.profiler import ProfileData
    profile = ProfileData.from_file(str(path))
    planes = list(profile.planes)
    gpus = sorted((p for p in planes if p.name.startswith("/device:GPU:")),
                  key=lambda p: _gpu_index(p.name))
    out = {"ops": [], "modules": []}
    if gpus:
        plane = gpus[0]
        lines = {ln.name: ln for ln in plane.lines}
        ops_lines = [lines[OPS_LINE]] if OPS_LINE in lines else \
            [ln for name, ln in lines.items() if name.startswith("Stream #")]
        if not ops_lines:
            raise TraceParseError(
                f"{path}: plane {plane.name} has neither an {OPS_LINE!r} "
                f"nor a 'Stream #' line (lines: {sorted(lines)})")
        for line in ops_lines:
            out["ops"] += [(e.name, e.start_ns, e.duration_ns)
                           for e in line.events]
        if MODULES_LINE in lines:
            out["modules"] = [(e.name, e.start_ns, e.duration_ns)
                              for e in lines[MODULES_LINE].events]
        out["plane"] = plane.name
        return out
    for plane in planes:
        if plane.name != "/host:CPU":
            continue
        for line in plane.lines:
            if not any(m in line.name for m in _CPU_EXECUTOR_LINES):
                continue
            out["ops"] += [(e.name, e.start_ns, e.duration_ns)
                           for e in line.events
                           if not e.name.startswith(_CPU_INFRA_PREFIXES)
                           and "::" not in e.name]
        out["plane"] = plane.name
    return out


def kernel_table(ops):
    """OrderedDict {kernel name: {"seconds": total, "calls": n}} of
    (name, start_ns, dur_ns) events, seconds-descending."""
    totals = {}
    for name, _, dur in ops:
        entry = totals.setdefault(name, [0.0, 0])
        entry[0] += dur
        entry[1] += 1
    order = sorted(totals.items(), key=lambda kv: -kv[1][0])
    return OrderedDict((k, {"seconds": d / 1e9, "calls": n})
                       for k, (d, n) in order)


def busy_seconds(ops):
    """Union of the events' [start, start+dur) intervals, in seconds:
    the time in which at least one kernel ran."""
    busy = 0.0
    end = None
    for start, dur in sorted((s, d) for _, s, d in ops):
        stop = start + dur
        if end is None or start >= end:
            busy += dur
            end = stop
        elif stop > end:
            busy += stop - end
            end = stop
    return busy / 1e9


def window_seconds(ops):
    """From the first kernel's start to the last kernel's end."""
    if not ops:
        return 0.0
    return (max(s + d for _, s, d in ops) - min(s for _, s, _ in ops)) / 1e9


def parse_kernel_times(log_dir):
    """Per-kernel device time from the newest XPlane dump under `log_dir`
    (`kernel_table`). Raises TraceParseError when there is no dump or it
    holds no kernel events."""
    path = newest_dump(log_dir)
    if path is None:
        raise TraceParseError(f"no *.xplane.pb under {log_dir}")
    ops = trace_events(path)["ops"]
    if not ops:
        raise TraceParseError(f"{path}: no kernel events")
    return kernel_table(ops)
