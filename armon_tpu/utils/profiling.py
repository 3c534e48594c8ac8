"""Profiling: sections and kernel tracing.

Rebuild of the reference's profiling layer (`src/profiling.jl`):
- `@section` (nestable named timing scopes, `src/profiling.jl:71-175`)
  becomes `section(...)`: a context manager that wall-times host-side phases
  AND emits `jax.named_scope` annotations so device-side work is attributed
  in XLA profiles;
- the TimerOutputs backend (`src/profiling.jl:181-208`) becomes `Timer`,
  a nested accumulator reported in `SolverStats.timer`;
- the NVTX/CUDA-profiler hooks (`ext/ArmonNVTX.jl`) become
  `trace(log_dir)`: a `jax.profiler.trace` wrapper producing
  TensorBoard/XPlane dumps.

`time_async=False` (config parity with `src/parameters.jl:132-135`) makes
`section` block on device work for honest timings.
"""

import contextlib
import time
from collections import OrderedDict

import jax


class Timer:
    """Nested section-time accumulator (TimerOutputs analog)."""

    def __init__(self):
        self.times = OrderedDict()   # name -> [total_seconds, calls]
        self._stack = []

    def push(self, name):
        self._stack.append((name, time.perf_counter()))

    def pop(self):
        name, t0 = self._stack.pop()
        path = "/".join(n for n, _ in self._stack) or ""
        key = f"{path}/{name}" if path else name
        entry = self.times.setdefault(key, [0.0, 0])
        entry[0] += time.perf_counter() - t0
        entry[1] += 1

    def report(self) -> dict:
        return {k: {"seconds": v[0], "calls": v[1]}
                for k, v in self.times.items()}


@contextlib.contextmanager
def section(name, timer: Timer = None, sync_args=None, time_async=True):
    """Named scope + optional host timing. With `time_async=False`, blocks on
    `sync_args` (a pytree of arrays, or a zero-arg callable returning one)
    before closing the timer — the analog of the reference's per-section
    device barrier (`src/profiling.jl:86-88`)."""
    if timer is not None:
        timer.push(name)
    try:
        with jax.named_scope(name):
            yield
    finally:
        if timer is not None:
            if not time_async and sync_args is not None:
                jax.block_until_ready(
                    sync_args() if callable(sync_args) else sync_args)
            timer.pop()


@contextlib.contextmanager
def trace(log_dir):
    """Whole-run profiler trace (NVTX/CUDA-profiler analog): produces an
    XPlane/TensorBoard dump under `log_dir`."""
    with jax.profiler.trace(str(log_dir)):
        yield
