"""Smoke run of the solver on NVIDIA GPUs, through the user's entry points.

    python chip_smoke.py                # one card: phases a-e below
    python chip_smoke.py --four-cards   # four cards: the mesh phase only

Phases (one card):
  a. device: JAX must see a GPU; the card's name and power limit come from
     nvidia-smi, queried before JAX starts.
  b. goldens: the 100x100 golden runs against tests/reference_data at the
     reference's tolerance ladder (f64: Sod, Sod_y, Sod_circ, Sedov,
     Bizarrium; f32: Sod, Sod_circ).
  c. conservation: 10000 f64 cycles of Sod, Sod_y and Sod_circ at <= 1e-12
     relative mass/energy drift (`test/conservation.jl:13-14`); the f32
     drift of Sod_circ is reported.
  d. flagship: `armon()` on Sod 8192^2 and 16384^2 f32 (GAD + minmod,
     euler_2nd, nghost 4, 100 cycles, check_result=True): set-up and
     compile seconds, steady cell-cycles/s, peak device memory, the
     conservation-sum time, and whether the native I/O library loaded.
  e. trace: one profiler window of the 8192^2 loop, reduced by
     `armon_tpu.utils.xplane`: device ms per cycle, idle share, kernels
     per sweep, the top five kernels, and the effective bandwidth of the
     design's byte floor beside a measured device copy.

`--four-cards` runs Sod 8192^2 f32 on a (2,2) mesh and Sod 8190x8191 on a
(4,1) mesh (the padded uneven-split path), each against the single-device
run of the same problem, checks conservation, and reads the halo and
`pmin` collectives from one trace.

Any failed phase makes the script exit non-zero without the ok line. The
last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import argparse
import json
import os
import re
import sys
import time
import traceback
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

OUT_DIR = os.path.join(ROOT, "chiprun_out", "chip_smoke")

FLAGSHIP = dict(test="Sod", scheme="GAD", riemann_limiter="minmod",
                projection="euler_2nd", nghost=4, data_type=np.float32,
                maxtime=1e30, silent=5)
FLAGSHIP_N = 8192
LITERAL_N = 16384
CYCLES = 100
CONSERVATION_CYCLES = 10000
UNEVEN_N = (8190, 8191)
COPY_ELEMS = 1 << 29  # a 2 GiB f32 array for the copy-bandwidth probe
# Bytes the fused design moves per cycle, in field crossings (one field
# read or written once): 17.6 per cycle.
FLOOR_CROSSINGS = 17.6
# Published H100 SXM device-memory bandwidth (NVIDIA data sheet).
HBM_PEAK_BYTES = {"NVIDIA H100 80GB HBM3": 3.35e12}

# Golden gates per (test, bits): the diff count at the reference's ladder
# must not exceed `max_count`; for Bizarrium the non-p fields are gated on
# their max relative diff (p crosses zero at the interface, so its relative
# diff is unbounded there — the reference excludes Bizarrium and Sedov from
# its zero gate, `test/convergence.jl:24-27`).
GOLDEN_GATES = {
    ("Sod", 64): dict(max_count=0),
    ("Sod_y", 64): dict(max_count=0),
    ("Sod_circ", 64): dict(max_count=0),
    ("Sedov", 64): dict(max_count=0),
    ("Bizarrium", 64): dict(max_count=16000, non_p_rel=1e-12),
    ("Sod", 32): dict(max_count=0),
    ("Sod_circ", 32): dict(max_count=0),
}
CONSERVATION_RTOL = 1e-12


class PhaseFailure(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseFailure(msg)


def say(*args):
    print(*args, flush=True)


def _write_table(name, table):
    """The whole kernel table of a trace, one kernel per line, under
    OUT_DIR (too long for the script's own output)."""
    with open(os.path.join(OUT_DIR, name), "w") as f:
        for kernel, v in table.items():
            f.write(f"{v['seconds']:.9f} s\t{v['calls']}\t{kernel}\n")


def _real(cfg, a):
    g = cfg.nghost
    return np.asarray(a)[g:-g, g:-g]


# ------------------------------------------------------------------ phases

def phase_goldens():
    from armon_tpu import armon
    from armon_tpu.core.solver import gather_state
    from armon_tpu.core.state import SAVED_VARS
    from armon_tpu.io.golden import (golden_params, golden_file, abs_tol,
                                     rel_tol)
    from armon_tpu.io.output import (read_reference_csv, compare_states,
                                     saved_vars_arrays)
    for (test, bits), gate in GOLDEN_GATES.items():
        dtype = np.float64 if bits == 64 else np.float32
        params = golden_params(test, dtype, return_data=True)
        stats = armon(params)
        cfg = params.config
        host = gather_state(params, stats.data)
        ref_dt, ref_cycles, ref = read_reference_csv(cfg,
                                                     golden_file(test, dtype))
        cnt, _, details = compare_states(cfg, host, ref, atol=abs_tol(dtype),
                                         rtol=rel_tol(dtype))
        ours = saved_vars_arrays(cfg, host)
        atol, rtol = abs_tol(dtype), rel_tol(dtype)
        max_abs = max(float(np.max(np.abs(ours[v] - ref[v])))
                      for v in SAVED_VARS)
        # relative to the larger magnitude, floored at the ladder's atol
        # (near-zero cells are judged by atol, like the comparator)
        max_rel = max(float(np.max(
            np.abs(ours[v] - ref[v]) / np.maximum(
                np.maximum(np.abs(ours[v]), np.abs(ref[v])), atol)))
            for v in SAVED_VARS if v != "p" or test != "Bizarrium")
        say(f"  golden {test} f{bits}: cycles {stats.cycles}/{ref_cycles} "
            f"dt {stats.last_dt!r}/{float(ref_dt)!r} diffs@ladder {cnt} "
            f"max_abs {max_abs:.3e} max_rel{'(non-p)' if test == 'Bizarrium' else ''} "
            f"{max_rel:.3e} per-var {details}")
        check(stats.cycles == ref_cycles, f"{test} f{bits}: cycle count")
        check(abs(float(ref_dt) - stats.last_dt)
              <= max(atol, rtol * abs(float(ref_dt))), f"{test} f{bits}: dt")
        check(cnt <= gate["max_count"],
              f"{test} f{bits}: {cnt} diffs > {gate['max_count']}")
        if "non_p_rel" in gate:
            check(max_rel < gate["non_p_rel"],
                  f"{test} f{bits}: non-p rel diff {max_rel:.3e}")


def phase_conservation():
    from armon_tpu.core.solver import make_init, make_jit_loop, \
        make_conservation
    from armon_tpu.io.golden import golden_params
    for test, dtype in (("Sod", np.float64), ("Sod_y", np.float64),
                        ("Sod_circ", np.float64), ("Sod_circ", np.float32)):
        params = golden_params(test, dtype, maxcycle=CONSERVATION_CYCLES,
                               maxtime=1e30)
        cons = make_conservation(params)
        state = make_init(params)()
        m0, e0 = cons(state)
        t0 = time.perf_counter()
        state, t, cycles, dt, ok = make_jit_loop(params)(state)
        check(bool(ok) and int(cycles) == CONSERVATION_CYCLES,
              f"{test}: stopped at cycle {int(cycles)}")
        seconds = time.perf_counter() - t0
        m1, e1 = cons(state)
        dm, de = abs(m1 - m0) / m0, abs(e1 - e0) / e0
        bits = np.dtype(dtype).itemsize * 8
        say(f"  conservation {test} f{bits}: {CONSERVATION_CYCLES} cycles "
            f"in {seconds:.2f} s, |dM|/M {dm:.3e} |dE|/E {de:.3e}")
        if bits == 64:
            check(dm <= CONSERVATION_RTOL and de <= CONSERVATION_RTOL,
                  f"{test} f64 drift above {CONSERVATION_RTOL}")


def _flagship(n, device):
    """armon() twice on the same params: the first call compiles, the
    second is the steady run. The steady run's final state is checked:
    finite, positive density, and f32 mass/energy drift within 1e-5."""
    import jax
    import jax.numpy as jnp
    from armon_tpu import ArmonParameters, armon
    from armon_tpu.core.solver import make_init, make_conservation

    def params(**kw):
        return ArmonParameters(N=(n, n), maxcycle=CYCLES, check_result=True,
                               **FLAGSHIP, **kw)

    runs = []
    for return_data in (False, True):
        p = params(return_data=return_data)
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            stats = armon(p)
        wall = time.perf_counter() - t0
        check(stats.cycles == CYCLES, f"{n}^2: {stats.cycles} cycles")
        runs.append((wall, stats))
    # check_result's own report: the reference's isapprox(drift, 0;
    # atol=1e-12) gate, which an f32 run does not meet by design
    for w in caught:
        say(f"  check_result {n}^2 f32: " + " ".join(str(w.message).split()))
    (wall0, first), (wall1, steady) = runs
    state = steady.data
    m, e = make_conservation(p)(state)
    dm = abs(m - p.initial_mass) / p.initial_mass
    de = abs(e - p.initial_energy) / p.initial_energy
    finite = all(bool(jnp.all(jnp.isfinite(getattr(state, v))))
                 for v in ("rho", "u", "v", "E", "p"))
    positive = bool(jnp.all(state.rho > 0))
    say(f"  flagship Sod {n}^2 f32: state {state.rho.shape} finite {finite} "
        f"rho>0 {positive}; |dM|/M {dm:.3e} |dE|/E {de:.3e}")
    check(finite and positive, f"{n}^2: non-finite or non-positive state")
    check(dm <= 1e-5 and de <= 1e-5, f"{n}^2: f32 drift {dm:.3e} {de:.3e}")
    del state, steady.data
    cells_per_sec = steady.giga_cells_per_sec * 1e9
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use",
                                                       0)
    say(f"  flagship Sod {n}^2 f32: first armon() {wall0:.2f} s "
        f"(loop {first.solve_time:.2f} s incl. compile), steady armon() "
        f"{wall1:.2f} s (loop {steady.solve_time:.4f} s); "
        f"compile ~{first.solve_time - steady.solve_time:.2f} s")
    say(f"  flagship Sod {n}^2 f32: {cells_per_sec:.6e} cell-cycles/s "
        f"on {device['kind']} [{device['card']}], "
        f"peak_bytes_in_use {peak} ({peak / 2**30:.2f} GiB)")
    # The compensated f32 conservation sum (a sequential scan over
    # columns): its own time, once compiled.
    p = params()
    cons = make_conservation(p)
    state = make_init(p)()
    cons(state)
    t0 = time.perf_counter()
    m, e = cons(state)
    say(f"  conservation sum {n}^2 f32: {time.perf_counter() - t0:.4f} s "
        f"per call (mass {m!r}, energy {e!r})")
    return cells_per_sec, steady


def phase_flagship(device):
    from armon_tpu.io import native
    say(f"  native I/O library loaded: {native.available()}")
    _flagship(FLAGSHIP_N, device)
    _flagship(LITERAL_N, device)


def phase_trace(device):
    import jax
    import jax.numpy as jnp
    from armon_tpu import ArmonParameters
    from armon_tpu.core.solver import make_init, make_jit_loop
    from armon_tpu.utils import xplane

    n = FLAGSHIP_N
    params = ArmonParameters(N=(n, n), maxcycle=CYCLES, **FLAGSHIP)
    state = make_init(params)()
    loop = make_jit_loop(params)
    jax.block_until_ready(loop(state))  # compiled (cached from phase d)
    trace_dir = os.path.join(OUT_DIR, "trace_8192")
    with jax.profiler.trace(trace_dir):
        jax.block_until_ready(loop(state))
    path = xplane.newest_dump(trace_dir)
    check(path is not None, "no trace written")
    ev = xplane.trace_events(path)
    ops, modules = ev["ops"], ev["modules"]
    check(ops, f"no kernel events on {ev.get('plane')}")
    busy = xplane.busy_seconds(ops)
    window = xplane.window_seconds(ops)
    module_s = sum(d for _, _, d in modules) / 1e9
    per_cycle = busy / CYCLES
    sweeps = 2 * CYCLES
    table = xplane.kernel_table(ops)
    _write_table("trace_8192_kernels.txt", table)
    say(f"  trace {ev['plane']}: {len(ops)} kernel events, "
        f"{len(table)} distinct, {len(ops) / sweeps:.2f} kernels/sweep, "
        f"modules {[m for m, _, _ in modules][:4]} {module_s:.6f} s")
    say(f"  device busy {busy:.6f} s over a {window:.6f} s window "
        f"(idle share {1 - busy / window:.4f}); "
        f"{per_cycle * 1e3:.4f} ms/cycle busy, "
        f"{module_s / CYCLES * 1e3:.4f} ms/cycle module")
    for name, v in list(table.items())[:5]:
        say(f"    top kernel {name}: {v['seconds']:.6f} s, {v['calls']} "
            f"calls, {v['seconds'] / busy:.4f} of busy")
    # Kernel families: XLA numbers repeated fusions of one kind
    # (input_concatenate_fusion_12 -> input_concatenate_fusion).
    families = {}
    for name, v in table.items():
        f = families.setdefault(re.sub(r"[._]\d+$", "", name), [0.0, 0])
        f[0] += v["seconds"]
        f[1] += v["calls"]
    for name, (sec, calls) in sorted(families.items(),
                                     key=lambda kv: -kv[1][0])[:5]:
        say(f"    top family {name}: {sec / CYCLES * 1e3:.4f} ms/cycle, "
            f"{calls / CYCLES:.2f} kernels/cycle, {sec / busy:.4f} of busy")
    cfg = params.config
    rows, cols = cfg.local_shape
    floor_bytes = FLOOR_CROSSINGS * rows * cols * 4
    eff = floor_bytes / per_cycle
    peak = HBM_PEAK_BYTES.get(device["kind"])
    say(f"  byte floor {floor_bytes / 1e9:.4f} GB/cycle -> effective "
        f"{eff / 1e12:.4f} TB/s"
        + (f" = {eff / peak:.4f} of the {peak / 1e12:.2f} TB/s peak; floor "
           f"time {floor_bytes / peak * 1e3:.4f} ms/cycle" if peak else
           f" (no published peak for {device['kind']!r})"))
    # A plain device copy of a 2 GiB f32 array (read + write) in the same
    # process: what a streaming kernel reaches on this card.
    x = jnp.ones((COPY_ELEMS,), jnp.float32)
    copy = jax.jit(lambda a: a * 2.0)
    jax.block_until_ready(copy(x))
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        jax.block_until_ready(copy(x))
        best = min(best, time.perf_counter() - t0)
    say(f"  copy {x.nbytes / 2**30:.2f} GiB f32 (read+write): "
        f"{best * 1e3:.4f} ms, "
        f"{2 * x.nbytes / best / 1e12:.4f} TB/s")
    del x


def _solve(params):
    import jax
    from armon_tpu.core.solver import make_init, make_jit_loop, \
        make_conservation, gather_state
    cons = make_conservation(params)
    state = make_init(params)()
    m0, e0 = cons(state)
    loop = make_jit_loop(params)
    jax.block_until_ready(loop(state))
    t0 = time.perf_counter()
    out, t, cycles, dt, ok = jax.block_until_ready(loop(state))
    seconds = time.perf_counter() - t0
    check(bool(ok) and int(cycles) == CYCLES,
          f"P={params.P}: stopped at cycle {int(cycles)}")
    m1, e1 = cons(out)
    host = gather_state(params, out)
    return dict(host=host, dt=float(dt), seconds=seconds,
                drift=(abs(m1 - m0) / m0, abs(e1 - e0) / e0))


def phase_four_cards():
    import jax
    from armon_tpu import ArmonParameters
    from armon_tpu.core.solver import make_init, make_jit_loop
    from armon_tpu.io.golden import abs_tol, rel_tol
    from armon_tpu.utils import xplane

    check(len(jax.devices()) >= 4, f"{len(jax.devices())} devices < 4")
    for N, P in (((FLAGSHIP_N, FLAGSHIP_N), (2, 2)), (UNEVEN_N, (4, 1))):
        single = ArmonParameters(N=N, maxcycle=CYCLES, **FLAGSHIP)
        mesh = ArmonParameters(N=N, maxcycle=CYCLES, P=P, **FLAGSHIP)
        a, b = _solve(single), _solve(mesh)
        cfg = single.config
        cells = N[0] * N[1] * CYCLES
        exact = a["dt"] == b["dt"]
        worst = {}
        count = 0
        for v in ("rho", "u", "v", "E", "p"):
            x = _real(cfg, getattr(a["host"], v))
            y = _real(cfg, getattr(b["host"], v))
            exact &= bool(np.array_equal(x, y))
            err = np.abs(x - y)
            tol = np.maximum(abs_tol(np.float32), rel_tol(np.float32)
                             * np.maximum(np.abs(x), np.abs(y)))
            count += int((~(err <= tol)).sum())
            worst[v] = float(err.max())
        say(f"  mesh {P} N={N}: single {cells / a['seconds']:.6e}, mesh "
            f"{cells / b['seconds']:.6e} cell-cycles/s; dt {a['dt']!r} vs "
            f"{b['dt']!r}; bit-exact {exact}; diffs@f32-ladder {count}; "
            f"max abs {worst}")
        say(f"  mesh {P} N={N}: drift |dM|/M, |dE|/E single {a['drift']} "
            f"mesh {b['drift']}")
        check(count == 0, f"mesh {P}: {count} cells off the f32 ladder")
        check(max(b["drift"]) <= 1e-6, f"mesh {P}: drift {b['drift']}")
        del a, b

    params = ArmonParameters(N=(FLAGSHIP_N, FLAGSHIP_N), maxcycle=CYCLES,
                             P=(2, 2), **FLAGSHIP)
    state = make_init(params)()
    loop = make_jit_loop(params)
    jax.block_until_ready(loop(state))
    trace_dir = os.path.join(OUT_DIR, "trace_mesh_2x2")
    with jax.profiler.trace(trace_dir):
        jax.block_until_ready(loop(state))
    ev = xplane.trace_events(xplane.newest_dump(trace_dir))
    ops = ev["ops"]
    busy = xplane.busy_seconds(ops)
    # XLA's collectives run as NCCL kernels on the GPU: ppermute (the
    # halo) as send/recv, pmin/psum as all-reduce. Events carry either the
    # NCCL kernel's name or the HLO instruction's (`ppermute.31`).
    kinds = {"halo": ("ppermute", "sendrecv", "collective-permute",
                      "collectivepermute", "send", "recv"),
             "all-reduce": ("pmin", "psum", "allreduce", "all-reduce"),
             "all-gather": ("allgather", "all-gather")}
    coll = {}
    names = set()
    for name, _, dur in ops:
        low = name.lower()
        for kind, marks in kinds.items():
            if any(m in low for m in marks):
                names.add(name)
                c = coll.setdefault(kind, [0, 0.0])
                c[0] += 1
                c[1] += dur / 1e9
                break
    say(f"  mesh (2,2) trace {ev['plane']}: busy {busy:.6f} s, "
        f"{busy / CYCLES * 1e3:.4f} ms/cycle; collectives "
        + ", ".join(f"{k}: {n} events ({n / CYCLES:.2f}/cycle) {s:.6f} s "
                    f"({s / busy:.4f} of busy)"
                    for k, (n, s) in sorted(coll.items())))
    say(f"  collective kernel names: {sorted(names)}")
    _write_table("trace_mesh_2x2_kernels.txt", xplane.kernel_table(ops))
    check("halo" in coll, "no halo collective in the trace")


# -------------------------------------------------------------------- main

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card mesh phase")
    args = ap.parse_args(argv)

    from armon_tpu.utils.device_info import card_lines, require_gpu, \
        NoGPUError
    from armon_tpu.utils.compile_cache import enable_compile_cache
    cards = card_lines()  # before JAX starts
    cache = enable_compile_cache()
    try:
        device = require_gpu()
    except NoGPUError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 1
    import jax
    jax.config.update("jax_enable_x64", True)
    device["card"] = cards[0] if cards else "nvidia-smi: no answer"
    os.makedirs(OUT_DIR, exist_ok=True)
    say(f"(a) device: platform {device['platform']}, kind "
        f"{device['kind']}, count {device['count']}; compile cache {cache}")

    if args.four_cards:
        phases = [("four-cards mesh", phase_four_cards)]
    else:
        phases = [("(b) goldens", phase_goldens),
                  ("(c) conservation", phase_conservation),
                  ("(d) flagship", lambda: phase_flagship(device)),
                  ("(e) trace", lambda: phase_trace(device))]
    failed = []
    for name, fn in phases:
        say(f"{name}:")
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:  # reported, and the run exits non-zero below
            traceback.print_exc()
            failed.append(name)
            say(f"{name}: FAILED")
        say(f"{name}: {time.perf_counter() - t0:.1f} s")
    for line in cards:
        say(line)
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": device["platform"], "kind": device["kind"],
        "count": device["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
