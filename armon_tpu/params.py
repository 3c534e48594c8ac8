"""User-facing solver parameters.

Rebuild of the reference front-end `ArmonParameters` (`src/parameters.jl`):
a keyword-argument cascade where each init step consumes its options and any
leftover raises an error naming the unknown options
(`src/parameters.jl:359-372`). The full reference option space (SURVEY.md
§2.5) is accepted; options that exist to manage the reference's own
threading/SIMD/MPI machinery (threads, SIMD, NUMA, cache-blocking scheduler,
Scotch partitioning, GPU-aware buffers, the backend choice) are validated and
recorded but have no effect — the equivalent decisions live in XLA
(SURVEY.md §2.3, §2.4). The kernels are plain `jax.numpy`/`lax` code that XLA
compiles and fuses for whatever backend JAX runs on.

``P=(px, py)`` selects a `jax.sharding.Mesh` layout instead of an MPI
process grid.
"""


from typing import Optional

import numpy as np

from .utils.errors import solver_error
from .models.cases import test_from_name, Sedov, TestCase
from .core.config import SolverConfig
from .core.state import State


_DTYPE_NAMES = {
    "float64": np.float64, "Float64": np.float64, "f64": np.float64,
    "float32": np.float32, "Float32": np.float32, "f32": np.float32,
}


def _stencil_width_riemann(scheme: str) -> int:
    # src/riemann_schemes.jl:17-18
    return {"Godunov": 1, "GAD": 2}[scheme]


def _stencil_width_projection(projection: str) -> int:
    # src/projection_schemes.jl:11-12
    return {"euler": 1, "euler_2nd": 2}[projection]


def _init_distributed(coordinator_address, num_processes, process_id):
    """Idempotent `jax.distributed.initialize` — the `MPI.Init` analog
    (src/parameters.jl:409-413). Safe to call from every process of a
    multi-host launch; repeated calls with the same coordinator are no-ops,
    a DIFFERENT coordinator after initialization is a config error."""
    import jax
    if jax.distributed.is_initialized():
        try:  # best-effort mismatch check (private module; may move)
            from jax._src import distributed as _dist
            prev = getattr(_dist.global_state, "coordinator_address", None)
        except Exception:
            prev = None
        if prev not in (None, coordinator_address):
            solver_error("config",
                         f"jax.distributed is already initialized with "
                         f"coordinator {prev!r}; cannot re-initialize with "
                         f"{coordinator_address!r}")
        return
    kw = {}
    if num_processes is not None:
        kw["num_processes"] = int(num_processes)
    if process_id is not None:
        kw["process_id"] = int(process_id)
    jax.distributed.initialize(coordinator_address=coordinator_address, **kw)


class ArmonParameters:
    """Validating front-end. ``ArmonParameters(**options)`` then
    ``armon(params)`` (`README.md:33-39` of the reference)."""

    def __init__(self, **options):
        opts = dict(options)

        # --- data type + grid (src/parameters.jl:348-353)
        data_type = opts.pop("data_type", np.float64)
        if isinstance(data_type, str):
            data_type = _DTYPE_NAMES.get(data_type)
        if isinstance(data_type, type) and data_type is float:
            data_type = np.float64
        if data_type not in (np.float64, np.float32):
            solver_error("config", f"Unsupported data_type: {options.get('data_type')}")
        self.data_type = np.dtype(data_type)

        N = tuple(opts.pop("N", (10, 10)))
        if len(N) != 2 or any(n <= 0 for n in N):
            solver_error("config", f"Invalid grid size N: {N}")
        self.N = N  # global real cells (nx, ny)

        self._init_scheme(opts)
        self._init_test(opts)
        self._init_mesh(opts)
        self._init_device(opts)
        self._init_profiling(opts)
        self._init_indexing(opts)
        self._init_output(opts)
        self._init_solver_state(opts)

        if opts:
            bad = ", ".join(f"'{k}'" for k in opts)
            raise TypeError(f"{len(opts)} unconsumed options:\n{bad}")

        self._config = None

    # ------------------------------------------------------------------ init
    def _init_scheme(self, o):
        """src/parameters.jl:577-630"""
        self.scheme = str(o.pop("scheme", "GAD"))
        if self.scheme not in ("Godunov", "GAD"):
            solver_error("config", f"Unknown scheme: '{self.scheme}'")
        self.projection = str(o.pop("projection", "euler_2nd"))
        if self.projection not in ("euler", "euler_2nd"):
            solver_error("config", f"Unknown projection scheme: '{self.projection}'")
        self.riemann_limiter = str(o.pop("riemann_limiter", "minmod"))
        if self.riemann_limiter not in ("no_limiter", "minmod", "superbee"):
            solver_error("config", f"Unknown limiter name: '{self.riemann_limiter}'")
        self.axis_splitting = str(o.pop("axis_splitting", "Sequential"))
        if self.axis_splitting == "SequentialSym":
            self.axis_splitting = "Godunov"
        if self.axis_splitting not in ("Sequential", "Godunov", "Strang", "X_only", "Y_only"):
            solver_error("config", f"Unknown splitting method: '{self.axis_splitting}'")

        self.nghost = int(o.pop("nghost", 4))
        # The true one-sweep dependency depth is the SUM of the stencil
        # widths, not the reference's PRODUCT (`src/parameters.jl:609-613`):
        # the fluxes range extends `stencil(projection) + 1` cells past the
        # real domain (`src/parameters.jl:1008`), and the outermost
        # Riemann solve reads `stencil(riemann) - 1` further (GAD reads
        # rho[i+s] and rho[i-2s], `src/riemann_schemes.jl:66-81`) — so a
        # real cell's output depends on ghosts up to depth
        # stencil(riemann) + stencil(projection). The two rules coincide
        # exactly at GAD+euler_2nd (4, the only minimum the reference's
        # suite exercises); at the product rule's other minima the
        # reference kernels index past the ghost band (into the adjacent
        # row via the flat linear index), and this rebuild's padded-array
        # tiers would read wrap/pad garbage into the edge real cells —
        # measured, see tests/test_params.py::test_nghost_floor_is_sum.
        min_nghost = (_stencil_width_riemann(self.scheme)
                      + _stencil_width_projection(self.projection))
        if self.nghost < min_nghost:
            solver_error("config",
                         f"Not enough ghost cells for the scheme: at least "
                         f"{min_nghost} are needed (stencil sum; the "
                         f"reference's product rule under-counts), got "
                         f"{self.nghost}")

        self.cst_dt = bool(o.pop("cst_dt", False))
        self.Dt = float(o.pop("Dt", 0.0))
        self.dt_on_even_cycles = bool(o.pop("dt_on_even_cycles", False))
        if self.cst_dt and self.Dt == 0:
            solver_error("config", "Dt == 0 with constant step enabled")

    def _init_test(self, o):
        """src/parameters.jl:632-670"""
        test = o.pop("test", "Sod")
        domain_size = o.pop("domain_size", None)
        origin = o.pop("origin", None)
        cfl = float(o.pop("cfl", 0.0))
        maxtime = float(o.pop("maxtime", 0.0))
        # Clamped to int32 (the jit loop's cycle-counter dtype): larger
        # values mean "unbounded" and would otherwise wrap or overflow in
        # np.int32(maxcycle) at trace time.
        self.maxcycle = min(int(o.pop("maxcycle", 500_000)), 2**31 - 1)

        if isinstance(test, TestCase):
            self.test = test
        else:
            # Sedov needs the cell size (src/parameters.jl:657-659, computed
            # with the *global* N since indexing init runs later).
            from .models.cases import _REGISTRY
            cls = _REGISTRY.get(str(test))
            if cls is None:
                solver_error("config", f"Unknown test case: '{test}'")
            ds = tuple(domain_size) if domain_size is not None else cls.default_domain_size
            dx = ds[0] / self.N[0]
            dy = ds[1] / self.N[1]
            self.test = test_from_name(test, dx, dy, self.data_type)

        tcls = type(self.test)
        self.domain_size = tuple(map(float, domain_size)) if domain_size is not None \
            else tuple(map(float, tcls.default_domain_size))
        self.origin = tuple(map(float, origin)) if origin is not None \
            else tuple(map(float, tcls.default_domain_origin))

        # cfl/maxtime default to the test's values (src/parameters.jl:666-667)
        self.cfl = cfl if cfl != 0 else self.test.default_CFL
        self.maxtime = maxtime if maxtime != 0 else self.test.default_max_time

    def _init_mesh(self, o):
        """Device-mesh layout; absorbs the reference MPI options
        (src/parameters.jl:408-467)."""
        self.use_MPI = bool(o.pop("use_MPI", False))  # accepted; mesh replaces MPI
        self.P = tuple(o.pop("P", (1, 1)))
        # MPI rank reordering: the device mesh is a plain reshape of the
        # device list (every device reaches every other at the same rate).
        self.reorder_grid = bool(o.pop("reorder_grid", True))
        o.pop("global_comm", None)   # no communicator: the mesh replaces it
        self.gpu_aware = bool(o.pop("gpu_aware", True))  # N/A: data stays on device
        self.devices = o.pop("devices", None)  # explicit device list
        if len(self.P) != 2 or any(p <= 0 for p in self.P):
            solver_error("config", f"Invalid process grid P: {self.P}")
        # Multi-process (multi-host) runs — the analog of the reference's
        # `MPI.Init` + cartesian communicator over a cluster
        # (src/parameters.jl:408-431): hand the coordinator endpoint to
        # `jax.distributed.initialize` and the mesh below spans every
        # process's devices. All three options must be given together
        # (num_processes/process_id may be omitted where the launcher
        # environment provides them).
        self.coordinator_address = o.pop("coordinator_address", None)
        self.num_processes = o.pop("num_processes", None)
        self.process_id = o.pop("process_id", None)
        if self.coordinator_address is not None:
            _init_distributed(self.coordinator_address, self.num_processes,
                              self.process_id)
        import jax
        # is_initialized() first: jax.process_count() initializes the
        # default backend as a side effect, which would pin the platform
        # at ArmonParameters construction; uninitialized distributed state
        # means single-process, nothing to do.
        if (jax.distributed.is_initialized() and jax.process_count() > 1
                and not self.use_MPI):
            # Per-shard I/O (`use_MPI`-gated, src/io.jl:46-75) is the only
            # output/checkpoint route that works when shards live on other
            # processes — the gather paths raise a pointed error there.
            self.use_MPI = True

    def _init_device(self, o):
        """src/parameters.jl:470-530 — backend knobs. The backend is whatever
        JAX runs on; threading/SIMD/NUMA/cache-blocking are the reference's
        host machinery, which XLA replaces. Accepted as no-ops for config
        compatibility."""
        self.device = o.pop("device", "default")
        self.use_gpu = bool(o.pop("use_gpu", False))
        if o.pop("use_kokkos", False):
            solver_error("config", "use_kokkos is not supported: the kernels "
                                   "are jax.numpy code compiled by XLA for "
                                   "the backend JAX runs on")
        self.use_threading = bool(o.pop("use_threading", True))
        self.use_simd = bool(o.pop("use_simd", True))
        self.use_cache_blocking = bool(o.pop("use_cache_blocking", True))
        self.async_cycle = bool(o.pop("async_cycle", False))
        self.use_two_step_reduction = bool(o.pop("use_two_step_reduction", False))
        self.workload_distribution = o.pop("workload_distribution", "simple")
        o.pop("distrib_params", None)
        self.numa_aware = bool(o.pop("numa_aware", False))
        self.lock_memory = bool(o.pop("lock_memory", False))
        self.busy_wait_limit = int(o.pop("busy_wait_limit", 100))

    def _init_profiling(self, o):
        """src/parameters.jl:532-575. Known profilers: 'trace'
        (jax.profiler XPlane dump — the NVTX/CUDA-profiler analog)."""
        prof = o.pop("profiling", [])
        # A bare string ('profiling=trace', the natural CLI spelling) is
        # ONE profiler name, not an iterable of characters.
        self.profiling = [prof] if isinstance(prof, str) else list(prof)
        unknown = set(map(str, self.profiling)) - {"trace"}
        if unknown:
            solver_error("config", "Unknown profiler" +
                         ("s" if len(unknown) > 1 else "") + ": " +
                         ", ".join(sorted(unknown)))
        self.measure_time = bool(o.pop("measure_time", True))
        self.time_async = bool(o.pop("time_async", True))
        self.log_blocks = bool(o.pop("log_blocks", False))
        o.pop("estimated_blk_log_size", None)

    def _init_indexing(self, o):
        """src/parameters.jl:673-697: split the global grid over the mesh.

        Any (N, P) is accepted like the reference. XLA shards must be
        uniform, so every shard is padded to n_local = ceil(N/P) real cells
        and the hi-edge shard owns the short remainder (n_edge); its slack
        cells are dead by the padded-array design. NOTE the partition
        boundaries differ from the reference, which floor-splits and gives
        the edge rank the LONG remainder: N=10, P=4 yields per-rank cell
        ranges [0,3)[3,6)[6,9)[9,10) here vs [0,2)[2,4)[4,6)[6,10) there.
        Global results are identical, but a per-shard `_<cx>×<cy>` file
        (output/checkpoint) covers a different window than the same-named
        file from a reference MPI run — compare per-shard artifacts
        against the GLOBAL golden via the windowed readers
        (io/subdomain.py), never file-by-file against Julia MPI output."""
        self.global_grid = self.N
        px, py = self.P
        nx, ny = self.global_grid
        self.n_local = (-(-nx // px), -(-ny // py))
        self.n_edge = (nx - (px - 1) * self.n_local[0],
                       ny - (py - 1) * self.n_local[1])
        if any(p > 1 and n < self.nghost
               for p, n in zip(self.P, self.n_local)) \
                or any(p > 1 and e < self.nghost
                       for p, e in zip(self.P, self.n_edge)):
            solver_error("config",
                         f"domain {self.global_grid} is too small to be split by "
                         f"{self.P} devices while keeping more than "
                         f"{self.nghost} cells along each axis")

    def _init_output(self, o):
        """src/parameters.jl:700-728"""
        self.silent = int(o.pop("silent", 0))
        self.output_dir = str(o.pop("output_dir", "."))
        self.output_file = str(o.pop("output_file", "output"))
        self.write_output = bool(o.pop("write_output", False))
        self.write_ghosts = bool(o.pop("write_ghosts", False))
        self.write_slices = bool(o.pop("write_slices", False))
        p = o.pop("output_precision", None)
        self.output_precision = int(p) if p is not None else \
            (17 if self.data_type.itemsize == 8 else 9)
        self.animation_step = int(o.pop("animation_step", 0))
        # Write a restartable snapshot every N cycles
        # (armon_tpu.io.restart; resume with armon(..., restore_from=path)).
        self.checkpoint_step = int(o.pop("checkpoint_step", 0))
        self.compare = bool(o.pop("compare", False))
        self.is_ref = bool(o.pop("is_ref", False))
        self.comparison_tolerance = float(o.pop("comparison_tolerance", 1e-10))
        self.check_result = bool(o.pop("check_result", False))
        self.return_data = bool(o.pop("return_data", False))

    def _init_solver_state(self, o):
        self.initial_mass = 0.0
        self.initial_energy = 0.0

    # ------------------------------------------------------------- derived
    @property
    def config(self) -> SolverConfig:
        if self._config is None:
            self._config = SolverConfig(
                dtype=self.data_type,
                nghost=self.nghost,
                n_global=self.global_grid,
                n_local=self.n_local,
                domain_size=self.domain_size,
                origin=self.origin,
                test=self.test,
                riemann=self.scheme,
                limiter=self.riemann_limiter,
                projection=self.projection,
                splitting=self.axis_splitting,
                cfl=self.cfl,
                maxtime=self.maxtime,
                maxcycle=self.maxcycle,
                Dt=self.Dt,
                cst_dt=self.cst_dt,
                dt_on_even_cycles=self.dt_on_even_cycles,
                proc_dims=self.P,
                n_edge=self.n_edge,
            )
        return self._config

    def memory_required(self) -> dict:
        """Byte accounting, analog of `src/blocking/block_grid.jl:598-709`:
        per device (`block_memory`) and over the whole mesh."""
        mem = block_memory(self.n_local, self.nghost,
                           self.data_type.itemsize,
                           n_fields=len(State._fields))
        mem["total_bytes"] = mem["per_device_total_bytes"] * \
            self.P[0] * self.P[1]
        return mem

    def __repr__(self):
        return (f"ArmonParameters(test={self.test!r}, N={self.N}, "
                f"dtype={self.data_type.name}, scheme={self.scheme}, "
                f"projection={self.projection}, limiter={self.riemann_limiter}, "
                f"splitting={self.axis_splitting}, P={self.P})")

    def describe(self) -> str:
        """Multi-line parameter block (`print_parameters`,
        `src/parameters.jl:826-900`)."""
        mem = self.memory_required()
        dt_line = (f"constant at {self.Dt}" if self.cst_dt else
                   "initialized automatically, updated " +
                   ("only at even cycles" if self.dt_on_even_cycles
                    else "every cycle"))
        lines = [
            "Armon parameters:",
            f" - test:       {self.test!r}",
            f" - grid:       {self.N[0]}x{self.N[1]} cells "
            f"(+{self.nghost} ghosts), domain {self.domain_size} "
            f"from {self.origin}",
            f" - data type:  {self.data_type.name}",
            f" - scheme:     {self.scheme}"
            + (f" + {self.riemann_limiter} limiter"
               if self.scheme == "GAD" else ""),
            f" - projection: {self.projection}",
            f" - splitting:  {self.axis_splitting}",
            f" - time step:  {dt_line}; CFL={self.cfl}",
            f" - stops at:   t={self.maxtime} or {self.maxcycle} cycles",
            f" - mesh:       {self.P[0]}x{self.P[1]} devices, "
            f"{mem['per_device_total_bytes'] / 1e6:.1f} MB/device",
        ]
        return "\n".join(lines)


def block_memory(n_local, nghost, itemsize, n_fields=11, comm_vars=7,
                 transient_fields=5) -> dict:
    """Itemized byte accounting of one device's padded block, including
    the time loop's steady-state transients (analog of
    `src/blocking/block_grid.jl:598-709`): the `n_fields` state arrays,
    `transient_fields` extra full arrays that XLA keeps live across the
    while-loop carry and the sweep temporaries (an estimate, not a
    measurement — `memory_stats()["peak_bytes_in_use"]` is the measured
    figure), and the stacked halo slabs on four sides."""
    nx, ny = n_local
    rows, cols = ny + 2 * nghost, nx + 2 * nghost
    field = rows * cols * itemsize
    state = n_fields * field
    transients = transient_fields * field
    halo = 2 * (rows + cols) * nghost * comm_vars * itemsize
    return {
        "per_device_field_bytes": field,
        "per_device_state_bytes": state,
        "per_device_transient_bytes": transients,
        "per_device_halo_bytes": halo,
        "per_device_total_bytes": state + transients + halo,
    }


def data_type(params: ArmonParameters):
    """Reference API parity (`src/Armon.jl:15`)."""
    return params.data_type.type


def memory_required(params: ArmonParameters):
    return params.memory_required()
