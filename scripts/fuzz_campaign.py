"""Extended option-space fuzz campaign.

Runs the fuzz invariants from tests/test_option_fuzz.py over a much larger
seed range than the committed suite (which pins a handful of seeds for
regression speed). This is the bug-hunting mode: the round-3 session found
real bugs (nghost floor, NaN-dropping pmin, Strang step-file collisions) with exactly these oracles at small seed
counts — more seeds, more geometry/option corners.

Usage:
    python scripts/fuzz_campaign.py [START] [COUNT]   # default 1000 200

Prints one line per (invariant, seed); on failure, prints the exception and
continues (a campaign summarizes, it doesn't stop at the first kill).
Exit 1 if anything failed. Failures reproduce with
`random.Random(20260818 + seed)` through the same `_sample`.
"""

import os
import sys
import tempfile
import traceback

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
sys.path.insert(0, os.path.join(_ROOT, "tests"))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import pytest

import test_option_fuzz as fuzz


class _Tmp:
    """Fresh tmp dir per call, pathlib-compatible like pytest's tmp_path."""

    def __enter__(self):
        import pathlib
        self._dir = tempfile.TemporaryDirectory()
        return pathlib.Path(self._dir.name)

    def __exit__(self, *exc):
        self._dir.cleanup()


def main():
    start = int(sys.argv[1]) if len(sys.argv) > 1 else 1000
    count = int(sys.argv[2]) if len(sys.argv) > 2 else 200

    # (name, fn, needs_tmp, relative weight — heavier invariants get
    # fewer seeds so one campaign pass stays a few hours of CPU)
    invariants = [
        ("combination", fuzz.test_random_option_combination, False, 1.0),
        ("ghost_poison", fuzz.test_random_option_ghost_poison, False, 0.6),
        ("sharded==single", fuzz.test_random_option_sharded_matches_single,
         False, 0.4),
        ("resume_bit_exact", fuzz.test_random_option_resume_bit_exact,
         True, 0.4),
        ("reshard_resume", fuzz.test_random_option_reshard_resume, True, 0.3),
        ("compare_roundtrip", fuzz.test_random_option_compare_roundtrip,
         True, 0.3),
        ("output_roundtrip", fuzz.test_random_option_output_roundtrip,
         True, 0.3),
        ("tiny_grid", fuzz.test_random_tiny_grid, False, 0.5),
        ("transpose", fuzz.test_random_option_transpose_symmetry,
         False, 0.4),
        ("axis_invariance", fuzz.test_random_option_axis_invariance_bitwise,
         False, 0.5),
    ]

    failures = []
    ran = 0
    for name, fn, needs_tmp, weight in invariants:
        n = max(1, int(count * weight))
        for seed in range(start, start + n):
            ran += 1
            try:
                if needs_tmp:
                    with _Tmp() as tmp:
                        fn(seed, tmp)
                else:
                    fn(seed)
                status = "ok"
            except pytest.skip.Exception as e:
                status = f"skip ({e})"
            except Exception:
                status = "FAIL"
                failures.append((name, seed))
                traceback.print_exc()
            print(f"[{name}] seed={seed}: {status}", flush=True)

    print(f"\n{ran} runs, {len(failures)} failures", flush=True)
    for name, seed in failures:
        print(f"  FAIL {name} seed={seed}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
