# Convenience targets (the reference wraps its test runs in test/makefile)

.PHONY: test test-fast test-quick endround bench smoke native clean

test: native
	JAX_PLATFORMS=cpu python -m pytest tests/ -q

# Iteration loop: drop the marked-slow tiers (heavy fuzz sweeps,
# process grids, 25-device covering) — ~1/4 the wall time of `make test`.
test-quick: native
	JAX_PLATFORMS=cpu python -m pytest tests/ -q -m "not slow"

test-fast: native
	JAX_PLATFORMS=cpu python -m pytest tests/ -q -x -k "not conservation and not golden"

# End-of-round gate: the FULL suite must be green on the tree being
# committed — an unexecuted test must never ship. The graft-contract legs
# run on the CPU platform in separate processes, so neither leg inherits
# the other's backend init (a backend pinned by a prior jit cannot be
# switched to the 8-device virtual mesh).
endround: native
	JAX_PLATFORMS=cpu python -m pytest tests/ -q
	JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
	  python -c "import __graft_entry__ as g; g.entry()"
	JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
	  python -c "import __graft_entry__ as g; g.dryrun_multichip(8)"
	@echo "ENDROUND GATE: suite green + graft contracts OK"

# GPU only: both exit non-zero without one.
bench:
	python bench.py

smoke:
	python chip_smoke.py

native:
	$(MAKE) -C armon_tpu/native

clean:
	$(MAKE) -C armon_tpu/native clean
	find . -name __pycache__ -type d -exec rm -rf {} +
