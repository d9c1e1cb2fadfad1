"""Test configuration: force the CPU backend with 8 virtual devices so
the multi-device sharding paths run without a GPU.  jax.config.update
also wins over a JAX_PLATFORMS set from outside.  Tests that need a
card are marked `gpu` and run in a child process (tests/test_gpu.py).
"""

import os
import sys

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Every jit compile pins a handful of VMAs (executable code/data
# mappings) for the life of jax's in-process caches; a full-suite run
# accumulates ~65k mappings and then segfaults INSIDE whatever XLA
# compile crosses vm.max_map_count (65530 default) — LLVM's JIT does
# not check mmap failures.  The crash moves around with test count, so
# it looks like heap corruption; it is not.  Dropping the caches when
# the map count gets high keeps the suite bounded at the cost of a few
# recompiles.
_MAPS_CLEAR_THRESHOLD = 30_000


@pytest.fixture(autouse=True)
def _vma_guard():
    yield
    try:
        with open("/proc/self/maps") as f:
            n = sum(1 for _ in f)
    except OSError:
        return
    if n > _MAPS_CLEAR_THRESHOLD:
        jax.clear_caches()
