"""meryl_tpu: a JAX k-mer counting and k-mer-set engine.

A from-scratch JAX/XLA design with the capabilities of marbl/meryl (see
SURVEY.md): canonical k-mer counting into a 64-way prefix-partitioned
sorted database, a command-line tree of set/arithmetic actions over
databases, histogram/statistics/ploidy reports, and a batched
exact-lookup query engine.
"""

__version__ = "0.1.0"

import os as _os

# fixed in-checkout location of the persistent compile cache (the path
# is part of the cache key, so it must not move between runs)
CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")


def _enable_compile_cache():
    """Persistent XLA compile cache: CLI invocations are separate
    processes, and the counting pipeline takes tens of seconds to
    compile per shape signature.  When JAX_COMPILATION_CACHE_DIR is set,
    JAX already reads it and the cache lives there; otherwise it lives
    in CACHE_DIR.  Opt out with MERYL_TPU_NO_CACHE=1."""
    if _os.environ.get("MERYL_TPU_NO_CACHE"):
        return
    # jaxlib 0.9 XLA:CPU AOT loads compare the compile-time feature
    # string (which contains XLA pseudo-features like
    # +prefer-no-scatter) against host CPUID (which never has them), so
    # EVERY cached-executable load on CPU logs a ~4KB spurious ERROR
    # block.  The entries load and run fine; silence the native ERROR
    # channel unless the user asked for it.  Real failures still
    # surface as Python exceptions; export MERYL_TPU_NATIVE_LOGS=1 to
    # keep backend diagnostics visible (e.g. when debugging).
    # Only effective when meryl_tpu is imported before jaxlib loads
    # (always true for the CLI entry points); TSL latches the level at
    # native-library load.
    if _os.environ.get("MERYL_TPU_NATIVE_LOGS", "0") == "0":
        _os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")
    import jax
    if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        _os.makedirs(CACHE_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)


_enable_compile_cache()

from . import kmer  # noqa: F401


def __getattr__(name):
    """Lazy public API (importing jax-heavy modules only on use)."""
    import importlib
    api = {
        "MerylDB": ("meryl_tpu.db", "MerylDB"),
        "MerylDBWriter": ("meryl_tpu.db", "MerylDBWriter"),
        "MerylHistogram": ("meryl_tpu.histogram", "MerylHistogram"),
        "ExactLookup": ("meryl_tpu.lookup", "ExactLookup"),
        "count_to_db": ("meryl_tpu.counter", "count_to_db"),
        "count_to_arrays": ("meryl_tpu.counter", "count_to_arrays"),
        "count_to_db_batched": ("meryl_tpu.counter", "count_to_db_batched"),
        "configure_counting": ("meryl_tpu.counter", "configure_counting"),
        "ShardedCounter": ("meryl_tpu.parallel.shard_count",
                           "ShardedCounter"),
    }
    if name in api:
        mod, attr = api[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(f"module 'meryl_tpu' has no attribute {name!r}")
