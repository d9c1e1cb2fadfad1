"""Device-memory budgets, derived from what the device reports.

Each budget is a fixed share of the device's `bytes_limit` (the memory
the runtime lets this process allocate):

  acc     device accumulator working set (counter, shard_count)   25%
  hbm     chunk planner's device budget (configure_counting)     100%
  lookup  lookup-table residency gate (lookup.ExactLookup)      37.5%
  bacj    grid compare-join cap (lookup._build_bacj)            37.5%

An env override (GB) wins for each.  The CPU backend has no device
memory of its own, so it keeps fixed sizes.  Any other device that
reports no `bytes_limit` is an error: nothing assumes a size.
"""

from __future__ import annotations

import os

SHARES = {"acc": 0.25, "hbm": 1.0, "lookup": 0.375, "bacj": 0.375}
CPU_GB = {"acc": 4.0, "hbm": 16.0, "lookup": 6.0, "bacj": 6.0}
ENV = {"acc": "MERYL_TPU_ACC_CAP_GB",
       "lookup": "MERYL_TPU_LOOKUP_DEVICE_GB",
       "bacj": "MERYL_TPU_BACJ_CAP_GB"}


def device_bytes_limit(device) -> int:
    """The device's allocatable bytes; raises when it reports none."""
    stats = device.memory_stats()
    if not stats or "bytes_limit" not in stats:
        raise RuntimeError(
            f"device {device} ({device.platform}) reports no "
            "memory_stats()['bytes_limit']; cannot size device budgets")
    return int(stats["bytes_limit"])


def _default_device():
    import jax
    return jax.local_devices()[0]


def budget_bytes(name: str, device=None) -> int:
    """Bytes of budget `name` (see module docstring) on `device`
    (default: this process's first device)."""
    env = ENV.get(name)
    if env and os.environ.get(env):
        return int(float(os.environ[env]) * 1e9)
    if device is None:
        device = _default_device()
    if device.platform == "cpu":
        return int(CPU_GB[name] * 1e9)
    return int(SHARES[name] * device_bytes_limit(device))
