"""Device memory budgets.

The merge engine and the PLCP driver choose between a device-resident
path and a slower bounded one by comparing the bytes a path would hold
on the device against a budget.  The budget is ``BUDGET_FRACTION`` of
what the device's allocator may hand out (``memory_stats()
["bytes_limit"]``); the rest is left for XLA's temporaries (sort
scratch, gathers) that the callers' byte estimates do not count.  The
CPU backend reports no memory stats, so there the host's physical
memory stands in for it.  An accelerator that reports no limit is an
error: no size is assumed.
"""

from __future__ import annotations

import os
from typing import Optional

BUDGET_FRACTION = 0.5


def device_bytes_limit(device=None) -> int:
    """Bytes the allocator of ``device`` (default: the first JAX device)
    may hand out."""
    import jax

    if device is None:
        device = jax.devices()[0]
    stats = device.memory_stats()
    if stats and "bytes_limit" in stats:
        return int(stats["bytes_limit"])
    if device.platform == "cpu":
        return os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    raise RuntimeError(
        "device %s (%s) reports no memory limit; cannot size device "
        "budgets" % (device, device.platform))


def device_budget(env_var: str, device=None) -> int:
    """Device-memory budget in bytes: ``env_var`` when set, else
    ``BUDGET_FRACTION`` of the device's allocator limit."""
    env: Optional[str] = os.environ.get(env_var)
    if env is not None:
        return int(env)
    return int(device_bytes_limit(device) * BUDGET_FRACTION)
