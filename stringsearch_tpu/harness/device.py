"""Device selection and identification for the harness entry points.

A measurement names the device it ran on and never falls back to the
CPU: `require_gpu` raises when JAX's default backend is not the GPU, and
`select_device` reports failure instead of picking another platform.
"""

from __future__ import annotations

import subprocess
import sys


def select_device(name: str) -> bool:
    """Make the first `name` device ("cpu" or "gpu") JAX's default.

    Returns False, with a message on stderr, when JAX has no such device.
    """
    import jax

    try:
        devs = jax.devices(name)
    except RuntimeError:  # backend absent or failed to initialize
        devs = []
    if not devs:
        print(f"--device {name}: no {name} device available", file=sys.stderr)
        return False
    jax.config.update("jax_default_device", devs[0])
    return True


def require_gpu(count: int = 1) -> list:
    """The default backend's first `count` devices; raises unless they
    are GPUs."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(
            f"needs a GPU, JAX's default backend is {devs[0].platform!r}")
    if len(devs) < count:
        raise RuntimeError(f"needs {count} GPUs, JAX has {len(devs)}")
    return devs[:count]


def device_record(devs) -> dict:
    """{"platform", "kind", "count"} of a device list, as JAX reports it."""
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def card_name_and_power() -> str:
    """Name and power limit of the cards, one line each, as
    `nvidia-smi --query-gpu=name,power.limit` reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()
