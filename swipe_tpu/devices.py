"""Which device a measurement ran on.

Every number a benchmark or the on-card check prints names its device:
the JAX platform, ``device_kind`` and device count, and for an NVIDIA
card its name and power limit as ``nvidia-smi`` reports them (a card set
below its maximum power runs slower under load).  A measurement that
finds no GPU stops; it never reports a CPU time under a device metric.
"""

from __future__ import annotations

import subprocess
import sys

__all__ = ["describe", "card_info", "require_gpu"]


def describe() -> dict:
    """{"platform", "kind", "count"} of JAX's default devices."""
    import jax
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def card_info() -> str:
    """``name, power.limit`` of each NVIDIA card, one per line."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip()


def require_gpu(what: str) -> dict:
    """Print the device and card, or exit non-zero when JAX has no GPU.

    ``what`` names the caller in the message."""
    dev = describe()
    if dev["platform"] != "gpu":
        sys.stderr.write(f"{what}: needs an NVIDIA GPU; JAX runs on "
                         f"{dev['platform']} ({dev['kind']}) — no result\n")
        sys.exit(1)
    print(f"device: {dev['platform']} {dev['kind']} x{dev['count']}",
          flush=True)
    print(f"card: {card_info()}", flush=True)
    return dev
