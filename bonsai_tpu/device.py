"""Which accelerator a measurement ran on.

Every speed number this repository reports names the card it was taken on
and that card's power limit (a card set below its maximum runs slower under
load).  ``card_identity`` asks nvidia-smi from a child process that does not
import JAX; ``require_gpu`` refuses to measure anywhere but on a CUDA device.
"""

from __future__ import annotations

import subprocess
from typing import Optional

NVIDIA_SMI_QUERY = [
    "nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
]


def card_identity() -> Optional[str]:
    """nvidia-smi's ``name, power.limit`` lines (one per card), or None
    where nvidia-smi is missing or fails."""
    try:
        proc = subprocess.run(
            NVIDIA_SMI_QUERY, capture_output=True, text=True, timeout=60
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    if proc.returncode != 0:
        return None
    return proc.stdout.strip() or None


def require_gpu(devices=None):
    """The JAX devices, after checking that they are CUDA GPUs.  Raises
    RuntimeError on any other platform: a measurement never falls back to
    the CPU."""
    if devices is None:
        import jax

        devices = jax.devices()
    platform = devices[0].platform
    if platform != "gpu":
        raise RuntimeError(
            f"needs a CUDA GPU; JAX found platform {platform!r} "
            f"({devices[0].device_kind})"
        )
    return devices
