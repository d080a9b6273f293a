"""The accelerator a run is on: its identity, its published peaks, and the
persistent compile cache.

Every benchmark line and chip_smoke.py name the device they ran on with
``device_record()`` and the card's ``nvidia-smi`` name and power limit
(``gpu_name_and_power_limit``), because a card set below its maximum power
runs slower under load.
"""
from __future__ import annotations

import os
import subprocess
from pathlib import Path

__all__ = [
    "PEAKS", "peaks", "gpu_name_and_power_limit", "device_record",
    "enable_compile_cache",
]

REPO_ROOT = Path(__file__).resolve().parents[2]

# Published dense peaks per device kind (NVIDIA H100 SXM data sheet: rates
# without sparsity, at the full 700 W power limit).  A device that is not
# listed has no roofline: ``peaks`` raises rather than guess.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops_per_s": 989e12,
        "tf32_flops_per_s": 495e12,
        "fp32_flops_per_s": 67e12,
        "hbm_bytes_per_s": 3.35e12,
    },
}


def peaks(device_kind: str) -> dict:
    """Published peaks of ``device_kind`` (a ``jax.Device.device_kind``)."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device kind {device_kind!r}; add its "
            "data-sheet rates to fiode_tpu.utils.device.PEAKS"
        ) from None


def gpu_name_and_power_limit():
    """``nvidia-smi``'s ``name, power.limit`` line per card, or None where
    there is no nvidia-smi.  Runs as a child process, so it never touches
    JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip()


def device_record() -> dict:
    """The device as JAX reports it: platform, device kind and count."""
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache and return its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it and nothing
    else is set here.  Otherwise the cache sits at ``.jax_cache`` in the
    checkout: a fixed path, because the path is part of what a later run
    must find again."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = str(REPO_ROOT / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
