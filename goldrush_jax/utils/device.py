"""The device a measurement runs on, named the same way everywhere.

Measurement entry points (``bench.py``, ``chip_smoke.py``) call
``require_gpu`` first: a device number is only ever taken on an NVIDIA GPU,
never on a CPU fallback."""

from __future__ import annotations

import subprocess

import jax


def require_gpu() -> list:
    """JAX's devices, or SystemExit when the first one is not a GPU."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"needs an NVIDIA GPU; JAX found {len(devs)} "
            f"{devs[0].platform} device(s)")
    return devs


def jax_device() -> dict:
    """Platform, kind and count as JAX reports them."""
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def cards() -> list[str]:
    """One ``name, power.limit`` line per card, from nvidia-smi (run in a
    child process, which never imports JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]
