"""What a measurement ran on: the JAX device triple and the card's name and
power limit, printed beside every rate."""

from __future__ import annotations

import os
import subprocess


def device_info() -> dict:
    """{platform, kind, count} as JAX reports the devices."""
    import jax

    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }


def card_line() -> str:
    """`name, power.limit` of the first GPU as nvidia-smi reports it, or
    "not available" where nvidia-smi is absent."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError):
        return "not available"
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    return lines[0] if lines else "not available"


def require_gpu(allow_cpu_rehearsal: bool = False) -> dict:
    """device_info(), or SystemExit when JAX finds no GPU. With
    allow_cpu_rehearsal, a CPU run is accepted only when JAX_PLATFORMS=cpu
    was asked for explicitly."""
    info = device_info()
    if info["platform"] == "gpu":
        return info
    if (
        allow_cpu_rehearsal
        and info["platform"] == "cpu"
        and os.environ.get("JAX_PLATFORMS") == "cpu"
    ):
        return info
    raise SystemExit(
        f"no GPU: JAX reports platform {info['platform']!r}"
        + (" (set JAX_PLATFORMS=cpu for a CPU rehearsal)"
           if allow_cpu_rehearsal else "")
    )
