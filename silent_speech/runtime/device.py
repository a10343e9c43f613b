"""What the program runs on: the device as JAX reports it, and the card.

Measurement paths (bench.py, chip_smoke.py) name the device beside every
number and refuse to run anywhere but a GPU: a CPU number must never stand
in for a card's.
"""

from __future__ import annotations

import subprocess

NVIDIA_SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"]


def device_info() -> dict:
    """{'platform', 'kind', 'count'} of the default backend's devices."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def card_info() -> str:
    """The cards' names and power limits from ``nvidia-smi``, one line per
    card, run as a child that never touches JAX."""
    try:
        out = subprocess.run(NVIDIA_SMI_QUERY, capture_output=True,
                             text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return "; ".join(line.strip() for line in out.splitlines() if line.strip())


def require_gpu() -> dict:
    """device_info(); raises SystemExit (exit code 1) when the default
    backend is not a GPU."""
    info = device_info()
    if info["platform"] != "gpu":
        raise SystemExit(
            f"no GPU: JAX's default backend is {info['platform']!r} "
            f"({info['kind']}); this measurement runs only on the card")
    return info
