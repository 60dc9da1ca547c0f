"""The device a measurement runs on, as every recorded number names it."""

from __future__ import annotations

import subprocess

import jax


def device_report() -> dict:
    """JAX's first device (platform, kind, device count) and the card's name
    and power limit from ``nvidia-smi`` — a card set below its maximum power
    runs slower under load, so every number carries both."""
    d = jax.devices()[0]
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        card = "not available"
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices()), "card": card}


def hardware_label() -> str:
    """One-line device label for result files."""
    dev = device_report()
    return f"{dev['count']}x {dev['kind']} ({dev['platform']}; {dev['card']})"
