"""The card a measurement runs on: refuse anything but a GPU, and read the
card's name and power limit."""
from __future__ import annotations

import subprocess

import jax


def require_gpu():
    """The first JAX device; SystemExit (exit code 1) unless it is a GPU.

    A measurement that finds no card fails instead of falling back to the
    CPU, whose times say nothing about the card.
    """
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX found {dev.platform} "
                         f"({dev.device_kind}); this runs only on a card")
    return dev


def card_lines() -> list[str]:
    """`name, power.limit` of each card, one line per card, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives
    them. A card set below its maximum power runs slower under load, so
    every number is kept beside this line."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]
