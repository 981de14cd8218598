"""The card's identity, as every measurement of the port records it."""

from __future__ import annotations

import subprocess


def card_line() -> str:
    """The first card's name and power limit, as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` prints them, e.g.
    "NVIDIA H100 80GB HBM3, 700.00 W". Raises where nvidia-smi is missing
    or fails."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]
