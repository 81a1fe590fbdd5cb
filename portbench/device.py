"""What a run says of its cards: the name and power limit as `nvidia-smi`
reads them, and the peak of device memory."""

from __future__ import annotations

import subprocess


def card_name(torch) -> str:
    """`torch.cuda.get_device_name()` of the first card."""
    return torch.cuda.get_device_name(0)


def power_limits() -> list:
    """Each card's power limit as `nvidia-smi` prints it ("700.00 W"), or
    [] where it cannot be read."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return []
    if res.returncode != 0:
        return []
    return [line.strip() for line in res.stdout.splitlines() if line.strip()]


def memory_peak_bytes(torch, cards: list) -> int:
    """`max_memory_allocated` of the fullest card."""
    return max(int(torch.cuda.max_memory_allocated(c)) for c in cards)
