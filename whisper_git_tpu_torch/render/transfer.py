"""The render path's copies between the host and the device, counted.

Every host-to-device copy the frame path makes (`rasterizer.py`,
`compose.py`, `frame.py`, the kernels' descriptor arrays, the renderer's
atlases) goes through `upload`, and the program's own reads of a frame
back to the host through `readback` or `count_readback`. The counts
(`tracing.COUNTERS`: `upload.calls`, `upload.bytes`, `readback.calls`,
`readback.bytes`) are taken at the call, on any device, so that a run on
the CPU counts what a run on the card would copy."""

from __future__ import annotations

import numpy as np
import torch

from ..tracing import COUNTERS


def upload(a: np.ndarray, device) -> torch.Tensor:
    """`a` as a tensor on `device` (`torch.from_numpy(a).to(device)`)."""
    COUNTERS["upload.calls"] += 1
    COUNTERS["upload.bytes"] += a.nbytes
    return torch.from_numpy(a).to(device)


def count_readback(t: torch.Tensor) -> None:
    """`t` is about to be copied to the host by the caller."""
    COUNTERS["readback.calls"] += 1
    COUNTERS["readback.bytes"] += t.numel() * t.element_size()


def readback(t: torch.Tensor) -> np.ndarray:
    """`t` on the host, as numpy."""
    count_readback(t)
    return t.cpu().numpy()
