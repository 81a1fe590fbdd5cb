"""The render path's copies between the host and the device, counted.

Every host-to-device copy the frame path makes (`rasterizer.py`,
`compose.py`, `frame.py`, the kernels' descriptor arrays, the renderer's
atlases) goes through `upload`, or `upload_fused` where a frame hands over
many arrays at once (the oversized path's tables and bins), and the
program's own reads of a frame back to the host through `readback` or
`count_readback`. The counts (`tracing.COUNTERS`: `upload.calls`,
`upload.bytes`, `upload.fused_calls`, `upload.fused_parts`,
`upload.staging_waits`, `readback.calls`, `readback.bytes`) are taken at
the call, on any device, so that a run on the CPU counts what a run on the
card would copy."""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..tracing import COUNTERS

# Every array of a fused blob starts at a multiple of this many bytes.
FUSED_ALIGN = 256


def upload(a: np.ndarray, device) -> torch.Tensor:
    """`a` as a tensor on `device` (`torch.from_numpy(a).to(device)`)."""
    COUNTERS["upload.calls"] += 1
    COUNTERS["upload.bytes"] += a.nbytes
    return torch.from_numpy(a).to(device)


def fused_offsets(arrays) -> tuple[list[int], int]:
    """The byte offset of each of `arrays` in one blob, each a multiple of
    FUSED_ALIGN, and the blob's size."""
    offsets, at = [], 0
    for a in arrays:
        offsets.append(at)
        at += -(-a.nbytes // FUSED_ALIGN) * FUSED_ALIGN
    return offsets, at


def _lay_out(host: np.ndarray, arrays, offsets) -> None:
    """Write `arrays` into the byte array `host` at `offsets`."""
    for a, at in zip(arrays, offsets):
        host[at:at + a.nbytes].view(a.dtype).reshape(a.shape)[...] = a


class _Staging:
    """A ring of two page-locked buffers for one card's fused uploads. A
    slot's event is recorded after its copy; the host waits on it before it
    writes the slot again, so no upload overwrites bytes the card has not
    read yet. A buffer grows, at least twofold, to the largest blob seen,
    and never shrinks."""

    def __init__(self):
        self.lock = threading.Lock()
        self.buffers = [torch.empty(0, dtype=torch.uint8) for _ in range(2)]
        self.events = [torch.cuda.Event() for _ in range(2)]
        self.next = 0

    def copy(self, arrays, offsets, size: int,
             device: torch.device) -> torch.Tensor:
        """`arrays` laid out at `offsets` in a blob of `size` bytes on
        `device`, by one copy on its current stream."""
        with self.lock:
            i = self.next
            self.next = (i + 1) % len(self.buffers)
            done = self.events[i]
            if not done.query():
                COUNTERS["upload.staging_waits"] += 1
                done.synchronize()
            buf = self.buffers[i]
            if buf.numel() < size:
                buf = self.buffers[i] = torch.empty(
                    max(size, 2 * buf.numel()), dtype=torch.uint8,
                    pin_memory=True)
            _lay_out(buf.numpy(), arrays, offsets)
            blob = torch.empty(size, dtype=torch.uint8, device=device)
            blob.copy_(buf[:size], non_blocking=True)
            done.record(torch.cuda.current_stream(device))
            return blob


_STAGING: dict[torch.device, _Staging] = {}


def upload_fused(arrays, device) -> tuple[torch.Tensor, ...]:
    """`arrays` on `device` by one copy of one blob → a contiguous view of
    the blob for each, of its shape and dtype (each at an offset of
    `fused_offsets`). On a CUDA card the blob is written into a reused
    page-locked buffer (`_Staging`) and copied without blocking on the
    current stream; elsewhere it is a host blob moved by `.to(device)`.
    Counted as one upload of the blob's bytes."""
    device = torch.device(device)
    offsets, size = fused_offsets(arrays)
    COUNTERS["upload.calls"] += 1
    COUNTERS["upload.bytes"] += size
    COUNTERS["upload.fused_calls"] += 1
    COUNTERS["upload.fused_parts"] += len(arrays)
    if device.type == "cuda":
        staging = _STAGING.get(device) \
            or _STAGING.setdefault(device, _Staging())
        blob = staging.copy(arrays, offsets, size, device)
    else:
        blob = torch.zeros(size, dtype=torch.uint8)
        _lay_out(blob.numpy(), arrays, offsets)
        blob = blob.to(device)
    typed: dict = {}
    views = []
    for a, at in zip(arrays, offsets):
        t = typed.get(a.dtype)
        if t is None:
            t = typed[a.dtype] = blob.view(_torch_dtype(a.dtype))
        views.append(t.as_strided(a.shape, _row_major(a.shape),
                                  at // a.itemsize))
    return tuple(views)


_TORCH_DTYPES: dict = {}


def _torch_dtype(dt: np.dtype) -> torch.dtype:
    t = _TORCH_DTYPES.get(dt)
    if t is None:
        t = _TORCH_DTYPES[dt] = torch.from_numpy(np.empty(0, dt)).dtype
    return t


def _row_major(shape: tuple) -> tuple:
    """The element strides of a contiguous array of `shape`."""
    strides, n = [], 1
    for d in reversed(shape):
        strides.append(n)
        n *= max(d, 1)
    return tuple(reversed(strides))


def count_readback(t: torch.Tensor) -> None:
    """`t` is about to be copied to the host by the caller."""
    COUNTERS["readback.calls"] += 1
    COUNTERS["readback.bytes"] += t.numel() * t.element_size()


def readback(t: torch.Tensor) -> np.ndarray:
    """`t` on the host, as numpy."""
    count_readback(t)
    return t.cpu().numpy()
