"""The port's terminal presenter (`host/term_display.py`) against the
reference's: the downsample within 1 u8, the half-block emit byte-equal,
the cell→pixel mapping equal (and the sixel mapping with SGR-Pixels
repaired), the banner, the latest-wins mailbox, the degraded present, and
the two kinds of failure: a terminal write error drops a frame, a failed
readback stops the presenter and raises."""

from __future__ import annotations

import io
import os
import shutil
import threading
import time
import unittest.mock as mock

import numpy as np
import pytest
import torch

from whisper_git_tpu.host import term_display as ref_td
from whisper_git_tpu_torch.host import term_display as port_td
from whisper_git_tpu_torch.host.sixel import decode_sixel

SIZES = [(78, 120), (96, 200), (60, 100), (450, 720), (800, 1280)]


def _frame(seed: int, h: int = 800, w: int = 1280) -> np.ndarray:
    """Seeded noise under flat panels and hard edges, like a UI frame."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    img[h // 4:h // 2, :] = (30, 34, 40, 255)
    img[:, w // 3:w // 3 + 3] = 255
    img[::17, :, 1] = 0
    return img


@pytest.mark.parametrize("rows2,cols", SIZES)
def test_downsample_within_1_u8_of_the_reference(rows2, cols):
    for seed in (0, 1):
        img = _frame(seed)
        want = np.asarray(ref_td._downsample(img, rows2, cols))
        got = port_td._downsample(torch.from_numpy(img), rows2, cols)
        assert got.dtype == torch.uint8 and got.is_contiguous()
        assert tuple(got.shape) == want.shape == (rows2, cols, 3)
        d = np.abs(got.numpy().astype(int) - want.astype(int))
        print(f"{rows2}x{cols} seed {seed}: max {d.max()} u8, "
              f"differing {(d > 0).mean():.6f}")
        assert d.max() <= 1


def test_downsample_1_to_1_is_the_frame():
    img = _frame(2, 64, 96)
    got = port_td._downsample(torch.from_numpy(img), 64, 96).numpy()
    assert np.array_equal(got, img[..., :3])


def test_row_str_and_diff_emit_byte_equal_to_the_reference():
    rng = np.random.default_rng(5)
    ref = ref_td.TermDisplay((64, 64), out=io.StringIO())
    port = port_td.TermDisplay((64, 64), out=io.StringIO())
    for d in (ref, port):
        d.cols, d.rows = 24, 6
    grid = rng.integers(0, 4, (12, 24, 3), dtype=np.uint8) * 60
    for step in range(6):
        top, bot = grid[0::2], grid[1::2]
        for r in range(6):
            assert port_td.TermDisplay._row_str(top[r], bot[r]) == \
                ref_td.TermDisplay._row_str(top[r], bot[r])
        assert port._diff_emit(top, bot) == ref._diff_emit(top, bot)
        grid = grid.copy()
        grid[rng.integers(0, 12), rng.integers(0, 24)] = step * 40


def _pair(monkeypatch, sixel: bool):
    if sixel:
        monkeypatch.setenv("WGIT_SIXEL", "1")
    else:
        monkeypatch.delenv("WGIT_SIXEL", raising=False)
    out = []
    for mod in (ref_td, port_td):
        d = mod.TermDisplay((1280, 800), out=io.StringIO())
        d.cols, d.rows = 120, 40
        d._px_size = (1200, 820)
        out.append(d)
    return out


CELLS = [(1, 1), (60, 20), (101, 10), (120, 40), (7, 33)]


def test_cell_to_px_equal_in_cell_and_pixel_mode(monkeypatch):
    ref, port = _pair(monkeypatch, sixel=False)
    term = os.terminal_size((120, 41))
    with mock.patch.object(shutil, "get_terminal_size", return_value=term):
        for pixel in (False, True):
            ref.pixel_mouse = port.pixel_mouse = pixel
            for col, row in CELLS:
                assert port.cell_to_px(col, row) == ref.cell_to_px(col, row)


def _sixel_pair(monkeypatch):
    ref, port = _pair(monkeypatch, sixel=True)
    for d in (ref, port):
        d._sixel_size = (410, 656)       # the image's terminal pixels
        d._frame_size = (800, 1280)
    return ref, port


def test_cell_to_px_sixel_without_sgr_pixels_equal(monkeypatch):
    """Cell coordinates map through the image extent, as the reference
    maps them."""
    ref, port = _sixel_pair(monkeypatch)
    term = os.terminal_size((120, 41))
    with mock.patch.object(shutil, "get_terminal_size", return_value=term):
        for col, row in CELLS:
            got = port.cell_to_px(col, row)
            assert got == ref.cell_to_px(col, row)
            s = 656 / 1280
            assert got[0] == pytest.approx(
                min((col - 0.5) * 1200 / 120 / s, 1280.0))


def test_cell_to_px_sixel_with_sgr_pixels_takes_terminal_pixels(
        monkeypatch):
    """With SGR-Pixels confirmed the event carries terminal pixels: they
    map through the image's scale directly (the reference multiplies them
    again by the cell size, 10x too far)."""
    ref, port = _sixel_pair(monkeypatch)
    ref.pixel_mouse = port.pixel_mouse = True
    s = 656 / 1280
    term = os.terminal_size((120, 41))
    with mock.patch.object(shutil, "get_terminal_size", return_value=term):
        for px, py in ((1, 1), (101, 57), (300, 200), (656, 410)):
            x, y = port.cell_to_px(px, py)
            assert x == pytest.approx((px - 0.5) / s)
            assert y == pytest.approx((py - 0.5) / s)
        # A click at terminal pixel (300, 200) of a 656-px-wide image
        # lands 584 px into the 1280-px frame; the reference's lands at
        # the frame's right edge.
        assert port.cell_to_px(300, 200)[0] == pytest.approx(584.3902439)
        assert ref.cell_to_px(300, 200)[0] == 1280.0


def test_banner_then_first_present_erases_it():
    out = io.StringIO()
    d = port_td.TermDisplay((64, 32), out=out)
    d.banner("whisper-git-tpu — rendering repo…")
    s = out.getvalue()
    assert "rendering repo…" in s and "\x1b[2;3H" in s
    d._present(np.zeros((d.rows * 2, d.cols, 3), np.uint8))
    assert out.getvalue()[len(s):].count("\x1b[") >= d.rows
    d._writes_stopped = True
    before = out.getvalue()
    d.banner("late banner")
    assert out.getvalue() == before


def _threaded(d):
    d._refresh_size = lambda: None
    d._thread = threading.Thread(target=d._present_loop, daemon=True)
    d._thread.start()


def _stop(d):
    with d._cv:
        d._closing = True
        d._cv.notify()
    d._thread.join(timeout=5.0)
    assert not d._thread.is_alive()


def test_present_latest_wins():
    """show() never blocks; while the presenter is stalled on one frame,
    each newer frame replaces the one waiting, so the frames in between
    are dropped and the newest lands."""
    d = port_td.TermDisplay((64, 64), out=io.StringIO())
    d.cols, d.rows = 8, 4
    presented, gate, entered = [], threading.Event(), threading.Event()
    orig = d._present

    def slow_present(item):
        entered.set()
        if not presented:
            gate.wait(timeout=3.0)
        presented.append(int(np.asarray(d._fetch(item))[0, 0, 0]))
        orig(item)

    d._present = slow_present
    _threaded(d)
    try:
        for shade in (5, 10, 20, 30, 40):
            t0 = time.monotonic()
            d.show(torch.full((64, 64, 4), shade, dtype=torch.uint8))
            assert time.monotonic() - t0 < 0.5
            assert entered.wait(timeout=3.0)   # the presenter holds 5
        gate.set()
        deadline = time.monotonic() + 3.0
        while time.monotonic() < deadline and presented[-1:] != [40]:
            time.sleep(0.02)
        assert presented == [5, 40]
        assert d.device_frames == 2
    finally:
        _stop(d)


class _Event:
    def __init__(self, exc=None):
        self.exc = exc

    def synchronize(self):
        if self.exc is not None:
            raise self.exc


def test_replaced_readback_gives_its_buffer_back():
    """A pinned buffer whose grid was replaced in the mailbox unread goes
    back to the ring; one of an older shape (a resize) is dropped."""
    d = port_td.TermDisplay((64, 64), out=io.StringIO())
    d.cols, d.rows = 8, 4
    _threaded(d)
    d._cv.acquire()   # hold the presenter off the mailbox
    try:
        d._ring_shape = (8, 8, 3)
        buf = torch.zeros((8, 8, 3), dtype=torch.uint8)
        d._pending = port_td._Readback(buf, _Event(), time.monotonic())
    finally:
        d._cv.release()
    try:
        d.show(torch.zeros((64, 64, 4), dtype=torch.uint8))
        assert d._free == [buf]
        d._give_back(port_td._Readback(torch.zeros((6, 8, 3),
                                                   dtype=torch.uint8),
                                       _Event(), 0.0))
        assert d._free == [buf]
    finally:
        _stop(d)


def test_degraded_present_chip_and_device_swap_back():
    out = io.StringIO()
    d = port_td.TermDisplay((64, 32), out=out)
    d.rows, d.cols = 8, 16
    d.present_host_cells(np.full((16, 16, 3), 40, np.uint8),
                         chip=" approx ")
    assert d.degraded_frames == 1 and d._degraded_active
    assert "approx" in out.getvalue()
    n0 = len(out.getvalue())
    d._present(torch.full((16, 16, 3), 40, dtype=torch.uint8))
    assert not d._degraded_active and d.device_frames == 1
    assert "\x1b[1;1H" in out.getvalue()[n0:], "chip row not repainted"
    d.present_host_cells(np.zeros((10, 10, 3), np.uint8))
    assert d.degraded_frames == 1   # a stale size is dropped


def test_stale_frame_after_a_degraded_paint_is_dropped():
    """A device frame whose copy started before a degraded paint, and is
    older than STALE_PRESENT_S, is not presented over the approximation."""
    d = port_td.TermDisplay((64, 32), out=io.StringIO())
    d.rows, d.cols = 8, 16
    d.present_host_cells(np.full((16, 16, 3), 40, np.uint8))
    t_old = d._last_degraded_t - d.STALE_PRESENT_S - 0.1
    d._ring_shape = (16, 16, 3)
    stale = port_td._Readback(torch.full((16, 16, 3), 9, dtype=torch.uint8),
                              _Event(), t_old)
    d._pending = stale
    _threaded(d)
    try:
        deadline = time.monotonic() + 2.0
        while time.monotonic() < deadline and stale.buf not in d._free:
            time.sleep(0.01)
        assert stale.buf in d._free and d.device_frames == 0
    finally:
        _stop(d)


def test_display_sixel_present_and_degraded(monkeypatch):
    monkeypatch.setenv("WGIT_SIXEL", "1")
    out = io.StringIO()
    d = port_td.TermDisplay((64, 32), out=out)
    frame = torch.zeros((32, 64, 4), dtype=torch.uint8)
    frame[..., 2] = 200
    frame[..., 3] = 255
    d.show(frame)   # no thread: presents synchronously
    s = out.getvalue()
    assert "\x1b[H" in s and "\x1bPq" in s and s.endswith("\x1b\\")
    assert d.device_frames == 1
    dec = decode_sixel(s[s.index("\x1bPq"):].encode("latin-1"))
    assert dec[..., 2].max() >= 180 and dec[..., 0].max() <= 3
    assert d.degraded_grid_size() == (16, 32)
    n0 = len(out.getvalue())
    d.present_host_cells(np.full((16, 32, 3), 150, np.uint8),
                         chip=" approx ")
    s = out.getvalue()[n0:]
    assert "\x1bPq" in s and "approx" in s and d.degraded_frames == 1


class _FlakyOut(io.StringIO):
    def __init__(self, fails: int):
        super().__init__()
        self.fails = fails

    def write(self, s):
        if self.fails:
            self.fails -= 1
            raise BlockingIOError(11, "Resource temporarily unavailable")
        return super().write(s)


def test_terminal_write_error_drops_the_frame():
    """EAGAIN on the tty: the frame is dropped, the next present repaints
    in full after a clear, nothing raises."""
    out = _FlakyOut(fails=1)
    d = port_td.TermDisplay((64, 32), out=out)
    d.rows, d.cols = 8, 16
    d._present(torch.full((16, 16, 3), 7, dtype=torch.uint8))
    assert d.device_frames == 0 and d._prev is None and d._need_clear
    d._present(torch.full((16, 16, 3), 7, dtype=torch.uint8))
    assert d.device_frames == 1
    assert out.getvalue().startswith("\x1b[2J")
    assert out.getvalue().count("▀") == 8 * 16
    d.check()   # nothing to raise


def test_readback_error_stops_the_presenter_and_raises():
    """A failed device readback is not swallowed frame after frame: the
    present thread stops, and check() and the next show() raise it."""
    d = port_td.TermDisplay((64, 32), out=io.StringIO())
    d.rows, d.cols = 8, 16
    boom = RuntimeError("CUDA error: an illegal memory access")
    d._ring_shape = (16, 16, 3)
    d._pending = port_td._Readback(torch.zeros((16, 16, 3),
                                               dtype=torch.uint8),
                                   _Event(boom), time.monotonic())
    _threaded(d)
    d._thread.join(timeout=5.0)
    assert not d._thread.is_alive() and d.device_frames == 0
    with pytest.raises(RuntimeError, match="illegal memory access"):
        d.check()
    with pytest.raises(RuntimeError, match="illegal memory access"):
        d.show(torch.zeros((32, 64, 4), dtype=torch.uint8))


def test_readback_on_the_cpu_reads_the_grid():
    d = port_td.TermDisplay((64, 32), out=io.StringIO())
    grid = port_td._downsample(torch.from_numpy(_frame(3, 32, 64)), 8, 16)
    host = d.readback(grid)
    assert isinstance(host, np.ndarray) and np.array_equal(host,
                                                           grid.numpy())
