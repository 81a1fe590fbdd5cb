"""In-terminal presentation: live half-block truecolor frames + mouse.

Counterpart of `whisper_git_tpu/host/term_display.py`. The reference
presents through a Vulkan swapchain; without a display server the
interactive host presents the SAME rendered frames in the terminal: the
device-resident u8 frame is area-downsampled on its own device to a
(2·rows, cols) RGB grid (one text cell shows two vertical pixels via '▀'
with independent fg/bg), and only cells that changed since the previous
frame are re-emitted. Alongside, xterm SGR mouse tracking (DECSET
1002/1003/1006) feeds the Runner's hit-testing, which is what makes
click/double-click/right-click/wheel/hover work without a windowing stack.

The readback: on a CUDA frame, `show` (on the render thread) starts an
async copy of the grid into a pinned host buffer and records an event on
the render thread's current stream; the present thread waits on that
event before it reads. A small ring of pinned buffers serves the copies,
so a buffer the present thread is reading is never written. A CPU grid is
read directly.

Cell→pixel mapping is exact by construction: cell (col, row) covers
pixels [col·W/cols, (col+1)·W/cols) × [row·H/rows, (row+1)·H/rows).
"""

from __future__ import annotations

import os
import shutil
import sys
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

_ENTER = ("\x1b[?1049h"   # alt screen
          "\x1b[?25l"     # hide cursor
          "\x1b[?1002h"   # button-event mouse tracking (incl. drag)
          "\x1b[?1003h"   # any-motion tracking (hover)
          "\x1b[?1006h"   # SGR extended coordinates
          "\x1b[?1016h"   # SGR-Pixels: report PIXEL coordinates where
                           # supported (sub-cell precision for drags);
                           # unsupported terminals ignore it and keep 1006
          "\x1b[?2004h"   # bracketed paste
          "\x1b[?1016$p")  # DECRQM: ask whether 1016 actually took —
                            # the ?1016;1$y report flips pixel mapping on
_EXIT = ("\x1b[?2004l\x1b[?1016l\x1b[?1006l\x1b[?1003l\x1b[?1002l"
         "\x1b[?25h\x1b[?1049l")


def _downsample(frame_u8: torch.Tensor, rows2: int, cols: int
                ) -> torch.Tensor:
    """(H, W, 4) u8 → (rows2, cols, 3) u8, area-average on the frame's
    device: bilinear with antialiasing (what the reference's
    `jax.image.resize(..., "linear")` computes), + 0.5, clipped, cast."""
    rgb = frame_u8[..., :3].permute(2, 0, 1).unsqueeze(0).float()
    out = F.interpolate(rgb, size=(rows2, cols), mode="bilinear",
                        antialias=True, align_corners=False)
    return (out[0].permute(1, 2, 0) + 0.5).clamp(0, 255).to(
        torch.uint8).contiguous()


class _Readback:
    """A CUDA grid on its way to the host: the pinned buffer its copy lands
    in, the event recorded after the copy, and when the copy started."""

    __slots__ = ("buf", "event", "t")

    def __init__(self, buf: torch.Tensor, event, t: float):
        self.buf, self.event, self.t = buf, event, t


class TermDisplay:
    """Half-block frame presenter. Use as a context manager around the
    interactive loop; `show(frame)` presents one device frame."""

    # Pinned host buffers for the grids' copies: one the present thread
    # reads, one waiting in the mailbox, one for the next copy.
    RING = 3
    # A frame older than this, with a degraded host frame painted after
    # its copy started, is dropped unpresented: the screen does not step
    # back to a picture older than the approximation on it.
    STALE_PRESENT_S = 0.25

    def __init__(self, viewport: tuple[int, int], out=None):
        self.viewport = viewport
        self.out = out if out is not None else sys.stdout
        size = shutil.get_terminal_size((120, 40))
        self.cols = max(20, size.columns)
        self.rows = max(10, size.lines - 1)  # keep one line for the prompt
        self._prev: np.ndarray | None = None
        self._need_clear = False
        self._chip_drawn = False
        self.pixel_mouse = False          # SGR-Pixels (1016) confirmed
        self._px_size: tuple[int, int] | None = None
        # Async present: `show` hands the grid to a single-slot worker
        # (latest wins) so the render thread never blocks on the readback
        # or terminal writes — present-side stalls (a slow terminal) drop
        # frames instead of freezing the pipeline, like a mailbox-mode
        # swapchain.
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._pending = None
        self._closing = False
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._ring_shape: tuple | None = None
        self._free: list[torch.Tensor] = []
        # Terminal writes are serialized through _write_lock and gated by
        # _writes_stopped so __exit__ can restore the terminal even while
        # the present worker is stuck: once the flag is set, the worker's
        # late write is skipped instead of spraying escape sequences into
        # the restored shell.
        self._write_lock = threading.Lock()
        self._writes_stopped = False
        # Degraded host-side present (host/degraded.py): freshness of the
        # last DEVICE frame, counters, and a mutex serializing the two
        # producers' diff-emit state (_prev) — the present thread's device
        # frames vs the UI thread's host-rasterized cells.
        self._present_mutex = threading.Lock()
        self._created_t = time.monotonic()
        # Sixel mode (WGIT_SIXEL=1): pixel-accurate frames in terminals
        # with sixel graphics, instead of 2-pixel half-block cells. The
        # frame downsamples on its device to the terminal's pixel winsize
        # (or stays 1:1 when unknown/larger) and each present is a full
        # DCS stream, with the latest-wins mailbox absorbing the
        # backpressure. Half-block remains the default presentation.
        self.sixel = os.environ.get("WGIT_SIXEL") in ("1", "true")
        self._sixel_size: tuple[int, int] | None = None
        self._frame_size: tuple[int, int] | None = None
        self._last_device_present: float | None = None
        self._last_degraded_t = 0.0
        self._degraded_active = False
        self.degraded_frames = 0
        self.device_frames = 0
        self._stats_path = os.environ.get("WGIT_PRESENT_STATS")

    def __enter__(self):
        self.out.write(_ENTER)
        self.out.flush()
        self._thread = threading.Thread(target=self._present_loop,
                                        daemon=True, name="wgit-present")
        self._thread.start()
        return self

    def __exit__(self, *exc):
        with self._cv:
            self._closing = True
            self._cv.notify()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        # Even if the worker outlived the join timeout, stop its future
        # writes BEFORE restoring the screen.
        got = self._write_lock.acquire(timeout=1.0)
        self._writes_stopped = True
        try:
            self.out.write(_EXIT)
            self.out.flush()
        finally:
            if got:
                self._write_lock.release()
        if self._stats_path:
            self._write_stats()

    def check(self) -> None:
        """Raise the error that stopped the present thread (a failed
        readback from the device), if one did."""
        if self._error is not None:
            raise self._error

    # -- coordinates -----------------------------------------------------

    def set_pixel_mouse(self, enabled: bool) -> None:
        """Flip SGR-Pixels (DECSET 1016) coordinate mapping, confirmed by
        the terminal's DECRQM report. Needs the kernel's pixel winsize
        (TIOCGWINSZ xpixel/ypixel) to translate terminal pixels → app
        pixels; terminals that report 0 stay on cell mapping."""
        self.pixel_mouse = False
        if not enabled:
            return
        px = self._query_px_size()
        if px is not None:
            self._px_size = px
            self.pixel_mouse = True

    def _query_px_size(self) -> tuple[int, int] | None:
        """Kernel pixel winsize (TIOCGWINSZ xpixel/ypixel), or None when
        the terminal doesn't report one."""
        try:
            import fcntl
            import struct
            import termios

            buf = fcntl.ioctl(self.out.fileno(), termios.TIOCGWINSZ,
                              b"\0" * 8)
            _r, _c, xp, yp = struct.unpack("HHHH", buf)
        except (OSError, ValueError, ImportError):
            return None
        return (xp, yp) if xp > 0 and yp > 0 else None

    def cell_to_px(self, col: int, row: int) -> tuple[float, float]:
        """1-based terminal coordinate → app pixel. Cell mode maps the
        cell center; pixel mode (SGR-Pixels 1016) maps sub-cell exactly,
        closing the ~8×16 px pointer quantization for divider drags and
        hunk buttons."""
        w, h = self.viewport
        if self.sixel and self._sixel_size is not None \
                and self._px_size is not None \
                and self._frame_size is not None:
            # The aspect-fit sixel image occupies tw×th TERMINAL pixels
            # from the origin — clicks map through the image extent,
            # not the full cell grid (a half-screen image would
            # otherwise land every click ~2× off). With SGR-Pixels the
            # event already carries terminal pixels.
            th, tw = self._sixel_size
            fh, fw = self._frame_size
            if self.pixel_mouse:
                tpx, tpy = col - 0.5, row - 0.5
            else:
                size = shutil.get_terminal_size((120, 40))
                xp, yp = self._px_size
                tpx = (col - 0.5) * xp / max(size.columns, 1)
                tpy = (row - 0.5) * yp / max(size.lines, 1)
            s = tw / max(fw, 1)
            return (min(tpx / max(s, 1e-6), float(w)),
                    min(tpy / max(s, 1e-6), float(h)))
        if self.pixel_mouse and self._px_size is not None:
            size = shutil.get_terminal_size((120, 40))
            xp, yp = self._px_size
            # The frame occupies self.rows of size.lines terminal rows;
            # terminal pixels span ALL rows.
            frame_h_px = yp * self.rows / max(size.lines, self.rows + 1)
            return ((col - 0.5) * w / max(xp, 1),
                    (row - 0.5) * h / max(frame_h_px, 1.0))
        return ((col - 0.5) * w / self.cols,
                (row - 0.5) * h / self.rows)

    def banner(self, text: str) -> None:
        """Host-side status line into the (otherwise empty) alt screen
        before the first device frame lands — the first present paints
        every cell (prev is None → full repaint), erasing it. Keeps the
        screen talking while the first frame builds the kernels."""
        with self._write_lock:
            if self._writes_stopped:
                return
            self.out.write(
                f"\x1b[2;3H\x1b[38;2;120;140;160m{text[:self.cols - 4]}"
                "\x1b[0m")
            self.out.flush()

    # -- presentation ------------------------------------------------------

    def _refresh_size(self) -> None:
        """Track terminal resizes (cheap enough per frame that no SIGWINCH
        handler is needed): a size change forces a full repaint and keeps
        cell→pixel mouse mapping correct."""
        size = shutil.get_terminal_size((120, 40))
        cols = max(20, size.columns)
        rows = max(10, size.lines - 1)
        if cols != self.cols or rows != self.rows:
            with self._cv:
                self.cols, self.rows = cols, rows
                self._prev = None
                stale, self._pending = self._pending, None  # drop it
                self._need_clear = True  # old cells may lie outside
            self._give_back(stale)
            if self.pixel_mouse:
                # The pixel winsize changed with the window: re-query so
                # SGR-Pixels mouse coordinates keep mapping correctly.
                px = self._query_px_size()
                if px is not None:
                    self._px_size = px

    def _sixel_target(self, frame_shape) -> tuple[int, int]:
        """Output pixel size for sixel mode: fit the frame into the
        terminal's pixel winsize MINUS the reserved prompt line (a
        full-height image would scroll the screen every present on
        terminals with sixel scrolling enabled, the common default);
        1:1 when the winsize is unknown or larger. Uses the cached
        pixel winsize (_refresh_size re-queries on resize)."""
        fh, fw = int(frame_shape[0]), int(frame_shape[1])
        if self._px_size is None:
            self._px_size = self._query_px_size()
        px = self._px_size
        if px is None:
            return fh, fw
        xp, yp = px
        size = shutil.get_terminal_size((120, 40))
        yp_eff = int(yp * self.rows / max(size.lines, self.rows + 1))
        if xp >= fw and yp_eff >= fh:
            return fh, fw
        s = min(xp / fw, yp_eff / fh)
        return max(6, int(fh * s)), max(8, int(fw * s))

    def show(self, frame_device: torch.Tensor) -> None:
        """Queue one device frame for presentation (latest wins). The
        downsample and, on CUDA, the copy into a pinned buffer are
        enqueued here, on the caller's current stream; the wait for the
        copy and the terminal emit run on the present thread. Without the
        thread (tests), presents synchronously. Raises the error that
        stopped the present thread, if one did."""
        self.check()
        self._refresh_size()
        if self.sixel:
            th, tw = self._sixel_target(frame_device.shape)
            self._sixel_size = (th, tw)
            self._frame_size = (int(frame_device.shape[0]),
                                int(frame_device.shape[1]))
            grid = _downsample(frame_device, th, tw)
        else:
            grid = _downsample(frame_device, self.rows * 2, self.cols)
        item = self._start_readback(grid) if grid.is_cuda else grid
        if self._thread is None:
            self._present(item)
            self._give_back(item)
            return
        with self._cv:
            old, self._pending = self._pending, item
            self._cv.notify()
        # The frame it replaces was never read; its buffer's copy is
        # ordered before any later copy on the same stream.
        self._give_back(old)

    def _start_readback(self, grid: torch.Tensor) -> _Readback:
        """Copy a CUDA grid into a free pinned buffer of the ring, and
        record an event after the copy on the current stream. The ring is
        reallocated when the grid's shape changes (a terminal resize, a
        sixel target); buffers still held keep their old shape and are
        dropped when given back."""
        shape = tuple(grid.shape)
        with self._cv:
            if shape != self._ring_shape:
                self._ring_shape = shape
                self._free = [torch.empty(shape, dtype=torch.uint8,
                                          pin_memory=True)
                              for _ in range(self.RING)]
            # At most two buffers are held (one read, one waiting), so
            # the ring of three always has a free one.
            buf = self._free.pop()
        buf.copy_(grid, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(grid.device))
        return _Readback(buf, event, time.monotonic())

    def readback(self, grid: torch.Tensor) -> np.ndarray:
        """A grid on the host through the presenter's own path (on CUDA
        the pinned ring's copy and its event, waited on here): what a
        present does before it emits."""
        item = self._start_readback(grid) if grid.is_cuda else grid
        host = np.array(self._fetch(item))
        self._give_back(item)
        return host

    def _give_back(self, item) -> None:
        if isinstance(item, _Readback):
            with self._cv:
                if tuple(item.buf.shape) == self._ring_shape:
                    self._free.append(item.buf)

    def _present_loop(self) -> None:
        while True:
            with self._cv:
                while self._pending is None and not self._closing:
                    self._cv.wait(timeout=0.5)
                item, self._pending = self._pending, None
            if item is None:   # closing, mailbox drained
                return
            t = getattr(item, "t", None)
            if t is not None and self._degraded_active \
                    and self._last_degraded_t > t and not self._closing \
                    and time.monotonic() - t > self.STALE_PRESENT_S:
                # Stale, with a degraded host frame painted after its copy
                # started: drop rather than step back to the past.
                self._give_back(item)
                continue
            try:
                self._present(item)
            except Exception as exc:   # a failed readback: surfaced by
                self._error = exc      # check() on the loop's threads
                return
            self._give_back(item)

    @staticmethod
    def _fetch(item) -> np.ndarray:
        """The grid on the host: wait for a pinned copy's event, read a
        CPU tensor directly."""
        if isinstance(item, _Readback):
            item.event.synchronize()
            return item.buf.numpy()
        if isinstance(item, torch.Tensor):
            return item.numpy()
        return np.asarray(item)

    def _present(self, item) -> None:
        grid = self._fetch(item)
        if self.sixel:
            if self._sixel_size is not None \
                    and grid.shape[:2] != self._sixel_size:
                return  # stale-size frame
            self._present_sixel(grid)
            return
        if grid.shape != (self.rows * 2, self.cols, 3):
            return  # stale-size frame from before a terminal resize
        with self._present_mutex:
            if self._degraded_active:
                # Real pixels are back. The approximated cells live in
                # _prev, so the normal diff repaints exactly the cells
                # that differ; only the chip TEXT bypassed the cell
                # grid — force its row dirty so it is overwritten.
                self._degraded_active = False
                if self._chip_drawn:
                    self._chip_drawn = False
                    if self._prev is not None and len(self._prev):
                        self._prev[0] = 255 - self._prev[0]
            top, bot = grid[0::2], grid[1::2]
            prefix = ""
            if self._need_clear:
                self._need_clear = False
                prefix = "\x1b[2J"
            payload = prefix + self._diff_emit(top, bot)
            with self._write_lock:
                if self._writes_stopped:
                    return
                try:
                    self.out.write(payload)
                    self.out.flush()
                except OSError:
                    # EAGAIN or a partial write on the tty: drop this
                    # frame and repaint in full next time (a partial write
                    # may have landed).
                    self._prev = None
                    self._need_clear = True
                    return
            self._last_device_present = time.monotonic()
            self.device_frames += 1
            self._maybe_write_stats()

    # -- degraded host-side present (host/degraded.py) ---------------------

    def device_frame_age(self) -> float:
        """Seconds since the last DEVICE frame reached the terminal
        (since construction when none has yet — the first frame)."""
        t = self._last_device_present
        return time.monotonic() - (self._created_t if t is None else t)

    def degraded_grid_size(self) -> tuple[int, int]:
        """(rows, cols) the degraded rasterizer should produce: the
        half-block cell grid normally; in sixel mode HALF the image
        target (a cell-grid paint would overlay glyphs onto the image;
        full resolution would put ~100× the raster area plus the
        encode on the UI thread — the present path integer-upscales).
        Before the first device frame the target derives from the
        viewport, so the warmup preview fills the screen rather than
        rendering at postage-stamp cell size."""
        if self.sixel:
            if self._sixel_size is None:
                w, h = self.viewport
                self._sixel_size = self._sixel_target((int(h), int(w)))
                self._frame_size = (int(h), int(w))
            th, tw = self._sixel_size
            return max(6, th // 2), max(8, tw // 2)
        return self.rows * 2, self.cols

    def presented_since(self, t: float) -> bool:
        """Has a DEVICE frame reached the terminal since monotonic t?
        (The loop's overdue-post detector: an idle screen whose last
        posted frame was presented is current — never degrade it.)"""
        p = self._last_device_present
        return p is not None and p >= t

    def present_host_cells(self, grid: np.ndarray,
                           chip: str | None = None) -> None:
        """Present a host-rasterized (rows*2, cols, 3) u8 cell grid from
        the UI thread — the degraded path while no device frame is
        coming. Serialized with device presents; the optional `chip`
        text overlays the top-right corner (cleared by the full repaint
        the next device frame triggers)."""
        if self.sixel:
            self._present_host_sixel(grid, chip)
            return
        if grid.shape != (self.rows * 2, self.cols, 3):
            return  # terminal resized since the caller sampled dims
        # Bounded acquire: the present thread can hold this mutex while
        # blocked in a slow terminal write — the UI thread must drop
        # the degraded frame rather than wait behind it.
        if not self._present_mutex.acquire(timeout=0.05):
            return
        try:
            top, bot = grid[0::2], grid[1::2]
            prefix = ""
            if self._need_clear:
                # A truncated earlier write may have left a dangling
                # escape on the wire — the degraded path itself must emit
                # the recovery clear (a device frame may not be coming
                # for a while).
                self._need_clear = False
                self._prev = None
                prefix = "\x1b[2J"
            payload = prefix + self._diff_emit(top, bot)
            if chip:
                chip = chip[:max(0, self.cols - 2)]
                col = max(1, self.cols - len(chip) - 1)
                payload += (f"\x1b[1;{col}H\x1b[48;2;120;84;20m"
                            f"\x1b[38;2;255;226;150m{chip}\x1b[0m")
                self._chip_drawn = True
            # This runs on the UI THREAD (the present thread may be
            # mid-write) — a full tty buffer or a held write lock must
            # DROP the frame, not block input. Bounded lock + bounded
            # non-blocking write; a truncated payload (mid-escape)
            # forces a full clear+repaint on the next present.
            if not self._write_lock.acquire(timeout=0.05):
                self._prev = None   # diff state updated but not emitted
                self._need_clear = True
                return
            try:
                if self._writes_stopped:
                    return
                if not self._write_bounded(payload, budget_s=0.05):
                    self._prev = None
                    self._need_clear = True
                    return
            finally:
                self._write_lock.release()
            self._degraded_active = True
            self._last_degraded_t = time.monotonic()
            self.degraded_frames += 1
            self._maybe_write_stats()
        finally:
            self._present_mutex.release()

    def _present_host_sixel(self, grid: np.ndarray,
                            chip: str | None) -> None:
        """Degraded present in SIXEL mode: the approximation renders at
        the sixel pixel target and ships through the same DCS pipe (a
        half-block cell paint would overlay glyphs onto the image).
        UI-thread rules apply: bounded lock, bounded write."""
        from .sixel import encode_sixel

        if self._sixel_size is not None \
                and grid.shape[:2] != self._sixel_size:
            # Rasterized at a reduced resolution (degraded_grid_size
            # halves the target to keep the UI-thread raster+encode
            # bounded): integer-upscale to the image extent.
            th, tw = self._sixel_size
            gh, gw = grid.shape[:2]
            ky = max(1, -(-th // gh))
            kx = max(1, -(-tw // gw))
            if ky > 4 or kx > 4:
                return  # stale size from before a resize
            grid = np.repeat(np.repeat(grid, ky, axis=0), kx,
                             axis=1)[:th, :tw]
        payload = b"\x1b[H" + encode_sixel(grid[..., :3])
        if chip:
            payload += (f"\x1b[1;1H\x1b[48;2;120;84;20m"
                        f"\x1b[38;2;255;226;150m{chip}\x1b[0m"
                        ).encode()
        if not self._present_mutex.acquire(timeout=0.05):
            return
        try:
            if self._need_clear:
                self._need_clear = False
                payload = b"\x1b[2J" + payload
            if not self._write_lock.acquire(timeout=0.05):
                return
            try:
                if self._writes_stopped:
                    return
                if not self._write_bounded(payload, budget_s=0.2):
                    self._need_clear = True
                    return
            finally:
                self._write_lock.release()
            self._degraded_active = True
            self._last_degraded_t = time.monotonic()
            self.degraded_frames += 1
            self._maybe_write_stats()
        finally:
            self._present_mutex.release()

    def _write_bounded(self, payload, budget_s: float) -> bool:
        """Write `payload` (str or bytes) without ever blocking longer
        than `budget_s` (O_NONBLOCK + select). Returns False when
        truncated/abandoned. Non-fd outputs (StringIO in tests) write
        directly."""
        import fcntl
        import select as _select

        try:
            fd = self.out.fileno()
        except (AttributeError, OSError, ValueError):
            self.out.write(payload if isinstance(payload, str)
                           else payload.decode("latin-1"))
            self.out.flush()
            return True
        try:
            self.out.flush()
        except OSError:
            pass
        data = payload if isinstance(payload, bytes) else payload.encode()
        deadline = time.monotonic() + budget_s
        flags = fcntl.fcntl(fd, fcntl.F_GETFL)
        fcntl.fcntl(fd, fcntl.F_SETFL, flags | os.O_NONBLOCK)
        try:
            off = 0
            while off < len(data):
                try:
                    off += os.write(fd, data[off:off + 65536])
                except BlockingIOError:
                    remain = deadline - time.monotonic()
                    if remain <= 0:
                        return off == len(data)
                    _select.select([], [fd], [], remain)
                except OSError:
                    return False
            return True
        finally:
            fcntl.fcntl(fd, fcntl.F_SETFL, flags)

    def _write_stats(self) -> None:
        try:
            import json

            with open(self._stats_path, "w") as f:
                json.dump({"degraded_frames": self.degraded_frames,
                           "device_frames": self.device_frames}, f)
        except OSError:
            pass

    def _maybe_write_stats(self) -> None:
        """Present counters for a soak harness (WGIT_PRESENT_STATS):
        rewritten every few presents and on exit — cheap, atomic-ish
        (single small write)."""
        if not self._stats_path:
            return
        total = self.degraded_frames + self.device_frames
        if total % 20 and not self._closing:
            return
        self._write_stats()

    def _present_sixel(self, grid: np.ndarray) -> None:
        """Full-frame sixel present: home the cursor and emit one DCS
        stream (host/sixel.py). No cell diffing — sixel terminals
        replace the image region wholesale."""
        from .sixel import encode_sixel

        payload = b"\x1b[H" + encode_sixel(grid[..., :3])
        with self._present_mutex:
            if self._need_clear:
                # Resize / truncated write: stale content outside the
                # image never gets overwritten by the image itself.
                self._need_clear = False
                payload = b"\x1b[2J" + payload
            with self._write_lock:
                if self._writes_stopped:
                    return
                if not self._write_bounded(payload, budget_s=1.0):
                    self._need_clear = True
                    return
            self._last_device_present = time.monotonic()
            self.device_frames += 1
            self._maybe_write_stats()

    def _diff_emit(self, top: np.ndarray, bot: np.ndarray) -> str:
        """Emit only cells whose colors changed since the previous frame."""
        cur = np.concatenate([top, bot], axis=-1)  # (rows, cols, 6)
        prev = self._prev
        self._prev = cur
        chunks: list[str] = []
        if prev is None or prev.shape != cur.shape:
            dirty_rows = range(cur.shape[0])
        else:
            changed = (cur != prev).any(axis=-1)
            dirty_rows = np.nonzero(changed.any(axis=1))[0]
        for r in dirty_rows:
            chunks.append(f"\x1b[{r + 1};1H")
            chunks.append(self._row_str(top[r], bot[r]))
        return "".join(chunks)

    @staticmethod
    def _row_str(top_row: np.ndarray, bot_row: np.ndarray) -> str:
        parts = []
        last_fg = last_bg = None
        for (tr, tg, tb), (br, bg_, bb) in zip(top_row.tolist(),
                                               bot_row.tolist()):
            fg = (tr, tg, tb)
            bg = (br, bg_, bb)
            if fg != last_fg:
                parts.append(f"\x1b[38;2;{tr};{tg};{tb}m")
                last_fg = fg
            if bg != last_bg:
                parts.append(f"\x1b[48;2;{br};{bg_};{bb}m")
                last_bg = bg
            parts.append("▀")
        parts.append("\x1b[0m")
        return "".join(parts)


def display_enabled() -> bool:
    want = os.environ.get("WGIT_TERM_DISPLAY")
    if want is not None:
        return want not in ("0", "false", "")
    return sys.stdout.isatty()
