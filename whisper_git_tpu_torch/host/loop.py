"""Frame loop driver — the windowed host's event loop without a display.

Counterpart of `whisper_git_tpu/host/loop.py`. The reference's Host
(src/host.rs) waits on winit events and timer deadlines
(`ControlFlow::WaitUntil`, next_wake — host.rs:46-50,206-219), translates
pointer/keyboard input through `Runner` hit-testing (host.rs:268-301),
then runs before_build → build → render → present. Without a display
server the loop drives the same protocol through the terminal: it blocks
on the EventLoopProxy doorbell with a timer-derived timeout, polls the
async engine, rebuilds and lays out the El tree through the Runner,
routes terminal keys AND xterm SGR mouse events (click / double-click /
right-click / wheel / hover) through the same string-routed dispatch as
the windowed design, and presents frames either live in the terminal
(half-block truecolor, see term_display) or to a PNG (WGIT_FRAME_DUMP).

Every device dispatch runs on one render thread, on the device the
caller chose (`device`, default cuda): the scene compile's uploads,
`render_scene_device`, the presenter's downsample and copy, and the
kernels' nvcc builds at their first launch. On a machine with several
cards the renderer shards each frame over all of them
(`render/meshstate.py`); the thread's current card stays the first, and
each shard's launch switches to its own card and back
(`render/raster_kernel.py::launch_on`). The frame is gathered onto the
renderer's card, where the presenter downsamples it and records its
copy's event on that card's stream.
"""

from __future__ import annotations

import os
import threading
import time

from ..app.ui_app import WhisperApp
from ..engine import EventLoopProxy

FRAME_TIMEOUT = 1.0  # safety-net cadence needs periodic wakeups
BLINK_TIMEOUT = 0.25  # caret flips every 0.5 s; wake at quarter phase so
                      # an idle focused input still blinks (reference
                      # README.md:14 does continuous redraw for this)
PULSE_TIMEOUT = 0.15  # dirty-indicator pulse animation cadence


def next_wake_timeout(app: WhisperApp, now: float) -> float:
    """Earliest timer deadline (reference: HostApp::next_wake).
    Animation deadlines: busy-op spinners, toast lifetime/fade, and the
    caret blink while any text input is focused all pull the wake down
    to 0.25 s; a fully idle frame sleeps the 1 s safety-net cadence."""
    timeout = FRAME_TIMEOUT
    for tab in app.tabs:
        if tab.busy_slots():
            timeout = min(timeout, BLINK_TIMEOUT)  # live spinner elapsed
    if app.toasts:
        timeout = min(timeout, BLINK_TIMEOUT)  # lifetime expiry + fade
    if app.focused_input:
        timeout = min(timeout, BLINK_TIMEOUT)  # caret blink phase
    # "The Pulse": the header dirty dot breathes while the focused
    # worktree has changes (design_feedback_feb2026.md:339). 0.15 s steps
    # give ≥13 frames per cycle at the gentlest 2 s period; each frame
    # ships only the small volatile tail, so the cadence is cheap.
    tab = app.current()
    if tab is not None:
        view = tab.active_view()
        st = view.status if view is not None else None
        if st is not None and (st.staged or st.unstaged or st.untracked):
            timeout = min(timeout, PULSE_TIMEOUT)
    return timeout


def _route_mouse(app, runner, display, ev) -> bool:
    """Map one terminal MouseEvent into Runner dispatch. Returns True when
    the frame should re-render."""
    x, y = display.cell_to_px(ev.col, ev.row)
    if ev.kind == "down":
        if ev.button == "middle":
            app._focus_route_hit = False
        app.shift_click = bool(ev.shift)
        try:
            runner.pointer_down(x, y, button=ev.button)
        finally:
            app.shift_click = False
        if ev.button == "middle":
            # Middle-click pastes the PRIMARY selection into the input
            # under the click — and only there (reference:
            # src/host.rs:874-897); pointer_down just routed the
            # focus-input action if the click landed on one.
            app.paste_primary(at_click=True)
        return True
    if ev.kind == "wheel":
        step = 84.0  # one wheel click ≈ three rows; on_scroll applies the
        # Scroll Speed setting itself, like the windowed design.
        if ev.shift:
            # Shift+wheel: horizontal diff scroll (reference README,
            # "Diff Viewer — Shift+ScrollWheel").
            tab = app.current()
            if tab is not None and app.diff_open:
                tab.diff_hscroll = max(0.0,
                                       tab.diff_hscroll - ev.wheel * step)
        else:
            app.on_scroll(-ev.wheel * step, x, y)
        return True
    if ev.kind == "move":
        if ev.button != "none":  # drag: move with the button held
            return runner.pointer_drag(x, y)
        return runner.pointer_move(x, y)
    if ev.kind == "up":
        runner.pointer_up()
    return False


def _dump_ledger(path: str) -> None:
    """Write the cache ledger (ledger.py) and the kernels' build states to
    `path` as JSON."""
    import json

    from .. import ledger as _ledger
    from ..render.renderer import kernel_libraries

    snap = _ledger.snapshot()
    snap["_violations"] = _ledger.violations(snap)
    snap["_kernel_builds"] = {
        name: {"loaded": st["lib"] is not None, "built": st["built"],
               "seconds": round(st["seconds"], 3)}
        for name, st in kernel_libraries().items()}
    with open(path, "w") as lf:
        json.dump(snap, lf)


def run_loop(app: WhisperApp, max_frames: int | None = None,
             device="cuda") -> int:
    import sys

    proxy = EventLoopProxy()
    app.proxy = proxy
    dump_path = os.environ.get("WGIT_FRAME_DUMP")

    interactive = sys.stdin.isatty() and not os.environ.get("WGIT_NO_INPUT")
    term_ctx = term = None
    display_ctx = display = None
    renderer = None

    from ..ui.runner import Runner
    from .term_display import display_enabled

    want_display = interactive and display_enabled()
    if dump_path or want_display:
        # The renderer (and the device check) BEFORE the alt screen: a
        # device that cannot be had fails on the normal terminal.
        from ..render.renderer import get_renderer

        renderer = get_renderer(device)

    if interactive:
        from .term_display import TermDisplay
        from .term_input import TerminalInput

        term_ctx = TerminalInput()
        term = term_ctx.__enter__()
        if want_display:
            display_ctx = TermDisplay((int(app.config.window_width),
                                       int(app.config.window_height)))
            display = display_ctx.__enter__()
            names = ", ".join(t.title for t in app.tabs) or "welcome"
            display.banner(f"whisper-git-tpu — rendering {names}…")

    measurer = None
    if renderer is not None:
        measurer = getattr(renderer, "measurer", None)
    runner = Runner(app, measurer=measurer)

    frames = 0
    # WGIT_HEARTBEAT=path: append a monotonic timestamp ~4×/s from the
    # frame loop, and spawn a pure-HOST timer thread doing the same into
    # path+".host". An outside harness reads both:
    #   * host-thread gaps  → the PROCESS wedged (GIL hang, deadlock);
    #   * loop gaps with a healthy host thread → the UI thread stalled
    #     in build/layout/reducers — it is host-pure, since the render
    #     worker below owns every device dispatch;
    #   * presented-bytes stalls with a healthy loop → the render thread
    #     or the presenter fell behind (the mailbox dropped frames).
    hb_path = os.environ.get("WGIT_HEARTBEAT")
    hb_fd = None
    hb_last = 0.0
    hb_stop = None
    if hb_path:
        hb_fd = os.open(hb_path, os.O_WRONLY | os.O_CREAT | os.O_APPEND,
                        0o644)
        hb_stop = threading.Event()

        def _host_beat(stop=hb_stop, path=hb_path + ".host"):
            fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND,
                         0o644)
            try:
                while not stop.is_set():
                    os.write(fd, f"{time.monotonic():.3f}\n".encode())
                    stop.wait(0.25)
            finally:
                os.close(fd)

        threading.Thread(target=_host_beat, daemon=True,
                         name="wgit-heartbeat").start()
    # Scene compile + device render + present run on a RENDER THREAD with
    # a single-slot latest-wins mailbox, so the UI thread stays host-pure
    # — build, layout, input, reducers — and a slow frame (the first one
    # waits for the kernels' nvcc builds) drops frames instead of
    # freezing input.
    render_box: list = [None]
    render_err: list = []
    render_stop = [False]
    render_thread = None
    if renderer is not None:
        render_cv = threading.Condition()

        def _render_worker():
            from ..render.rasterizer import render_scene_device
            from ..ui.theme import DARK

            while True:
                with render_cv:
                    while render_box[0] is None and not render_stop[0]:
                        render_cv.wait(0.5)
                    work = render_box[0]
                    render_box[0] = None
                if work is None:   # stop requested, mailbox drained
                    return
                root_w, vw, vh = work
                try:
                    scene = renderer.compile(root_w, (vw, vh),
                                             DARK.background)
                    img = render_scene_device(
                        scene, renderer.font_tex_device(),
                        renderer.image_atlas_device())
                    if display is not None:
                        display.show(img)
                    if dump_path:
                        from ..render.renderer import save_png

                        save_png(img.cpu().numpy(), dump_path)
                except Exception as e:   # surfaced on the UI thread
                    render_err.append(e)
                    return

        render_thread = threading.Thread(target=_render_worker,
                                         daemon=True, name="wgit-render")
        render_thread.start()
    # Degraded host-side present (host/degraded.py): while no device frame
    # is coming the picture must stay live, not just the input loop. Two
    # triggers: an INPUT ECHO right after an interaction the device
    # present is already late for (the first frame, which waits for the
    # kernel builds, included), and an OVERDUE repaint cadence while a
    # POSTED frame is late (an idle screen whose last post WAS presented
    # is current — never degrade it). The next device frame swaps the
    # real pixels back in.
    ECHO_AFTER_S = 0.08
    OUTAGE_AFTER_S = 0.25
    last_degraded_paint = 0.0
    last_post_t = None
    had_input = False
    # WGIT_LEDGER=path: dump the aggregate cache ledger (ledger.py) every
    # ~5 s, with the kernels' build states.
    ledger_path = os.environ.get("WGIT_LEDGER")
    ledger_last = 0.0
    # WGIT_TRACEMALLOC=path: python-allocation growth attribution —
    # snapshot at start-of-loop, write the top deltas to `path` at each
    # housekeeping tick (RSS-creep bisection; ~2x alloc overhead).
    tm_path = os.environ.get("WGIT_TRACEMALLOC")
    tm_base = None
    if tm_path:
        import tracemalloc

        tracemalloc.start(8)
    # Interactive GC policy (host/gctune.py): gen2 pauses deferred to
    # idle ticks.
    from .gctune import idle_gc_tick, install_interactive_gc

    install_interactive_gc()
    last_input_t = time.monotonic()
    try:
        while not app.quit_requested:
            if hb_fd is not None:
                now_hb = time.monotonic()
                if now_hb - hb_last >= 0.25:
                    hb_last = now_hb
                    os.write(hb_fd, f"{now_hb:.3f}\n".encode())
            if time.monotonic() - ledger_last >= 5.0:
                ledger_last = time.monotonic()
                if ledger_path:
                    try:
                        _dump_ledger(ledger_path)
                    except Exception:
                        pass  # observability must never take the loop down
                if tm_path:
                    try:
                        import tracemalloc

                        snap = tracemalloc.take_snapshot().filter_traces(
                            [tracemalloc.Filter(False, tracemalloc.__file__)])
                        if tm_base is None:
                            tm_base = snap
                        else:
                            diff = snap.compare_to(tm_base, "lineno")
                            with open(tm_path, "w") as tf:
                                for st in diff[:25]:
                                    tf.write(f"{st.size_diff / 1024:.0f} KB "
                                             f"(+{st.count_diff}) "
                                             f"{st.traceback}\n")
                    except Exception:
                        pass
                idle_gc_tick(time.monotonic() - last_input_t > 1.0)
                try:
                    # Return freed glibc arena pages to the OS: the
                    # frame cadence churns small numpy buffers and the
                    # allocator otherwise keeps the high-water mark
                    # resident forever (RSS creep that is fragmentation,
                    # not live data).
                    import ctypes

                    ctypes.CDLL("libc.so.6").malloc_trim(0)
                except Exception:
                    pass
            if render_err:
                raise render_err[0]
            if display is not None:
                display.check()   # a failed readback ends the run
            app.before_build()
            viewport = (float(app.config.window_width),
                        float(app.config.window_height))
            root = runner.prepare(viewport)
            if render_thread is not None:
                # Was the render pipeline BEHIND before this post? (The
                # previous posted frame still unpresented — the echo
                # trigger below must key on genuine lag, not on
                # time-since-last-present, which grows during healthy
                # IDLE and would flash approximations on every
                # keystroke after a pause.)
                nowd = time.monotonic()
                pipeline_behind = (
                    display is not None and last_post_t is not None
                    and not display.presented_since(last_post_t)
                    and nowd - last_post_t > ECHO_AFTER_S)
                with render_cv:
                    render_box[0] = (root, int(viewport[0]),
                                     int(viewport[1]))
                    render_cv.notify()
                if last_post_t is None \
                        or display is None \
                        or display.presented_since(last_post_t):
                    last_post_t = time.monotonic()
            else:
                pipeline_behind = False
            if display is not None:
                nowd = time.monotonic()
                warming = display.device_frames == 0
                # How long the CURRENT content has been waiting (the
                # oldest unpresented post) — the honest stall age.
                wait_s = (nowd - last_post_t
                          if last_post_t is not None else 0.0)
                overdue = (last_post_t is not None
                           and not display.presented_since(last_post_t)
                           and wait_s > OUTAGE_AFTER_S)
                # Sixel-mode degraded paints cost ~10× a cell-grid one
                # (reduced-res raster + encode on the UI thread):
                # rate-limit accordingly.
                echo_gap = 0.25 if display.sixel else 0.03
                echo = (had_input and (warming or pipeline_behind)
                        and nowd - last_degraded_paint > echo_gap)
                if echo or (overdue
                            and nowd - last_degraded_paint > 0.15):
                    from ..ui.theme import DARK
                    from .degraded import rasterize_cells

                    if warming and wait_s > 0.5:
                        chip = (f" ◈ first frame {wait_s:.0f}s (kernel "
                                "builds) — approximate preview ")
                    elif overdue and wait_s > 0.5:
                        chip = (f" ◈ frame late {wait_s:.0f}s — "
                                "approximate ")
                    else:
                        chip = None
                    gr, gc = display.degraded_grid_size()
                    grid = rasterize_cells(root, viewport, gr, gc,
                                           DARK.background)
                    display.present_host_cells(grid, chip)
                    last_degraded_paint = time.monotonic()
            had_input = False
            frames += 1
            if max_frames is not None and frames >= max_frames:
                break
            timeout = next_wake_timeout(app, time.monotonic())
            if term is not None:
                from .term_input import (
                    KeyEvent,
                    ModeReport,
                    PasteEvent,
                    dispatch,
                )

                # Drain input while waiting out the frame budget; any event
                # or doorbell ends the wait and re-renders.
                deadline = time.monotonic() + timeout
                need_frame = False
                while time.monotonic() < deadline:
                    ev = term.poll(timeout=min(
                        0.05, max(0.0, deadline - time.monotonic())))
                    if ev is not None:
                        if isinstance(ev, ModeReport):
                            if ev.mode == 1016 and display is not None:
                                display.set_pixel_mouse(ev.value in (1, 3))
                            continue
                        if isinstance(ev, (KeyEvent, PasteEvent)):
                            dispatch(app, ev)
                            need_frame = True
                        elif display is not None:
                            need_frame = _route_mouse(app, runner, display,
                                                      ev) or need_frame
                        if need_frame:
                            had_input = True
                            last_input_t = time.monotonic()
                            break
                    if proxy.pending():
                        break
                if not need_frame:
                    proxy.wait(timeout=0.0)
            else:
                proxy.wait(timeout=timeout)
    finally:
        if render_thread is not None:
            # Let the pending frame finish (the dump path's consumers
            # read the file after run_loop returns), then stop.
            with render_cv:
                render_stop[0] = True
                render_cv.notify()
            # A frame-dump consumer reads the file after run_loop
            # returns, and the final frame may still be waiting for the
            # kernels' first build — wait it out. A live display's worker
            # gets a short grace instead: the display teardown gates its
            # late writes.
            render_thread.join(timeout=120.0 if dump_path else 8.0)
        if hb_stop is not None:
            hb_stop.set()
        if hb_fd is not None:
            os.close(hb_fd)
        if display_ctx is not None:
            display_ctx.__exit__(None, None, None)
        if term_ctx is not None:
            term_ctx.__exit__(None, None, None)
        for tab in app.tabs:
            tab.stop_workers()
    # An error on the FINAL frame has no next loop iteration to surface
    # it — a frame-dump run would otherwise "succeed" with no dump
    # written. (Checked after teardown so the terminal is restored; an
    # exception already propagating out of the try re-raises itself.)
    if render_err:
        raise render_err[0]
    if display is not None:
        display.check()
    return 0
