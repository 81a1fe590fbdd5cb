"""Spans and counters of the port's frame path.

**Spans.** `span(name, **attrs)` is a context manager put where the work
happens: the app's input and build, layout, the scene compile, and each
step of `render_scene_device` (compose, frame cache, oversized path, mesh
shards), CPython's collections and the background workers. A span records
its name, its start and end, its parent (the innermost span open on the
same thread), its thread, the frame it belongs to and small integer
attributes (`hit`, `card`, `gen`).

Times are `time.perf_counter_ns()`: the clock the benchmark puts device
events on with its marker (`portbench/trace.py`), so program spans and the
device trace share one clock with no conversion.

Tracing is off until `enable()`. Off, `span()` makes one flag check and
returns the shared `NOOP` object: no span is made and nothing recorded.
On, spans are kept in memory, the newest `MAX_SPANS` of them, and leave it
only through `collect()` (a snapshot) or `write_chrome()` (Chrome
trace-event JSON, which Perfetto opens; `WGIT_TRACE=path` in `host/loop.py`
writes one at exit). No span synchronizes the device, launches device
work, or calls the profiler's or NVTX's ranges. While tracing is on, a
`gc.callbacks` hook records one `gc` span a collection (attribute `gen`).

**Frames.** `next_frame()` is called where the app starts building a
frame; the number travels with the work (`set_frame` on the render
thread). Each call also keeps the counters as the frame began in
`FRAME_LOG` (the newest `FRAME_LOG_LEN` frames), so that a reader holding
a window's host times takes the window's counts from it
(`counters_at`).

**Counters** are always on: plain int increments of `COUNTERS`, which
holds every name the program counts, under a fixed order. Modules register
their own counter dicts or getters by reference with `register_counters`
(as `ledger.register_dict` registers caches); `counters()` snapshots them
all, with CPython's collections by generation from `gc.get_stats()`.
"""

from __future__ import annotations

import gc
import itertools
import json
import threading
from collections import deque
from time import perf_counter_ns
from typing import NamedTuple

MAX_SPANS = 1 << 20
FRAME_LOG_LEN = 1 << 14

# Every counter the program increments; the order is FRAME_LOG's.
COUNTERS: dict = dict.fromkeys((
    # Which path served each `render_scene_device` call.
    "frames.composed", "frames.frame_cache", "frames.oversized",
    "frames.packed",
    # The compose path (`compose.prepare_compose_dispatch`).
    "compose.attempted", "compose.declined_subpixel", "compose.plan_hits",
    "compose.plan_builds", "compose.plan_slab_misses",
    "compose.layer_builds",
    # What the compose path's layer builds cost and what its caches drop:
    # the device pixels of every chrome group and slab K2 builds (the
    # layer's height times its width), and one count a least recently
    # used entry each cache evicts.
    "compose.built_px", "compose.slab_evictions", "compose.group_evictions",
    "compose.plan_evictions",
    # The volatile tails of composed frames (`compose.frame_tails`): shape
    # tails K3 decodes from the frame blob itself, and glyph or image
    # tails K2 pre-renders for it.
    "compose.tails_inline", "compose.tails_prerendered",
    # The frame cache's blocks (`frame.build_blocks`) that K2 resolves from
    # the frame blob itself: scroll windows, and volatile tails.
    "blocks.windows_inline", "blocks.tails_inline",
    # Host-to-device copies of the render path (`render/transfer.py`), and
    # its own device-to-host reads. A fused upload counts once in
    # `upload.calls`, and the arrays it carries in `upload.fused_parts`; a
    # staging wait is a fused upload that found its page-locked buffer
    # still being read by the card.
    "upload.calls", "upload.bytes", "upload.fused_calls",
    "upload.fused_parts", "upload.staging_waits", "readback.calls",
    "readback.bytes",
    # Frames whose device work a render mesh split (the compose path's
    # blend, the frame cache's launch), and the kernel launches its shards
    # made (a shard whose slice holds a row of the output launches one).
    "mesh.frames", "mesh.shard_launches",
    # Background workers started.
    "refresh.state_starts", "refresh.status_starts", "avatar.fetch_starts",
    "diff_stats.starts",
), 0)

_SOURCES: dict = {}   # name -> dict (by reference) or getter


class Span(NamedTuple):
    """One recorded span: its id, its parent's (None at a thread's top),
    name, start and end in ns of `perf_counter_ns`, thread ident, frame
    number and attributes."""
    sid: int
    parent: int | None
    name: str
    t0: int
    t1: int
    tid: int
    frame: int
    attrs: dict


class _NoSpan:
    """The span `span()` hands out while tracing is off."""
    __slots__ = ()

    def set(self, **attrs) -> None:
        pass


NOOP = _NoSpan()
# Its `with` methods are C-level callables, which the statement calls
# without a Python frame: `__enter__` returns NOOP; `__exit__` takes the
# three exception arguments and returns a new empty dict (false), so an
# exception passes on. A site runs no Python code but `span()` while off.
_NoSpan.__enter__ = itertools.repeat(NOOP).__next__
_NoSpan.__exit__ = type.__prepare__

_ON = False
_BUF: deque = deque(maxlen=MAX_SPANS)
_IDS = itertools.count(1)
_TLS = threading.local()
_FRAME = [0]          # the newest frame number
_RECORDED = [0]       # spans recorded since enable()
_ENABLED_AT = [0]     # when enable() was last called, in ns
FRAME_LOG: deque = deque(maxlen=FRAME_LOG_LEN)


def _thread_state() -> list:
    """[open spans, thread ident, frame number or None] of this thread."""
    try:
        return _TLS.st
    except AttributeError:
        st = _TLS.st = [[], threading.get_ident(), None]
        return st


class _Span:
    __slots__ = ("name", "attrs", "sid", "parent", "frame", "t0", "st")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        st = _thread_state()
        stack = st[0]
        self.parent = stack[-1].sid if stack else None
        self.sid = next(_IDS)
        self.frame = _FRAME[0] if st[2] is None else st[2]
        self.st = st
        stack.append(self)
        self.t0 = perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = perf_counter_ns()
        st = self.st
        st[0].pop()
        if _ON:
            _BUF.append((self.sid, self.parent, self.name, self.t0, t1,
                         st[1], self.frame, self.attrs))
            _RECORDED[0] += 1
        return False

    def set(self, **attrs) -> None:
        """Attributes known only inside the span (a cache hit)."""
        self.attrs.update(attrs)


def span(name: str, **attrs):
    """A span named `name` around a `with` block; `NOOP` while tracing is
    off."""
    if not _ON:
        return NOOP
    return _Span(name, attrs)


def next_frame() -> int:
    """A new frame starts on this thread: its number, which spans opened
    here carry from now on. The counters as it starts go to FRAME_LOG."""
    n = _FRAME[0] + 1
    _FRAME[0] = n
    _thread_state()[2] = n
    FRAME_LOG.append((perf_counter_ns(), n, tuple(COUNTERS.values())))
    return n


def set_frame(n: int) -> None:
    """Work of frame `n` continues on this thread (the render thread)."""
    _thread_state()[2] = n


def counters_at(t_ns: int) -> dict | None:
    """The counters of COUNTERS as the first frame that started at or
    after `t_ns` began, or None where FRAME_LOG holds no such frame or
    has dropped the frames before it."""
    log = list(FRAME_LOG)
    for k, (t, _, values) in enumerate(log):
        if t >= t_ns:
            if k == 0 and len(log) == FRAME_LOG.maxlen:
                return None
            return dict(zip(COUNTERS, values))
    return None


# ---------------------------------------------------------------------------
# Counters.
# ---------------------------------------------------------------------------

def register_counters(name: str, source) -> None:
    """Snapshot `source` under `name` in `counters()`: a dict of counts,
    read by reference (its keys as `name.key`), or a zero-argument
    callable returning such a dict or one count."""
    _SOURCES[name] = source


def counters() -> dict:
    """Every counter now: COUNTERS, the registered sources, and CPython's
    collections by generation (`gc.gen<g>.collections`)."""
    out = dict(COUNTERS)
    for name, src in _SOURCES.items():
        v = src() if callable(src) else src
        if isinstance(v, dict):
            for k, x in list(v.items()):
                out[f"{name}.{k}"] = x
        else:
            out[name] = v
    for g, s in enumerate(gc.get_stats()):
        out[f"gc.gen{g}.collections"] = s["collections"]
    return out


# ---------------------------------------------------------------------------
# On and off, the collector's spans, and the way out.
# ---------------------------------------------------------------------------

_GC_OPEN: dict = {}   # thread ident -> (t0, generation, parent, frame)


def _gc_hook(phase: str, info: dict) -> None:
    st = _thread_state()
    if phase == "start":
        stack = st[0]
        _GC_OPEN[st[1]] = (perf_counter_ns(), info.get("generation", -1),
                           stack[-1].sid if stack else None,
                           _FRAME[0] if st[2] is None else st[2])
        return
    opened = _GC_OPEN.pop(st[1], None)
    if opened is None or not _ON:
        return
    t0, gen, parent, frame = opened
    _BUF.append((next(_IDS), parent, "gc", t0, perf_counter_ns(), st[1],
                 frame, {"gen": gen}))
    _RECORDED[0] += 1


def enabled() -> bool:
    return _ON


def enable() -> None:
    """Start recording, from an empty buffer; install the collector's
    hook."""
    global _ON
    _BUF.clear()
    _RECORDED[0] = 0
    _ENABLED_AT[0] = perf_counter_ns()
    if _gc_hook not in gc.callbacks:
        gc.callbacks.append(_gc_hook)
    _ON = True


def disable() -> None:
    """Stop recording and take the collector's hook out; what was
    recorded stays for `collect()`."""
    global _ON
    _ON = False
    if _gc_hook in gc.callbacks:
        gc.callbacks.remove(_gc_hook)
    _GC_OPEN.clear()


def collect() -> dict:
    """{"spans": the recorded spans (`Span`), oldest first, "dropped":
    spans recorded but pushed out of the buffer, "counters": `counters()`,
    "threads": thread ident -> name of the threads alive now}."""
    spans = [Span._make(r) for r in list(_BUF)]
    return {"spans": spans, "dropped": _RECORDED[0] - len(spans),
            "counters": counters(),
            "threads": {t.ident: t.name for t in threading.enumerate()}}


def chrome_trace(data: dict) -> dict:
    """`collect()`'s result as Chrome trace-event JSON (microseconds):
    one complete event a span, the threads' names, and one counter track
    a frame-path counter from FRAME_LOG's frames since `enable()`."""
    pid = 1
    events = [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
               "args": {"name": name}}
              for tid, name in data["threads"].items()]
    for s in data["spans"]:
        args = dict(s.attrs, frame=s.frame)
        if s.parent is not None:
            args["parent"] = s.parent
        events.append({"name": s.name, "ph": "X", "pid": pid, "tid": s.tid,
                       "ts": s.t0 / 1e3, "dur": (s.t1 - s.t0) / 1e3,
                       "args": dict(args, id=s.sid)})
    for t, n, values in list(FRAME_LOG):
        if t < _ENABLED_AT[0]:
            continue
        events.append({"name": "counters", "ph": "C", "pid": pid,
                       "ts": t / 1e3,
                       "args": dict(zip(COUNTERS, values), frame=n)})
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"counters": data["counters"],
                          "dropped_spans": data["dropped"]}}


def write_chrome(path: str) -> None:
    """Write what was recorded, and the counters, to `path` as Chrome
    trace-event JSON."""
    with open(path, "w") as f:
        json.dump(chrome_trace(collect()), f)
