"""The device trace of a run, from `torch.profiler`
with CUDA activity alone (CUPTI: kernels and copies, with no host op
recorded, so the trace stays small over a whole window).

Device time is put on the host's clock by a marker: with the device idle,
the host reads its clock and launches one small kernel, the first device
event of the trace; the difference of the two is the offset (a kernel's
launch latency, some microseconds, is its error).
"""

from __future__ import annotations

import bisect
import time

import numpy as np

K_NAMES = {"K1": "raster_tiles_kernel", "K2": "raster_blocks_kernel",
           "K3": "compose_tiles_kernel"}
SKIP_PAD_NS = 100_000
PHASES = ("app_build", "layout", "compile", "render_host", "device_wait",
          "between_frames")


class DeviceTrace:
    def __init__(self, torch, cards: list):
        self.torch = torch
        self.cards = cards
        self.prof = None
        self.offset_ns = 0
        self.events = []

    def start(self) -> None:
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile

        marker = torch.zeros(1, device=f"cuda:{self.cards[0]}")
        for c in self.cards:
            torch.cuda.synchronize(c)
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize()
        self._t_marker = time.perf_counter_ns()
        marker.add_(1.0)
        torch.cuda.synchronize()

    def stop(self) -> None:
        for c in self.cards:
            self.torch.cuda.synchronize(c)
        self.prof.__exit__(None, None, None)
        evs = []
        for e in self.prof.profiler.kineto_results.events():
            if "CUDA" not in str(e.device_type()):
                continue
            evs.append((int(e.start_ns()), int(e.duration_ns()),
                        int(e.device_index()), e.name()))
        if not evs:
            raise RuntimeError("the profiler recorded no device event")
        evs.sort()
        self.offset_ns = evs[0][0] - self._t_marker
        # On the host's clock, the marker left out.
        self.events = [(s - self.offset_ns, d, c, n) for s, d, c, n in evs[1:]]
        self.prof = None

    def summary(self, t0_ns: int, t1_ns: int, phase_ns, chips: int,
                skip=()) -> dict:
        """Over the host window [t0_ns, t1_ns]: device seconds and busy
        seconds (the union of the intervals in which an operation ran) by
        card, each kernel's seconds, the top device operations and the
        longest idle gaps of the busiest card, named by the host phase at
        their middle. A copy to the host that meets one of the host
        intervals `skip` (the harness's own copies of sampled frames),
        widened by SKIP_PAD_NS against the marker's error, is left out."""
        by_card: dict = {}
        per_name: dict = {}
        kernel_s = {k: 0.0 for k in K_NAMES}
        skip = sorted((a - SKIP_PAD_NS, b + SKIP_PAD_NS) for a, b in skip)
        starts = [a for a, _ in skip]
        for s, d, c, n in self.events:
            e = s + d
            if e <= t0_ns or s >= t1_ns:
                continue
            if n.startswith("Memcpy DtoH"):
                k = bisect.bisect_right(starts, e) - 1
                if k >= 0 and s <= skip[k][1]:
                    continue
            s2, e2 = max(s, t0_ns), min(e, t1_ns)
            by_card.setdefault(c, []).append((s2, e2))
            per_name[n] = per_name.get(n, 0.0) + d / 1e9
            for k, pat in K_NAMES.items():
                if pat in n:
                    kernel_s[k] += d / 1e9
        busy, device_s, merged = {}, {}, {}
        for c, iv in by_card.items():
            iv.sort()
            m = []
            for s, e in iv:
                if m and s <= m[-1][1]:
                    m[-1][1] = max(m[-1][1], e)
                else:
                    m.append([s, e])
            merged[c] = m
            busy[c] = sum(e - s for s, e in m) / 1e9
            device_s[c] = sum(e - s for s, e in iv) / 1e9
        window_s = (t1_ns - t0_ns) / 1e9
        busiest = max(busy, key=busy.get) if busy else None
        gaps = []
        if busiest is not None:
            edges = [t0_ns] + [x for se in merged[busiest] for x in se] \
                + [t1_ns]
            for a, b in zip(edges[0::2], edges[1::2]):
                if b > a:
                    gaps.append((b - a, (a + b) // 2))
        gaps.sort(reverse=True)
        top_gaps = [[name_phase(phase_ns, mid), g / 1e9]
                    for g, mid in gaps[:10]]
        ops = sorted(per_name.items(), key=lambda kv: -kv[1])[:10]
        return {
            "window_s": window_s,
            "busy_s_by_card": busy,
            "device_s_by_card": device_s,
            "busy_s": sum(busy.values()) / max(chips, 1),
            "busiest": busiest,
            "kernel_s": kernel_s,
            "device_ops": [[n[:96], s] for n, s in ops],
            "idle_gaps": top_gaps,
        }


def name_phase(phase_ns, t_ns: int) -> str:
    """The host phase a time falls in: the frame whose event came last
    before it, and the span of that frame (`PHASES`); "frame" where the
    run kept no spans (`--trace 0`)."""
    if phase_ns is None:
        return "frame"
    starts = phase_ns[:, 0]
    j = int(np.searchsorted(starts, t_ns, side="right")) - 1
    if j < 0:
        return "before_window"
    row = phase_ns[j]
    for k in range(5):
        if t_ns < row[k + 1]:
            return PHASES[k]
    return PHASES[5]
