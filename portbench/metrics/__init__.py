"""Per-metric readers, one module a metric, found by the metric's name in
`BENCHMARK.json`. Each has `read(ctx)`: the number, or None where it finds
nothing to read (the metric is then left out of the line). `ctx` is what
`harness.run_cell` gathered: `frames`, `window_s`, `lat_ns` (each frame's
event-to-complete time), `setup_s`, `peak_bytes`, `chips`, `launches`
(K1 / K2 / K3 launches in the window), `moved_bytes` (bytes copied between
cards in the window), `trace` (`trace.DeviceTrace.summary`), and in a
traced run `phase_ns` (each frame's span boundaries) and `least_s` (each
kernel's least time over the window's frames, `counts.py`)."""


def roofline(ctx, kernel: str):
    """The kernel's least time over its summed device time in the window,
    in %."""
    s = ctx.get("trace")
    least = ctx.get("least_s")
    if s is None or least is None or s["kernel_s"][kernel] <= 0.0:
        return None
    return 100.0 * least[kernel] / s["kernel_s"][kernel]
