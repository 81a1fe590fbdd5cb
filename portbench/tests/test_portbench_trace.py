"""The reduction of a device trace to busy time, kernel time, the top
operations and the idle gaps, on hand-made events."""

import numpy as np
import pytest

from portbench.trace import DeviceTrace, name_phase

MS = 1_000_000


def trace_of(events):
    t = DeviceTrace(None, [0])
    t.events = events
    return t


@pytest.mark.parametrize("with_phases", [True, False])
def test_summary(with_phases):
    # Card 0: K3 at [1, 2) ms and a copy at [1.5, 3) ms (overlapping), a
    # kernel at [8, 9) ms; card 1: K2 at [4, 6) ms. Window [0, 10) ms.
    ev = [(1 * MS, 1 * MS, 0, "void raster::compose_tiles_kernel<4>(P)"),
          (int(1.5 * MS), int(1.5 * MS), 0, "Memcpy HtoD (Pageable -> Device)"),
          (8 * MS, 1 * MS, 0, "elementwise"),
          (4 * MS, 2 * MS, 1, "void raster::raster_blocks_kernel<32, 4>(B)")]
    phases = np.array([[0, 1, 2, 3, 4, 5],
                       [5 * MS, 5 * MS + 1, 5 * MS + 2, 5 * MS + 3,
                        7 * MS, 9 * MS]], np.int64)
    # The harness's own copy at [9.5, 9.8) ms, inside a skipped span.
    ev.append((int(9.5 * MS), int(0.3 * MS), 0, "Memcpy DtoH (Device -> Pinned)"))
    s = trace_of(ev).summary(0, 10 * MS, phases if with_phases else None,
                             chips=2, skip=[(int(9.4 * MS), int(9.9 * MS))])
    assert s["window_s"] == pytest.approx(0.010)
    assert s["busy_s_by_card"][0] == pytest.approx(0.003)   # [1, 3) + [8, 9)
    assert s["device_s_by_card"][0] == pytest.approx(0.0035)
    assert s["busy_s_by_card"][1] == pytest.approx(0.002)
    assert s["busy_s"] == pytest.approx(0.0025)
    assert s["busiest"] == 0
    assert s["kernel_s"]["K3"] == pytest.approx(0.001)
    assert s["kernel_s"]["K2"] == pytest.approx(0.002)
    assert s["kernel_s"]["K1"] == 0.0
    assert s["device_ops"][0][0].startswith("void raster::raster_blocks")
    gaps = s["idle_gaps"]
    assert [g for _, g in gaps] == pytest.approx([0.005, 0.001, 0.001])
    if with_phases:
        # The 5 ms gap [3, 8) ms has its middle in frame 1's render span.
        assert gaps[0][0] == "render_host"
    else:
        assert gaps[0][0] == "frame"


def test_name_phase():
    ph = np.array([[10, 20, 30, 40, 50, 60]], np.int64)
    assert name_phase(ph, 5) == "before_window"
    assert [name_phase(ph, t) for t in (15, 25, 35, 45, 55, 65)] == \
        ["app_build", "layout", "compile", "render_host", "device_wait",
         "between_frames"]
