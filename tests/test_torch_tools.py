"""The port's last tools against the reference's, on the CPU:
`tools/vector_smoke.py` (the seam gate, through `Renderer.render`),
`tools/fixtures.py` (the same tree, dumped alike), `tools/scale_repo.py`
(the same fast-import stream, the same commits), the soak's gates
(`tools/soak.py::verdict`) on recorded heartbeats and RSS series, with no
pty and no sleep, and the `compose` mode of `tools/kernel_times.py` (the
compose probe) on the op lists it launches."""

from __future__ import annotations

import os
import subprocess

import numpy as np
import pytest
import torch

from test_torch_host_copies import _code
from test_torch_slice import fresh_compile_caches
from whisper_git_tpu_torch.tools import soak

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("rel", ["tools/fixtures.py", "tools/scale_repo.py"])
def test_copy_is_the_references_code(rel):
    assert _code(os.path.join(ROOT, "whisper_git_tpu_torch", rel)) == \
        _code(os.path.join(ROOT, "whisper_git_tpu", rel))


@pytest.fixture(scope="module")
def renderers():
    from whisper_git_tpu.render.renderer import get_renderer
    from whisper_git_tpu_torch.render.renderer import Renderer

    return get_renderer(), Renderer("cpu")


def test_vector_smoke_on_the_cpu_has_no_seams(tmp_path, renderers):
    from whisper_git_tpu.tools import vector_smoke as ref_smoke
    from whisper_git_tpu_torch.render.renderer import decode_png
    from whisper_git_tpu_torch.tools import vector_smoke

    fresh_compile_caches(*renderers)
    out = str(tmp_path / "vs.png")
    result = vector_smoke.run(out, device="cpu")
    assert result["max_diff_per_row_vs_single"] <= 2
    assert result["max_diff_overlap_vs_single"] <= 2
    with open(out, "rb") as f:
        img = decode_png(f.read())
    assert img.shape == (int(vector_smoke.ROWS * vector_smoke.ROW_H + 50),
                         420, 4)
    # The reference's render of the same tree: glyphs resampled, so its
    # own Pallas-vs-XLA bound (at most 8 u8, over 2 u8 on under 1 %).
    fresh_compile_caches(*renderers)
    ref_out = str(tmp_path / "ref.png")
    ref_result = ref_smoke.run(ref_out)
    assert ref_result["max_diff_per_row_vs_single"] <= 2
    with open(ref_out, "rb") as f:
        ref_img = decode_png(f.read())
    d = np.abs(img.astype(np.int16) - ref_img.astype(np.int16))
    assert d.max() <= 8 and (d > 2).mean() < 0.01


def test_vector_smoke_cli_takes_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run(
        ["python", "-m", "whisper_git_tpu_torch.tools.vector_smoke",
         str(tmp_path / "vs.png"), "--device", "cpu"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "PASS" in res.stdout


@pytest.mark.parametrize("off", [0.0, 16.0, 300.0])
def test_steady_window_tree_dumps_like_the_reference(renderers, off):
    from whisper_git_tpu.tools import fixtures as ref_fixtures
    from whisper_git_tpu.ui import dump as ref_dump
    from whisper_git_tpu_torch.tools import fixtures
    from whisper_git_tpu_torch.ui import dump

    ref, port = renderers
    fresh_compile_caches(ref, port)
    size = (384, 256)
    ref_root = ref.layout(ref_fixtures.steady_window_tree(off), size)
    root = port.layout(fixtures.steady_window_tree(off), size)
    assert dump.to_tree_text(root) == ref_dump.to_tree_text(ref_root)
    assert dump.to_svg(root, *size) == ref_dump.to_svg(ref_root, *size)
    scene = fixtures.steady_window_scene(port, off, size)
    assert scene.windows and scene.width == 384


@pytest.mark.parametrize("commits,files", [(50, 20), (120, 300)])
def test_scale_repo_stream_is_the_references(commits, files):
    from whisper_git_tpu.tools import scale_repo as ref_scale
    from whisper_git_tpu_torch.tools import scale_repo

    assert b"".join(scale_repo._gen_stream(commits, files)) == \
        b"".join(ref_scale._gen_stream(commits, files))


def test_scale_repo_builds_the_references_history(tmp_path):
    from whisper_git_tpu.tools import scale_repo as ref_scale
    from whisper_git_tpu_torch.tools import scale_repo

    port = scale_repo.build_scale_repo(50, 20, str(tmp_path / "port"))
    ref = ref_scale.build_scale_repo(50, 20, str(tmp_path / "ref"))

    def git(path, *args):
        return subprocess.run(["git", "-C", path, *args], check=True,
                              capture_output=True, text=True).stdout

    assert git(port, "rev-parse", "HEAD") == git(ref, "rev-parse", "HEAD")
    assert git(port, "rev-list", "--count", "--all") == \
        git(ref, "rev-list", "--count", "--all")
    assert git(port, "ls-files") == git(ref, "ls-files")
    # Built once, then reused.
    assert scale_repo.build_scale_repo(50, 20, str(tmp_path / "port")) \
        == port


# ---------------------------------------------------------------------------
# The soak's gates on recorded runs.
# ---------------------------------------------------------------------------

def _beats(t0: float, t1: float, step: float = 0.25, gaps=()) -> list:
    """Heartbeats every `step` s over [t0, t1], with (start, length)
    gaps cut out."""
    out, t = [], t0
    while t <= t1:
        if not any(a < t < a + n for a, n in gaps):
            out.append(round(t, 3))
        t += step
    return out


def _clean(**over):
    kw = dict(secs=60.0, on_card=True, exit_rc=0, alt_restored=True,
              crash_logs=0, stalls=[], host_beats=_beats(100, 170),
              loop_beats=_beats(100, 170), t_script=110.0,
              rss_series=[(10.0, 800), (40.0, 820), (70.0, 822)],
              ledger={"_violations": []})
    kw.update(over)
    return soak.verdict(**kw)


def test_soak_verdict_passes_a_clean_run():
    ok, notes, fig = _clean()
    assert ok, notes
    assert fig["host_thread_max_gap_s"] == 0.0
    assert fig["rss_mb_final"] == 822
    assert fig["rss_slope_mb_per_min"] is None   # the tail is too short


@pytest.mark.parametrize("over,why", [
    ({"exit_rc": 1}, "exit code"),
    ({"alt_restored": False}, "terminal not restored"),
    ({"crash_logs": 1}, "crash log"),
    # A stall over 1 s after the warm-up fails: the reference tolerated
    # two in (1 s, 3 s] as tunnel congestion, the port none.
    ({"stalls": [(1.4, 40, False, 130.0)]}, "without a repaint"),
    ({"stalls": [("no-repaint>3s", 41, False, 131.0)]}, "without a repaint"),
    ({"host_beats": _beats(100, 170, gaps=[(120, 2.0)])}, "wedged"),
    ({"loop_beats": _beats(100, 170, gaps=[(115, 13.0)])}, "loop blocked"),
    ({"host_beats": [], "loop_beats": []}, "no heartbeat"),
    ({"ledger": {"_violations": ["compose.plans 9 > 6"]}}, "cap violation"),
    ({"rss_series": [(10.0, 800), (40.0, 6100)]}, "cap"),
    ({"rss_series": [(10.0, 800), (20.0, 800), (30.0, 800), (40.0, 800),
                     (50.0, 900), (60.0, 1200)]}, "final third"),
])
def test_soak_verdict_fails_each_gate(over, why):
    ok, notes, _ = _clean(**over)
    assert not ok
    assert any(why in n for n in notes), notes


def test_soak_verdict_warmup_stalls_and_short_gaps_pass():
    ok, notes, fig = _clean(
        stalls=[(2.5, 3, True, 111.0), ("no-repaint>3s", 5, True, 112.0)],
        host_beats=_beats(100, 170, gaps=[(104, 5.0)]),   # before the script
        loop_beats=_beats(100, 170, gaps=[(130, 2.0)]))   # 2 s of 60
    assert ok, notes
    assert len(fig["warmup_stalls_excluded"]) == 2
    assert fig["app_loop_max_gap_s"] >= 1.5
    assert any("frame loop blocked" in n for n in notes)


def test_soak_rss_slope_gate_on_the_card_only():
    # 10 minutes, 5 MB/min: over the 2 MB/min gate on the card; the CPU
    # run records it and passes (its caches sit in process RSS).
    series = [(float(t), 1000 + 5 * t / 60.0) for t in range(0, 601, 30)]
    ok, notes, fig = _clean(secs=600.0, rss_series=series,
                            host_beats=_beats(100, 720, step=0.5),
                            loop_beats=_beats(100, 720, step=0.5))
    assert not ok and any("RSS slope" in n for n in notes)
    assert fig["rss_slope_mb_per_min"] == pytest.approx(5.0, abs=0.01)
    ok, notes, _ = _clean(secs=600.0, rss_series=series, on_card=False,
                          host_beats=_beats(100, 720, step=0.5),
                          loop_beats=_beats(100, 720, step=0.5))
    assert ok, notes
    flat = [(float(t), 1000 + (t % 60) / 30.0) for t in range(0, 601, 30)]
    assert abs(soak.rss_slope(flat)) < 0.5


def test_soak_stats_and_beat_files(tmp_path):
    assert soak.repaint_stats([]) == {"repaint_p50_ms": None,
                                      "repaint_p95_ms": None}
    stats = soak.repaint_stats([float(i) for i in range(1, 101)])
    assert stats == {"repaint_p50_ms": 51.0, "repaint_p95_ms": 96.0}
    path = tmp_path / "hb"
    path.write_text("1.0\n1.25\n3.5\n")
    assert soak.read_beats(str(path)) == [1.0, 1.25, 3.5]
    assert soak.gaps_after([1.0, 1.25, 3.5], 0.0, 1.5) == [(2.25, 3.5)]
    assert soak.gaps_after([1.0, 1.25, 3.5], 5.0, 1.5) == []
    assert soak.read_beats(str(tmp_path / "missing")) == []


def test_soak_writes_nothing_outside_out(monkeypatch, tmp_path):
    """`run` keeps its work under `--out` and removes it: a run whose app
    never paints leaves `soak.json` alone there."""
    import whisper_git_tpu_torch.bench as bench

    monkeypatch.setattr(soak, "FIRST_FRAME_S", 0.0)
    made = []

    def fixture(base):
        made.append(base)
        os.makedirs(os.path.join(base, "bench-repo"))
        return os.path.join(base, "bench-repo")

    monkeypatch.setattr(bench, "build_history_repo", fixture)
    out = tmp_path / "soak"
    result = soak.run(0.0, "cpu", str(out))
    assert not result["ok"] and "no first frame" in result["notes"][0]
    assert made == [str(out / "work")]
    assert sorted(os.listdir(out)) == ["soak.json"]


# ---------------------------------------------------------------------------
# The compose probe: `tools/kernel_times.py compose`.
# ---------------------------------------------------------------------------

def test_compose_probe_launches_the_plan_filtered_by_kind(renderers):
    import importlib.util

    from whisper_git_tpu_torch.render import compose as C
    from whisper_git_tpu_torch.render import compose_kernel as CK
    from whisper_git_tpu_torch.render import raster_kernel as K
    from whisper_git_tpu_torch.tools import fixtures

    spec = importlib.util.spec_from_file_location(
        "kernel_times", os.path.join(
            ROOT, "whisper_git_tpu_torch", "tools", "kernel_times.py"))
    kt = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(kt)
    port = renderers[1]
    fresh_compile_caches(*renderers)
    C.clear_caches()
    scene = fixtures.steady_window_scene(port, 16.0)
    frame = C.render_frame_composed(scene, port.font_tex_device(),
                                    port.image_atlas_device())
    outs = []

    class Timer:   # the card's timers, standing in: each runs fn once
        @staticmethod
        def device_ms(fn):
            outs.append(fn())
            return 0.0, 0.0, 1.0

        @staticmethod
        def event_ms(fn, runs):
            fn()
            return 0.0

    real_build = CK.build
    CK.build = lambda: None
    try:
        rows = kt.compose(Timer, torch, port, scene)
    finally:
        CK.build = real_build
    assert [r["variant"] for r in rows] == ["none", "imgs", "slabs", "dyn",
                                            "all"]
    kinds = {r["variant"]: set(r["ops"]) for r in rows}
    assert kinds["none"] == set() and kinds["imgs"] == {"img"}
    assert kinds["slabs"] == {"slab"} and kinds["dyn"] <= {"dyn", "dyni"}
    assert kinds["all"] >= {"img", "slab", "dyni"}
    assert torch.equal(outs[-1], frame)   # "all" is the frame
    bg = K.quantize_u8(torch.tensor(
        [float(c) for c in scene.background[:3]] + [1.0]))
    assert torch.equal(outs[0], bg.expand_as(outs[0]))   # "none"
    assert set(kt.MODES) == {"raster", "slabs", "compose"}
