"""The port's copies of the reference's device-free host modules
(`host/sixel.py`, `host/term_input.py`, `host/gctune.py`,
`host/degraded.py`, `tools/ptydrive.py`, `tools/dump_bundles.py`): the
same code, and the same
results on the same inputs — sixel bytes, parsed terminal events and the
degraded cell raster of one app state."""

from __future__ import annotations

import ast
import os

import numpy as np
import pytest

from whisper_git_tpu.host import degraded as ref_degraded
from whisper_git_tpu.host import sixel as ref_sixel
from whisper_git_tpu.host import term_input as ref_input
from whisper_git_tpu_torch.host import degraded as port_degraded
from whisper_git_tpu_torch.host import sixel as port_sixel
from whisper_git_tpu_torch.host import term_input as port_input

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COPIES = ["host/sixel.py", "host/term_input.py", "host/gctune.py",
          "host/degraded.py", "tools/ptydrive.py", "tools/dump_bundles.py"]


def _code(path: str) -> str:
    """The module's AST without docstrings: the code, whatever the
    comments and docstrings say."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if isinstance(body, list) and body \
                and isinstance(body[0], ast.Expr) \
                and isinstance(body[0].value, ast.Constant) \
                and isinstance(body[0].value.value, str):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


@pytest.mark.parametrize("rel", COPIES)
def test_copy_is_the_references_code(rel):
    assert _code(os.path.join(ROOT, "whisper_git_tpu_torch", rel)) == \
        _code(os.path.join(ROOT, "whisper_git_tpu", rel))


@pytest.mark.parametrize("dither", [False, True])
def test_encode_sixel_byte_equal_and_decode_round_trips(dither):
    rng = np.random.default_rng(3 + dither)
    for shape in ((23, 37, 3), (6, 500, 3), (48, 64, 3)):
        rgb = rng.integers(0, 256, shape, dtype=np.uint8)
        rgb[: shape[0] // 2, : shape[1] // 3] = (30, 40, 60)
        data = port_sixel.encode_sixel(rgb, dither=dither)
        assert data == ref_sixel.encode_sixel(rgb, dither=dither)
        dec = port_sixel.decode_sixel(data)
        assert np.array_equal(dec, ref_sixel.decode_sixel(data))
        assert dec.shape == rgb.shape
        if not dither:
            idx = port_sixel.quantize_332(rgb)
            want = np.zeros_like(rgb)
            for c in np.unique(idx):
                want[idx == c] = port_sixel.palette_rgb(int(c))
            assert np.abs(dec.astype(int) - want.astype(int)).max() <= 3


def test_parse_sgr_mouse_equal():
    rng = np.random.default_rng(7)
    bodies = ["garbage", "0;10", "0;1;1", "2;3;4", "35;7;8", "32;7;8",
              "64;2;2", "65;2;2", "68;2;2", "1;99;300", "4;5;6"]
    bodies += [f"{b};{c};{r}" for b, c, r in
               rng.integers(0, 100, (40, 3)).tolist()]
    for body in bodies:
        for final in ("M", "m"):
            got = port_input.parse_sgr_mouse(body, final)
            want = ref_input.parse_sgr_mouse(body, final)
            assert (got is None) == (want is None), body
            if got is not None:
                assert vars(got) == vars(want), body


STREAM = (b"a\x1b[<0;12;7M\x1b[<0;12;7m\x1b[<65;1;1M\x1b[?1016;1$y"
          b"\x1b[200~pasted text\x1b[201~\x1b[A\x1bOB\x10x\r\x7f"
          b"\x1b[<35;40;6M\x1b[3~\t")


def _events(mod) -> list:
    r, w = os.pipe()
    try:
        os.write(w, STREAM)
        term = mod.TerminalInput(fd=r)
        out = []
        for _ in range(40):
            ev = term.poll(timeout=0.1)
            if ev is None:
                break
            out.append((type(ev).__name__, vars(ev)))
        return out
    finally:
        os.close(r)
        os.close(w)


def test_terminal_input_on_a_pipe_gives_the_same_events():
    got = _events(port_input)
    assert got == _events(ref_input)
    kinds = {name for name, _ in got}
    assert {"KeyEvent", "MouseEvent", "PasteEvent", "ModeReport"} <= kinds


def test_rasterize_cells_byte_equal_on_the_same_app_state(tmp_path):
    import bench
    from whisper_git_tpu.app.repo_tab import RepoTab as RefTab
    from whisper_git_tpu.app.ui_app import WhisperApp as RefApp
    from whisper_git_tpu.ui.layout import layout_tree as ref_layout
    from whisper_git_tpu.ui.theme import DARK as REF_DARK
    from whisper_git_tpu_torch.app.repo_tab import RepoTab as PortTab
    from whisper_git_tpu_torch.app.ui_app import WhisperApp as PortApp
    from whisper_git_tpu_torch.app.views.widgets import freeze_cursor
    from whisper_git_tpu_torch.app.views.widgets import freeze_pulse
    from whisper_git_tpu_torch.ui.layout import layout_tree as port_layout
    from whisper_git_tpu_torch.ui.theme import DARK as PORT_DARK

    from test_torch_slice import fresh_compile_caches

    freeze_pulse(0.0)
    freeze_cursor(True)
    repo = bench.build_history_repo(str(tmp_path), 30)
    grids = []
    for App, Tab, layout, dark in (
            (RefApp, RefTab, ref_layout, REF_DARK),
            (PortApp, PortTab, port_layout, PORT_DARK)):
        fresh_compile_caches()
        tab = Tab.open(repo)
        tab.refresh_sync(include_orphans=False)
        app = App.with_tabs([tab])
        viewport = (640.0, 400.0)
        app.before_build()
        root = layout(app.build(viewport), viewport)
        mod = ref_degraded if App is RefApp else port_degraded
        grids.append(mod.rasterize_cells(root, viewport, 78, 120,
                                         dark.background))
        tab.stop_workers()
    assert grids[0].shape == (78, 120, 3) and grids[0].std() > 1.0
    assert np.array_equal(grids[1], grids[0])
