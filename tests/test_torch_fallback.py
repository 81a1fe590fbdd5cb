"""The port's fallback glyph bank (`whisper_git_tpu_torch/render/fallback.py`)
against the reference's bank tests (tests/test_fallback.py) and against the
reference's bank itself.

The test environment has no CJK-capable font (only DejaVu), so the chain is
exercised with codepoints DejaVu covers but the resident atlas does not
(Hebrew, box drawing, math), and CJK through a synthesized fixture font.
Where both banks hold the same codepoints, the port's texture rows and
metric rows equal the reference's byte for byte (the EDT is exact in both;
`tests/test_torch_sdf.py`). The bidi and shaping tests are `shaping.py`'s,
which the port copies verbatim (`tests/test_torch_host_copies.py`)."""

from __future__ import annotations

import sys

import numpy as np
import pytest
import torch

from test_fallback import _build_cjk_fixture_font
from whisper_git_tpu_torch.render import fallback as fb
from whisper_git_tpu_torch.render.atlas import CELL, _font_path
from whisper_git_tpu_torch.render.rasterizer import render_scene
from whisper_git_tpu_torch.render.renderer import Renderer
from whisper_git_tpu_torch.ui.el import El

torch.set_num_threads(2)

# Codepoints OUTSIDE the resident atlas coverage but INSIDE DejaVu:
HEBREW = "שלום"           # U+05E9... Hebrew
BOX = "┌─┐"               # box drawing
MATH = "∮"                # contour integral U+222E


@pytest.fixture(scope="module")
def renderer():
    return Renderer("cpu")


def _render(renderer, s: str, size=(256, 64)) -> np.ndarray:
    tree = El("stack", children=[
        El("text", text=s, font_size=20.0, color=(1.0, 1.0, 1.0, 1.0))])
    root = renderer.layout(tree, (float(size[0]), float(size[1])))
    scene = renderer.compile(root, size, (0.1, 0.1, 0.12, 1.0))
    return render_scene(scene, renderer.font_tex_device(),
                        renderer.image_atlas_device())


def _bank(renderer, capacity: int = 0) -> fb.FallbackBank:
    bank = fb.FallbackBank(capacity=capacity, device="cpu")
    bank.set_layout(v_base=renderer.font_tex.shape[0],
                    primary_ascent=renderer.regular.ascent)
    return bank


def _cell(bank, key) -> np.ndarray:
    slot = bank._cp_slot[key]
    r, c = divmod(slot, bank.COLS)
    return bank.texture[r * CELL:(r + 1) * CELL, c * CELL:(c + 1) * CELL]


def test_resident_atlas_does_not_cover_probe_glyphs(renderer):
    """Guard: if these ever enter the resident set, pick new probes."""
    for ch in HEBREW + BOX + MATH:
        assert ch not in renderer.regular.glyphs


def test_renderer_wires_the_bank(renderer):
    bank = renderer.fallback_bank
    assert bank.device == renderer.device
    assert renderer.regular.fallback is bank and renderer.bold.fallback is bank
    assert bank._v_base == renderer.font_tex.shape[0]
    assert bank._primary_ascent == renderer.regular.ascent
    assert bank.texture.shape[1] == renderer.font_tex.shape[1]


def test_chain_discovers_dejavu():
    paths = fb.discover_chain_paths()
    assert paths, "fallback chain must never be empty (DejaVu is bundled)"
    assert any("DejaVu" in p for p in paths)


def test_ensure_rasterizes_and_registers(renderer):
    bank = renderer.fallback_bank
    cps = [ord(c) for c in HEBREW]
    assert bank.ensure(cps)
    assert bank.used
    for cp in cps:
        row = bank.metrics[cp]
        u, v = int(row[0]), int(row[1])
        assert v >= renderer.font_tex.shape[0]  # below resident rows
        # The cell actually holds ink (SDF interior values > 128).
        v_rel = v - renderer.font_tex.shape[0]
        cell = bank.texture[v_rel:v_rel + 64, u:u + 64]
        assert cell.max() > 128
    assert not bank.ensure(cps)  # idempotent


def test_measure_uses_real_advances(renderer):
    atlas = renderer.regular
    w_heb = atlas.measure(HEBREW, 14.0)
    w_qm = atlas.measure("?" * len(HEBREW), 14.0)
    assert w_heb > 0
    # Hebrew letters are narrower than '?' in DejaVu; the widths must
    # come from the bank, not the '?' fallback metrics.
    assert abs(w_heb - w_qm) > 0.5


def test_render_differs_from_question_marks(renderer):
    """End-to-end: a Hebrew string renders DIFFERENT pixels than the
    same-length '?' string (i.e. the bank cells are actually sampled)."""
    img_heb = _render(renderer, HEBREW)
    img_qm = _render(renderer, "?" * len(HEBREW))
    assert img_heb.shape == img_qm.shape
    assert (img_heb != img_qm).any()
    # And the glyphs left ink: some pixels clearly brighter than bg.
    assert (img_heb[..., :3].max(axis=-1) > 128).sum() > 50


def test_box_drawing_and_math(renderer):
    bank = renderer.fallback_bank
    cps = [ord(c) for c in BOX + MATH]
    bank.ensure(cps)
    for cp in cps:
        assert cp in bank.metrics, hex(cp)


def test_missing_coverage_marks_and_falls_back(renderer):
    """A codepoint no chain font covers renders '?' and is never
    retried."""
    bank = renderer.fallback_bank
    pua = 0xE123   # private use area — no real font maps it
    bank.ensure([pua])
    assert pua in bank.missing
    assert pua not in bank.metrics
    atlas = renderer.regular
    w = atlas.measure(chr(pua), 14.0)
    assert w == pytest.approx(atlas.measure("?", 14.0), rel=1e-5)


def test_combined_texture_grows_and_versions(renderer):
    """The device copy gains the bank's rows once the bank is used, and is
    uploaded again (a new tensor) for each new bank version, never
    between two."""
    bank = renderer.fallback_bank
    bank.ensure([ord(c) for c in HEBREW])
    tex0 = renderer.font_tex_device()
    assert tex0.shape[0] == (renderer.font_tex.shape[0]
                             + bank.texture.shape[0])
    assert renderer.font_tex_device() is tex0
    assert np.array_equal(tex0.numpy()[renderer.font_tex.shape[0]:],
                          bank.texture)
    v0 = bank.version
    bank.ensure([ord("∯")])  # another DejaVu math glyph
    assert bank.version > v0
    tex1 = renderer.font_tex_device()
    assert tex1 is not tex0  # re-uploaded after the texture write
    assert np.array_equal(tex1.numpy()[renderer.font_tex.shape[0]:],
                          bank.texture)


def test_eviction_epoch_policy(renderer):
    """Slot protection is epoch-based: glyphs touched since the last
    epoch clear are NEVER recycled (cached quads may reference their
    cells); overflow defers to '?', and the next frame fires ONE
    voluntary epoch clear that frees stale slots."""
    bank = _bank(renderer, capacity=12)      # one row → quick recycling
    first = [0x05D0 + i for i in range(12)]   # fills exactly
    bank.ensure(first)
    assert bank.evictions == 0
    bank.ensure([0x2560])
    assert bank.evictions == 0
    assert 0x2560 not in bank.metrics
    assert 0x2560 not in bank.missing         # will retry
    assert first[0] in bank.metrics           # nothing garbled
    bank.begin_frame()
    assert bank.evictions == 1
    bank.ensure([0x2560])
    assert 0x2560 in bank.metrics
    assert bank.evictions == 1
    evicted = next(cp for cp in first if cp not in bank.metrics)
    bank.ensure([evicted])
    assert evicted in bank.metrics


def test_single_ensure_overflow_never_doubles_slots(renderer):
    """One ensure() with more new codepoints than free slots must not
    hand any slot to two codepoints."""
    bank = _bank(renderer, capacity=12)
    bank.ensure([0x05D0 + i for i in range(30)])  # 30 new > 12 slots
    assert len(bank.metrics) == 12                # 12 landed, rest deferred
    cells = [(int(r[0]), int(r[1])) for r in bank.metrics.values()]
    assert len(set(cells)) == len(cells), "two codepoints share a cell"
    assert bank._pressure                         # deferral recorded


def test_overflow_does_not_stampede_caches(renderer):
    """Voluntary epoch clears are rate-limited (at most one per
    _CLEAR_BACKOFF frames)."""
    bank = _bank(renderer, capacity=12)
    want = [0x05D0 + i for i in range(30)]    # 30 unique > 12 slots
    for _ in range(25):                       # 25 "frames"
        bank.begin_frame()
        bank.ensure(want)
        bank.touch(want)                      # all visible every frame
    assert bank.evictions <= 25 // bank._CLEAR_BACKOFF + 1


def test_run_template_revalidates_on_eviction(renderer):
    """A cached text template that used the bank rebuilds after an
    eviction (its quads may point at recycled cells)."""
    compiler = renderer.compiler
    atlas = renderer.regular
    bank = renderer.fallback_bank
    line = "ש test"
    t1 = compiler._run_template(atlas, line, 1.0, 0)
    t2 = compiler._run_template(atlas, line, 1.0, 0)
    assert t2 is t1                       # cache hit, no eviction
    bank.evictions += 1                   # simulate a recycle
    t3 = compiler._run_template(atlas, line, 1.0, 0)
    assert t3 is not t1                   # rebuilt
    bank.evictions -= 1


def test_bold_run_uses_bank_without_bold_offset(renderer):
    """Bank rows carry an absolute v: a bold run mixing resident and
    fallback glyphs must offset only the resident glyphs."""
    compiler = renderer.compiler
    tpl = compiler._run_template(renderer.bold, "aש", 1.0,
                                 compiler.bold_v_offset)
    assert tpl.shape[0] == 2
    v_a, v_heb = tpl[0, 5], tpl[1, 5]
    assert v_a >= compiler.bold_v_offset
    assert v_a < renderer.font_tex.shape[0]
    assert v_heb >= renderer.font_tex.shape[0]


def test_cjk_chain_end_to_end_with_fixture_font(renderer, tmp_path,
                                                monkeypatch):
    """The full CJK path, hermetically: WGIT_FALLBACK_FONTS discovery →
    cmap coverage → rasterize → bank → ink, with a synthesized TTF."""
    font_path = str(tmp_path / "cjk-fixture.ttf")
    _build_cjk_fixture_font(font_path)
    monkeypatch.setenv("WGIT_FALLBACK_FONTS", font_path)
    bank = _bank(renderer)
    assert bank.ensure([0x4E2D, 0x6587])
    assert 0x4E2D in bank.metrics and 0x6587 in bank.metrics
    c1, c2 = _cell(bank, 0x4E2D), _cell(bank, 0x6587)
    assert c1.max() > 128 and c2.max() > 128
    assert (c1 != c2).any()
    adv = bank.advance(0x4E2D)
    assert adv is not None and adv > 20


def test_bold_chain_prefers_real_bold_face():
    chain = fb.discover_chain_paths(bold=True)
    assert any("Bold" in p for p in chain)
    bold_i = min(i for i, p in enumerate(chain) if "DejaVuSans-Bold" in p)
    reg_i = min(i for i, p in enumerate(chain)
                if p.endswith("DejaVuSans.ttf"))
    assert bold_i < reg_i


def test_bold_bank_glyphs_differ_and_are_heavier(renderer):
    """A bold Hebrew run rasterizes from DejaVuSans-Bold into its own
    bank cell; its ink coverage exceeds the regular cell's."""
    bank = renderer.fallback_bank
    cp = ord("ש")
    renderer.regular.metric_rows("ש")
    renderer.bold.metric_rows("ש")
    k_reg, k_bold = bank.key_for(cp, False), bank.key_for(cp, True)
    assert k_reg in bank.metrics and k_bold in bank.metrics
    assert k_reg != k_bold
    reg, bold = _cell(bank, k_reg), _cell(bank, k_bold)
    assert not np.array_equal(reg, bold)
    assert (bold >= 128).sum() > (reg >= 128).sum() * 1.05


@pytest.mark.parametrize("what", ["heavier", "wider"])
def test_synthetic_embolden_when_no_bold_face(renderer, tmp_path,
                                              monkeypatch, what):
    """A chain font with no bold sibling (the synthesized CJK fixture)
    renders bold runs heavier via coverage dilation, and advances the pen
    past the wider ink."""
    font_path = str(tmp_path / "cjk-fixture.ttf")
    _build_cjk_fixture_font(font_path)
    monkeypatch.setenv("WGIT_FALLBACK_FONTS", font_path)
    bank = _bank(renderer, capacity=24)
    cp = 0x4E2D
    assert bank.ensure([cp])
    assert bank.ensure([cp], bold=True)
    k_reg, k_bold = bank.key_for(cp, False), bank.key_for(cp, True)
    if what == "heavier":
        assert (_cell(bank, k_bold) >= 128).sum() > \
            (_cell(bank, k_reg) >= 128).sum()
    else:
        assert bank.metrics[k_bold][6] > bank.metrics[k_reg][6]


# -- the port's bank against the reference's ----------------------------------

def _ref_bank_pair(renderer, capacity, chain, monkeypatch=None):
    """A fresh bank of each package, the same layout and chain."""
    from whisper_git_tpu.render import fallback as ref_fb

    banks = []
    for mod in (ref_fb, fb):
        bank = (mod.FallbackBank(capacity=capacity) if mod is ref_fb
                else mod.FallbackBank(capacity=capacity, device="cpu"))
        bank.set_layout(v_base=renderer.font_tex.shape[0],
                        primary_ascent=renderer.regular.ascent)
        if chain is not None:
            bank._chain_paths = chain
            bank._loaded_fonts = {p: mod._ChainFont(p)
                                  for paths in chain.values() for p in paths}
        banks.append(bank)
    return banks


def _assert_banks_equal(ref_bank, port_bank):
    assert np.array_equal(port_bank.texture, ref_bank.texture)
    assert sorted(port_bank.metrics) == sorted(ref_bank.metrics)
    for key, row in ref_bank.metrics.items():
        got = port_bank.metrics[key]
        assert got.dtype == row.dtype and np.array_equal(got, row), hex(key)
    assert port_bank.missing == ref_bank.missing
    assert port_bank._cp_slot == ref_bank._cp_slot
    assert (port_bank.version, port_bank.used) == (ref_bank.version,
                                                   ref_bank.used)


def test_bank_texture_and_rows_equal_the_reference(renderer):
    """DejaVu's chain: Hebrew, box drawing and math at both weights, a
    missing codepoint, and an overflow that recycles a slot, through both
    banks: the same texture bytes, metric rows, slots and misses."""
    dejavu, dejavu_bold = _font_path(False), _font_path(True)
    chain = {False: [dejavu], True: [dejavu_bold, dejavu]}
    ref_bank, port_bank = _ref_bank_pair(renderer, 24, chain)
    steps = [([ord(c) for c in HEBREW + BOX + MATH], False),
             ([ord(c) for c in HEBREW + "∯≟"], True),
             ([0xE123, ord("ע")], False),
             ([0x05D0 + i for i in range(20)], False),   # overflows
             ([0x2551, 0x2554, 0x2557], False)]         # recycles
    for cps, bold in steps:
        for bank in (ref_bank, port_bank):
            bank.begin_frame()
            bank.ensure(cps, bold=bold)
        _assert_banks_equal(ref_bank, port_bank)
    assert port_bank.used and len(port_bank.metrics) == 24
    assert port_bank.evictions == ref_bank.evictions == 1
    assert 0x2557 in port_bank.metrics


def test_synthetic_embolden_equals_the_reference(renderer, tmp_path,
                                                 monkeypatch):
    """The fixture CJK font has no bold face: both banks embolden the same
    coverage and widen the same advance."""
    font_path = str(tmp_path / "cjk-fixture.ttf")
    _build_cjk_fixture_font(font_path)
    monkeypatch.setenv("WGIT_FALLBACK_FONTS", font_path)
    ref_bank, port_bank = _ref_bank_pair(renderer, 24, None)
    for bank in (ref_bank, port_bank):
        bank.ensure([0x4E2D, 0x6587])
        bank.ensure([0x4E2D], bold=True)
    _assert_banks_equal(ref_bank, port_bank)
    assert port_bank.key_for(0x4E2D, True) in port_bank.metrics


def test_without_fonttools_or_matplotlib_text_renders_question_marks(
        renderer, monkeypatch):
    """The machine with the card has no matplotlib, fontTools or Pillow:
    the chain skips its DejaVu tier, no font loads, and Hebrew renders as
    '?' with no exception reaching the frame; the font texture keeps its
    resident rows."""
    from whisper_git_tpu_torch.tools.goldens import pin_bank

    dejavu = _font_path(False)
    for name in list(sys.modules):
        if name.partition(".")[0] in ("matplotlib", "fontTools", "PIL"):
            monkeypatch.setitem(sys.modules, name, None)
    for root in ("matplotlib", "fontTools", "PIL"):
        monkeypatch.setitem(sys.modules, root, None)
    with pytest.raises(ImportError):
        _font_path(False)
    restore = pin_bank(renderer, {False: None, True: None}, {})
    try:
        bank = renderer.fallback_bank
        assert dejavu not in fb.discover_chain_paths()
        img_heb = _render(renderer, HEBREW)
        img_qm = _render(renderer, "?" * len(HEBREW))
        assert np.array_equal(img_heb, img_qm)
        assert {ord(c) for c in HEBREW} <= bank.missing
        assert not bank.metrics and not bank.used
        assert renderer.font_tex_device().shape == renderer.font_tex.shape
    finally:
        restore()
