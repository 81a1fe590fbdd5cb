"""Pixel-golden scenes, rendered through the port.

The port's counterpart of `whisper_git_tpu/tools/goldens.py`: the same
nine small, fully deterministic scenes (no git, no wall clock, no network)
built from the port's `ui`, rendered through the port's renderer (layout →
scene compile → `render_scene_device`) on a torch device. The goldens
themselves (`tests/goldens/*.png`) belong to the reference, which wrote
them on the CPU; the port reads them and never writes them, so this module
has no `generate`. `tests/test_torch_goldens.py` holds the port against
them on the CPU, `chip_smoke.py` on the card, both at ±TOLERANCE u8.

The `fallback` scene draws glyphs from the fallback bank. `_pin_dejavu_bank`
pins its chain to the bundled DejaVu, as the reference does, so the pixels
do not depend on the fonts a machine has; `tools/mask_font.py::
pin_mask_bank` pins it to DejaVu's masks stored in an npz, for a machine
without Pillow or matplotlib.
"""

from __future__ import annotations

import os

import numpy as np

from ..ui import column, path, rect, row, scroll, spacer, stack, text
from ..ui.theme import DARK as T

SIZE = (360, 240)
TOLERANCE = 2  # u8 steps per channel: covers bf16 matmul re-fusion drift
               # across XLA releases while catching any real shader change


def _identicon(seed: int) -> np.ndarray:
    """Deterministic identicon-like RGBA tile (no hashlib/time)."""
    rng = np.random.RandomState(seed)
    half = rng.randint(0, 2, (5, 3), dtype=np.int64)
    grid = np.concatenate([half, half[:, ::-1][:, 1:]], axis=1)
    color = np.array([60 + 40 * (seed % 5), 120, 200 - 30 * (seed % 4)],
                     np.uint8)
    tile = np.zeros((40, 40, 4), np.uint8)
    tile[..., 3] = 255
    tile[..., :3] = 34
    for r in range(5):
        for c in range(5):
            if grid[r, c]:
                tile[r * 8:(r + 1) * 8, c * 8:(c + 1) * 8, :3] = color
    return tile


def _scene_chrome():
    rows = []
    for i in range(6):
        rows.append(rect(
            row(rect(text("main", font_size=10, bold=True,
                          color=(1, 1, 1, 0.95)),
                     fill=T.pill_head, radius=9, padding=(1, 6, 1, 6)),
                text(f"commit subject {i}: tidy the pills", color=T.text),
                spacer(),
                text("2h ago", color=T.text_muted, font_size=11),
                gap=8, align="center", width="fill", height="fill"),
            width="fill", height=28,
            fill=T.surface if i % 2 else T.background))
    return stack(
        column(
            rect(text("whisper-git chrome", bold=True, font_size=14,
                      color=T.text_bright),
                 fill=T.surface_raised, height=32, width="fill",
                 padding=(6, 10, 6, 10)),
            *rows, width="fill", height="fill"),
        width="fill", height="fill", fill=T.background)


def _scene_graph():
    prims = []
    lanes = [(0.357, 0.608, 0.835, 1.0), (0.455, 0.781, 0.502, 1.0),
             (0.918, 0.620, 0.302, 1.0), (0.678, 0.498, 0.839, 1.0)]
    for li, color in enumerate(lanes):
        x = 20 + li * 24
        prims.append(("vline", x, 10.0, 220.0, 2.0, color))
        prims.append(("circle", x, 40.0 + li * 40, 4.5, color))
    prims.append(("cubic", (20, 80), (20, 120), (68, 100), (68, 140),
                  2.0, lanes[2]))
    prims.append(("cubic", (92, 60), (92, 100), (44, 80), (44, 120),
                  2.0, lanes[1]))
    return stack(path(prims, width=360, height=240),
                 width="fill", height="fill", fill=T.background)


def _scene_modal():
    panel = rect(
        column(
            text("Reset (hard) to 3f2a91c?", bold=True, font_size=13,
                 color=T.text_bright),
            text("DESTROYS all uncommitted changes.", font_size=11,
                 color=T.text_muted),
            row(spacer(),
                rect(text("Cancel", color=T.text), fill=T.surface_hover,
                     radius=5, padding=(4, 10, 4, 10)),
                rect(text("Reset hard", bold=True, color=(1, 1, 1, 1)),
                     fill=T.danger, radius=5, padding=(4, 10, 4, 10)),
                gap=8, width="fill"),
            gap=10, width=280, padding=(12, 14, 12, 14)),
        fill=T.surface_raised, border=T.border_light, border_width=1,
        radius=10, shadow=True)
    return stack(
        rect(width="fill", height="fill", fill=T.background),
        stack(panel, width="fill", height="fill", align="center"),
        width="fill", height="fill")


def _scene_diffish():
    rows = []
    samples = [
        ("-", "    old_line = compute(x)", (0.55, 0.20, 0.23, 0.45)),
        ("+", "    new_line = compute(x, y)", (0.18, 0.43, 0.25, 0.45)),
        (" ", "    return new_line", None),
        ("-", "def resize(img):", (0.55, 0.20, 0.23, 0.45)),
        ("+", "def resize(img, scale):", (0.18, 0.43, 0.25, 0.45)),
    ]
    for i, (sign, code, wash) in enumerate(samples):
        cells = [rect(text(str(i + 10), font_size=10, color=T.text_muted),
                      width=28, height="fill", padding=(2, 4, 2, 4)),
                 text(sign + " " + code, font_size=11, color=T.text)]
        rows.append(rect(row(*cells, width="fill", height="fill"),
                         width="fill", height=18, fill=wash))
    # word-level highlight overlays
    overlay = stack(
        rect(width=60, height=14, fill=(0.9, 0.35, 0.35, 0.30), radius=2),
        width="fill", height="fill", padding=(19, 0, 0, 120))
    return stack(
        column(*rows, width="fill", height="fill", padding=(8, 8, 8, 8)),
        overlay, width="fill", height="fill", fill=T.background)


def _scene_images():
    from ..ui import image

    tiles = [image(_identicon(s), width=40, height=40) for s in range(6)]
    big = image(_identicon(7), width=96, height=96)  # upsampled quad
    return stack(
        column(row(*tiles, gap=10), big, gap=14, padding=(16, 16, 16, 16)),
        width="fill", height="fill", fill=T.background)


def _scene_window():
    def make_row(i):
        return rect(
            row(text(f"row {i} steady content", color=T.text),
                spacer(), text("v1", font_size=10, color=T.text_muted),
                gap=6, align="center", width="fill", height="fill"),
            width="fill", height=24,
            fill=T.surface if i % 2 else T.background,
            cache_key=("golden-row", i, i % 2))

    body = scroll(30, make_row, offset=37.0, row_heights=[24.0] * 30,
                  key="golden-scroll", width="fill", flex=1)
    thumb = rect(width=6, height=36, fill=T.accent, radius=3,
                 volatile=True)
    return stack(
        column(body, width="fill", height="fill"),
        stack(thumb, width=6, height=36),
        width="fill", height="fill", fill=T.background)


def _scene_unicode():
    lines = [
        ("Привет, мир — коммит исправлен", T.text),
        ("γειά σου κόσμε — ταχύτερο", T.text_bright),
        ("Łódź Ćirić Đorđe Žižek", T.text_muted),
        ("naïve façade – résumé", T.text),
    ]
    rows = [rect(text(s, font_size=13, color=c, bold=(i == 1)),
                 width="fill", height=26, padding=(4, 8, 4, 8),
                 fill=T.surface if i % 2 else T.background)
            for i, (s, c) in enumerate(lines)]
    return stack(column(*rows, width="fill", height="fill",
                        padding=(10, 10, 10, 10)),
                 width="fill", height="fill", fill=T.background)


def _scene_signatures():
    """Round-2 visual signatures, pinned: dual-tone size-scaled nodes
    with comet tails, author strips, conventional-commit prefix colors,
    and the dirty/conflict chips (pulse at a fixed phase)."""
    from ..app.views.commit_graph import IDENTICON_COLORS, commit_kind

    rows = []
    fixtures = [  # (subject, +adds, -dels, author-seed)
        ("feat: add rewind timeline", 620, 40, "ada"),
        ("fix(scope)!: race in present loop", 48, 12, "brin"),
        ("docs: deepen the render notes", 6, 1, "ada"),
        ("plain subject without prefix", 0, 0, "cyd"),
    ]
    radii = [8.5, 5.5, 4.0, 4.0]
    tones = [(0.55, 0.74, 0.46, 0.95), (0.75, 0.55, 0.45, 0.95),
             (0.52, 0.73, 0.48, 0.95), None]
    for i, ((subj, add, dele, author), r_node, tone) in enumerate(
            zip(fixtures, radii, tones)):
        lane = (0.36, 0.61, 0.84, 1.0)
        prims = [("vline", 14, 0.0, 28.0, 2.0, lane)]
        tail = 2.0 * r_node
        for frac, w, a in ((0.45, 3.8, 0.55), (0.75, 2.6, 0.30),
                           (1.0, 1.6, 0.14)):
            prims.append(("vline", 14, 14.0, 14.0 + tail * frac, w,
                          (lane[0], lane[1], lane[2], a)))
        if tone is not None:
            prims.append(("circle", 14, 14.0, r_node, tone))
            prims.append(("circle", 14, 14.0, max(r_node - 2.0, 2.0),
                          lane))
        else:
            prims.append(("circle", 14, 14.0, r_node, lane))
        ac = IDENTICON_COLORS[sum(author.encode())
                              % len(IDENTICON_COLORS)]
        kind = commit_kind(subj)
        if kind is not None:
            head_len, cat = kind
            subject = row(text(subj[:head_len], color=cat, bold=True,
                               font_size=13),
                          text(subj[head_len:], color=T.text,
                               font_size=13), gap=0, align="center")
        else:
            subject = text(subj, color=T.text, font_size=13)
        rows.append(rect(
            row(rect(width=3, height="fill",
                     fill=(ac[0], ac[1], ac[2], 0.55)),
                path(prims, width=32, height=28),
                subject, spacer(),
                rect(text(f"+{add} −{dele}", font_size=10,
                          color=T.text_muted),
                     fill=(1, 1, 1, 0.06), radius=4,
                     padding=(1, 5, 1, 5)),
                gap=8, align="center", width="fill", height="fill"),
            width="fill", height=28,
            fill=T.surface if i % 2 else T.background))
    chips = row(
        rect(text("⚠ 2 conflicts", font_size=11, bold=True,
                  color=T.text_bright),
             fill=(T.danger[0], T.danger[1], T.danger[2], 0.45),
             radius=T.radius_pill, padding=(3, 8, 3, 8)),
        rect(row(rect(width=7, height=7, radius=3.5,
                      fill=(0.92, 0.75, 0.25, 0.675)),  # pulse mid-phase
                 text("1 staged · 3 modified", font_size=11,
                      color=T.text_muted), gap=6, align="center"),
             radius=T.radius_pill, padding=(3, 8, 3, 8)),
        text("fetched 4m ago", font_size=11, color=T.text_muted),
        gap=8, align="center", width="fill", padding=(6, 10, 6, 10))
    return stack(
        column(rect(chips, fill=T.surface_raised, width="fill",
                    height=32),
               *rows, width="fill", height="fill"),
        width="fill", height="fill", fill=T.background)


def _scene_fallback():
    """Fallback glyph bank (render/fallback.py): every line uses
    codepoints OUTSIDE the resident atlas that DejaVu (always bundled
    via matplotlib) covers, so the bank's chain-discovery, lazy EDT
    rasterization, baseline alignment against the resident ascent, and
    mixed resident+fallback runs are all pixel-pinned. CJK is absent by
    necessity (no CJK font ships with CI) — its path is gated in
    tests/test_fallback.py instead."""
    lines = [
        ("שלום עולם — hebrew commit", T.text),          # RTL script glyphs
        ("mixed run: ∮ f(x) dx ≟ ∯ g", T.text_bright),   # math + resident
        ("┌── box ──┐ │ drawing │ └──┘", T.text_muted),  # box drawing
        ("αβγ mixed עם resident ascii", T.text),         # three scripts
    ]
    rows = [rect(text(s, font_size=13, color=c, bold=(i == 1)),
                 width="fill", height=26, padding=(4, 8, 4, 8),
                 fill=T.surface if i % 2 else T.background)
            for i, (s, c) in enumerate(lines)]
    return stack(column(*rows, width="fill", height="fill",
                        padding=(10, 10, 10, 10)),
                 width="fill", height="fill", fill=T.background)


SCENES = {
    "chrome": _scene_chrome,
    "graph": _scene_graph,
    "modal": _scene_modal,
    "diffish": _scene_diffish,
    "images": _scene_images,
    "window": _scene_window,
    "unicode": _scene_unicode,
    "signatures": _scene_signatures,
    "fallback": _scene_fallback,
}


def pin_bank(renderer, chain_paths: dict, loaded_fonts: dict):
    """Swap in a fresh fallback bank whose chain is `chain_paths` ({bold:
    [path, …]}) with the fonts of `loaded_fonts` ({path: chain font})
    already loaded, and drop every cache that may hold the old bank's
    quads. Returns a restore callable."""
    from ..render.fallback import FallbackBank

    old_bank = renderer.fallback_bank
    bank = FallbackBank(device=renderer.device)
    bank.set_layout(v_base=renderer.font_tex.shape[0],
                    primary_ascent=renderer.regular.ascent)
    bank._chain_paths = chain_paths
    bank._loaded_fonts = loaded_fonts
    renderer.fallback_bank = bank
    renderer.regular.attach_fallback(bank)
    renderer.bold.attach_fallback(bank)
    renderer._font_tex_dev = None  # force re-upload with the new bank

    def _drop_caches():
        c = renderer.compiler
        c._text_cache.clear()
        c._subtree_cache.clear()
        c._window_cache.clear()
        from ..render import compose as _c, frame as _f
        _f.clear_caches()
        _c.clear_caches()

    _drop_caches()

    def restore():
        renderer.fallback_bank = old_bank
        renderer.regular.attach_fallback(old_bank)
        renderer.bold.attach_fallback(old_bank)
        renderer._font_tex_dev = None
        _drop_caches()

    return restore


def _pin_dejavu_bank(renderer):
    """Swap in a fresh fallback bank whose chain is ONLY the bundled
    DejaVu, so golden pixels do not depend on which system fonts happen
    to be installed (a machine with unifont/Noto CJK would otherwise
    rasterize the fallback scene from a different font). Needs
    matplotlib, fontTools and Pillow. Returns a restore callable."""
    from ..render.atlas import _font_path
    from ..render.fallback import _ChainFont

    dejavu = _font_path(bold=False)
    dejavu_bold = _font_path(bold=True)
    return pin_bank(renderer,
                    {False: [dejavu], True: [dejavu_bold, dejavu]},
                    {dejavu: _ChainFont(dejavu),
                     dejavu_bold: _ChainFont(dejavu_bold)})


def render_scene_image(name: str, device="cuda",
                       pin=_pin_dejavu_bank) -> np.ndarray:
    """Scene `name` rendered through the port's renderer on `device`, its
    bank pinned by `pin` → (H, W, 4) u8 on the host."""
    from ..render.rasterizer import render_scene
    from ..render.renderer import get_renderer

    r = get_renderer(device)
    restore = pin(r)
    try:
        tree = SCENES[name]()
        root = r.layout(tree, (float(SIZE[0]), float(SIZE[1])))
        scene = r.compile(root, SIZE, T.background)
        return render_scene(scene, r.font_tex_device(),
                            r.image_atlas_device())
    finally:
        restore()


def golden_dir() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))), "tests", "goldens")
