"""Sixel frame encoding — pixel-accurate in-terminal presentation.

The half-block presenter (term_display.py) shows two vertical pixels
per character cell; terminals with sixel graphics (xterm -ti vt340,
mlterm, wezterm, foot, konsole, iTerm2, …) can render the REAL
framebuffer instead. This encoder turns an (H, W, 3) u8 frame into a
DCS sixel stream using a fixed 252-color 6×7×6 RGB cube (6 blue
levels — a 3-3-2 palette's 2-bit blue green-tints dark navy themes):

  * palette registers are declared once per stream (`#i;2;r;g;b` with
    0-100 percent components);
  * pixels quantize to register indices with vectorized numpy;
  * each 6-row band emits, per color present in the band, a
    run-length-encoded column bitmask (`!<n><ch>`), `$` to rewind,
    `-` to advance to the next band.

Everything is numpy + bytes assembly — a 1280×800 frame encodes in
tens of milliseconds, fine for the ~5-10 fps this mode targets over a
pty (the payload is hundreds of KB per frame; the latest-wins mailbox
absorbs the backpressure). The half-block path remains the default —
sixel is opt-in via WGIT_SIXEL=1 (see term_display).

Reference analog: the Vulkan swapchain present
(reference: src/host.rs:420-550) — this environment has no
display server, so pixel-accurate presentation goes through the
terminal's sixel decoder instead of a surface."""

from __future__ import annotations

import numpy as np

# 6×7×6 cube: index = r6*42 + g7*6 + b6 (252 registers).
_NR, _NG, _NB = 6, 7, 6
_LEVELS_R = np.round(np.arange(_NR) * 255 / (_NR - 1)).astype(np.uint8)
_LEVELS_G = np.round(np.arange(_NG) * 255 / (_NG - 1)).astype(np.uint8)
_LEVELS_B = np.round(np.arange(_NB) * 255 / (_NB - 1)).astype(np.uint8)


def quantize_332(rgb: np.ndarray) -> np.ndarray:
    """(H, W, 3) u8 → (H, W) palette indices (0..251), NEAREST level
    per channel. (Name kept from the original 3-3-2 scheme; the cube
    is 6×7×6 now.)"""
    r = (rgb[..., 0].astype(np.uint32) * (_NR - 1) + 127) // 255
    g = (rgb[..., 1].astype(np.uint32) * (_NG - 1) + 127) // 255
    b = (rgb[..., 2].astype(np.uint32) * (_NB - 1) + 127) // 255
    return (r * (_NG * _NB) + g * _NB + b).astype(np.uint8)


def palette_rgb(idx: int) -> tuple:
    """Palette register → (r, g, b) u8 (level centers: a bucket's level
    is its round-trip representative)."""
    r, rem = divmod(idx, _NG * _NB)
    g, b = divmod(rem, _NB)
    return (int(_LEVELS_R[r]), int(_LEVELS_G[g]), int(_LEVELS_B[b]))


def _rle(chars: np.ndarray) -> bytes:
    """Run-length encode a row of sixel character codes (ints 63..126).
    Sixel repeat introducer: `!<count><char>`."""
    out = bytearray()
    n = len(chars)
    i = 0
    arr = chars
    # Find run boundaries vectorized.
    if n == 0:
        return bytes(out)
    change = np.nonzero(np.diff(arr))[0] + 1
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change, [n]])
    for s, e in zip(starts, ends):
        c = int(arr[s])
        run = int(e - s)
        if run >= 4:
            out += b"!%d%c" % (run, c)
        else:
            out += bytes([c]) * run
    return bytes(out)


# 4×4 Bayer threshold matrix, centered at 0 (ordered dithering before
# nearest-level quantization hides the cube's banding on gradients and
# the slight hue cast on colors that land between levels).
_BAYER4 = (np.array([[0, 8, 2, 10],
                     [12, 4, 14, 6],
                     [3, 11, 1, 9],
                     [15, 7, 13, 5]], np.float32) + 0.5) / 16.0 - 0.5


def _dither(rgb: np.ndarray) -> np.ndarray:
    h, w = rgb.shape[:2]
    ty = np.tile(_BAYER4, ((h + 3) // 4, (w + 3) // 4))[:h, :w]
    steps = np.array([255.0 / (_NR - 1), 255.0 / (_NG - 1),
                      255.0 / (_NB - 1)], np.float32)
    out = rgb.astype(np.float32) + ty[..., None] * steps
    return np.clip(out, 0.0, 255.0).astype(np.uint8)


def encode_sixel(rgb: np.ndarray, dither: bool = True) -> bytes:
    """(H, W, 3) u8 frame → complete DCS sixel sequence (ESC P q …
    ESC \\), 6×7×6 palette with ordered dithering, cursor left at the
    frame's top-left band position semantics of the terminal."""
    h, w = rgb.shape[:2]
    idx = quantize_332(_dither(rgb) if dither else rgb)
    used = np.unique(idx)
    out = bytearray(b"\x1bPq")
    # Raster attributes: 1:1 aspect, frame size (lets terminals size
    # the image without scanning).
    out += b'"1;1;%d;%d' % (w, h)
    for c in used:
        r, g, b = palette_rgb(int(c))
        out += b"#%d;2;%d;%d;%d" % (
            int(c), round(r * 100 / 255), round(g * 100 / 255),
            round(b * 100 / 255))
    n_bands = (h + 5) // 6
    for band in range(n_bands):
        y0 = band * 6
        rows = idx[y0:y0 + 6]
        k = rows.shape[0]
        # (k, W) → per-color column bitmasks. Colors present in band:
        band_colors = np.unique(rows)
        weights = (1 << np.arange(k)).astype(np.uint8)[:, None]
        first = True
        for c in band_colors:
            mask = (rows == c)
            bits = (mask * weights).sum(axis=0).astype(np.uint8)
            if not bits.any():
                continue
            if not first:
                out += b"$"   # rewind to band start for the next color
            first = False
            out += b"#%d" % int(c)
            out += _rle(bits + 63)
        out += b"-"   # next band
    out += b"\x1b\\"
    return bytes(out)


def decode_sixel(data: bytes) -> np.ndarray:
    """Minimal decoder for the subset `encode_sixel` emits — the test
    harness's ground truth (no sixel-capable terminal exists in CI).
    Returns (H, W, 3) u8."""
    assert data.startswith(b"\x1bPq") and data.endswith(b"\x1b\\")
    body = data[3:-2]
    i = 0
    palette: dict = {}
    w = h = None
    if body[i:i + 1] == b'"':
        j = i + 1
        while body[j:j + 1] not in b"#!$-\x1b" and body[j:j + 1]:
            j += 1
        parts = body[i + 1:j].split(b";")
        w, h = int(parts[2]), int(parts[3])
        i = j
    img = np.zeros((h, w, 3), np.uint8)
    x = 0
    band = 0
    color = 0
    while i < len(body):
        ch = body[i:i + 1]
        if ch == b"#":
            j = i + 1
            while body[j:j + 1].isdigit():
                j += 1
            reg = int(body[i + 1:j])
            if body[j:j + 1] == b";":
                # palette definition #reg;2;r;g;b
                parts = []
                k = j + 1
                for _ in range(4):
                    e = k
                    while body[e:e + 1].isdigit():
                        e += 1
                    parts.append(int(body[k:e]))
                    k = e + 1 if body[e:e + 1] == b";" else e
                palette[reg] = tuple(
                    round(p * 255 / 100) for p in parts[1:4])
                i = k
            else:
                # Color switch: x is untouched (the encoder rewinds
                # to the band start with $ before each color).
                color = reg
                i = j
            continue
        if ch == b"$":
            x = 0
            i += 1
            continue
        if ch == b"-":
            band += 1
            x = 0
            i += 1
            continue
        if ch == b"!":
            j = i + 1
            while body[j:j + 1].isdigit():
                j += 1
            count = int(body[i + 1:j])
            bits = body[j] - 63
            for dy in range(6):
                if bits & (1 << dy):
                    y = band * 6 + dy
                    if y < h:
                        img[y, x:x + count] = palette.get(
                            color, (0, 0, 0))
            x += count
            i = j + 1
            continue
        # plain sixel char
        bits = body[i] - 63
        for dy in range(6):
            if bits & (1 << dy):
                y = band * 6 + dy
                if y < h:
                    img[y, x] = palette.get(color, (0, 0, 0))
        x += 1
        i += 1
    return img
