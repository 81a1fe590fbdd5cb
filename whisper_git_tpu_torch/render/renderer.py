"""Renderer facade: atlases + fallback glyph bank + scene compiler +
rasterizer on one device.

The per-frame path: layout_tree → SceneCompiler.compile →
render_scene_device → (H, W, 4) u8 on the device (`Renderer.render` runs it
for one element tree and reads the frame back). With more than one card
visible, the renderer shards the frame pipeline over all of them
(`render/meshstate.py::maybe_auto_mesh`). Counterpart of
`whisper_git_tpu/render/renderer.py`. The resident atlases come from the
committed npz (no Pillow, matplotlib or EDT at start-up). A codepoint
outside them goes to the lazy fallback bank (`render/fallback.py`), which
rasterizes it from a chain font with Pillow, encodes it with the EDT on
this renderer's device and writes it into rows below the resident ones;
the device copy of the font texture is uploaded again whenever the bank's
version moves. Where the chain has no loadable font (no fontTools or
Pillow), such a codepoint renders '?'.

PNG files are written and read here with zlib alone (`png_bytes`,
`decode_png`): the screenshots, the frame dump and the avatar cache.
"""

from __future__ import annotations

import struct
import threading
import zlib
from typing import Optional

import numpy as np
import torch

from ..ui.el import El
from ..ui.layout import LayoutNode, layout_tree
from .atlas import AtlasMeasurer, font_texture, load_atlases
from .scene import Scene, SceneCompiler


def resolve_device(device) -> torch.device:
    """`device` as a torch.device. Asking for CUDA where there is none
    raises: the renderer never carries on on the CPU instead."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available (use device='cpu')")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


class Renderer:
    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        from .meshstate import maybe_auto_mesh

        # Several cards: shard the frame pipeline over every one of them
        # (nothing on one card or on the CPU; see render/meshstate.py and
        # parallel/mesh.py).
        maybe_auto_mesh(self.device)
        self.regular, self.bold = load_atlases()
        self.font_tex = font_texture(self.regular, self.bold)
        self.compiler = SceneCompiler(
            self.regular, self.bold,
            bold_v_offset=self.regular.texture.shape[0])
        self.measurer = AtlasMeasurer(self.regular, self.bold)
        # Lazy fallback glyph bank: out-of-coverage codepoints (CJK,
        # Hebrew, box drawing, …) rasterize on first use from a discovered
        # font chain into rows BELOW the resident atlases. Until first use
        # the combined texture keeps its resident-only shape.
        from .fallback import FallbackBank
        from .shaping import set_coverage_probe

        self.fallback_bank = FallbackBank(device=self.device)
        assert self.fallback_bank.texture.shape[1] == self.font_tex.shape[1]
        self.fallback_bank.set_layout(v_base=self.font_tex.shape[0],
                                      primary_ascent=self.regular.ascent)
        self.regular.attach_fallback(self.fallback_bank)
        self.bold.attach_fallback(self.fallback_bank)
        # Gate Arabic presentation forms on real glyph availability
        # (resident atlas or fallback chain): an uncovered contextual
        # form would render '?', worse than the unjoined base letter.
        reg, bank = self.regular, self.fallback_bank
        set_coverage_probe(
            lambda cp: (cp < reg.max_cp and reg.lut[cp, 7] != 0.0)
            or bank._font_for(cp) is not None)
        # Device copies: the font texture again whenever the bank's
        # version moves; the image atlas again whenever the compiler
        # writes a new image into it.
        self._font_tex_dev = None
        self._font_tex_bank_version = None
        self._image_atlas_dev = None
        self._image_atlas_version = -1

    def font_tex_device(self) -> torch.Tensor:
        """The combined font texture on the device: the resident rows, and
        the bank's rows below them once the bank holds a glyph. No kernel
        keeps its pointer past a launch."""
        bank = self.fallback_bank
        want = bank.version if bank.used else -1
        if self._font_tex_dev is None or self._font_tex_bank_version != want:
            tex = self.font_tex
            if bank.used:
                tex = np.concatenate([tex, bank.texture], axis=0)
            self._font_tex_dev = torch.from_numpy(tex).to(self.device)
            self._font_tex_bank_version = want
        return self._font_tex_dev

    def image_atlas_device(self) -> torch.Tensor:
        if (self._image_atlas_dev is None
                or self._image_atlas_version != self.compiler.atlas_version):
            self._image_atlas_dev = torch.from_numpy(
                self.compiler.image_atlas.copy()).to(self.device)
            self._image_atlas_version = self.compiler.atlas_version
        return self._image_atlas_dev

    def layout(self, el: El, viewport: tuple[float, float]) -> LayoutNode:
        return layout_tree(el, viewport, self.measurer)

    def compile(self, root: LayoutNode, viewport: tuple[int, int],
                background: tuple) -> Scene:
        return self.compiler.compile(root, viewport, background)

    def render(self, el: El, viewport: tuple[int, int],
               background: Optional[tuple] = None) -> np.ndarray:
        """Layout, compile and render `el` at `viewport` on this renderer's
        device → the (H, W, 4) u8 frame on the host."""
        from ..ui.theme import DARK
        from .rasterizer import render_scene

        bg = background or DARK.background
        root = self.layout(el, viewport)
        scene = self.compile(root, viewport, bg)
        return render_scene(scene, self.font_tex_device(),
                            self.image_atlas_device())


_RENDERERS: dict = {}


def get_renderer(device="cuda") -> Renderer:
    """One shared Renderer per device."""
    key = str(resolve_device(device))
    if key not in _RENDERERS:
        _RENDERERS[key] = Renderer(key)
    return _RENDERERS[key]


def kernel_libraries() -> dict:
    """The build state of each kernel's library (K1, K2, K3): loaded
    handle, path, whether this process compiled it, and nvcc's seconds
    (`raster_kernel.new_library_state`)."""
    from . import blocks_kernel, compose_kernel, raster_kernel

    return {"K1": raster_kernel._LIB, "K2": blocks_kernel._LIB,
            "K3": compose_kernel._LIB}


def _build_quietly(build) -> None:
    try:
        build()
    except Exception:   # built again, and raised, at the first launch
        pass


def start_kernel_builds() -> list:
    """Start building K1, K2 and K3 from `csrc/` (one nvcc each, side by
    side, on daemon threads), so that the builds overlap what runs before
    the first frame. → the threads. A kernel's first launch waits on its
    library's lock for the build to end; a build that failed here is
    built again there, and raises there."""
    from . import blocks_kernel, compose_kernel, raster_kernel

    threads = []
    for name, mod in (("K1", raster_kernel), ("K2", blocks_kernel),
                      ("K3", compose_kernel)):
        t = threading.Thread(target=_build_quietly, args=(mod.build,),
                             daemon=True, name=f"wgit-build-{name}")
        t.start()
        threads.append(t)
    return threads


def png_bytes(img: np.ndarray) -> bytes:
    """(H, W, 4) u8 RGBA → PNG file bytes (8-bit RGBA, no filtering)."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 4:
        raise ValueError(f"expected (H, W, 4) uint8, got {img.shape}")
    h, w = img.shape[:2]
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          img.reshape(h, w * 4)], axis=1).tobytes()

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}   # colour type → samples


def _png_unfilter(rows: np.ndarray, bpp: int) -> Optional[np.ndarray]:
    """(H, 1 + stride) filtered scanlines → (H, stride) u8 samples; None
    on an unknown filter type."""
    h, stride = rows.shape[0], rows.shape[1] - 1
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        f, cur = rows[y, 0], rows[y, 1:]
        if f == 0:
            rec = cur
        elif f == 1:    # Sub: a running sum along the row, per byte lane
            rec = np.cumsum(cur.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif f == 2:    # Up
            rec = cur + prev
        elif f in (3, 4):   # Average, Paeth: each byte needs its left one
            c, p = cur.tolist(), prev.tolist()
            r = [0] * stride
            for i in range(stride):
                a = r[i - bpp] if i >= bpp else 0
                if f == 3:
                    r[i] = (c[i] + ((a + p[i]) >> 1)) & 255
                    continue
                b = p[i]
                d = p[i - bpp] if i >= bpp else 0
                pa, pb, pc = abs(b - d), abs(a - d), abs(a + b - 2 * d)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else d)
                r[i] = (c[i] + pred) & 255
            rec = np.array(r, np.uint8)
        else:
            return None
        out[y] = rec
        prev = out[y]
    return out


def decode_png(data: bytes) -> Optional[np.ndarray]:
    """PNG file bytes → (H, W, 4) u8 RGBA, the inverse of `png_bytes`.
    Reads 8-bit samples, not interlaced, in colour types 0 (grey), 2
    (RGB), 3 (palette, with PLTE and tRNS), 4 (grey + alpha) and 6 (RGBA),
    under any of the five row filters; a tRNS colour key makes its pixels
    transparent, as Pillow's `convert("RGBA")` does. Anything else (another
    format, 16-bit or packed samples, interlacing, a truncated file or a
    chunk whose CRC does not match) → None."""
    if data[:8] != PNG_SIGNATURE:
        return None
    pos, ihdr, plte, trns, idat = 8, None, None, None, []
    while True:
        if pos + 12 > len(data):
            return None                     # truncated before IEND
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = data[pos + 8 + n:pos + 12 + n]
        if len(body) != n or len(crc) != 4 or struct.unpack(">I", crc)[0] \
                != zlib.crc32(tag + body) & 0xFFFFFFFF:
            return None
        if tag == b"IHDR":
            ihdr = body
        elif tag == b"PLTE":
            plte = body
        elif tag == b"tRNS":
            trns = body
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + n
    if ihdr is None or len(ihdr) != 13:
        return None
    w, h, depth, ctype, comp, filt, interlace = struct.unpack(">IIBBBBB",
                                                             ihdr)
    ch = _PNG_CHANNELS.get(ctype)
    if depth != 8 or ch is None or comp or filt or interlace or not w \
            or not h:
        return None
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error:
        return None
    stride = w * ch
    if len(raw) < h * (stride + 1):
        return None
    px = _png_unfilter(np.frombuffer(raw, np.uint8, count=h * (stride + 1))
                       .reshape(h, stride + 1), ch)
    if px is None:
        return None
    px = px.reshape(h, w, ch)
    out = np.empty((h, w, 4), np.uint8)
    if ctype == 3:
        if plte is None or not plte or len(plte) % 3 or len(plte) > 768:
            return None
        n_pal = len(plte) // 3
        if int(px.max()) >= n_pal:
            return None
        alpha = np.full(n_pal, 255, np.uint8)
        if trns is not None:
            if len(trns) > n_pal:
                return None
            alpha[:len(trns)] = np.frombuffer(trns, np.uint8)
        pal = np.concatenate([np.frombuffer(plte, np.uint8).reshape(-1, 3),
                              alpha[:, None]], axis=1)
        return pal[px[..., 0]]
    color = px[..., :3] if ctype in (2, 6) else px[..., :1]
    out[..., :3] = color
    if ctype in (4, 6):
        out[..., 3] = px[..., -1]
        return out
    out[..., 3] = 255
    if trns is not None:        # a colour key: 16-bit samples, low byte
        if len(trns) != 2 * color.shape[-1]:
            return None
        key = np.frombuffer(trns, ">u2")
        if (key < 256).all():
            out[(color == key.astype(np.uint8)).all(axis=-1), 3] = 0
    return out


def save_png(img: np.ndarray, path: str) -> None:
    with open(path, "wb") as f:
        f.write(png_bytes(img))
