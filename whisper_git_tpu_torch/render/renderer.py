"""Renderer facade: atlases + scene compiler + rasterizer on one device.

The per-frame path: layout_tree → SceneCompiler.compile →
render_scene_device → (H, W, 4) u8 on the device. Counterpart of
`whisper_git_tpu/render/renderer.py`. The atlases come from the committed
npz (no Pillow, matplotlib or EDT at start-up). There is no fallback glyph
bank yet: a codepoint outside the resident atlas renders '?'.
"""

from __future__ import annotations

import struct
import threading
import zlib

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
        self.regular, self.bold = load_atlases()
        self.font_tex = font_texture(self.regular, self.bold)
        self.compiler = SceneCompiler(
            self.regular, self.bold,
            bold_v_offset=self.regular.texture.shape[0])
        self.measurer = AtlasMeasurer(self.regular, self.bold)
        # Device copies: the font texture once; the image atlas again
        # whenever the compiler writes a new image into it.
        self._font_tex_dev = torch.from_numpy(self.font_tex).to(self.device)
        self._image_atlas_dev = None
        self._image_atlas_version = -1

    def font_tex_device(self) -> torch.Tensor:
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


def save_png(img: np.ndarray, path: str) -> None:
    with open(path, "wb") as f:
        f.write(png_bytes(img))
