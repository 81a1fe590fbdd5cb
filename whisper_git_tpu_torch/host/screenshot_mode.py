"""Headless screenshot: one frame of the app through the port's renderer →
PNG. Counterpart of `whisper_git_tpu/host/screenshot_mode.py`."""

from __future__ import annotations

from ..app.ui_app import WhisperApp
from ..render.rasterizer import render_scene_device
from ..render.renderer import get_renderer, save_png
from ..ui.theme import DARK


def compile_frame(app: WhisperApp, renderer, width: int, height: int,
                  scale: float = 1.0):
    """App state → El tree → layout → compiled Scene. `width`×`height` is
    the PHYSICAL output size; layout runs at the logical size
    (width/scale) and the compiled commands are scaled into physical
    pixels (Scene.scaled)."""
    app.before_build()
    viewport = (float(width) / scale, float(height) / scale)
    tree = app.build(viewport)
    root = renderer.layout(tree, viewport)
    scene = renderer.compile(root, (int(viewport[0]), int(viewport[1])),
                             DARK.background)
    if scale != 1.0:
        scene = scene.scaled(scale, out_w=width, out_h=height)
    return scene


def render_frame_device(app: WhisperApp, renderer, width: int, height: int,
                        scale: float = 1.0):
    """One frame of the app → (H, W, 4) u8 on the renderer's device."""
    scene = compile_frame(app, renderer, width, height, scale)
    return render_scene_device(scene, renderer.font_tex_device(),
                               renderer.image_atlas_device())


def run(path: str, width: int, height: int, scale: float,
        app: WhisperApp, device="cuda") -> None:
    """Render one frame of `app` and write it to `path` as PNG."""
    img = render_frame_device(app, get_renderer(device), width, height,
                              scale)
    save_png(img.cpu().numpy(), path)
