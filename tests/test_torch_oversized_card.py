"""The oversized path on the card: frames of the benchmark's 5K wheel cell
(the history view of 1000 commits at 5120x2880, scale 2) rendered back to
back through `render_scene_device`, whose tables and bins reach the card in
one fused upload through a ring of reused page-locked buffers, each
`torch.equal` to K1 on the same tables uploaded one array at a time. The
card is held back now and then by a spin kernel, so that the host comes
back to a buffer the card is still reading: a buffer reused too early
shows as a frame that differs.

Needs a CUDA card and skips without one. This file imports no JAX and the
tests' `conftest.py` does, so on a machine with a card run it alone:

    python3 -m pytest --noconftest -p no:cacheprovider -m card -s \\
        tests/test_torch_oversized_card.py
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

SEED = 2718281828
FRAMES = 32
SPIN_EVERY = 4
SPIN_CYCLES = 50_000_000   # about 25 ms: longer than two frames' host work


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def wheel_scenes(card, tmp_path_factory):
    """The 5K cell's application as the benchmark sets it up (its
    configuration, repository and primed avatars, one card), and the
    scenes of its first FRAMES wheel events."""
    from portbench import events, harness, repo
    from whisper_git_tpu_torch.app.repo_tab import RepoTab
    from whisper_git_tpu_torch.app.ui_app import WhisperApp
    from whisper_git_tpu_torch.app.views.widgets import (
        freeze_cursor,
        freeze_pulse,
    )
    from whisper_git_tpu_torch.host.screenshot_mode import compile_frame
    from whisper_git_tpu_torch.render.renderer import Renderer

    conf = harness.load_json(harness.ROOT, "portbench", "configs",
                             "history1000-5120x2880-s2.json")
    tmp = str(tmp_path_factory.mktemp("wheel5k"))
    env = pytest.MonkeyPatch()
    env.setenv("WGIT_MESH", "0")
    for var in ("XDG_CACHE_HOME", "XDG_STATE_HOME", "XDG_CONFIG_HOME"):
        env.setenv(var, os.path.join(tmp, var.lower()))
        os.makedirs(os.environ[var], exist_ok=True)
    commits = repo.history(SEED, conf["history"])
    path = repo.build_repo(tmp, commits, repo.tags(conf["history"], commits))
    emails = repo.prime_avatars(os.environ["XDG_CACHE_HOME"], SEED)
    freeze_pulse(0.0)
    freeze_cursor(True)
    tab = RepoTab.open(path)
    tab.refresh_sync(include_orphans=False)
    app = WhisperApp.with_tabs([tab])
    app.avatar_cache.prefetch_sync(emails, timeout=60.0)
    renderer = Renderer(card)
    W, H = (int(v) for v in conf["viewport"])
    scale = float(conf["scale"])
    compile_frame(app, renderer, W, H, scale)
    ev = events.cycle(events.load("wheel"), SEED,
                      tab.graph_layout.total_height)
    scenes = []
    for n in range(FRAMES):
        _, dy = events.event_at(ev, n)
        app.on_scroll(dy, *harness.POINTER)
        scenes.append((tab.history_scroll,
                       compile_frame(app, renderer, W, H, scale)))
    yield renderer, scenes
    for t in app.tabs:
        t.stop_workers()
    env.undo()


@pytest.mark.card
def test_fused_frames_equal_per_part_uploads(card, wheel_scenes):
    """FRAMES oversized frames enqueued with no synchronisation between
    them, then each against K1 on its tables and bins uploaded one array
    at a time by `transfer.upload`."""
    from whisper_git_tpu_torch import tracing
    from whisper_git_tpu_torch.render import rasterizer as P
    from whisper_git_tpu_torch.render.raster_kernel import render_tiles
    from whisper_git_tpu_torch.render.transfer import upload

    renderer, scenes = wheel_scenes
    font, atlas = renderer.font_tex_device(), renderer.image_atlas_device()
    assert all(max(s.width, s.height) > P.MAX_PACKED_PX for _, s in scenes)
    torch.cuda.synchronize()
    c0 = tracing.counters()
    frames = []
    for i, (_, scene) in enumerate(scenes):
        if i % SPIN_EVERY == 0:
            torch.cuda._sleep(SPIN_CYCLES)
        frames.append(P.render_scene_device(scene, font, atlas))
    c1 = tracing.counters()
    fused, parts, waits = (c1[k] - c0[k] for k in (
        "upload.fused_calls", "upload.fused_parts", "upload.staging_waits"))
    for i, ((off, scene), got) in enumerate(zip(scenes, frames)):
        flat, ty, tx, tables, sig = P.oversized_tables(scene)
        plain = tuple(tuple(upload(np.ascontiguousarray(a), card)
                            for a in layer) for layer in tables)
        want = render_tiles(plain, font, atlas,
                            tuple(float(c) for c in flat.background[:3]),
                            ty, tx, sig, flat.height, flat.width)
        assert torch.equal(got, want), (i, off)
    torch.cuda.synchronize()
    print(f"oversized path on {torch.cuda.get_device_name(0)}: {len(scenes)} "
          f"5K wheel frames (offsets {scenes[0][0]:.3f} to "
          f"{scenes[-1][0]:.3f}) torch.equal to K1 on per-part uploads; "
          f"fused uploads {fused} of {parts} arrays, upload.staging_waits "
          f"{waits}")
    assert fused == len(scenes)
    assert waits >= 1
