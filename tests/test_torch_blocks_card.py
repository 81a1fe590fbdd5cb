"""K2 on the card: window and tail blocks, which the kernel resolves from the
frame blob itself, against the plain blocks `frame.resolve_blocks` makes of
them on the card in torch, over frames of the benchmark's drag traffic on
the history view of 1000 commits at 1280x800, every one `torch.equal`.

Needs a CUDA card and skips without one. This file imports no JAX and the
tests' `conftest.py` does, so on a machine with a card run it alone:

    python3 -m pytest --noconftest -p no:cacheprovider -m card -s \\
        tests/test_torch_blocks_card.py
"""

from __future__ import annotations

import os

import pytest
import torch

SEED = 3141592653
FRAMES = 32


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def drag_scenes(card, tmp_path_factory):
    """The drag cell's application as the benchmark sets it up (its
    configuration, repository and primed avatars, one card), and the
    scenes of its first FRAMES drag events."""
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
                             "history1000-1280x800.json")
    tmp = str(tmp_path_factory.mktemp("drag"))
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
    compile_frame(app, renderer, W, H, 1.0)
    ev = events.cycle(events.load("drag"), SEED,
                      tab.graph_layout.total_height)
    scenes = []
    for n in range(FRAMES):
        _, dy = events.event_at(ev, n)
        app.handle_action(f"scroll-drag:history:0.00:{dy:.2f}",
                          *harness.POINTER)
        scenes.append((tab.history_scroll,
                       compile_frame(app, renderer, W, H, 1.0)))
    yield renderer, scenes
    for t in app.tabs:
        t.stop_workers()
    env.undo()


@pytest.mark.card
def test_k2_resolves_windows_and_tails_as_torch_does(card, drag_scenes):
    """Every frame: the u8 frame of K2 on the frame cache's blocks equals
    K2's on their plain resolution. Every eighth frame also: the f32 and
    i16 layers, a tile rect, a mesh slice of two tile rows, and the blocks
    repeated past the descriptors that ride in the launch."""
    from whisper_git_tpu_torch.render import blocks_kernel as B
    from whisper_git_tpu_torch.render import frame as F
    from whisper_git_tpu_torch.render.transfer import upload

    renderer, scenes = drag_scenes
    font, atlas = renderer.font_tex_device(), renderer.image_atlas_device()
    B.build()
    kinds = {"WindowBlock": 0, "TailBlock": 0, "tuple": 0}
    cases = 0
    for i, (off, scene) in enumerate(scenes):
        blob, chrome, wins, meta = F.pack_frame(scene, card)
        ty, tx = meta[0], meta[1]
        blocks = F.build_blocks(upload(blob, card), chrome, wins, meta)
        plain = F.resolve_blocks(blocks, ty, tx)
        for cls_lists in blocks:
            for bl in cls_lists:
                for b in bl:
                    kinds[type(b).__name__] += 1
        bg = tuple(float(c) for c in scene.background[:3])
        size = (ty, tx, scene.height, scene.width)
        runs = [(bg, {})]
        if i % 8 == 0:
            runs += [(None, {}), (None, {"layer_i16": True}),
                     (bg, {"tile_rect": (2, 3, ty, tx - 1)}),
                     (None, {"layer_i16": True, "tile_rect": (0, 0, 4, 5)}),
                     (bg, {"n_tiles": 2 * tx, "tile0": 4 * tx})]
        for background, kw in runs:
            got = B.render_tiles_blocks(blocks, font, atlas, background,
                                        *size, **kw)
            want = B.render_tiles_blocks(plain, font, atlas, background,
                                         *size, **kw)
            assert got.dtype == want.dtype and got.shape == want.shape
            assert torch.equal(got, want), (i, off, kw)
            cases += 1
        if i % 8 == 0:
            n = sum(len(bl) for cls_lists in blocks for bl in cls_lists)
            reps = B.MAX_INLINE_BLOCKS // n + 1
            got = B.render_tiles_blocks(blocks * reps, font, atlas, bg, *size)
            want = B.render_tiles_blocks(plain * reps, font, atlas, bg, *size)
            assert torch.equal(got, want), (i, off, "device array")
            cases += 1
    torch.cuda.synchronize()
    print(f"K2 on {torch.cuda.get_device_name(0)}: {len(scenes)} drag frames "
          f"(offsets {scenes[0][0]:.3f} to {scenes[-1][0]:.3f}), {cases} "
          f"launches on the frame cache's blocks torch.equal to their plain "
          f"resolution; blocks {kinds}")
    assert kinds["WindowBlock"] >= len(scenes)
    assert kinds["TailBlock"] >= len(scenes)
