"""The port on a machine with several cards, the parts that run on the CPU.

* `maybe_auto_mesh` with `torch.cuda` made to report 2, 4 or 8 cards: the
  (1, n) mesh over every card under `auto`, starting at the renderer's
  card; `WGIT_MESH=<n>` forces a count, `0` none; a CPU renderer gets none.
* The replica cache (`render/frame.py::replicate`) over a mesh of two
  distinct devices, the CPU and `meta` (a device that holds shapes and no
  data): a tensor that lives on unchanged (the atlases, the cached chrome
  tables, a plan's layers) is copied to the other device once, however
  many fresh tables the frames hand over beside it; a changed one is
  copied again, and a dead one's copy is dropped.
* The bench's line names its mesh and the cards visible, and gives its
  device figures a card's each (null on the CPU); a busy share is a card's
  own, so none reads over 1 when several cards work side by side.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from whisper_git_tpu_torch import bench
from whisper_git_tpu_torch.parallel import mesh as PM
from whisper_git_tpu_torch.render import frame as F
from whisper_git_tpu_torch.render import meshstate as MS

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
META = torch.device("meta")
CPU = torch.device("cpu")


def _cuda(i):
    return torch.device("cuda", i)


@pytest.fixture
def cards(monkeypatch):
    """`torch.cuda` reporting `n` cards (`cards(n)`), the current one 0,
    WGIT_MESH unset; the render mesh cleared after the test."""
    monkeypatch.delenv("WGIT_MESH", raising=False)
    MS.set_render_mesh(None)

    def fake(n, current=0):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: n)
        monkeypatch.setattr(torch.cuda, "current_device", lambda: current)

    yield fake
    MS.set_render_mesh(None)


@pytest.fixture
def fresh_replicas():
    F.clear_caches()
    for k in F.MOVED:
        F.MOVED[k] = 0
    yield
    F.clear_caches()


@pytest.mark.parametrize("n", (2, 4, 8))
def test_auto_mesh_over_every_card(cards, n):
    cards(n)
    mesh = MS.maybe_auto_mesh("cuda")
    assert mesh is not None and MS.get_render_mesh() is mesh
    assert mesh.shape == {"dp": 1, "sp": n}
    assert mesh.flat == tuple(_cuda(i) for i in range(n))


@pytest.mark.parametrize("device,current,first", (("cuda:1", 0, 1),
                                                  ("cuda:3", 0, 3),
                                                  ("cuda", 2, 2)))
def test_auto_mesh_starts_at_the_renderers_card(cards, device, current,
                                                first):
    cards(4, current)
    mesh = MS.maybe_auto_mesh(device)
    # The frame is gathered onto the first shard's card: the renderer's.
    assert mesh.flat == tuple(_cuda((first + i) % 4) for i in range(4))


@pytest.mark.parametrize("n", (2, 4, 8))
def test_wgit_mesh_forces_a_count(cards, monkeypatch, n):
    cards(n)
    monkeypatch.setenv("WGIT_MESH", "2")
    mesh = MS.maybe_auto_mesh("cuda")
    assert mesh.shape == {"dp": 1, "sp": 2}
    assert mesh.flat == (_cuda(0), _cuda(1))
    monkeypatch.setenv("WGIT_MESH", "16")   # at most the cards there are
    assert MS.maybe_auto_mesh("cuda").flat == tuple(_cuda(i)
                                                    for i in range(n))


@pytest.mark.parametrize("want", ("0", "off", "none"))
def test_wgit_mesh_off_installs_none(cards, monkeypatch, want):
    cards(4)
    monkeypatch.setenv("WGIT_MESH", want)
    assert MS.maybe_auto_mesh("cuda") is None
    assert MS.get_render_mesh() is None


def test_one_card_and_the_cpu_get_no_auto_mesh(cards):
    cards(1)
    assert MS.maybe_auto_mesh("cuda") is None
    cards(4)
    assert MS.maybe_auto_mesh("cpu") is None   # auto never meshes the CPU
    assert MS.get_render_mesh() is None


def test_mesh_hashes_and_compares_by_its_devices():
    devs = [_cuda(i) for i in range(4)]
    a, b = PM.Mesh([devs]), PM.make_mesh(4, devices=devs)
    assert a == b and hash(a) == hash(b) and len({a, b}) == 1
    assert a != PM.Mesh([devs[::-1]])
    two = PM.make_mesh(4, dp=2, devices=devs)
    assert two.shape == {"dp": 2, "sp": 2} and two != a
    assert two.flat == tuple(devs)


def test_replicate_copies_a_living_tensor_once(fresh_replicas):
    """30 frames, each handing over 100 fresh tables (more than the
    history view's frame-cache path hands over) beside the atlases and a
    plan's layers: those are copied once, the tables every frame."""
    font = torch.zeros(512, 1024, dtype=torch.uint8)
    atlas = torch.zeros(128, 128, 4, dtype=torch.uint8)
    layers = [torch.zeros(64, 128, 4, dtype=torch.int16) for _ in range(3)]
    living = (font, atlas, *layers)
    first = None
    for frame in range(30):
        tables = [torch.full((16, 4), float(frame)) for _ in range(100)]
        out = F.replicate((tables, font, atlas, layers), META)
        assert all(t.device == META for t in out[0])
        copies = (out[1], out[2], *out[3])
        if first is None:
            first = copies
        assert all(c is f for c, f in zip(copies, first)), frame
    once = sum(t.numel() * t.element_size() for t in living)
    assert F.MOVED["replicas"] == once + 30 * 100 * 16 * 4 * 4
    # On its own device a tensor is itself: nothing copied, nothing kept.
    assert F.replicate(font, CPU) is font


def test_replicate_copies_a_changed_tensor_again_and_drops_a_dead_one(
        fresh_replicas):
    t = torch.zeros(8)
    c0 = F.replicate(t, META)
    assert F.replicate(t, META) is c0
    t.add_(1)    # a new version: the old copy no longer stands for it
    c1 = F.replicate(t, META)
    assert c1 is not c0 and F.replicate(t, META) is c1
    assert len(F._REPLICAS[META]) == 1
    del t        # the source is gone: so is its copy
    assert len(F._REPLICAS[META]) == 0


def test_replicate_views_through_their_base(fresh_replicas, monkeypatch):
    """Views taken anew each frame of a tensor that lives on (a chrome
    table's segment rows) copy nothing after the first frame; the views of
    one buffer copy it once; a small view of a large base is copied
    alone. Each view reads the values it stands for: the copies are made
    here with `clone` on the CPU, so they can be read."""
    real_move = F.move
    monkeypatch.setattr(F, "move", lambda t, device, kind: (
        real_move(t, META, kind), t.clone())[1])
    seg = torch.arange(3 * 130, dtype=torch.int32).reshape(3, 130)
    for _ in range(5):
        rows = [seg[i] for i in range(3)]
        for got, want in zip(F.replicate(rows, META), rows):
            assert got.stride() == want.stride() and torch.equal(got, want)
    assert F.MOVED["replicas"] == seg.numel() * 4
    buf = torch.arange(2048, dtype=torch.float32)
    views = (buf[:1024].view(64, 16), buf[1024:1280].view(64, 4))
    for got, want in zip(F.replicate(views, META), views):
        assert torch.equal(got, want)
    assert F.MOVED["replicas"] == seg.numel() * 4 + buf.numel() * 4
    big = torch.arange(100_000, dtype=torch.float32)
    assert torch.equal(F.replicate(big[10:20], META), big[10:20])
    assert F.MOVED["replicas"] == (seg.numel() + buf.numel() + 10) * 4


@pytest.fixture(scope="module")
def history_view(tmp_path_factory):
    from whisper_git_tpu_torch.app.repo_tab import RepoTab
    from whisper_git_tpu_torch.app.ui_app import WhisperApp
    from whisper_git_tpu_torch.host.screenshot_mode import compile_frame
    from whisper_git_tpu_torch.render.renderer import Renderer

    repo = bench.build_history_repo(str(tmp_path_factory.mktemp("cards")),
                                    60)
    tab = RepoTab.open(repo)
    tab.refresh_sync(include_orphans=False)
    app = WhisperApp.with_tabs([tab])
    app.avatar_cache.enabled = False
    renderer = Renderer("cpu")

    def compile_at(off):
        tab.history_scroll = float(off)
        return compile_frame(app, renderer, 1280, 800)

    yield SimpleNamespace(renderer=renderer, compile_at=compile_at)
    for t in app.tabs:
        t.stop_workers()


def test_frame_cache_over_two_devices_copies_the_atlases_once(
        history_view, fresh_replicas, monkeypatch):
    """The history view at 1280x800 through the frame cache over a mesh
    of the CPU and `meta`, 30 frames of a scroll, the blocks kernel
    stubbed (nothing renders on `meta`): the atlases and the cached chrome
    tables reach the second device once, and every frame hands that
    shard the same copies of the atlases."""
    renderer = history_view.renderer
    font = renderer.font_tex_device()
    atlas = renderer.image_atlas_device()
    seen, copied = [], []

    def stub(layers_blocks, font_tex, image_atlas, background, tiles_y,
             tiles_x, height, width, *, n_tiles, tile0, **kw):
        seen.append((font_tex, image_atlas))
        r0, r1 = tile0 // tiles_x, (tile0 + n_tiles) // tiles_x
        rows = max(0, min(r1 * 64, height) - r0 * 64)
        return torch.zeros((rows, width, 4), dtype=torch.uint8)

    real_move = F.move

    def recording(t, device, kind):
        out = real_move(t, device, kind)
        if out is not t:
            copied.append(t)
        return out

    monkeypatch.setattr(F, "render_tiles_blocks", stub)
    monkeypatch.setattr(F, "move", recording)
    MS.set_render_mesh(PM.Mesh([[CPU, META]]))
    try:
        fresh = []
        for i in range(30):
            scene = history_view.compile_at((i * 17) % 400)
            n0 = len(copied)
            frame = F.render_frame_device(scene, font, atlas)
            assert tuple(frame.shape) == (800, 1280, 4)
            fresh.append(len(copied) - n0)
    finally:
        MS.set_render_mesh(None)
    on_meta = [s for s in seen if s[0].device == META]
    assert len(on_meta) == 30 and len(seen) == 60
    assert all(f is on_meta[0][0] and a is on_meta[0][1]
               for f, a in on_meta)
    assert sum(1 for t in copied if t is font) == 1
    assert sum(1 for t in copied if t is atlas) == 1
    chrome = [t for e in F._CHROME_CACHE.values()
              for t in _tensors((e["parts"], e["bins"], e["segs"]))]
    assert chrome and all(sum(1 for c in copied if c is t) <= 1
                          for t in chrome)
    # After the first frame, only each frame's own tensors: its frame
    # blob, which holds the windows' uniforms and the volatile tails.
    assert max(fresh[1:]) < fresh[0]


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _tensors(x)]
    return []


def test_card_device_us_keeps_each_card_apart():
    """Four cards each busy 8 ms of a 10 ms wall: summed they read 3.2
    times the wall; a card's own share is 0.8."""
    events = [SimpleNamespace(device_type="DeviceType.CUDA", device_index=i,
                              self_device_time_total=2000.0)
              for i in range(4) for _ in range(4)]
    events.append(SimpleNamespace(device_type="DeviceType.CPU",
                                  device_index=-1,
                                  self_device_time_total=0.0))
    cards = [f"cuda:{i}" for i in range(4)] + ["cuda:5"]
    us = bench.card_device_us(events, cards)
    assert us == {**{f"cuda:{i}": 8000.0 for i in range(4)}, "cuda:5": 0.0}
    wall_us = 10000.0
    assert sum(us.values()) / wall_us > 1
    assert all(v / wall_us <= 1 for v in us.values())


def test_bench_line_names_its_mesh(tmp_path):
    """The bench on the CPU with WGIT_MESH=auto, as a user's process runs
    it: no mesh (auto never meshes the CPU), no card visible, no device
    figures."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "WGIT_DEVICE", "WGIT_FRAME_CACHE",
                        "WGIT_FRAME_COMPOSE")}
    env.update(PYTHONPATH=ROOT, WGIT_SKIP_AVATARS="1", WGIT_MESH="auto",
               XDG_STATE_HOME=str(tmp_path / "state"),
               XDG_CACHE_HOME=str(tmp_path / "cache"),
               XDG_CONFIG_HOME=str(tmp_path / "config"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, "-m", "whisper_git_tpu_torch.bench",
                          "--device", "cpu", "--iters", "2", "--batches",
                          "1"], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    row = json.loads(res.stdout.strip().splitlines()[-1])
    assert row["mesh"] is None and row["device_count"] == 0
    for key in ("device_ms_per_frame_by_card", "device_busy_share_by_card",
                "device_ms_per_frame", "device_busy_share"):
        assert row[key] is None, key
    assert "mesh None" in res.stderr
