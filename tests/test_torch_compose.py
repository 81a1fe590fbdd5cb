"""The port's compose path (`whisper_git_tpu_torch/render/compose.py`)
on the CPU, at the size `tests/test_compose.py` uses (640×480, its
60-commit fixture): the host half against the reference's
(`whisper_git_tpu/render/compose.py` under WGIT_COMPOSE_KERNEL=interpret,
its kernel mode on the CPU), the composed frame against the port's packed
path and against the reference's composed frame, and the reference's cache
behaviour.

Tolerances: a composed frame is within 1 u8 a channel of the packed
path's, with under 2 % of values differing (layer boundaries re-associate
`over`; cached layers round to 2^-15). Against the reference's composed
frame the bound is 1 u8 too, unless the two blocks rasterizers' known
bf16 gap in glyph resampling shows through, and then the reference's own
glyph bound (at most 8 u8, more than 2 u8 on under 1 % of values) holds
and the numbers are printed."""

from __future__ import annotations

import dataclasses
import os
import random
import subprocess

import numpy as np
import pytest
import torch
import torch.utils._python_dispatch

import whisper_git_tpu.render.compose as C
import whisper_git_tpu.render.frame as F
import whisper_git_tpu.render.rasterizer as R
from test_torch_compose_kernel import interleaved, port_compose_args
from test_torch_slice import fresh_compile_caches
from whisper_git_tpu.render.renderer import get_renderer
from whisper_git_tpu.ui.theme import DARK
from whisper_git_tpu_torch.parallel import mesh as PM
from whisper_git_tpu_torch.render import compose as PC
from whisper_git_tpu_torch.render import compose_kernel as CK
from whisper_git_tpu_torch.render import frame as PF
from whisper_git_tpu_torch.render import meshstate as PMS
from whisper_git_tpu_torch.render import rasterizer as P
from whisper_git_tpu_torch.render import wire as W
from whisper_git_tpu_torch.render.blocks_kernel import render_tiles_blocks
from whisper_git_tpu_torch.render.raster_kernel import render_tiles
from whisper_git_tpu_torch.render.renderer import Renderer
from whisper_git_tpu_torch.tools.synthetic import synthetic_scene

torch.set_num_threads(2)

VIEWPORT = (640, 480)
SWEEP = (0.0, 17.0, 51.0, 120.0, 203.0, 340.0)


def _fresh():
    """Both packages' compose and frame caches and bucket high-water
    marks emptied, so that the same scenes in the same order give the same
    padding and the same plans."""
    for mod in (C, PC, F, PF):
        mod.clear_caches()
    for mod in (F, PF):
        mod._WR_HW.clear()
        mod._DYN_HW.clear()
    for mod in (R, P):
        mod._WIN_HOST_CACHE.clear()
        mod._WIN_DEV_CACHE.clear()


@pytest.fixture(scope="module")
def app_fixture(tmp_path_factory):
    """The reference's app on its compose fixture (a history tall enough
    that offsets past the overscan are reachable at this viewport), with
    the reference's and the port's renderers."""
    from whisper_git_tpu.app.repo_tab import RepoTab
    from whisper_git_tpu.app.ui_app import WhisperApp
    from whisper_git_tpu.tools.dump_bundles import make_fixture_repo

    repo = make_fixture_repo(str(tmp_path_factory.mktemp("compose")))
    env = dict(os.environ, GIT_TERMINAL_PROMPT="0")
    for i in range(60):
        env["GIT_AUTHOR_DATE"] = env["GIT_COMMITTER_DATE"] = str(
            1_750_000_000 + i * 3600)
        subprocess.run(["git", "-C", repo, "commit", "--allow-empty", "-m",
                        f"scroll filler {i}"], check=True,
                       capture_output=True, env=env)
    tab = RepoTab.open(repo)
    tab.refresh_sync(include_orphans=False)
    app = WhisperApp.with_tabs([tab])
    app.avatar_cache.enabled = False
    ref, port = get_renderer(), Renderer("cpu")
    fresh_compile_caches(ref, port)
    return app, tab, ref, port


def _scenes(app_fixture, off: float):
    """The history view at scroll offset `off`, compiled by both packages
    from one tree → (reference scene, port scene)."""
    app, tab, ref, port = app_fixture
    tab.history_scroll = float(off)
    tree = app.build((float(VIEWPORT[0]), float(VIEWPORT[1])))
    return (ref.compile(ref.layout(tree, VIEWPORT), VIEWPORT,
                        DARK.background),
            port.compile(port.layout(tree, VIEWPORT), VIEWPORT,
                         DARK.background))


def _scene(app_fixture, off: float):
    return _scenes(app_fixture, off)[1]


def _atlases(port):
    return port.font_tex_device(), port.image_atlas_device()


def _packed(scene, port) -> np.ndarray:
    os.environ["WGIT_FRAME_CACHE"] = "0"
    try:
        return P.render_scene_device(scene, *_atlases(port)).numpy()
    finally:
        os.environ.pop("WGIT_FRAME_CACHE", None)


def _composed(scene, port):
    img = PC.render_frame_composed(scene, *_atlases(port))
    return None if img is None else img.numpy()


def _diff(a, b):
    return np.abs(a.astype(np.int16) - b.astype(np.int16))


def _reference_composed(ref_scene, ref, monkeypatch) -> np.ndarray:
    monkeypatch.setenv("WGIT_COMPOSE_KERNEL", "interpret")
    img = C.render_frame_composed(ref_scene, ref.font_tex_device(),
                                  ref.image_atlas_device())
    assert img is not None
    return np.asarray(img)


def _assert_close_to_reference(got, want, label):
    d = _diff(got, want)
    print(f"{label}: port composed vs reference composed: max {d.max()} "
          f"u8, >0 on {(d > 0).mean():.6f}, >2 on {(d > 2).mean():.6f}")
    if d.max() > 1:   # the two blocks rasterizers' bf16 glyph gap
        assert d.max() <= 8 and (d > 2).mean() < 0.01, label


# ---- the host half against the reference's --------------------------------------

def test_quant_i16_value_equal_after_the_layout_change():
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    ty, tx = 2, 3
    tiles = rng.uniform(-0.1, 1.1, (ty * tx, 4, 64, 128)).astype(np.float32)
    # exact halves of the fixed-point step, where the rounding mode shows
    tiles[0, 0, 0, :64] = (np.arange(64, dtype=np.float32) + 0.5) / 32767.0
    want = np.asarray(C._quant_i16_planar(jnp.asarray(tiles), ty, tx))
    layer = interleaved(tiles.reshape(ty, tx, 4, 64, 128))
    got = PC._quant_i16_planar(torch.from_numpy(layer))
    assert got.dtype == torch.int16 and got.is_contiguous()
    assert np.array_equal(got.numpy(), interleaved(want))
    assert got.min() == -3277 and got.max() == 32767


def test_plan_and_blob_equal_the_references(app_fixture, monkeypatch):
    """Over a scroll with warm caches, as interactive use is: the run
    list, the chrome groups, every group's bbox, the plan's ops, the frame
    blob byte for byte and its dyn_meta."""
    _, _, ref, port = app_fixture
    monkeypatch.setenv("WGIT_COMPOSE_KERNEL", "interpret")
    _fresh()
    seen = {"ref": [], "port": []}

    def spy(mod, name, side):
        real = getattr(mod, name)

        def wrapped(*a, **k):
            out = real(*a, **k)
            seen[side].append((name, out if name != "_group_chrome" else
                               [tuple(o) if o[0] != "group" else
                                ("group", tuple(o[1])) for o in out]))
            return out
        monkeypatch.setattr(mod, name, wrapped)

    for name in ("_flatten_runs", "_group_chrome", "_group_bbox"):
        spy(C, name, "ref")
        spy(PC, name, "port")
    for off in (17.0, 34.0, 120.0, 340.0):
        ref_scene, port_scene = _scenes(app_fixture, off)
        args_r, st_r = C.prepare_compose_dispatch(
            ref_scene, ref.font_tex_device(), ref.image_atlas_device())
        args_p, st_p = PC.prepare_compose_dispatch(port_scene,
                                                   *_atlases(port))
        ops_r, dyn_meta_r, n_slabs_r = st_r["meta"]
        ops_p, dyn_meta_p, n_slabs_p = st_p["meta"]
        assert ops_r == ops_p, off
        assert dyn_meta_r == dyn_meta_p and n_slabs_r == n_slabs_p, off
        blob_r, blob_p = np.asarray(args_r[0]), args_p[0].numpy()
        assert blob_r.dtype == blob_p.dtype == np.int16
        assert blob_r.tobytes() == blob_p.tobytes(), off
        for key in ("background", "height", "width", "tiles_y", "tiles_x"):
            assert st_r[key] == st_p[key], (off, key)
        # the same layers, cut to the same tile rects
        assert len(args_r[1]) == len(args_p[1])
        for a, b in zip(args_r[1], args_p[1]):
            assert -(-b.shape[0] // 64) == a.shape[0]
            assert -(-b.shape[1] // 128) == a.shape[1]
        assert [tuple(s.shape) for s in args_p[2]] == \
            [(PC._slab_height(480), 640, 4)] * n_slabs_p
    assert seen["ref"] and seen["ref"] == seen["port"]
    assert {n for n, _ in seen["port"]} == {"_flatten_runs", "_group_chrome",
                                            "_group_bbox"}


def test_plain_kernel_matches_reference_kernel_on_carried_bytes(
        app_fixture, monkeypatch):
    """The reference's dispatch (its blob, its i16 layers and slabs, its
    plan) carried into the port: the port's device half and the plain
    compose kernel against the reference's `_compose_frame`, which runs
    its Pallas kernel in interpret mode. Same bytes in, so the two blocks
    rasterizers' differences stay out."""
    _, _, ref, port = app_fixture
    monkeypatch.setenv("WGIT_COMPOSE_KERNEL", "interpret")
    _fresh()
    for off in (33.0, 203.0):
        ref_scene, _ = _scenes(app_fixture, off)
        args, statics = C.prepare_compose_dispatch(
            ref_scene, ref.font_tex_device(), ref.image_atlas_device())
        assert statics["blend"] == "kernel_interp"
        want = np.asarray(C._compose_frame(*args, **statics))
        kw = port_compose_args(args, statics)
        got = PC._compose_frame(kw.pop("blob"), kw.pop("images"),
                                kw.pop("slabs"), *_atlases(port),
                                **kw).numpy()
        d = _diff(got, want)
        print(f"offset {off}: plain K3 vs the reference's kernel on the "
              f"same bytes: max {d.max()} u8, {(d > 0).sum()} values above "
              "0")
        assert got.shape == want.shape == (480, 640, 4)
        assert d.max() <= 1


# ---- the path against the packed path and the reference's frame ------------------

@pytest.fixture(scope="module")
def sweep(app_fixture):
    """Port frames over the scroll sweep: composed and packed."""
    _, _, _, port = app_fixture
    _fresh()
    out = {}
    for off in SWEEP:
        ref_scene, scene = _scenes(app_fixture, off)
        got = _composed(scene, port)
        assert got is not None, f"compose declined integer scroll {off}"
        out[off] = (ref_scene, got, _packed(scene, port))
    return out


@pytest.mark.parametrize("off", SWEEP)
def test_compose_matches_packed_across_scroll(sweep, off):
    _, got, want = sweep[off]
    assert got.shape == want.shape == (480, 640, 4)
    assert got.dtype == np.uint8
    d = _diff(got, want)
    assert d.max() <= 1, (
        f"off={off}: max u8 diff {d.max()} at "
        f"{np.unravel_index(d.argmax(), d.shape)}")
    assert (d > 0).mean() < 0.02, f"off={off}: {(d > 0).mean():.2%} differ"
    assert (got[..., 3] == 255).all()


@pytest.mark.parametrize("off", (17.0, 203.0))
def test_compose_matches_reference_composed(app_fixture, sweep, off,
                                            monkeypatch):
    _, _, ref, _ = app_fixture
    ref_scene, got, _ = sweep[off]
    C.clear_caches()
    want = _reference_composed(ref_scene, ref, monkeypatch)
    _assert_close_to_reference(got, want, f"offset {off}")


def test_compose_random_walk_stays_exact(app_fixture):
    """The reference's seeded random walk over scroll offsets and content
    changes: within 1 u8 of the packed path at EVERY step, whatever the
    walk triggers (cache hits, slab rebuilds, selection changes)."""
    rng = random.Random(424242)
    app, tab, _, port = app_fixture
    PC.clear_caches()
    oids = [c.oid for c in tab.commits if not c.is_synthetic]
    try:
        for step in range(8):
            roll = rng.random()
            if roll < 0.2 and oids:
                tab.select_commit(rng.choice(oids))
            elif roll < 0.3:
                tab.select_commit(None)
            off = float(rng.randrange(0, 600))
            scene = _scene(app_fixture, off)
            got = _composed(scene, port)
            assert got is not None, (step, off)
            diff = int(_diff(got, _packed(scene, port)).max())
            assert diff <= 1, (step, off, diff)
    finally:
        tab.select_commit(None)


# ---- cache behaviour (tests/test_compose.py:89-160) ------------------------------

def test_pure_scroll_hits_caches(app_fixture):
    _, _, _, port = app_fixture
    PC.clear_caches()
    assert _composed(_scene(app_fixture, 17.0), port) is not None
    groups = {k: v[0].data_ptr() for k, v in PC._GROUP_CACHE.items()}
    slabs = {k: (v["y0s"], v["img"].data_ptr())
             for k, v in PC._SLAB_CACHE.items()}
    assert groups and slabs
    k2, k1 = render_tiles_blocks.launches, render_tiles.launches
    # A scroll inside the layout's materialization bucket (window uid
    # stable) re-renders NOTHING: a row offset and one blend.
    assert _composed(_scene(app_fixture, 34.0), port) is not None
    assert {k: v[0].data_ptr()
            for k, v in PC._GROUP_CACHE.items()} == groups
    assert {k: (v["y0s"], v["img"].data_ptr())
            for k, v in PC._SLAB_CACHE.items()} == slabs
    assert len(PC._PLAN_CACHE) == 1
    assert (render_tiles_blocks.launches, render_tiles.launches) == (k2, k1)


def test_plan_rebuild_reuses_memoized_stacks(app_fixture):
    _, _, _, port = app_fixture
    PC.clear_caches()
    assert _composed(_scene(app_fixture, 17.0), port) is not None
    plans_before = dict(PC._PLAN_CACHE)
    img_ids = {id(v["img_stack"]) for v in plans_before.values()}
    # One materialization bucket later: new window uid → new plan key;
    # chrome groups unchanged.
    assert _composed(_scene(app_fixture, 17.0 + 128.0), port) is not None
    new_plans = [v for k, v in PC._PLAN_CACHE.items()
                 if k not in plans_before]
    assert new_plans, "scroll did not produce a new plan key"
    for v in new_plans:
        assert id(v["img_stack"]) in img_ids, "chrome img stack re-built"
        assert all(isinstance(t, torch.Tensor) for t in v["img_stack"])


def test_slab_rebuild_outside_overscan(app_fixture):
    _, _, _, port = app_fixture
    PC.clear_caches()
    assert _composed(_scene(app_fixture, 0.0), port) is not None
    before = {k: v["y0s"] for k, v in PC._SLAB_CACHE.items()}
    assert before, "fixture produced no scroll windows"
    scene = _scene(app_fixture, float(PC.OVERSCAN + 200))
    got = _composed(scene, port)
    assert got is not None
    after = {k: v["y0s"] for k, v in PC._SLAB_CACHE.items()}
    assert any(after.get(k) != y for k, y in before.items()
               if k in after) or set(after) != set(before)
    assert _diff(got, _packed(scene, port)).max() <= 1


def test_fractional_scroll_falls_back(app_fixture, monkeypatch):
    _, _, _, port = app_fixture
    scene = _scene(app_fixture, 13.5)
    assert scene.windows, "fixture produced no scroll windows"
    assert _composed(scene, port) is None
    # the public entry still renders (the frame cache) and equals packed
    monkeypatch.delenv("WGIT_FRAME_CACHE", raising=False)
    monkeypatch.delenv("WGIT_FRAME_COMPOSE", raising=False)
    img = P.render_scene_device(scene, *_atlases(port)).numpy()
    assert np.array_equal(img, _packed(scene, port))


def test_content_change_invalidates(app_fixture):
    _, tab, _, port = app_fixture
    PC.clear_caches()
    base = _composed(_scene(app_fixture, 0.0), port)
    assert base is not None
    # selecting a commit changes chrome + window content
    tab.select_commit(tab.commits[2].oid)
    try:
        scene2 = _scene(app_fixture, 0.0)
        got = _composed(scene2, port)
        assert _diff(got, _packed(scene2, port)).max() <= 1
        assert not np.array_equal(base, got), \
            "selection change did not change pixels"
    finally:
        tab.select_commit(None)


def test_caches_are_keyed_by_device_and_capped_for_it(app_fixture):
    assert PC._img_cache_cap(12, torch.device("cuda")) == 12
    assert PC._img_cache_cap(12, "cpu") == 3
    assert PC._img_cache_cap(6, "cpu") == 2
    _, _, _, port = app_fixture
    PC.clear_caches()
    assert _composed(_scene(app_fixture, 17.0), port) is not None
    for cache in (PC._GROUP_CACHE, PC._SLAB_CACHE, PC._PLAN_CACHE,
                  PC._STACK_CACHE, PC._BLOB_DEV_CACHE):
        assert cache and all("cpu" in repr(k) for k in cache), cache.keys()
    PC.clear_caches()
    assert not (PC._GROUP_CACHE or PC._SLAB_CACHE or PC._PLAN_CACHE
                or PC._STACK_CACHE or PC._BLOB_DEV_CACHE
                or PC._DYN_PACK_CACHE)


def test_revisited_frame_state_uploads_nothing(app_fixture):
    _, _, _, port = app_fixture
    PC.clear_caches()
    prep = [PC.prepare_compose_dispatch(_scene(app_fixture, off),
                                        *_atlases(port))
            for off in (17.0, 34.0, 17.0)]
    assert prep[0][0][0] is prep[2][0][0]        # the same device blob
    assert prep[0][0][0] is not prep[1][0][0]
    assert len(PC._BLOB_DEV_CACHE) == 2


# ---- what the reference's scene-shaped tests hold ---------------------------------

def _ui_frames(ui, size, port, ref, monkeypatch):
    """`ui` laid out and compiled by both packages at `size` → the port's
    composed frame, its packed frame, the reference's composed frame, and
    the port's dispatch."""
    _fresh()
    scene = port.compile(port.layout(ui, size), size, DARK.background)
    prep = PC.prepare_compose_dispatch(scene, *_atlases(port))
    assert prep is not None
    got = _composed(scene, port)
    want = _packed(scene, port)
    ref_scene = ref.compile(ref.layout(ui, size), size, DARK.background)
    return got, want, _reference_composed(ref_scene, ref, monkeypatch), prep


def test_dyn_class_appearing_under_identical_chrome(monkeypatch):
    """A volatile class APPEARING while the chrome bytes stay identical
    must invalidate the cached plan (tests/test_compose.py:205)."""
    from whisper_git_tpu.ui import rect, row, stack, text

    port = Renderer("cpu")
    _fresh()

    def build(with_dot: bool):
        header_kids = [text("steady chrome header", color=DARK.text)]
        if with_dot:
            header_kids.append(rect(width=10, height=10, radius=5,
                                    fill=(0.9, 0.7, 0.2, 0.8),
                                    volatile=True))
        tree = stack(
            stack(rect(row(*header_kids, gap=8, align="center",
                           width="fill", height="fill"),
                       fill=DARK.surface_raised, width="fill", height=32,
                       padding=(6, 10, 6, 10)),
                  width="fill", height="fill"),
            width="fill", height="fill", fill=DARK.background)
        return port.compile(port.layout(tree, (256, 128)), (256, 128),
                            DARK.background)

    plain, dotted = build(False), build(True)
    a = _composed(plain, port)
    chrome = list(PF._CHROME_CACHE)
    b = _composed(dotted, port)
    assert a is not None and b is not None
    assert list(PF._CHROME_CACHE) == chrome, "the chrome bytes changed"
    assert len(PC._PLAN_CACHE) == 2
    assert (a != b).any(), "volatile element invisible: stale plan reused"
    assert _diff(b, _packed(dotted, port)).max() <= 1


def test_chrome_layers_are_ink_cropped(app_fixture):
    """Cached chrome layers hold only the tile rect of their ink
    (tests/test_compose.py:250), in pixels here, with tile offsets."""
    _, _, _, port = app_fixture
    PC.clear_caches()
    scene = _scene(app_fixture, 17.0)
    assert _composed(scene, port) is not None
    assert PC._GROUP_CACHE, "no chrome groups cached"
    fractions = []
    for img, ty0, tx0 in PC._GROUP_CACHE.values():
        h, w = img.shape[:2]
        assert img.dtype == torch.int16 and img.shape[2] == 4
        assert 0 <= ty0 and 0 <= tx0
        assert ty0 * 64 + h <= scene.height and tx0 * 128 + w <= scene.width
        # whole tiles, but for the frame's ragged edge
        assert h % 64 == 0 or ty0 * 64 + h == scene.height
        assert w % 128 == 0 or tx0 * 128 + w == scene.width
        fractions.append((h * w) / (scene.height * scene.width))
    assert min(fractions) < 0.5, \
        "every chrome layer is near-full-frame: bbox cropping inactive"


def test_dyn_subgrid_covers_only_thumb_columns(app_fixture):
    """The volatile tail's bins cover only the tile columns its commands
    touch, and the range is stable across a scroll
    (tests/test_compose.py:282)."""
    _, _, _, port = app_fixture
    PC.clear_caches()
    metas, kops = [], []
    for off in (10.0, 40.0, 90.0):
        scene = _scene(app_fixture, off)
        args, statics = PC.prepare_compose_dispatch(scene, *_atlases(port))
        metas.append(statics["meta"][1])
        kops.append(PC.frame_tails(args[0], args[3], args[4], 480, 640,
                                   statics["tiles_y"], statics["tiles_x"],
                                   statics["meta"])[2])
    tiles_x = -(-scene.width // PC.TILE_W)
    ranges = [(c0, c1) for dm in metas for (_, ks, c0, c1) in dm if any(ks)]
    assert ranges, "no volatile tails in the fixture scene"
    assert any(c1 - c0 < tiles_x for c0, c1 in ranges), \
        "dyn subgrid inactive: volatile tails cover the full tile grid"
    assert metas[0] == metas[1] == metas[2]
    assert kops[0] == kops[1] == kops[2]
    assert any(op[0] == "dyni" for op in kops[0])


def test_windowless_scene(monkeypatch):
    """A scene with no scroll window (tests/test_compose.py:330): no slab,
    an empty starts vector, chrome and volatile ops only."""
    from whisper_git_tpu.ui import column, rect, text

    ref, port = get_renderer(), Renderer("cpu")
    ui = column(
        rect(text("No windows here", color=DARK.text, bold=True),
             fill=DARK.surface_raised, radius=6, padding=(6, 10, 6, 10),
             width="fill", height=40),
        rect(width=12, height=12, radius=6,
             fill=(0.9, 0.6, 0.2, 0.9), volatile=True),
        width="fill", height="fill", fill=DARK.background, gap=8)
    got, want, ref_img, (args, statics) = _ui_frames(ui, (256, 128), port,
                                                     ref, monkeypatch)
    assert statics["meta"][2] == 0 and args[2] == ()
    assert {op[0] for op in statics["meta"][0]} == {"img", "dyn"}
    assert _diff(got, want).max() <= 1
    _assert_close_to_reference(got, ref_img, "windowless")


def test_inline_volatile_off_column_zero(monkeypatch):
    """Volatile shapes whose tile-column ranges start at c0 = 1, 2, 3
    through the inline tail (tests/test_compose.py:364: global x there
    misplaced the dots by up to 193 u8)."""
    from whisper_git_tpu.ui import rect, row, spacer, stack

    ref, port = get_renderer(), Renderer("cpu")
    ui = stack(
        rect(width="fill", height="fill", fill=DARK.background),
        row(spacer(154),
            *[el for x in range(3) for el in
              (rect(width=12, height=12, radius=6,
                    fill=(0.9, 0.6, 0.2, 0.9), volatile=True),
               spacer(116))],
            width="fill", height=60),
        width="fill", height="fill")
    got, want, ref_img, (args, statics) = _ui_frames(ui, (512, 128), port,
                                                     ref, monkeypatch)
    cols = [(m[2], m[3]) for m in statics["meta"][1] if m[3] > m[2]]
    assert any(c0 >= 1 for c0, _ in cols), \
        f"fixture regression: no volatile tail at column >= 1 ({cols})"
    assert _diff(got, want).max() <= 1
    bg = np.array([int(c * 255.0 + 0.5) for c in DARK.background[:3]])
    assert (got[..., :3] != bg).any(axis=2).sum() > 3 * 60, "the dots are missing"
    _assert_close_to_reference(got, ref_img, "inline tail off column 0")


def test_glyph_tail_is_prerendered_by_the_blocks_rasterizer():
    """A volatile tail with glyphs takes the pre-rendered route ("dyn"),
    its shapes the inline one ("dyni"); the frame stays within 1 u8 of
    the packed path's."""
    port = Renderer("cpu")
    scene = synthetic_scene("volatile", 0, port.regular,
                            port.regular.texture.shape[0])
    scene.windows = [dataclasses.replace(w, dy=float(int(w.dy)))
                     for w in scene.windows]
    font, atlas = port.font_tex_device(), torch.from_numpy(scene.image_atlas)
    PC.clear_caches()
    args, statics = PC.prepare_compose_dispatch(scene, font, atlas)
    starts, dyns, kops = PC.frame_tails(
        args[0], font, atlas, scene.height, scene.width, statics["tiles_y"],
        statics["tiles_x"], statics["meta"])
    kinds = [op[0] for op in kops]
    assert "dyn" in kinds and "dyni" in kinds and "slab" in kinds
    pre = [dyns[(op[1], op[2])] for op in kops if op[0] == "dyn"]
    assert all(t.dtype == torch.float32 and t.shape[0] == scene.height
               and t.shape[2] == 4 for t in pre)
    before = CK.compose_tiles.launches
    got = PC._compose_frame(*args, **statics).numpy()
    assert CK.compose_tiles.launches == before   # the CPU launches nothing
    os.environ["WGIT_FRAME_CACHE"] = "0"
    try:
        want = P.render_scene_device(scene, font, atlas).numpy()
    finally:
        os.environ.pop("WGIT_FRAME_CACHE", None)
    assert _diff(got, want).max() <= 1


# ---- cached layers written by the blocks rasterizer itself ------------------------

@pytest.mark.parametrize("off", (17.0, 203.0))
def test_cached_layers_match_the_references(app_fixture, monkeypatch, off):
    """Every chrome group layer and window slab of the port's plan, as the
    blocks rasterizer now writes them (i16, a group over its ink's tile
    rect only), against the reference's under its kernel mode: the same
    rects, the i16 values within the blocks rasterizers' own bound, in u8
    units (1 u8 on shapes; the bf16 glyph gap at most 8 u8, more than 2 u8
    on under 1 % of values)."""
    _, _, ref, port = app_fixture
    monkeypatch.setenv("WGIT_COMPOSE_KERNEL", "interpret")
    _fresh()
    ref_scene, port_scene = _scenes(app_fixture, off)
    args_r, _ = C.prepare_compose_dispatch(ref_scene, ref.font_tex_device(),
                                           ref.image_atlas_device())
    args_p, st_p = PC.prepare_compose_dispatch(port_scene, *_atlases(port))
    n = 0
    for what, ref_layers, port_layers in (("chrome", args_r[1], args_p[1]),
                                          ("slab", args_r[2], args_p[2])):
        assert len(ref_layers) == len(port_layers) > 0
        for i, (a, b) in enumerate(zip(ref_layers, port_layers)):
            assert b.dtype == torch.int16 and b.is_contiguous()
            want = interleaved(np.asarray(a))
            assert want.dtype == np.int16
            h, w = b.shape[:2]
            assert want.shape[0] - h < 64 and want.shape[1] - w < 128
            d = np.abs(b.numpy().astype(np.int32)
                       - want[:h, :w].astype(np.int32)) * (255.0 / 32767.0)
            print(f"offset {off} {what} {i} {tuple(b.shape)}: max "
                  f"{d.max():.4f} u8, >2 u8 on {(d > 2).mean():.6f}")
            if d.max() > 1:
                assert d.max() <= 8 and (d > 2).mean() < 0.01, (what, i)
            n += int(np.abs(b.numpy()).max() > 0)
    assert n >= 4, "hardly a layer holds ink"
    assert len(args_p[1]) + len(args_p[2]) == \
        len(PC._GROUP_CACHE) + len(PC._SLAB_CACHE)


def test_layer_builds_write_what_the_quantize_pass_made(app_fixture,
                                                        monkeypatch):
    """`_window_slab` and `_chrome_group_image` ask the blocks rasterizer
    for the i16 layer (a group: over its ink's tile rect) and cache what it
    returns, with no pass after it; the values are those of the former
    route, the whole f32 layer through `_quant_i16_planar` and then cut."""
    _, _, _, port = app_fixture
    calls = []
    real = PC.render_tiles_blocks

    def spy(*a, **k):
        out = real(*a, **k)
        calls.append((a, k, out))
        return out

    monkeypatch.setattr(PC, "render_tiles_blocks", spy)
    PC.clear_caches()
    assert _composed(_scene(app_fixture, 51.0), port) is not None
    builds = [c for c in calls if c[1].get("layer_i16")]
    cached = ({id(v[0]) for v in PC._GROUP_CACHE.values()}
              | {id(v["img"]) for v in PC._SLAB_CACHE.values()})
    assert {id(out) for _, _, out in builds} == cached and len(cached) >= 3
    rects = 0
    for a, k, out in builds:
        assert a[3] is None                       # a transparent canvas
        want = PC._quant_i16_planar(real(*a))     # the former route
        rect = k.get("tile_rect")
        if rect is not None:
            ty0, tx0, ty1, tx1 = rect
            want = want[ty0 * 64:ty1 * 64, tx0 * 128:tx1 * 128]
            rects += (ty1 - ty0) * (tx1 - tx0) < a[4] * a[5]
        assert out.dtype == torch.int16 and torch.equal(out, want)
    assert rects, "no chrome group was cut to less than the frame"


def test_plan_rows_live_and_die_with_the_plan(app_fixture):
    """The compose kernel's descriptor rows of the cached layers are built
    when the plan is, and only then: a plan hit hands the frame the same
    rows and builds none; a rebuilt plan brings rows of its own."""
    _, _, _, port = app_fixture
    font, atlas = _atlases(port)
    cpu = torch.device("cpu")
    PC.clear_caches()

    def frame(off):
        args, st = PC.prepare_compose_dispatch(_scene(app_fixture, off),
                                               font, atlas)
        starts, dyns, kops = PC.frame_tails(
            args[0], font, atlas, 480, 640, st["tiles_y"], st["tiles_x"],
            st["meta"])
        return args, st, (args[0], tuple(args[1]), tuple(args[2]), dyns,
                          kops, st["tiles_y"], cpu)

    built = CK._static_row.built
    args, st, desc_args = frame(17.0)
    rows = st["rows"]
    n_static = sum(op[0] in ("img", "slab") for op in st["meta"][0])
    assert isinstance(rows, CK.PlanRows) and len(rows.rows) == n_static > 0
    assert CK._static_row.built == built + n_static
    assert rows.serves(desc_args[1], desc_args[2], cpu)
    # a plan hit: the plan's own rows, none built by the dispatch or by the
    # frame's descriptors, which come out as if built afresh
    args2, st2, desc_args2 = frame(34.0)
    assert st2["rows"] is rows and len(PC._PLAN_CACHE) == 1
    desc, _ = CK.op_descriptors(*desc_args2, rows)
    assert CK._static_row.built == built + n_static
    fresh, _ = CK.op_descriptors(*desc_args2)
    assert CK._static_row.built == built + 2 * n_static
    assert desc.tobytes() == fresh.tobytes() and len(desc) >= n_static
    # one materialization bucket on: a new plan and new rows, which point
    # at the new plan's slabs
    args3, st3, desc_args3 = frame(17.0 + 128.0)
    assert len(PC._PLAN_CACHE) == 2 and st3["rows"] is not rows
    n3 = sum(op[0] in ("img", "slab") for op in st3["meta"][0])
    assert CK._static_row.built == built + 2 * n_static + n3
    assert st3["rows"].serves(desc_args3[1], desc_args3[2], cpu)
    assert not rows.serves(desc_args3[1], desc_args3[2], cpu)
    # and the frame through `_compose_frame` takes them
    assert PC._compose_frame(*args3, **st3).shape == (480, 640, 4)


# ---- the kernel reads the frame blob itself ----------------------------------------

def _old_frame_tails(blob, font_tex, image_atlas, height, width, tiles_y,
                     tiles_x, meta):
    """`compose.frame_tails` as it was before the compose kernel read the
    blob: every tail de-quantized and translated to its sub-grid with torch
    ops on the blob's device, shape tails handed to the kernel as f32
    tables, i32 bins and counts, glyph and image tails pre-rendered by the
    blocks rasterizer. → (starts i32, dyns, kops), what `blend_plain`
    takes."""
    ops, dyn_meta, n_slabs = meta
    starts = blob[:n_slabs].int()
    fo = n_slabs
    dyns = {}
    for li, (dyn_caps, dyn_ks, c0, c1) in enumerate(dyn_meta):
        ts = c1 - c0
        Tsub = tiles_y * ts
        x0px = c0 * PC.TILE_W
        sub_w = min(ts * PC.TILE_W, width - x0px)
        dyn_tables = None
        if sum(dyn_caps):
            nwords = W.words(dyn_caps)
            dyn_tables = W.dequantize(blob[fo:fo + nwords], dyn_caps)
            if x0px:
                dyn_tables = W.shift(dyn_tables, torch.tensor(
                    [float(-x0px), 0.0, -1e6, -1e6, 1e6, 1e6],
                    dtype=torch.float32, device=blob.device))
            fo += nwords
        for ci in range(3):
            k = dyn_ks[ci]
            if k == 0:
                continue
            b = blob[fo:fo + Tsub * k].reshape(Tsub, k).int()
            fo += Tsub * k
            if dyn_tables is None or sub_w <= 0:
                continue
            tabs = tuple(dyn_tables[j] for j in W.CLS_TABLES[ci])
            cnt = (b >= 0).sum(dim=1, dtype=torch.int32)
            if ci == 0:
                dyns[(li, ci)] = (tabs[0].contiguous(), tabs[1].contiguous(),
                                  b, cnt)
            else:
                dyns[(li, ci)] = PC._render_layer(
                    PC._single_class_blocks(ci, (tabs, b, None, cnt)),
                    font_tex, image_atlas, tiles_y, ts, height, sub_w)
    kops = []
    for op in ops:
        if op[0] == "dyn":
            li, ci = op[1], op[2]
            if (li, ci) not in dyns:
                continue
            c0, c1 = dyn_meta[li][2], dyn_meta[li][3]
            kops.append(("dyni", li, ci, c0, c1 - c0) if ci == 0
                        else ("dyn", li, ci, c0))
        else:
            kops.append(op)
    return starts, dyns, tuple(kops)


def _dots_scene(port, lead: float):
    """Three volatile dots 128 px apart after `lead` px over the
    background: shapes alone in the tail, its sub-grid from the dots'
    first tile column on."""
    from whisper_git_tpu.ui import rect, row, spacer, stack

    ui = stack(
        rect(width="fill", height="fill", fill=DARK.background),
        row(spacer(lead),
            *[el for x in range(3) for el in
              (rect(width=12, height=12, radius=6,
                    fill=(0.9, 0.6, 0.2, 0.9), volatile=True),
               spacer(116))],
            width="fill", height=60),
        width="fill", height="fill")
    return port.compile(port.layout(ui, (512, 128)), (512, 128),
                        DARK.background)


def _image_tail_scene(port):
    """A volatile image over the background: an image tail alone."""
    from whisper_git_tpu.ui import image, rect, row, spacer, stack

    tile = np.zeros((16, 16, 4), np.uint8)
    tile[:, :, 0] = 220
    tile[:, :, 3] = 255
    ui = stack(rect(width="fill", height="fill", fill=DARK.background),
               row(spacer(300), image(tile, width=16, height=16,
                                      volatile=True),
                   width="fill", height=60),
               width="fill", height="fill")
    return port.compile(port.layout(ui, (512, 320)), (512, 320),
                        DARK.background)


def _glyph_tail_scene(port):
    """The synthetic window scene with a volatile tail of shapes and
    glyphs, at a whole-pixel offset so that it composes."""
    scene = synthetic_scene("volatile", 0, port.regular,
                            port.regular.texture.shape[0])
    scene.windows = [dataclasses.replace(w, dy=float(int(w.dy)))
                     for w in scene.windows]
    return scene


TAIL_FIXTURES = ("shapes at column 0", "shapes off column 0", "glyphs",
                 "image", "glyphs on a mesh of two")


def _tail_fixture(name, port):
    """→ (scene, image atlas, the render mesh to install or None, the op
    kinds and a predicate on the shape tails' first columns that the
    fixture must show)."""
    if name == "shapes at column 0":
        return (_dots_scene(port, 20.0), port.image_atlas_device(), None,
                {"img", "dyni"}, lambda c0s: c0s == {0})
    if name == "shapes off column 0":
        return (_dots_scene(port, 154.0), port.image_atlas_device(), None,
                {"img", "dyni"}, lambda c0s: min(c0s) >= 1)
    if name == "image":
        return (_image_tail_scene(port), port.image_atlas_device(), None,
                {"img", "dyn"}, lambda c0s: not c0s)
    scene = _glyph_tail_scene(port)
    mesh = None if name == "glyphs" else PM.make_mesh(
        2, devices=[torch.device("cpu")] * 2)
    return (scene, torch.from_numpy(scene.image_atlas), mesh,
            {"img", "slab", "dyni", "dyn"}, lambda c0s: bool(c0s))


@pytest.mark.parametrize("name", TAIL_FIXTURES)
def test_plain_on_the_blob_is_the_old_decode_and_blend(name):
    """A composed frame whose plain compose reads the frame blob itself
    (`compose_tiles_plain` through `_compose_frame`) against the same blob
    decoded as the compose path did before (`_old_frame_tails`) and
    blended by the plain blend: byte for byte, for a shape tail at tile
    column 0 and off it, a glyph and an image tail, and on a mesh of two
    CPU devices."""
    port = Renderer("cpu")
    _fresh()
    scene, atlas, mesh, kinds, at_columns = _tail_fixture(name, port)
    font = port.font_tex_device()
    PMS.set_render_mesh(mesh)
    try:
        args, st = PC.prepare_compose_dispatch(scene, font, atlas)
        got = PC._compose_frame(*args, **st)
        starts, dyns, kops = _old_frame_tails(
            args[0], font, atlas, st["height"], st["width"], st["tiles_y"],
            st["tiles_x"], st["meta"])
    finally:
        PMS.set_render_mesh(None)
    assert {op[0] for op in kops} == kinds
    assert at_columns({op[3] for op in kops if op[0] == "dyni"})
    if mesh is not None:
        images, slabs = args[1][0], args[2][0]
    else:
        images, slabs = args[1], args[2]
    want = CK.blend_plain(starts, tuple(images), tuple(slabs), dyns,
                          ops=kops, tiles_y=st["tiles_y"],
                          tiles_x=st["tiles_x"],
                          background=st["background"], height=st["height"],
                          width=st["width"])
    assert got.shape == want.shape == (scene.height, scene.width, 4)
    assert torch.equal(got, want)


class _CountOps(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the ATen ops dispatched while it is on."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name", ("shapes off column 0", "glyphs"))
def test_frame_tails_launches_nothing_for_a_shape_tail(name):
    """A tail of shapes alone is host arithmetic: `frame_tails` dispatches
    no ATen op (on a card: launches no kernel); a glyph tail still runs its
    pre-render through the blocks rasterizer."""
    port = Renderer("cpu")
    _fresh()
    scene, atlas, _, kinds, _ = _tail_fixture(name, port)
    font = port.font_tex_device()
    args, st = PC.prepare_compose_dispatch(scene, font, atlas)
    with _CountOps() as seen:
        starts, dyns, kops = PC.frame_tails(
            args[0], font, atlas, st["height"], st["width"],
            st["tiles_y"], st["tiles_x"], st["meta"])
    assert {op[0] for op in kops} == kinds
    assert starts == slice(0, st["meta"][2])
    for op in kops:
        if op[0] == "dyni":
            assert all(isinstance(v, int) for v in dyns[(op[1], op[2])])
    if "dyn" in kinds:
        assert seen.ops, "the glyph tail was not pre-rendered"
    else:
        assert seen.ops == []


@pytest.mark.parametrize("name", TAIL_FIXTURES[:4] + ("history",))
def test_dyn_layer_packs_each_bins_row_first(name, app_fixture):
    """The compose kernel walks a shape tail's bins row up to its first
    −1: `_dyn_layer` (through `_pack_frame_blob`) puts every row's entries
    first, with only −1 after them, in every class."""
    port = app_fixture[3]
    _fresh()
    scenes = ([_scene(app_fixture, off) for off in (0.0, 17.0, 203.0)]
              if name == "history" else [_tail_fixture(name, port)[0]])
    rows = 0
    for scene in scenes:
        ty, tx = -(-scene.height // 64), -(-scene.width // 128)
        for li, lb in enumerate(scene.layers):
            _, bins, (caps, ks, c0, c1) = PF._dyn_layer(lb, li, ty, tx,
                                                        subgrid=True)
            fo = 0
            for k in ks:
                if not k:
                    continue
                b = bins[fo:fo + ty * (c1 - c0) * k].reshape(-1, k)
                fo += b.size
                empty = b < 0
                # once a slot is empty, every later slot of its row is
                assert (empty[:, 1:] >= empty[:, :-1]).all()
                rows += int((~empty).any(axis=1).sum())
    _fresh()   # the buckets' high-water marks this test raised
    assert rows > 0, "no tail had a bin entry"
