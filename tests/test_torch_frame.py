"""The port's frame cache (`whisper_git_tpu_torch/render/frame.py`) against
the reference's (`whisper_git_tpu/render/frame.py`) on the CPU: the host
half byte-equal, the device half bit-equal, the frame bit-identical to the
port's packed path, the cache behaviour, and the port's copies of the
scene compiler and the layout against the originals."""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import whisper_git_tpu.render.frame as F
import whisper_git_tpu.render.rasterizer as R
from test_torch_slice import fresh_compile_caches
from whisper_git_tpu.render.renderer import get_renderer
from whisper_git_tpu.ui.theme import DARK
from whisper_git_tpu_torch.render import blocks_kernel as B
from whisper_git_tpu_torch.render import frame as PF
from whisper_git_tpu_torch.render import rasterizer as P
from whisper_git_tpu_torch.render.blocks_kernel import render_tiles_blocks
from whisper_git_tpu_torch.render.renderer import Renderer
from whisper_git_tpu_torch.tools.synthetic import synthetic_scene

torch.set_num_threads(2)

VIEWPORT = (1280, 800)
SCROLL_OFFSETS = (0.0, 13.0, 17.0, 63.9, 64.0, 100.3, 111.5, 128.5)


def _fresh():
    """Both packages' frame caches and bucket high-water marks emptied, so
    that the same scenes in the same order give the same padding."""
    for mod in (F, PF):
        mod.clear_caches()
        mod._WR_HW.clear()
        mod._DYN_HW.clear()
    for mod in (R, P):
        mod._WIN_HOST_CACHE.clear()
        mod._WIN_DEV_CACHE.clear()


@pytest.fixture(scope="module")
def history(tmp_path_factory):
    """The reference's app on the bench's fixture repository (cut to 60
    commits), with the reference's and the port's renderers."""
    import bench
    from whisper_git_tpu.app.repo_tab import RepoTab
    from whisper_git_tpu.app.ui_app import WhisperApp

    repo = bench.build_history_repo(str(tmp_path_factory.mktemp("hist")), 60)
    tab = RepoTab.open(repo)
    tab.refresh_sync(include_orphans=False)
    app = WhisperApp.with_tabs([tab])
    app.avatar_cache.enabled = False
    ref, port = get_renderer(), Renderer("cpu")
    fresh_compile_caches(ref, port)
    return app, tab, ref, port, repo


def _compile_both(history, off: float, viewport=VIEWPORT):
    app, tab, ref, port = history[:4]
    tab.history_scroll = float(off)
    tree = app.build((float(viewport[0]), float(viewport[1])))
    return (ref.compile(ref.layout(tree, viewport), viewport,
                        DARK.background),
            port.compile(port.layout(tree, viewport), viewport,
                         DARK.background))


def _same(x, y, label):
    """A reference value (jax or numpy array, None, or a nest of them)
    equal to the port's (torch tensor, ...), in type, shape and bytes."""
    if x is None or y is None:
        assert x is None and y is None, label
    elif isinstance(x, (tuple, list)):
        assert len(x) == len(y), label
        for i, (a, b) in enumerate(zip(x, y)):
            _same(a, b, f"{label}[{i}]")
    else:
        a, b = np.asarray(x), y.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, label
        assert a.tobytes() == b.tobytes(), label


def _assert_pack_frame_equal(ref_scene, port_scene, label):
    n_ref, n_port = len(F._CHROME_CACHE), len(PF._CHROME_CACHE)
    blob_r, chrome_r, win_r, meta_r = F.pack_frame(ref_scene)
    blob_p, chrome_p, win_p, meta_p = PF.pack_frame(port_scene)
    assert blob_r.dtype == blob_p.dtype == np.int16, label
    assert blob_r.tobytes() == blob_p.tobytes(), label
    assert meta_r == meta_p, label
    _same(chrome_r, chrome_p, f"{label} chrome")   # tables, bins, segs
    _same(win_r, win_p, f"{label} windows")        # tables, (P, counts)
    # What rides beside the arrays: the chrome entries made by this call,
    # and every pair-bin entry, in insertion order.
    new_r = list(F._CHROME_CACHE.values())[n_ref:]
    new_p = list(PF._CHROME_CACHE.values())[n_port:]
    assert len(new_r) == len(new_p), label
    for er, ep in zip(new_r, new_p):
        for key in ("ks", "caps", "counts", "seg_totals", "seg_boxes"):
            assert er[key] == ep[key], (label, key)
    pairs_r = [v for v in F._WIN_PAIR_DEV.values() if v is not None]
    pairs_p = [v for v in PF._WIN_PAIR_DEV.values() if v is not None]
    assert len(pairs_r) == len(pairs_p), label
    for er, ep in zip(pairs_r, pairs_p):
        for key in ("row0", "WR", "kP", "wr_cap"):
            assert er[key] == ep[key], (label, key)
        _same((er["P"], er["counts"]), (ep["P"], ep["counts"]),
              f"{label} pair bins")


# ---- (a) the host half: pack_frame ------------------------------------------

def test_pack_frame_byte_equal_on_fixture_scene():
    import __graft_entry__ as g

    _fresh()
    scene = g._compiled_scene(256, 128)[1]
    _assert_pack_frame_equal(scene, scene, "graft-256x128")


@pytest.mark.parametrize("kind", ("window", "volatile", "windows2"))
def test_pack_frame_byte_equal_on_synthetic_scenes(kind):
    _fresh()
    port = Renderer("cpu")
    for seed in (0, 1):
        scene = synthetic_scene(kind, seed, port.regular,
                                port.regular.texture.shape[0])
        _assert_pack_frame_equal(scene, scene, f"{kind}-{seed}")
    if kind == "windows2":   # two windows cut chrome into three segments
        segs = PF.pack_frame(scene)[1][0][2]
        assert segs[0].shape[0] == 4 and segs[1].shape[0] == 4


def test_pack_frame_byte_equal_on_history_view(history):
    """One pass over the eight offsets with warm caches, as a scroll is."""
    _fresh()
    for off in SCROLL_OFFSETS:
        ref_scene, port_scene = _compile_both(history, off)
        assert port_scene.windows, "history scroll window was not recorded"
        _assert_pack_frame_equal(ref_scene, port_scene, f"history@{off}")


# ---- (b) the device half, piece by piece -------------------------------------

def test_dequant_parts_bit_equal():
    rng = np.random.default_rng(0)
    caps = (64, 256, 64)
    n = sum(caps[PF._PART_CLS[name]] * cols
            for name, cols, _ in P._PART_SPECS)
    blob = rng.integers(-32767, 32768, n).astype(np.int16)
    _same(F._dequant_parts(jnp.asarray(blob), caps),
          PF._dequant_parts(torch.from_numpy(blob), caps), "dequant")


@pytest.mark.parametrize("dy", (0.0, -37.375, 63.875, 100.25))
def test_shift_parts_bit_equal(dy):
    rng = np.random.default_rng(1)
    caps = (64, 64, 64)
    n = sum(caps[PF._PART_CLS[name]] * cols
            for name, cols, _ in P._PART_SPECS)
    blob = rng.integers(-3000, 3000, n).astype(np.int16)
    blob[::16] = rng.integers(0, 2, blob[::16].shape) * 8  # shape types 0/1
    dx = np.float32(12.5)
    clip = tuple(np.float32(c) for c in (10.0, 20.25, 300.0, 200.5))
    want = F._shift_parts(F._dequant_parts(jnp.asarray(blob), caps),
                          jnp.float32(dx), jnp.float32(dy),
                          tuple(jnp.float32(c) for c in clip))
    u = torch.tensor([dx, np.float32(dy), *clip, 0.0, 0.0])
    got = PF._shift_parts(PF._dequant_parts(torch.from_numpy(blob), caps), u)
    _same(want, got, f"shift dy={dy}")


@pytest.mark.parametrize("dy", (0.0, 63.9, 64.0, 100.3, 111.5, 128.5, -63.9,
                                -64.0, -200.125))
def test_pair_bin_gather_bit_equal(dy):
    """`_gather_pair_bins` against the reference's lines in
    `_render_frame` (frame.py l.517-522), at fractional scroll offsets and
    at exact tile multiples, with rows falling off both ends."""
    rng = np.random.default_rng(2)
    tiles_y, tiles_x, wr_cap = 13, 10, 8
    # (row0, WR, kP) of the three classes: rows falling off the top, off
    # the bottom, and a class with no rows at all.
    classes = ((-2, 5, 16), (3, 8, 8), (0, 0, 8))
    dyq = np.float32(np.rint(dy * 8.0)) / np.float32(8.0)
    uni2 = np.zeros(8, np.int32)
    for ci, (row0, WR, _) in enumerate(classes):
        uni2[2 * ci:2 * ci + 2] = (row0, WR)
    av, ok = PF._pair_rows(torch.from_numpy(uni2), torch.tensor(dyq),
                           tiles_y)
    for ci, (row0, WR, kP) in enumerate(classes):
        Pn = rng.integers(-1, 40, (wr_cap, tiles_x, kP)).astype(np.int32)
        counts = rng.integers(0, kP + 1, (wr_cap, tiles_x)).astype(np.int32)

        Pj, cj = jnp.asarray(Pn), jnp.asarray(counts)
        dyj, row0j, WRj = jnp.float32(dyq), jnp.int32(row0), jnp.int32(WR)
        r = jnp.arange(tiles_y, dtype=jnp.float32) * F.TILE_H
        a = jnp.floor((r - dyj) / F.TILE_H).astype(jnp.int32) - row0j
        avj = jnp.clip(a, 0, jnp.maximum(WRj - 1, 0))
        bins = Pj[avj].reshape(tiles_y * tiles_x, kP)
        cnt = jnp.where(((a >= 0) & (a < WRj))[:, None], cj[avj], 0
                        ).reshape(tiles_y * tiles_x).astype(jnp.int32)

        got = PF._gather_pair_bins(torch.from_numpy(Pn),
                                   torch.from_numpy(counts), av[ci], ok[ci],
                                   kP)
        _same((bins, cnt), got, f"gather dy={dy} class {ci}")


# ---- (c) the window and tail blocks K2 resolves from the frame blob ----------

def _torch_route_blocks(frame_blob, chrome_args, win_args, meta):
    """A frame's plain blocks made in torch over the whole frame at once,
    in the order K2 draws them: the uniforms from the frame blob, every
    window's tables moved (`_shift_parts`) and its pair bins gathered by
    the scroll offset (`_pair_rows`, `_gather_pair_bins`), each layer's
    volatile tail de-quantized from the blob (`_dequant_parts`) with its
    bins widened and counted."""
    tiles_y, tiles_x, n_win, win_meta, layers_meta = meta
    T = tiles_y * tiles_x
    if n_win:
        head = frame_blob[:n_win * 16].reshape(2, n_win, 8)
        uni = head[0].float() * PF._uniform_scale(frame_blob.device)
        uni2 = head[1].int()
    fo = n_win * 16
    win_blocks = []
    for wi in range(n_win):
        shifted = PF._shift_parts(win_args[wi][0], uni[wi])
        av, ok = PF._pair_rows(uni2[wi], uni[wi, 1], tiles_y)
        cls_blocks = []
        for ci in range(3):
            cm = win_meta[wi][2][ci]
            if cm is None:
                cls_blocks.append(None)
                continue
            P_, counts = win_args[wi][1][ci]
            cls_blocks.append(PF._gather_pair_bins(P_, counts, av[ci],
                                                   ok[ci], cm[0]))
        win_blocks.append((shifted, tuple(cls_blocks)))
    layers_blocks = []
    for li, (caps, ks, lws, dyn_meta, _) in enumerate(layers_meta):
        parts, bins3, segs3 = chrome_args[li]
        dyn_caps, dyn_ks = dyn_meta[0], dyn_meta[1]
        dyn_tables = None
        if sum(dyn_caps):
            nwords = sum(dyn_caps[PF._PART_CLS[name]] * cols
                         for name, cols, _ in P._PART_SPECS)
            dyn_tables = PF._dequant_parts(frame_blob[fo:fo + nwords],
                                           dyn_caps)
            fo += nwords
        dyn_bins = []
        for k in dyn_ks:
            if k == 0:
                dyn_bins.append(None)
                continue
            b = frame_blob[fo:fo + T * k].reshape(T, k).int()
            fo += T * k
            dyn_bins.append((b, (b >= 0).sum(dim=1, dtype=torch.int32)))
        cls_lists = []
        for ci in range(3):
            blocks = []
            idx = PF._CLS_TABLES[ci]
            for si in range(len(lws) + 1):
                if ks[ci]:
                    blocks.append((tuple(parts[j] for j in idx), bins3[ci],
                                   segs3[ci][si], segs3[ci][si + 1]))
                if si < len(lws):
                    wsh, wcls = win_blocks[lws[si]]
                    if wcls[ci] is not None:
                        blocks.append((tuple(wsh[j] for j in idx),
                                       wcls[ci][0], None, wcls[ci][1]))
            if dyn_bins[ci] is not None and dyn_tables is not None:
                blocks.append((tuple(dyn_tables[j] for j in idx),
                               dyn_bins[ci][0], None, dyn_bins[ci][1]))
            cls_lists.append(tuple(blocks))
        layers_blocks.append(tuple(cls_lists))
    return tuple(layers_blocks)


def _assert_blocks_equal(got, want, label):
    """Two nests of plain blocks equal: the same structure, every tensor
    of the same type, shape and bytes."""
    if isinstance(want, torch.Tensor):
        assert isinstance(got, torch.Tensor), label
        assert got.dtype == want.dtype and got.shape == want.shape, label
        assert torch.equal(got, want), label
    elif want is None:
        assert got is None, label
    else:
        assert type(got) is tuple and len(got) == len(want), label
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_blocks_equal(g, w, f"{label}[{i}]")


# Offsets of a drag: whole, fractional, past a tile row; "end" is 0.375 px
# short of the last offset, where the history ends above the frame's
# bottom, so that tile rows there fall outside the window's pair rows.
BLOB_OFFSETS = (0.0, 63.9, 111.5, "end")


@pytest.mark.parametrize("off", BLOB_OFFSETS)
def test_window_and_tail_blocks_equal_the_torch_route(history, off,
                                                      monkeypatch):
    """The history view's frame-cache blocks, window and tail blocks that
    K2 resolves from the frame blob: resolved to plain blocks, they are
    the torch route's, tensor for tensor; drawn by the plain version they
    give its frame bit for bit, and the JAX package's frame cache's within
    the glyph resampling bound."""
    _, tab, ref, port, _ = history
    _fresh()
    at_end = off == "end"
    if at_end:
        _compile_both(history, 0.0)
        off = max(0.0, tab.graph_layout.total_height - 200.0) - 0.375
    ref_scene, scene = _compile_both(history, off)
    blob, chrome, wins, meta = PF.pack_frame(scene)
    ty, tx, n_win = meta[:3]
    blob_t = torch.from_numpy(blob)
    blocks = PF.build_blocks(blob_t, chrome, wins, meta)
    flat = [b for cls_lists in blocks for c in cls_lists for b in c]
    n_windows = sum(isinstance(b, PF.WindowBlock) for b in flat)
    assert n_windows and any(isinstance(b, PF.TailBlock) for b in flat)
    want = _torch_route_blocks(blob_t, chrome, wins, meta)
    _assert_blocks_equal(PF.resolve_blocks(blocks, ty, tx), want, f"@{off}")
    # Tile rows that read no pair row of a window class, at the end.
    uni = blob_t[:n_win * 16].reshape(2, n_win, 8)
    outside = 0
    for wi in range(n_win):
        _, ok = PF._pair_rows(uni[1, wi].int(),
                              uni[0, wi, 1].float() / 8.0, ty)
        outside += sum(int((ok[ci] == 0).sum())
                       for ci in range(3) if meta[3][wi][2][ci] is not None)
    assert outside > 0 or not at_end
    args = (port.font_tex_device(), port.image_atlas_device(),
            tuple(float(c) for c in scene.background[:3]), ty, tx,
            scene.height, scene.width)
    got = B.render_tiles_blocks_plain(blocks, *args)
    assert torch.equal(got, B.render_tiles_blocks_plain(want, *args))
    monkeypatch.setenv("WGIT_FRAME_COMPOSE", "0")
    ref_img = np.asarray(F.render_frame_device(
        ref_scene, ref.font_tex_device(), ref.image_atlas_device()))
    d = np.abs(got.numpy().astype(np.int16) - ref_img.astype(np.int16))
    print(f"blob blocks vs JAX frame cache at {off}: max {d.max()} u8, "
          f">2 on {(d > 2).mean():.6f}")
    assert d.max() <= 8 and (d > 2).mean() < 0.01


def test_a_drag_frames_descriptors_ride_inline(history):
    """A drag frame of the history view at 1280x800 (a fractional offset,
    which compose declines): its descriptors ride in the launch, its
    windows point at their uniform rows of the blob and its tails at their
    tables and bins there."""
    import ctypes

    from whisper_git_tpu_torch.render import raster_kernel as K

    _fresh()
    scene = _compile_both(history, 37.625)[1]
    blob, chrome, wins, meta = PF.pack_frame(scene)
    ty, tx, n_win = meta[:3]
    blob_t = torch.from_numpy(blob)
    blocks = PF.build_blocks(blob_t, chrome, wins, meta)
    desc, keep = B._descriptors(blocks, ty, tx, torch.device("cpu"))
    assert 0 < len(desc) <= B.MAX_INLINE_BLOCKS
    p = B._BlocksParams()
    assert K.place_descriptors(p, "blocks", "inline_blocks", desc,
                               B.MAX_INLINE_BLOCKS, "cpu") is None
    assert bytes(p.inline_blocks)[:desc.nbytes] == desc.tobytes()
    base = blob_t.data_ptr()
    flat = [(ci, b) for cls_lists in blocks for ci in B.Z_ORDER
            for b in cls_lists[ci]]
    assert len(flat) == len(desc)
    for row, (ci, b) in zip(desc, flat):
        if isinstance(b, PF.WindowBlock):
            assert row["kind"] == 1 and row["aux"] == 8 * n_win
            assert row["lo"] == base + 16 * b.window
            assert row["bins"] == b.P.data_ptr() and row["k"] == b.P.shape[2]
            assert row["hi"] == b.counts.data_ptr()
        elif isinstance(b, PF.TailBlock):
            offs = B.tail_tables(b.at, b.caps, ci)
            assert row["kind"] == 2 and row["k"] == b.k
            assert [row[f] for f in ("t0", "t1", "t2")][:len(offs)] == \
                [base + 2 * o for o in offs]
            assert row["bins"] == base + 2 * b.bins and row["hi"] == 0
        else:
            assert row["kind"] == 0
    kinds = desc["kind"].tolist()
    assert kinds.count(1) >= 2 and kinds.count(2) >= 1
    assert ctypes.sizeof(p) <= 32764


def test_tail_tables_follow_the_part_specs():
    """`tail_tables` finds each class's tables where `_quant_parts_blob`
    puts them: the seven parts of `_PART_SPECS` one after another."""
    caps = (8, 16, 4)
    at, fo, want = 40, 40, {}
    for name, cols, _ in P._PART_SPECS:
        want.setdefault(PF._PART_CLS[name], []).append(fo)
        fo += caps[PF._PART_CLS[name]] * cols
    for ci in range(3):
        assert list(B.tail_tables(at, caps, ci)) == want[ci]


# ---- (e) the slice ------------------------------------------------------------

@pytest.fixture(scope="module")
def history_frames(history):
    """Port frames of the history view at 1280×800 through the frame cache
    and through the packed path, at the eight offsets."""
    _, _, _, port, _ = history
    _fresh()
    out = {}
    for off in SCROLL_OFFSETS:
        ref_scene, port_scene = _compile_both(history, off)
        font, atlas = port.font_tex_device(), port.image_atlas_device()
        cached = PF.render_frame_device(port_scene, font, atlas).numpy()
        fused, meta, ty, tx, win_list = P.pack_scene(port_scene)
        layer_data, sig = P.unpack_layers(
            torch.from_numpy(fused),
            tuple(torch.from_numpy(b) for _, _, b in win_list), meta,
            ty * tx)
        packed = P.render_tiles(
            layer_data, font, atlas,
            tuple(float(c) for c in port_scene.background[:3]), ty, tx, sig,
            port_scene.height, port_scene.width).numpy()
        out[off] = (ref_scene, cached, packed)
    return out


@pytest.mark.parametrize("off", SCROLL_OFFSETS)
def test_frame_cache_bit_identical_to_packed_path(history_frames, off):
    _, cached, packed = history_frames[off]
    assert cached.shape == packed.shape == (800, 1280, 4)
    assert cached.dtype == np.uint8
    assert np.array_equal(cached, packed)


@pytest.mark.parametrize("off", (0.0, 63.9, 111.5))
def test_history_frame_matches_reference_frame_cache(history, history_frames,
                                                     off, monkeypatch):
    _, _, ref, _, _ = history
    ref_scene, cached, _ = history_frames[off]
    monkeypatch.setenv("WGIT_FRAME_COMPOSE", "0")
    want = np.asarray(F.render_frame_device(
        ref_scene, ref.font_tex_device(), ref.image_atlas_device()))
    assert want.shape == cached.shape
    d = np.abs(cached.astype(np.int16) - want.astype(np.int16))
    print(f"frame cache vs JAX frame cache at {off}: max {d.max()} u8, "
          f">2 on {(d > 2).mean():.6f}")
    # Glyph resampling bound (tests/test_pallas_raster.py), as the packed
    # slice is held to in tests/test_torch_slice.py.
    assert d.max() <= 8
    assert (d > 2).mean() < 0.01


def test_render_scene_device_dispatch(history, monkeypatch):
    """Three levels: compose by default, the frame cache with
    WGIT_FRAME_COMPOSE=0 or when compose declines (a fractional scroll
    offset), the packed path with WGIT_FRAME_CACHE=0; oversized scenes
    take the f32 path before any of them."""
    from whisper_git_tpu_torch.render import compose as PC

    _, _, _, port, _ = history
    fractional = synthetic_scene("volatile", 0, port.regular,
                                 port.regular.texture.shape[0])
    assert fractional.windows[0].dy != int(fractional.windows[0].dy)
    scene = dataclasses.replace(fractional, windows=[
        dataclasses.replace(w, dy=float(int(w.dy)))
        for w in fractional.windows])
    font = port.font_tex_device()
    atlas = torch.from_numpy(scene.image_atlas)
    calls = []
    real_frame, real_composed = (PF.render_frame_device,
                                 PC.render_frame_composed)
    monkeypatch.setattr(PF, "render_frame_device",
                        lambda *a: calls.append("cache") or real_frame(*a))
    monkeypatch.setattr(
        PC, "render_frame_composed",
        lambda *a: calls.append("compose") or real_composed(*a))
    monkeypatch.delenv("WGIT_FRAME_CACHE", raising=False)
    monkeypatch.delenv("WGIT_FRAME_COMPOSE", raising=False)
    composed = P.render_scene_device(scene, font, atlas)
    assert calls == ["compose"]
    monkeypatch.setenv("WGIT_FRAME_COMPOSE", "0")
    a = P.render_scene_device(scene, font, atlas)
    assert calls == ["compose", "cache"]
    monkeypatch.setenv("WGIT_FRAME_CACHE", "0")
    b = P.render_scene_device(scene, font, atlas)
    assert calls == ["compose", "cache"]
    assert torch.equal(a, b)
    assert int((composed.int() - b.int()).abs().max()) <= 1
    # A fractional offset under the default: compose is asked, declines,
    # and the frame is the frame cache's, bit for bit the packed path's.
    del calls[:]
    want = P.render_scene_device(fractional, font, atlas)
    monkeypatch.delenv("WGIT_FRAME_CACHE")
    monkeypatch.delenv("WGIT_FRAME_COMPOSE")
    assert PC.render_frame_composed(fractional, font, atlas) is None
    del calls[:]
    got = P.render_scene_device(fractional, font, atlas)
    assert calls == ["compose", "cache"]
    assert torch.equal(got, want)
    big = dataclasses.replace(scene, width=P.MAX_PACKED_PX + 1)
    del calls[:]
    img = P.render_scene_device(big, font, atlas)
    assert calls == []
    assert img.shape == (big.height, big.width, 4)
    assert torch.equal(img, P._render_scene_f32_device(big, font, atlas))


def test_render_frame_device_defaults_to_the_scenes_image_atlas():
    port = Renderer("cpu")
    scene = synthetic_scene("images", 0, port.regular,
                            port.regular.texture.shape[0])
    font = port.font_tex_device()
    assert torch.equal(
        PF.render_frame_device(scene, font),
        PF.render_frame_device(scene, font,
                               torch.from_numpy(scene.image_atlas)))


def test_cpu_frame_launches_no_kernel(history):
    _, _, _, port, _ = history
    before = render_tiles_blocks.launches
    scene = synthetic_scene("window", 0, port.regular,
                            port.regular.texture.shape[0])
    PF.render_frame_device(scene, port.font_tex_device())
    assert render_tiles_blocks.launches == before


# ---- (f) cache behaviour (tests/test_frame_cache.py:65-98) ---------------------

SMALL = (640, 480)


def _port_scene(history, off):
    return _compile_both(history, off, SMALL)[1]


def _render(history, scene):
    port = history[3]
    return PF.render_frame_device(scene, port.font_tex_device(),
                                  port.image_atlas_device()).numpy()


def test_cache_hits_render_identically(history):
    PF.clear_caches()
    cold = _render(history, _port_scene(history, 40.0))
    n_entries = len(PF._CHROME_CACHE)
    assert n_entries > 0
    warm = _render(history, _port_scene(history, 40.0))
    assert np.array_equal(cold, warm)
    assert len(PF._CHROME_CACHE) == n_entries


def test_chrome_cache_hit_across_scroll(history):
    """Pure scrolling reuses the chrome entry (the scrollbar thumb is
    volatile → dynamic tail, so the static prefix is byte-stable)."""
    PF.clear_caches()
    first, second = _port_scene(history, 10.0), _port_scene(history, 27.0)
    assert first.windows[0].dy != second.windows[0].dy
    _render(history, first)
    n_entries = len(PF._CHROME_CACHE)
    n_parts = len(PF._WIN_PARTS_DEV)
    _render(history, second)
    assert len(PF._CHROME_CACHE) == n_entries  # no new chrome entries
    assert len(PF._WIN_PARTS_DEV) == n_parts   # window tables stay resident


def test_chrome_change_invalidates(history):
    """A real chrome change (a selected commit opens the details pane)
    gives a new chrome entry and different pixels, not a stale hit."""
    app, tab = history[:2]
    PF.clear_caches()
    base = _render(history, _port_scene(history, 0.0))
    n_entries = len(PF._CHROME_CACHE)
    sel = next(c.oid for c in tab.commits if not c.is_synthetic)
    app.handle_action(f"select-commit:{sel}")
    try:
        changed = _render(history, _port_scene(history, 0.0))
    finally:
        app.handle_action("escape")
        tab.select_commit(None)
    assert not np.array_equal(base, changed)
    assert len(PF._CHROME_CACHE) > n_entries


def test_caches_are_keyed_by_device(history):
    """A value cached for one device is not handed out for another."""
    PF.clear_caches()
    scene = _port_scene(history, 5.0)
    PF.pack_frame(scene, "cpu")
    n = (len(PF._CHROME_CACHE), len(PF._WIN_PARTS_DEV),
         len(PF._WIN_PAIR_DEV))
    PF.pack_frame(scene, "meta")
    assert (len(PF._CHROME_CACHE), len(PF._WIN_PARTS_DEV),
            len(PF._WIN_PAIR_DEV)) == tuple(2 * v for v in n)
    PF.clear_caches()


# ---- (h) the port's copies of the compiler and the layout ----------------------

def _buffers(scene):
    out = []
    for lb in scene.layers:
        out.append({f.name: getattr(lb, f.name)
                    for f in dataclasses.fields(lb)})
    wins = [(w.layer, w.dx, w.dy, tuple(w.clip), tuple(w.pos),
             {f.name: getattr(w.comp, f.name)
              for f in dataclasses.fields(w.comp)
              if f.name not in ("uid", "dyn")})
            for w in scene.windows]
    return out, wins, (scene.width, scene.height, tuple(scene.background))


def _assert_nested_equal(a, b, label):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), label
        for k in a:
            _assert_nested_equal(a[k], b[k], f"{label}.{k}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), label
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_nested_equal(x, y, f"{label}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, label
        assert a.tobytes() == b.tobytes(), label
    else:
        assert a == b, label


def _fresh_app(pkg: str, repo: str):
    """A new app of package `pkg` on `repo` (row geometry is memoized per
    app, so two apps are compared from the same start)."""
    import importlib

    repo_tab = importlib.import_module(f"{pkg}.app.repo_tab")
    ui_app = importlib.import_module(f"{pkg}.app.ui_app")
    tab = repo_tab.RepoTab.open(repo)
    tab.refresh_sync(include_orphans=False)
    app = ui_app.WhisperApp.with_tabs([tab])
    app.avatar_cache.enabled = False
    return app, tab


def test_copied_compiler_and_layout_match_reference(history, monkeypatch):
    """The reference's app, layout and compiler against the port's copies
    of all three on the same repository, over a scroll: every command
    buffer and every scroll window byte-equal."""
    from whisper_git_tpu.app.views import widgets as ref_widgets
    from whisper_git_tpu_torch.app.views import widgets as port_widgets
    from whisper_git_tpu_torch.ui.theme import DARK as PORT_DARK

    _, _, ref, port, repo = history
    # The dirty dot pulses with the clock: pin it in both packages.
    monkeypatch.setattr(ref_widgets, "_PULSE_FREEZE", 1.0)
    monkeypatch.setattr(port_widgets, "_PULSE_FREEZE", 1.0)
    fresh_compile_caches(ref, port)
    app, tab = _fresh_app("whisper_git_tpu", repo)
    papp, ptab = _fresh_app("whisper_git_tpu_torch", repo)
    vp = (float(VIEWPORT[0]), float(VIEWPORT[1]))
    for off in (0.0, 63.9, 128.5):
        tab.history_scroll = ptab.history_scroll = float(off)
        ref_scene = ref.compile(ref.layout(app.build(vp), VIEWPORT),
                                VIEWPORT, DARK.background)
        port_scene = port.compile(port.layout(papp.build(vp), VIEWPORT),
                                  VIEWPORT, PORT_DARK.background)
        assert port_scene.windows
        _assert_nested_equal(_buffers(ref_scene), _buffers(port_scene),
                             f"history@{off}")
