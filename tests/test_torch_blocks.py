"""The blocks rasterizer's plain version
(`blocks_kernel.render_tiles_blocks_plain`) against the reference's XLA
blocks scan (`frame._render_tiles_blocks_xla`) and against the Pallas
blocks kernel in interpret mode, on the same blocks.

The blocks are carried across from the reference: its `pack_frame` output
(frame blob, chrome arguments, window arguments) goes through the port's
`build_blocks` as torch tensors, its window and tail blocks are resolved to
plain ones (`resolve_blocks`), and the very same blocks, as jax arrays, go
through the reference's renderers."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import whisper_git_tpu.render.frame as F
from whisper_git_tpu.render import pallas_raster as PR
from whisper_git_tpu_torch.render import blocks_kernel as B
from whisper_git_tpu_torch.render import frame as PF
from whisper_git_tpu_torch.render.renderer import Renderer
from whisper_git_tpu_torch.tools.synthetic import synthetic_scene

torch.set_num_threads(2)


def _tree(fn, x):
    if x is None:
        return None
    if isinstance(x, (tuple, list)):
        return tuple(_tree(fn, v) for v in x)
    return fn(x)


def _to_torch(x):
    return _tree(lambda a: torch.from_numpy(np.array(a)), x)


def _to_jax(x):
    return _tree(lambda t: jnp.asarray(t.numpy()), x)


def reference_blocks(scene):
    """The reference's `pack_frame` output for `scene`, carried across
    into the port's block lists, every block a plain one. → (torch blocks,
    tiles_y, tiles_x)."""
    F.clear_caches()
    frame_blob, chrome_args, win_args, meta = F.pack_frame(scene)
    blocks = PF.build_blocks(torch.from_numpy(frame_blob),
                             _to_torch(chrome_args), _to_torch(win_args),
                             meta)
    return PF.resolve_blocks(blocks, meta[0], meta[1]), meta[0], meta[1]


@functools.partial(jax.jit, static_argnames=("background", "tiles_y",
                                             "tiles_x"))
def _xla_tiles(blocks, font, atlas, background, tiles_y, tiles_x):
    return F._render_tiles_blocks_xla(blocks, font, atlas, background,
                                      tiles_y, tiles_x)


def _xla_image(blocks, font, atlas, background, ty, tx, height, width):
    """The XLA blocks scan, assembled as `_render_frame` does (l.598-605):
    u8 with a background, the f32 layer without."""
    tiles = _xla_tiles(_to_jax(blocks), jnp.asarray(font), jnp.asarray(atlas),
                       background, ty, tx)
    img = np.asarray(tiles).reshape(ty, tx, F.TILE_H, F.TILE_W, 4)
    img = img.transpose(0, 2, 1, 3, 4).reshape(ty * F.TILE_H, tx * F.TILE_W,
                                               4)[:height, :width]
    if background is None:
        return img
    return np.clip(img * 255.0 + 0.5, 0.0, 255.0).astype(np.uint8)


def _u8_stats(a, b):
    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
    return int(d.max()), float((d > 2).mean())


@pytest.fixture(scope="module")
def port_renderer():
    return Renderer("cpu")


# (c) Tolerances: a shape-only scene within 1 u8 (f32 arithmetic in another
# order); scenes with glyphs or images at most 8 u8 with more than 2 u8 on
# under 1 % of values, the reference's own bound for bf16 resampling
# (tests/test_pallas_raster.py:65-66). An f32 layer is held to the same
# bounds in units of 1/255. Each test prints what it measured (`pytest -s`):
# 0 or 1 u8 on every kind, none above 2 (CHANGES.md).
KINDS_WITH_BLOCKS = ("shapes", "glyphs", "images", "empty", "ragged",
                     "window", "volatile", "windows2")


@pytest.mark.parametrize("kind", KINDS_WITH_BLOCKS)
def test_plain_matches_xla_blocks_with_background(port_renderer, kind):
    r = port_renderer
    scene = synthetic_scene(kind, 0, r.regular, r.regular.texture.shape[0])
    blocks, ty, tx = reference_blocks(scene)
    bg = tuple(float(c) for c in scene.background[:3])
    got = B.render_tiles_blocks_plain(
        blocks, r.font_tex_device(), torch.from_numpy(scene.image_atlas), bg,
        ty, tx, scene.height, scene.width).numpy()
    want = _xla_image(blocks, r.font_tex, scene.image_atlas, bg, ty, tx,
                      scene.height, scene.width)
    assert got.shape == want.shape == (scene.height, scene.width, 4)
    assert got.dtype == np.uint8
    mx, share = _u8_stats(got, want)
    print(f"plain K2 vs XLA blocks, {kind}: max {mx} u8, >2 on {share:.6f}")
    if kind in ("shapes", "empty"):
        assert mx <= 1, (kind, mx)
    else:
        assert mx <= 8 and share < 0.01, (kind, mx, share)


@pytest.mark.parametrize("kind", ("shapes", "images", "volatile",
                                  "windows2"))
def test_plain_matches_xla_blocks_on_a_transparent_canvas(port_renderer,
                                                          kind):
    r = port_renderer
    scene = synthetic_scene(kind, 1, r.regular, r.regular.texture.shape[0])
    blocks, ty, tx = reference_blocks(scene)
    got = B.render_tiles_blocks_plain(
        blocks, r.font_tex_device(), torch.from_numpy(scene.image_atlas),
        None, ty, tx, scene.height, scene.width)
    want = _xla_image(blocks, r.font_tex, scene.image_atlas, None, ty, tx,
                      scene.height, scene.width)
    assert got.dtype == torch.float32 and got.is_contiguous()
    assert tuple(got.shape) == want.shape == (scene.height, scene.width, 4)
    d = np.abs(got.numpy() - want) * 255.0
    print(f"plain K2 vs XLA blocks, {kind} f32 layer: max {d.max():.6f}/255")
    if kind == "shapes":
        assert d.max() <= 1.0, (kind, d.max())
    else:
        assert d.max() <= 8.0 and (d > 2.0).mean() < 0.01, (kind, d.max())
    # A layer, not a frame: pixels no command touched stay transparent.
    assert (got[..., 3] == 0).any() and (got[..., 3] > 0).any()


def test_three_chrome_segments_reach_the_renderer(port_renderer):
    r = port_renderer
    scene = synthetic_scene("windows2", 0, r.regular,
                            r.regular.texture.shape[0])
    blocks, _, _ = reference_blocks(scene)
    shapes, glyphs, images = blocks[0]
    # segment, window, segment, window, segment, volatile tail
    assert [lo is None for _, _, lo, _ in shapes] == \
        [False, True, False, True, False, True]
    assert len(glyphs) == 6
    assert shapes[0][1] is shapes[2][1] is shapes[4][1]  # one bins table


# (d) The Pallas blocks kernel, run as the reference's own test runs it
# (tests/test_frame_cache.py:100-141, interpret=True), at that test's
# budget: max 8 u8, more than 2 u8 on under 1 % (bf16 dot ordering).
def test_plain_matches_pallas_blocks_interpret(port_renderer):
    r = port_renderer
    scene = synthetic_scene("windows2", 0, r.regular,
                            r.regular.texture.shape[0], width=256,
                            height=128)
    blocks, ty, tx = reference_blocks(scene)
    bg = tuple(float(c) for c in scene.background[:3])
    got = B.render_tiles_blocks_plain(
        blocks, r.font_tex_device(), torch.from_numpy(scene.image_atlas), bg,
        ty, tx, scene.height, scene.width).numpy()
    font_cells, font_cols = PR.cellify(
        jnp.asarray(r.font_tex).astype(jnp.bfloat16))
    image_cells, img_cols = PR.cellify(
        jnp.asarray(scene.image_atlas).astype(jnp.bfloat16), channels=4)
    tiles = PR.render_tiles_blocks(_to_jax(blocks), font_cells, font_cols,
                                   image_cells, img_cols, bg, ty, tx,
                                   interpret=True)
    want = np.asarray(PR.assemble_planar(tiles, ty, tx, scene.height,
                                         scene.width))
    mx, share = _u8_stats(got, want)
    print(f"plain K2 vs Pallas interpret: max {mx} u8, >2 on {share:.6f}")
    assert mx <= 8 and share < 0.01, (mx, share)


# ---- the wrapper ---------------------------------------------------------------

def _small_blocks(r):
    scene = synthetic_scene("volatile", 0, r.regular,
                            r.regular.texture.shape[0], width=256,
                            height=128)
    blocks, ty, tx = reference_blocks(scene)
    return scene, blocks, ty, tx


def test_wrapper_takes_plain_version_on_cpu(port_renderer):
    r = port_renderer
    scene, blocks, ty, tx = _small_blocks(r)
    atlas = torch.from_numpy(scene.image_atlas)
    before = B.render_tiles_blocks.launches
    for bg in ((0.1, 0.2, 0.3), None):
        a = B.render_tiles_blocks(blocks, r.font_tex_device(), atlas, bg, ty,
                                  tx, scene.height, scene.width)
        b = B.render_tiles_blocks_plain(blocks, r.font_tex_device(), atlas,
                                        bg, ty, tx, scene.height,
                                        scene.width)
        assert torch.equal(a, b)
    assert B.render_tiles_blocks.launches == before  # no launch on the CPU


def test_wrapper_refuses_mesh_slices_and_other_devices(port_renderer):
    r = port_renderer
    scene, blocks, ty, tx = _small_blocks(r)
    atlas = torch.from_numpy(scene.image_atlas)
    # A mesh slice takes both of n_tiles and tile0, in whole tile rows.
    with pytest.raises(ValueError, match="go together"):
        B.render_tiles_blocks(blocks, r.font_tex_device(), atlas, None, ty,
                              tx, scene.height, scene.width, n_tiles=1)
    with pytest.raises(ValueError, match="go together"):
        B.render_tiles_blocks(blocks, r.font_tex_device(), atlas, None, ty,
                              tx, scene.height, scene.width, tile0=1)
    with pytest.raises(ValueError, match="whole rows"):
        B.render_tiles_blocks(blocks, r.font_tex_device(), atlas, None, ty,
                              tx, scene.height, scene.width, n_tiles=1,
                              tile0=0)
    with pytest.raises(ValueError, match="unsupported device"):
        B.render_tiles_blocks(blocks, r.font_tex_device().to("meta"), atlas,
                              None, ty, tx, scene.height, scene.width)


def test_descriptors_follow_z_order_and_check_their_tensors(port_renderer):
    """The host side of a launch, which the CPU can reach: one descriptor
    per block, layer by layer in class order shapes, images, glyphs, and a
    refusal of what the kernel does not take."""
    r = port_renderer
    scene, blocks, ty, tx = _small_blocks(r)
    dev = torch.device("cpu")
    desc, keep = B._descriptors(blocks, ty, tx, dev)
    want_cls = [ci for cls_lists in blocks for ci in B.Z_ORDER
                for _ in cls_lists[ci]]
    assert desc["cls"].tolist() == want_cls and len(want_cls) > 3
    assert desc.dtype.itemsize == 64
    assert not desc["kind"].any() and not desc["aux"].any()   # plain
    flat = [b for cls_lists in blocks for ci in B.Z_ORDER
            for b in cls_lists[ci]]
    for row, (tables, bins, lo, hi) in zip(desc, flat):
        assert row["t0"] == tables[0].data_ptr()
        assert row["bins"] == bins.data_ptr() and row["k"] == bins.shape[1]
        assert row["lo"] == (0 if lo is None else lo.data_ptr())
        assert row["hi"] == hi.data_ptr()
    assert len(keep) >= 4 * len(flat)
    tables, bins, lo, hi = blocks[0][0][0]
    bad = (((tables, bins.long(), lo, hi),), (), ())
    with pytest.raises(ValueError, match="bins"):
        B._descriptors((bad,), ty, tx, dev)
    bad = (((tables, bins, lo, hi[:-1]),), (), ())
    with pytest.raises(ValueError, match="rows"):
        B._descriptors((bad,), ty, tx, dev)
    bad = (((tables[:1], bins, lo, hi),), (), ())
    with pytest.raises(ValueError, match="tables"):
        B._descriptors((bad,), ty, tx, dev)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    from whisper_git_tpu_torch.render import raster_kernel as K

    monkeypatch.setattr(K.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setitem(B._LIB, "lib", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        B.build()


# ---- the layer epilogues of the compose path -----------------------------------

@pytest.mark.parametrize("kind", ("shapes", "images", "volatile",
                                  "windows2"))
def test_i16_mode_is_the_quantized_f32_layer(port_renderer, kind):
    """`layer_i16` writes `quantize_i16` of the f32 layer, value for value
    (what `compose._quant_i16_planar` made of it in a pass of its own)."""
    from whisper_git_tpu_torch.render import compose as PC

    r = port_renderer
    scene = synthetic_scene(kind, 1, r.regular, r.regular.texture.shape[0])
    blocks, ty, tx = reference_blocks(scene)
    args = (blocks, r.font_tex_device(), torch.from_numpy(scene.image_atlas),
            None, ty, tx, scene.height, scene.width)
    f32 = B.render_tiles_blocks_plain(*args)
    i16 = B.render_tiles_blocks_plain(*args, layer_i16=True)
    assert i16.dtype == torch.int16 and i16.is_contiguous()
    assert tuple(i16.shape) == (scene.height, scene.width, 4)
    assert torch.equal(i16, PC._quant_i16_planar(f32))
    assert PC._quant_i16_planar is B.quantize_i16
    assert torch.equal(i16, B.render_tiles_blocks(*args, layer_i16=True))
    assert int(i16[..., 3].max()) > 0 and int(i16.abs().max()) <= 32767


@pytest.mark.parametrize("kind", ("shapes", "images", "volatile",
                                  "windows2"))
def test_tile_rect_mode_is_the_crop_of_the_full_layer(port_renderer, kind):
    """`tile_rect` renders only those tiles: the output is the full layer
    cut to them, ending where the frame does (a ragged last row and
    column), in the f32, the i16 and the u8 mode."""
    r = port_renderer
    scene = synthetic_scene(kind, 1, r.regular, r.regular.texture.shape[0],
                            width=300, height=150)
    blocks, ty, tx = reference_blocks(scene)
    assert (ty, tx) == (3, 3)
    bg = tuple(float(c) for c in scene.background[:3])
    args = (blocks, r.font_tex_device(), torch.from_numpy(scene.image_atlas))
    size = (ty, tx, scene.height, scene.width)
    for rect in ((0, 0, 2, 1), (1, 1, 3, 3), (2, 2, 3, 3), (0, 0, 3, 3)):
        ty0, tx0, ty1, tx1 = rect
        ys = slice(ty0 * 64, min(ty1 * 64, scene.height))
        xs = slice(tx0 * 128, min(tx1 * 128, scene.width))
        for background, kw in ((None, {}), (None, {"layer_i16": True}),
                               (bg, {})):
            full = B.render_tiles_blocks_plain(*args, background, *size, **kw)
            got = B.render_tiles_blocks(*args, background, *size,
                                        tile_rect=rect, **kw)
            assert got.is_contiguous() and got.dtype == full.dtype
            assert torch.equal(got, full[ys, xs]), (rect, kw)
    assert got.shape == (150, 300, 4)


def test_layer_modes_refuse_what_has_no_meaning(port_renderer):
    r = port_renderer
    scene, blocks, ty, tx = _small_blocks(r)
    args = (blocks, r.font_tex_device(), torch.from_numpy(scene.image_atlas))
    size = (ty, tx, scene.height, scene.width)
    with pytest.raises(ValueError, match="layer_i16"):
        B.render_tiles_blocks(*args, (0.1, 0.2, 0.3), *size, layer_i16=True)
    for rect in ((0, 0, 0, 1), (0, 1, 1, 1), (-1, 0, 1, 1),
                 (0, 0, ty + 1, tx)):
        with pytest.raises(ValueError, match="tile rect"):
            B.render_tiles_blocks(*args, None, *size, tile_rect=rect)
    # a rect inside the grid but past the frame's pixels
    with pytest.raises(ValueError, match="outside"):
        B.rect_extent((0, 1, 1, 2), 1, 2, 64, 100)
    assert B.rect_extent(None, 2, 3, 100, 300) == (0, 0, 2, 3, 100, 300)
    assert B.rect_extent((1, 2, 2, 3), 2, 3, 100, 300) == (1, 2, 2, 3, 36, 44)


# ---- descriptors that ride in the launch ---------------------------------------

def test_params_struct_layout_and_the_inline_cap():
    """The parameter block as nvcc lays it out for a 64-bit target, with the
    block descriptors that ride in the launch by value at its end; the
    whole stays within the 32764 B a launch carries (CUDA 12.1 and later,
    on Volta and later cards)."""
    import ctypes

    P = B._BlocksParams
    D = B._BLOCK_DESC
    assert D.itemsize == 64 == B._BLOCK_PACK.size
    assert [D.fields[f][1] for f in D.names] == [0, 8, 16, 24, 32, 40, 48,
                                                 52, 56, 60]
    assert D.names[-2:] == ("kind", "aux")
    assert (P.blocks.offset, P.n_blocks.offset, P.out_mode.offset) == (0, 8,
                                                                       12)
    assert (P.font_tex.offset, P.image_atlas.offset) == (16, 32)
    assert (P.bg_r.offset, P.tiles_x.offset, P.ty0.offset) == (48, 60, 68)
    assert (P.rect_tx.offset, P.height.offset, P.out.offset) == (76, 80, 88)
    assert P.inline_blocks.offset == 96
    assert B.MAX_INLINE_BLOCKS == 64
    assert ctypes.sizeof(P) == 96 + B.MAX_INLINE_BLOCKS * 64 <= 32764


@pytest.mark.parametrize("n", (0, 3, 64, 65))
def test_descriptors_ride_inline_up_to_the_cap(n):
    """Up to the cap the rows are copied into the parameter block and no
    tensor is made; one row more and the list goes through an array in
    device memory, the inline rows untouched."""
    import ctypes

    from whisper_git_tpu_torch.render import raster_kernel as K

    rng = np.random.default_rng(n)
    desc = np.zeros(n, dtype=B._BLOCK_DESC)
    for name in B._BLOCK_DESC.names:
        desc[name] = rng.integers(1, 2 ** 31 - 1, n)
    p = B._BlocksParams()
    dev = K.place_descriptors(p, "blocks", "inline_blocks", desc,
                              B.MAX_INLINE_BLOCKS, torch.device("cpu"))
    inline = bytes(p.inline_blocks)
    if n <= B.MAX_INLINE_BLOCKS:
        assert dev is None and not p.blocks
        assert inline[:desc.nbytes] == desc.tobytes()
        assert not any(inline[desc.nbytes:])
    else:
        assert not any(inline)
        assert dev.dtype == torch.uint8 and dev.numel() == desc.nbytes
        assert p.blocks == dev.data_ptr()
        assert dev.numpy().tobytes() == desc.tobytes()
    assert ctypes.sizeof(p) == ctypes.sizeof(B._BlocksParams)
