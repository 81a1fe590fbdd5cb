"""The compose kernel's plain version
(`whisper_git_tpu_torch/render/compose_kernel.py::compose_tiles_plain`)
against the reference's Pallas kernel in interpret mode
(`whisper_git_tpu/render/pallas_compose.py::compose_tiles`) on the same
bytes, made from a seed with numpy; and the wrapper's rules on the CPU.

Tolerance: at most 1 u8 a channel. Both sides do the same f32 arithmetic
in the same order, so 0 is expected and the count above 0 is printed."""

from __future__ import annotations

import ctypes
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import whisper_git_tpu.render.pallas_compose as PC
import whisper_git_tpu.render.pallas_raster as PR
from whisper_git_tpu_torch.render import compose_kernel as CK
from whisper_git_tpu_torch.render import raster_kernel as K
from whisper_git_tpu_torch.render import wire as W
from whisper_git_tpu_torch.tools.synthetic import (COMPOSE_CASES,
                                                   compose_args_to,
                                                   synthetic_compose)

torch.set_num_threads(2)

TILE_H, TILE_W = CK.TILE_H, CK.TILE_W


# ---- carrying arguments between the two kernels --------------------------------

def planar(layer: np.ndarray) -> np.ndarray:
    """The port's interleaved (h, w, 4) layer → the reference's planar
    (Ty, Tx, 4, TH, TW) tiles, padded with transparency to whole tiles."""
    h, w = layer.shape[:2]
    ty, tx = -(-h // TILE_H), -(-w // TILE_W)
    full = np.zeros((ty * TILE_H, tx * TILE_W, 4), layer.dtype)
    full[:h, :w] = layer
    return np.ascontiguousarray(
        full.reshape(ty, TILE_H, tx, TILE_W, 4).transpose(0, 2, 4, 1, 3))


def interleaved(tiles: np.ndarray) -> np.ndarray:
    """The reference's planar (Ty, Tx, 4, TH, TW) tiles → the port's
    interleaved (Ty·TH, Tx·TW, 4) layer."""
    ty, tx = tiles.shape[:2]
    return np.ascontiguousarray(
        np.asarray(tiles).transpose(0, 3, 1, 4, 2).reshape(
            ty * TILE_H, tx * TILE_W, 4))


def port_compose_args(args, statics) -> dict:
    """The reference's compose dispatch, the `(args, statics)` of its
    `prepare_compose_dispatch` in kernel mode, as the keyword arguments of
    the port's `compose._compose_frame` on the CPU: the same blob, the
    same i16 values of every chrome layer and slab in the port's
    interleaved layout, the same plan."""
    blob, images, slabs = args[:3]
    out = {k: statics[k] for k in ("background", "height", "width",
                                   "tiles_y", "tiles_x", "meta")}
    out["blob"] = torch.from_numpy(np.array(blob))
    out["images"] = tuple(torch.from_numpy(interleaved(a)) for a in images)
    out["slabs"] = tuple(torch.from_numpy(interleaved(a)) for a in slabs)
    return out


def old_decode(blob: torch.Tensor, starts: slice, dyns: dict, ops: tuple,
               tiles_y: int) -> tuple:
    """The decode the compose path ran with torch ops before the kernel
    read the blob itself (`compose.frame_tails` then): the slab starts as
    i32, and each inline shape tail's tables de-quantized over its layer's
    seven parts (`wire.dequantize`, the shapes alone), translated to
    its sub-grid (`wire.shift`), its bins as i32 and their
    non-negative slots counted. → (starts, dyns) as the blend takes them;
    a pre-rendered tail is kept as it is."""
    out = dict(dyns)
    for op in ops:
        key = (op[1], op[2])
        if op[0] != "dyni" or key not in dyns:
            continue
        shapes_at, clips_at, bins_at, cap, k = dyns[key]
        c0, ts = op[3], op[4]
        assert clips_at == shapes_at + cap * 16
        tables = W.dequantize(blob[shapes_at:shapes_at + cap * 20],
                              (cap, 0, 0))
        if c0 * TILE_W:
            tables = W.shift(tables, torch.tensor(
                [float(-c0 * TILE_W), 0.0, -1e6, -1e6, 1e6, 1e6],
                dtype=torch.float32))
        b = blob[bins_at:bins_at + tiles_y * ts * k].reshape(-1, k).int()
        out[key] = (tables[0].contiguous(), tables[1].contiguous(), b,
                    (b >= 0).sum(dim=1, dtype=torch.int32))
    return blob[starts].int(), out


def _reference_frame(a: dict) -> np.ndarray:
    """`synthetic_compose`'s arguments, decoded as the compose path did
    (`old_decode`), through the reference's kernel in interpret mode and
    its `assemble_u8`."""
    t = compose_args_to(a, "cpu")
    starts, decoded = old_decode(t["blob"], t["starts"], t["dyns"],
                                 t["ops"], t["tiles_y"])
    dyns = {}
    for key, v in decoded.items():
        if isinstance(v, tuple):
            dyns[key] = tuple(jnp.asarray(x.numpy()) for x in v)
        else:
            dyns[key] = jnp.asarray(planar(v.numpy()))
    out5 = PC.compose_tiles(
        jnp.asarray(starts.numpy()),
        tuple(jnp.asarray(planar(x)) for x in a["images"]),
        tuple(jnp.asarray(planar(x)) for x in a["slabs"]), dyns,
        ops=a["ops"], tiles_y=a["tiles_y"], tiles_x=a["tiles_x"],
        background=tuple(float(c) for c in a["background"]), interpret=True)
    return np.asarray(PR.assemble_u8(out5, a["tiles_y"], a["tiles_x"],
                                     a["height"], a["width"]))


POS = ("blob", "images", "slabs", "dyns")


def _port_frame(a: dict, fn=CK.compose_tiles_plain) -> np.ndarray:
    t = compose_args_to(a, "cpu")
    pos = [t.pop(k) for k in POS]
    return fn(*pos, **t).numpy()


# ---- the plain version against the reference's kernel --------------------------

@pytest.mark.parametrize("seed", (0, 1))
@pytest.mark.parametrize("case", COMPOSE_CASES)
def test_plain_matches_reference_kernel(case, seed):
    a = synthetic_compose(case, seed)
    got, want = _port_frame(a), _reference_frame(a)
    assert got.shape == want.shape == (300, 384, 4)
    assert got.dtype == np.uint8
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    print(f"{case} seed {seed}: max {d.max()} u8, {(d > 0).sum()} values "
          "above 0")
    assert d.max() <= 1
    assert (got[..., 3] == 255).all()


@pytest.mark.parametrize("seed", (0, 1))
@pytest.mark.parametrize("case", COMPOSE_CASES)
def test_plain_on_the_blob_is_the_old_decode_and_blend(case, seed):
    """The plain version reading the blob (`decode_tail`, then the blend)
    against the blob decoded as the compose path did before
    (`old_decode`) and the same blend: byte for byte, capsules and clips
    of tails off tile column 0 among them."""
    t = compose_args_to(synthetic_compose(case, seed), "cpu")
    pos = [t.pop(k) for k in POS]
    starts, decoded = old_decode(pos[0], t["starts"], pos[3], t["ops"],
                                 t["tiles_y"])
    want = CK.blend_plain(starts, *pos[1:3], decoded,
                          **{k: v for k, v in t.items() if k != "starts"})
    assert torch.equal(CK.compose_tiles_plain(*pos, **t), want)
    for op in t["ops"]:
        if op[0] == "dyni":
            got = CK.decode_tail(pos[0], pos[3][(op[1], op[2])], op[3],
                                 op[4], t["tiles_y"])
            for a, b in zip(got, decoded[(op[1], op[2])]):
                assert a.dtype == b.dtype and torch.equal(a, b)


def test_kernel_reciprocals_are_the_blob_scales():
    """The reciprocal scales the kernels multiply a tail's i16 values by
    are np.float32(1 / scale) of the blob's shape and clip columns, powers
    of two, and the `__constant__` table the compose and blocks kernels
    share holds the same, beside the quad's and the glyph colour's."""
    shape_scale, clip_scale = W.SCALES[0], W.SCALES[1]
    SHAPE_INV, CLIP_INV = W.INV_SCALES[0], W.INV_SCALES[1]
    assert SHAPE_INV.dtype == np.float32
    assert np.array_equal(SHAPE_INV, np.float32(1.0) / shape_scale)
    assert (clip_scale == np.float32(1.0) / CLIP_INV).all()
    assert all(np.log2(v) == int(np.log2(v)) for v in shape_scale)
    with open(os.path.join(K.CSRC_DIR, "raster_steps.cuh")) as f:
        src = f.read()
    table = src[src.index("SHAPE_INV[16] = {"):].split("}")[0]
    vals = [np.float32(1.0) / np.float32(x.split("/")[1].strip()[:-1])
            for x in table.split("{")[1].split(",")]
    assert np.array_equal(np.float32(vals), SHAPE_INV)
    assert "CLIP_INV = 1.0f / 4.0f;" in src
    quad = W.SCALES[2]
    assert (quad == np.float32([8.0] * 4 + [1.0] * 4)).all()
    assert "QUAD_XY_INV = 1.0f / 8.0f;" in src
    assert W.SCALES[3][0] == 8192.0
    assert "COLOUR_INV = 1.0f / 8192.0f;" in src
    for name in ("compose_tiles.cu", "raster_blocks.cu"):
        with open(os.path.join(K.CSRC_DIR, name)) as f:
            assert '#include "raster_steps.cuh"' in f.read()


def test_cases_hold_every_op_kind():
    kinds = {op[0] for case in COMPOSE_CASES
             for op in synthetic_compose(case, 0)["ops"]}
    assert kinds == {"img", "slab", "dyni", "dyn"}
    layers = synthetic_compose("layers", 0)
    slab_h = layers["slabs"][0].shape[0]
    starts = layers["blob"][layers["starts"]].tolist()
    assert starts[0] % TILE_H == 0 and starts[1] % TILE_H != 0
    assert starts[2] == slab_h - layers["height"]
    _, i, ty0, tx0 = layers["ops"][2]
    assert ty0 > 0 and tx0 > 0
    # the rect ends on the frame's ragged last tile row
    assert layers["images"][i].shape[0] == layers["height"] - ty0 * TILE_H
    assert layers["images"][i].shape[0] % TILE_H != 0
    assert any(op[0] == "dyni" and op[3] >= 1
               for op in synthetic_compose("tails", 0)["ops"])
    assert synthetic_compose("windowless", 0)["starts"] == slice(0, 0)


def test_empty_op_list_is_the_background():
    a = synthetic_compose("empty", 0)
    got = _port_frame(a)
    bg = [int(c * 255.0 + 0.5) for c in a["background"]] + [255]
    assert (got == np.asarray(bg, np.uint8)).all()


# ---- what each op does, on the plain version ------------------------------------

def _one_op(op, images=(), slabs=(), starts=(), dyns=None, tail=(),
            height=192, width=384):
    """`op` alone through the plain version, on a blob of the slab
    `starts` and then the i16 values `tail`."""
    blob = torch.tensor(list(starts) + list(tail), dtype=torch.int16)
    return CK.compose_tiles_plain(
        blob, tuple(images), tuple(slabs), dyns or {},
        starts=slice(0, len(starts)), ops=(op,), tiles_y=3, tiles_x=3,
        background=(0.0, 0.0, 0.0), height=height, width=width).numpy()


def _solid(h, w, value=32767):
    return torch.full((h, w, 4), value, dtype=torch.int16)


def test_img_covers_only_its_rect():
    out = _one_op(("img", 0, 1, 2), images=[_solid(64, 128)])
    lit = out[..., 0] == 255
    assert lit[64:128, 256:384].all()
    assert lit.sum() == 64 * 128


def test_img_past_the_frame_is_cut():
    out = _one_op(("img", 0, 2, 0), images=[_solid(64, 384)], height=150)
    assert out.shape == (150, 384, 4)
    assert (out[128:, :, 0] == 255).all() and (out[:128, :, 0] == 0).all()


def test_slab_reads_from_its_start_under_the_y_clip():
    slab = torch.zeros((512, 384, 4), dtype=torch.int16)
    slab[100:110] = 32767           # rows 100..109 of the slab are lit
    out = _one_op(("slab", 0, (0.0, 0.0, 384.0, 192.0)), slabs=[slab],
                  starts=[63])
    rows = np.nonzero(out[:, 0, 0])[0]
    assert rows.tolist() == list(range(37, 47))      # 100 − 63 = 37
    # pixel centres: row y is inside the clip iff cy0 <= y + 0.5 <= cy1
    out = _one_op(("slab", 0, (0.0, 40.5, 384.0, 43.25)), slabs=[slab],
                  starts=[63])
    assert np.nonzero(out[:, 0, 0])[0].tolist() == [40, 41, 42]


def test_inline_tail_is_evaluated_at_subgrid_local_x():
    """A dot in the blob at frame x 276, a tail over the sub-grid from tile
    column 2, is moved to the sub-grid's x 20 and lands at its global
    position (the reference's regression for global x here:
    tests/test_compose.py, the inline tail off column 0)."""
    shapes = np.zeros((8, 16), np.float32)
    shapes[0, 1:6] = (276.0, 30.0, 12.0, 12.0, 6.0)
    shapes[0, 7:11] = 1.0
    clips = np.tile(np.float32([-8000.0, -8000.0, 8000.0, 8000.0]), (8, 1))
    bins = np.full((3, 8), -1, np.int16)
    bins[0, 0] = 0
    tail = np.concatenate([
        np.rint(shapes * W.SHAPE_COL_SCALE).astype(np.int16).ravel(),
        np.rint(clips * 4.0).astype(np.int16).ravel(), bins.ravel()])
    out = _one_op(("dyni", 0, 0, 2, 1), dyns={(0, 0): (0, 128, 160, 8, 8)},
                  tail=tail)
    ys, xs = np.nonzero(out[..., 0] == 255)
    assert ys.size and xs.min() >= 256 + 20 and xs.max() < 256 + 32
    assert ys.min() >= 30 and ys.max() < 42
    assert (out[..., 0][:, :256] == 0).all()
    d = CK.decode_tail(torch.from_numpy(tail), (0, 128, 160, 8, 8), 2, 1, 3)
    assert d[0][0, 1].item() == 20.0 and d[1][0, 0].item() == -8256.0
    assert d[3].tolist() == [1, 0, 0]


def test_prerendered_tail_blends_unscaled_at_its_column():
    layer = torch.zeros((192, 128, 4))
    layer[10:20, 5:9] = torch.tensor([0.5, 0.25, 0.0, 0.5])
    out = _one_op(("dyn", 0, 1, 1), dyns={(0, 1): layer})
    assert (out[10:20, 133:137, 0] == 128).all()
    assert (out[10:20, 133:137, 1] == 64).all()
    assert out[..., :3].sum() == 10 * 4 * (128 + 64)
    # a tail whose key is absent is skipped
    assert (_one_op(("dyn", 0, 2, 0))[..., :3] == 0).all()


# ---- the wrapper on the CPU -------------------------------------------------------

def test_wrapper_takes_plain_version_on_cpu():
    before = CK.compose_tiles.launches
    a = synthetic_compose("tails", 3)
    assert np.array_equal(_port_frame(a, CK.compose_tiles), _port_frame(a))
    assert CK.compose_tiles.launches == before  # no kernel launch on the CPU


def test_wrapper_rejects_a_mesh_slice_and_other_devices():
    a = compose_args_to(synthetic_compose("empty", 0), "cpu")
    pos = [a.pop(k) for k in POS]
    # A mesh slice takes both of n_rows and row0, and rows to blend.
    with pytest.raises(ValueError, match="go together"):
        CK.compose_tiles(*pos, **a, n_rows=2)
    with pytest.raises(ValueError, match="no slice"):
        CK.compose_tiles(*pos, **a, n_rows=0, row0=0)
    assert CK.compose_tiles(*pos, **a, n_rows=2, row0=0).shape[0] == 128
    pos[0] = torch.empty((0,), dtype=torch.int16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        CK.compose_tiles(*pos, **a)


def test_descriptors_mirror_the_ops():
    a = compose_args_to(synthetic_compose("tails", 0), "cpu")
    desc, keep = CK.op_descriptors(a["blob"], a["images"], a["slabs"],
                                   a["dyns"], a["ops"], a["tiles_y"],
                                   torch.device("cpu"))
    assert CK._OP_DESC.itemsize == 64
    assert desc["kind"].tolist() == [CK._KINDS[op[0]] for op in a["ops"]]
    img, tail, slab, pre = desc[0], desc[1], desc[2], desc[3]
    assert (img["h"], img["w"]) == a["images"][0].shape[:2]
    assert img["src"] == a["images"][0].data_ptr()
    shapes_at, clips_at, bins_at, cap, k = a["dyns"][(0, 0)]
    # the tail's offsets in the blob, and no pointer of its own
    assert (tail["src"], tail["shapes"], tail["clips"], tail["bins"]) == (
        0, shapes_at, clips_at, bins_at)
    assert (tail["tx0"], tail["ts"], tail["k"]) == (1, 2, k)
    assert (slab["slab"], slab["cy0"], slab["h"]) == (
        0, 33.0, a["slabs"][0].shape[0])
    assert (pre["tx0"], pre["ts"], pre["w"]) == (2, 1, 128)
    assert len(keep) == 2 + 1 + 1
    # a tail whose key is absent gets no descriptor
    desc2, _ = CK.op_descriptors(a["blob"], a["images"], a["slabs"], {},
                                 a["ops"], a["tiles_y"], torch.device("cpu"))
    assert desc2["kind"].tolist() == [0, 1, 0]


@pytest.mark.parametrize("bad", ("dtype", "shape", "strided", "bins"))
def test_descriptors_reject_what_the_kernel_does_not_take(bad):
    a = compose_args_to(synthetic_compose("tails", 0), "cpu")
    images, dyns = list(a["images"]), dict(a["dyns"])
    if bad == "dtype":
        images[0] = images[0].float()
    elif bad == "shape":
        images[0] = images[0][..., :3].contiguous()
    elif bad == "strided":
        images[0] = images[0][:, ::2]
    else:   # the tail's bins would run past the blob's end
        shapes, clips, bins, cap, k = dyns[(0, 0)]
        dyns[(0, 0)] = (shapes, clips, a["blob"].shape[0] - k, cap, k)
    with pytest.raises(ValueError, match="compose_tiles"):
        CK.op_descriptors(a["blob"], tuple(images), a["slabs"], dyns,
                          a["ops"], a["tiles_y"], torch.device("cpu"))


def test_params_struct_layout():
    """The parameter block as nvcc lays it out for a 64-bit target: a
    pointer and two ints, the blob's pointer and the starts' offset, three
    floats and five ints padded to 8, one pointer, then the op descriptors
    that ride in the launch by value."""
    assert CK._ComposeParams.blob.offset == 16
    assert CK._ComposeParams.starts.offset == 24
    assert CK._ComposeParams.out.offset == 64
    assert CK._ComposeParams.inline_ops.offset == 72
    assert ctypes.sizeof(CK._ComposeParams) == 72 + CK.MAX_INLINE_OPS * 64
    # a launch may carry 4 KB of parameters
    assert ctypes.sizeof(CK._ComposeParams) <= 4096


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(K.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setitem(CK._LIB, "lib", None)
    monkeypatch.setattr(K, "BUILD_DIR", str(tmp_path / "_build"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        CK.build()


# ---- descriptors that ride in the launch, rows kept with a plan ------------------

def test_descriptor_row_packs_as_the_struct_mirror():
    """A row's bytes, packed field by field, read back through the numpy
    mirror of `ComposeOp`."""
    assert CK._OP_PACK.size == CK._OP_DESC.itemsize == 64
    row = CK._row("op", "slab", src=4096, h=7, w=9, slab=3, cy0=1.5,
                  cy1=20.25)
    d = np.frombuffer(row, dtype=CK._OP_DESC)[0]
    assert (d["src"], d["kind"], d["h"], d["w"], d["slab"]) == (4096, 1, 7, 9,
                                                                3)
    assert (d["cy0"], d["cy1"], d["clips"], d["ts"]) == (1.5, 20.25, 0, 0)
    with pytest.raises(ValueError, match="aligned to 16"):
        CK._row("op", "dyn", src=4096 + 8)


@pytest.mark.parametrize("n", (0, 7, 48, 49))
def test_ops_ride_inline_up_to_the_cap(n):
    """Up to `MAX_INLINE_OPS` descriptors are copied into the parameter
    block and no tensor is made; one more and the list goes through an
    array in device memory, the inline rows untouched."""
    assert CK.MAX_INLINE_OPS == 48
    layer = torch.zeros((64, 128, 4), dtype=torch.int16)
    ops = tuple(("img", 0, i % 3, i % 2) for i in range(n))
    desc, keep = CK.op_descriptors(torch.zeros(0, dtype=torch.int16),
                                   (layer,), (), {}, ops, 3,
                                   torch.device("cpu"))
    assert len(desc) == len(keep) == n
    p = CK._ComposeParams()
    dev = K.place_descriptors(p, "ops", "inline_ops", desc,
                              CK.MAX_INLINE_OPS, torch.device("cpu"))
    inline = bytes(p.inline_ops)
    if n <= CK.MAX_INLINE_OPS:
        assert dev is None and not p.ops
        assert inline[:desc.nbytes] == desc.tobytes()
        assert not any(inline[desc.nbytes:])
    else:
        assert not any(inline)
        assert p.ops == dev.data_ptr() and dev.dtype == torch.uint8
        assert dev.numpy().tobytes() == desc.tobytes()


def test_plan_rows_spare_a_frame_its_static_rows():
    """`PlanRows` builds and checks the "img" and "slab" rows once; a frame
    that brings them builds only its tails' rows, to the same bytes, and
    rows made for other layers are not used."""
    a = compose_args_to(synthetic_compose("tails", 0), "cpu")
    dev = torch.device("cpu")
    args = (a["blob"], a["images"], a["slabs"], a["dyns"], a["ops"],
            a["tiles_y"], dev)
    n_static = sum(op[0] in ("img", "slab") for op in a["ops"])
    assert 0 < n_static < len(a["ops"])
    built = CK._static_row.built
    fresh, keep_fresh = CK.op_descriptors(*args)
    assert CK._static_row.built == built + n_static
    rows = CK.PlanRows(a["images"], a["slabs"], a["ops"], dev)
    assert CK._static_row.built == built + 2 * n_static
    assert len(rows.rows) == n_static
    assert rows.serves(a["images"], a["slabs"], dev)
    for _ in range(3):                       # three frames of the plan
        desc, keep = CK.op_descriptors(*args, rows)
        assert desc.tobytes() == fresh.tobytes()
        assert [t.data_ptr() for t in keep] == \
            [t.data_ptr() for t in keep_fresh]
    assert CK._static_row.built == built + 2 * n_static
    # the same values in other tensors: another plan's layers
    other = tuple(t.clone() for t in a["images"])
    assert not rows.serves(other, a["slabs"], dev)
    desc, _ = CK.op_descriptors(args[0], other, *args[2:], rows)
    assert CK._static_row.built == built + 3 * n_static
    assert desc["src"][0] == other[0].data_ptr() != fresh["src"][0]
    # the checks that guard the kernel's reads hold at plan build
    with pytest.raises(ValueError, match="compose_tiles"):
        CK.PlanRows((a["images"][0].float(),) + a["images"][1:], a["slabs"],
                    a["ops"], dev)
