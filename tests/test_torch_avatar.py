"""Avatars through the port: its zlib PNG decoder (`render/renderer.py::
decode_png`) against Pillow, the avatar disk cache (`services/avatar.py`)
against the reference's, and the history view with a primed cache against
the reference's frame.

Tolerances: the decoder 0 (Pillow's `convert("RGBA")`, value for value);
a cached avatar 0 where it is already 64×64 and at most 1 u8 where the
cache resizes it (the port's numpy Lanczos, `tests/test_torch_ops.py`);
the history view the reference's image bound, at most 8 u8 with more than
2 u8 on under 1 % of values (`tests/test_pallas_raster.py`).

No test reaches the network: `urllib.request.urlopen` raises in every test
that fetches, as it does on a machine without a network."""

from __future__ import annotations

import io
import struct
import urllib.error
import urllib.request
import zlib

import numpy as np
import pytest
import torch

from whisper_git_tpu_torch.render.renderer import decode_png, png_bytes
from whisper_git_tpu_torch.tools import avatar_fixture as AF

torch.set_num_threads(2)

VIEWPORT = (1280, 800)
KIND_CORRUPT = AF.KINDS.index("corrupt")


@pytest.fixture
def no_network(monkeypatch):
    def refuse(*a, **k):
        raise urllib.error.URLError("no network in the tests")

    monkeypatch.setattr(urllib.request, "urlopen", refuse)


def _image(mode: str, rng) -> "object":
    from PIL import Image

    h, w = 37, 53
    yy, xx = np.mgrid[0:h, 0:w]
    a = (np.stack([xx * 4, yy * 6, (xx + yy) * 3, 255 - xx * 2], -1)
         % 256).astype(np.uint8)
    a[::5] = rng.integers(0, 256, (len(a[::5]), w, 4))   # noisy rows
    if mode == "P":
        im = Image.fromarray(rng.integers(0, 256, (h, w)).astype(np.uint8),
                             "P")
        im.putpalette(rng.integers(0, 256, 768).astype(np.uint8).tobytes())
        return im
    channels = {"RGBA": [0, 1, 2, 3], "RGB": [0, 1, 2], "L": 0,
                "LA": [0, 3]}[mode]
    return Image.fromarray(a[..., channels], mode)


SAVES = {"level0": {"compress_level": 0}, "level9": {"compress_level": 9},
         "optimize": {"optimize": True}}
MODES = ("RGBA", "RGB", "L", "LA", "P", "P+tRNS", "L+tRNS", "RGB+tRNS")


def _pillow_png(mode: str, save: str, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    base = mode.partition("+")[0]
    im = _image(base, rng)
    kw = dict(SAVES[save])
    if mode == "P+tRNS":
        kw["transparency"] = rng.integers(0, 256, 100).astype(
            np.uint8).tobytes()
    elif mode == "L+tRNS":
        kw["transparency"] = int(np.asarray(im)[0, 0])
    elif mode == "RGB+tRNS":
        kw["transparency"] = tuple(int(v) for v in np.asarray(im)[0, 0])
    buf = io.BytesIO()
    im.save(buf, "PNG", **kw)
    return buf.getvalue()


def _filters(data: bytes) -> set:
    """The row filter types of an 8-bit PNG."""
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", data[pos + 8:pos + 8 + n])
        elif tag == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    w, h, _, ctype = hdr[:4]
    stride = w * {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype] + 1
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    return set(raw.reshape(h, stride)[:, 0].tolist())


@pytest.mark.parametrize("save", sorted(SAVES))
@pytest.mark.parametrize("mode", MODES)
def test_decoder_equals_pillow(mode, save):
    from PIL import Image

    data = _pillow_png(mode, save, seed=len(mode) * 7 + len(save))
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
    got = decode_png(data)
    assert got is not None and got.dtype == np.uint8
    assert np.array_equal(got, want)


def test_the_pillow_cases_cover_every_filter():
    seen = set()
    for mode in MODES:
        for save in SAVES:
            seen |= _filters(_pillow_png(mode, save,
                                         seed=len(mode) * 7 + len(save)))
    assert seen == {0, 1, 2, 3, 4}


@pytest.mark.parametrize("shape", [(1, 1), (20, 30), (64, 64), (7, 300)])
def test_decoder_round_trips_png_bytes(shape):
    img = np.random.default_rng(shape[1]).integers(
        0, 256, shape + (4,)).astype(np.uint8)
    assert np.array_equal(decode_png(png_bytes(img)), img)


def _bad_pngs() -> dict:
    from PIL import Image

    rng = np.random.default_rng(3)
    rgb = rng.integers(0, 256, (24, 24, 3)).astype(np.uint8)
    out = {}
    buf = io.BytesIO()
    Image.fromarray(rgb, "RGB").save(buf, "JPEG")
    out["jpeg"] = buf.getvalue()
    buf = io.BytesIO()
    Image.fromarray(rgb[..., 0].astype(np.uint16) * 257).save(buf, "PNG")
    out["16-bit"] = buf.getvalue()
    buf = io.BytesIO()
    im = Image.fromarray((rgb[..., 0] % 4).astype(np.uint8), "P")
    im.putpalette([0, 0, 0, 255, 0, 0, 0, 255, 0, 0, 0, 255])
    im.save(buf, "PNG")
    out["2-bit palette"] = buf.getvalue()
    good = png_bytes(np.dstack([rgb, np.full((24, 24), 255, np.uint8)]))
    # Pillow writes no interlaced PNG: the same file with IHDR's interlace
    # method set to Adam7 (and its CRC made good again).
    ihdr = bytearray(good[12:29])
    ihdr[-1] = 1
    out["interlaced"] = (good[:12] + bytes(ihdr)
                         + struct.pack(">I", zlib.crc32(bytes(ihdr)))
                         + good[33:])
    out["truncated"] = good[:len(good) // 2]
    out["no IEND"] = good[:-12]
    bad_crc = bytearray(good)
    bad_crc[40] ^= 0xFF
    out["bad CRC"] = bytes(bad_crc)
    out["empty"] = b""
    out["corrupt"] = b"\x89PNG\r\n\x1a\n" + bytes(range(200))
    return out


@pytest.mark.parametrize("what", ["jpeg", "16-bit", "interlaced",
                                  "2-bit palette", "truncated", "no IEND",
                                  "bad CRC", "empty", "corrupt"])
def test_decoder_refuses_what_it_does_not_read(what):
    assert decode_png(_bad_pngs()[what]) is None


# -- the avatar cache ----------------------------------------------------------

@pytest.fixture
def primed(tmp_path, monkeypatch, no_network):
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    monkeypatch.delenv("WGIT_SKIP_AVATARS", raising=False)
    emails = AF.author_emails()
    return emails, AF.prime_avatar_cache(emails)


def test_download_avatar_from_the_cache_equals_the_reference(primed):
    from whisper_git_tpu.services import avatar as ref_avatar
    from whisper_git_tpu_torch.services import avatar as port_avatar

    emails, kinds = primed
    for email in emails:
        got = port_avatar.download_avatar(email, timeout=0.1)
        want = ref_avatar.download_avatar(email, timeout=0.1)
        if kinds[email] == "corrupt":
            assert got is None and want is None
            continue
        assert got.shape == want.shape == (64, 64, 4)
        assert got.dtype == want.dtype == np.uint8
        d = np.abs(got.astype(np.int16) - want.astype(np.int16))
        assert d.max() <= (1 if kinds[email] == "96" else 0), (email, d.max())
        if kinds[email] == "64":
            assert np.array_equal(got, AF.avatar_image(
                emails.index(email), 64))


def test_prefetch_loads_seven_and_fails_one(primed):
    from whisper_git_tpu_torch.services.avatar import AvatarCache, AvatarState

    emails, kinds = primed
    cache = AvatarCache()
    cache.prefetch_sync(emails, timeout=3.0)
    states = [cache._states[e] for e in emails]
    assert states.count(AvatarState.LOADED) == 7
    assert cache._states[emails[KIND_CORRUPT]] is AvatarState.FAILED
    assert all(cache.get(e).shape == (64, 64, 4) for e in emails
               if kinds[e] != "corrupt")
    assert cache.get(emails[KIND_CORRUPT]) is None



def test_a_fetched_avatar_is_saved_with_png_bytes(tmp_path, monkeypatch):
    """An avatar fetched from the network lands in the disk cache as the
    port's own PNG, which the decoder reads back."""
    from PIL import Image

    from whisper_git_tpu_torch.services import avatar as port_avatar

    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    img = AF.avatar_image(5, 80)
    buf = io.BytesIO()
    Image.fromarray(img, "RGBA").save(buf, "PNG")

    class Response(io.BytesIO):
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(urllib.request, "urlopen",
                        lambda req, timeout: Response(buf.getvalue()))
    got = port_avatar.download_avatar("net@example.com")
    assert got.shape == (64, 64, 4)
    with open(port_avatar._cache_path("net@example.com"), "rb") as f:
        data = f.read()
    assert data == png_bytes(got)
    assert np.array_equal(decode_png(data), got)


# -- the history view with avatars ---------------------------------------------

def _app(pkg: str, repo: str):
    if pkg == "ref":
        from whisper_git_tpu.app.repo_tab import RepoTab
        from whisper_git_tpu.app.ui_app import WhisperApp
    else:
        from whisper_git_tpu_torch.app.repo_tab import RepoTab
        from whisper_git_tpu_torch.app.ui_app import WhisperApp
    tab = RepoTab.open(repo)
    tab.refresh_sync(include_orphans=False)
    app = WhisperApp.with_tabs([tab])
    emails = sorted({c.author_email for c in tab.commits if c.author_email})
    app.avatar_cache.prefetch_sync(emails, timeout=3.0)
    return app


def test_history_view_with_avatars_matches_reference(primed, tmp_path,
                                                     monkeypatch):
    from test_torch_slice import fresh_compile_caches

    import whisper_git_tpu.render.rasterizer as R
    from whisper_git_tpu.render.renderer import get_renderer
    from whisper_git_tpu.ui.theme import DARK
    from whisper_git_tpu_torch.render import rasterizer as P
    from whisper_git_tpu_torch.render.renderer import Renderer
    from whisper_git_tpu_torch.services.avatar import AvatarState

    repo = AF.build_authors_repo(str(tmp_path))
    ref_app, port_app = _app("ref", repo), _app("port", repo)
    states = port_app.avatar_cache._states
    assert sorted(s.value for s in states.values()) == \
        ["failed"] + ["loaded"] * 7
    assert {e: s.value for e, s in ref_app.avatar_cache._states.items()} \
        == {e: s.value for e, s in states.items()}
    assert sum(s is AvatarState.LOADED for s in states.values()) == 7
    ref, port = get_renderer(), Renderer("cpu")
    fresh_compile_caches(ref, port)
    vp = (float(VIEWPORT[0]), float(VIEWPORT[1]))
    ref_scene = ref.compile(ref.layout(ref_app.build(vp), VIEWPORT),
                            VIEWPORT, DARK.background)
    port_scene = port.compile(port.layout(port_app.build(vp), VIEWPORT),
                              VIEWPORT, DARK.background)
    n_images = sum(int(layer.n_images) for layer in port_scene.layers) + sum(
        len(w.comp.images) for w in port_scene.windows)
    assert n_images >= 7, "the history view drew no avatar quads"
    assert port.compiler.atlas_version > 0
    got = P.render_scene(port_scene, port.font_tex_device(),
                         port.image_atlas_device())
    monkeypatch.setenv("WGIT_FRAME_CACHE", "0")
    want = R.render_scene(ref_scene, ref.font_tex_device(),
                          ref.image_atlas_device())
    assert got.shape == want.shape == (800, 1280, 4)
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.max() <= 8
    assert (d > 2).mean() < 0.01


def test_bench_frame_is_unchanged_with_the_cache_on(tmp_path, monkeypatch,
                                                    no_network):
    """The bench leaves the avatar cache on: its one author's fetch fails
    with no network, the view draws the identicon, and the frame equals
    the frame with the cache off."""
    import bench

    from whisper_git_tpu_torch.app.repo_tab import RepoTab
    from whisper_git_tpu_torch.app.ui_app import WhisperApp
    from whisper_git_tpu_torch.app.views import widgets
    from whisper_git_tpu_torch.render.rasterizer import render_scene
    from whisper_git_tpu_torch.render.renderer import get_renderer
    from whisper_git_tpu_torch.services.avatar import AvatarState
    from whisper_git_tpu_torch.ui.theme import DARK

    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    monkeypatch.delenv("WGIT_SKIP_AVATARS", raising=False)
    tab = RepoTab.open(bench.build_history_repo(str(tmp_path), 30))
    tab.refresh_sync(include_orphans=False)
    app = WhisperApp.with_tabs([tab])
    assert app.avatar_cache.enabled
    app.avatar_cache.prefetch_sync(["bench@example.com"], timeout=3.0)
    assert app.avatar_cache._states["bench@example.com"] is \
        AvatarState.FAILED
    r = get_renderer("cpu")
    size = (640, 400)
    # The dirty dot pulses with the clock: pinned, two frames of one state
    # are equal.
    monkeypatch.setattr(widgets, "_PULSE_FREEZE", 1.0)

    def frame():
        tree = app.build((float(size[0]), float(size[1])))
        scene = r.compile(r.layout(tree, size), size, DARK.background)
        return render_scene(scene, r.font_tex_device(),
                            r.image_atlas_device())

    on = frame()
    app.avatar_cache.enabled = False
    assert np.array_equal(on, frame())
