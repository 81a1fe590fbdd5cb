"""The port's screenshot CLI runs without JAX, Pillow and matplotlib; the
device choice never falls back to the CPU; the PNG writer round-trips."""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_slice import fresh_compile_caches
from whisper_git_tpu_torch.render import raster_kernel as K
from whisper_git_tpu_torch.render.renderer import (Renderer, get_renderer,
                                                   png_bytes, save_png)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Runs the CLI, with jax, jaxlib, PIL and matplotlib unimportable when the
# first argument is "block", then fails (exit 3) if any of them made it
# into sys.modules anyway.
BLOCKED_RUN = """
import importlib.abc, runpy, sys
BLOCK = ("jax", "jaxlib", "PIL", "matplotlib")
class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCK:
            raise ImportError(f"{name} is blocked")
        return None
if sys.argv[1] == "block":
    sys.meta_path.insert(0, _Block())
sys.argv = ["whisper_git_tpu_torch"] + sys.argv[2:]
try:
    runpy.run_module("whisper_git_tpu_torch", run_name="__main__")
finally:
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCK)
    if loaded:
        print("imported:", loaded, file=sys.stderr)
        sys.exit(3)
"""


@pytest.fixture(scope="module")
def cli_env(tmp_path_factory):
    import bench

    base = tmp_path_factory.mktemp("cli")
    repo = bench.build_history_repo(str(base), 20)
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "WGIT_DEVICE", "XLA_FLAGS")}
    env.update(PYTHONPATH=ROOT, WGIT_SKIP_AVATARS="1",
               XDG_STATE_HOME=str(base / "state"),
               XDG_CACHE_HOME=str(base / "cache"),
               XDG_CONFIG_HOME=str(base / "config"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2")
    script = base / "blocked_run.py"
    script.write_text(BLOCKED_RUN)
    return base, repo, env, str(script)


def _cli(cli_env, out: str, *extra: str, mode: str = "block",
         repo: str | None = None):
    base, history_repo, env, script = cli_env
    return subprocess.run(
        [sys.executable, script, mode, "--screenshot", out, "--size",
         "1280x800", "--repo", repo or history_repo, *extra],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)


def _big_diff_repo(base) -> str:
    """A repository whose last commit rewrites 100 lines: enough paired
    -/+ lines that the reference computes word highlights with its JAX
    op (`ops/diffword.py`)."""
    path = str(base / "big-diff")
    env = dict(os.environ, GIT_AUTHOR_DATE="1700000000 +0000",
               GIT_COMMITTER_DATE="1700000000 +0000")

    def git(*args):
        subprocess.run(["git", "-C", path, *args], check=True,
                       capture_output=True, env=env)

    os.makedirs(path)
    git("init", "-q", "-b", "main")
    git("config", "user.email", "test@example.com")
    git("config", "user.name", "Test")
    for version in ("old", "new"):
        with open(os.path.join(path, "lines.txt"), "w") as f:
            f.writelines(f"line {i} {version} text\n" for i in range(100))
        git("add", "lines.txt")
        git("commit", "-q", "-m", f"{version} lines")
    return path


def test_cli_screenshot_runs_without_jax_pil_matplotlib(cli_env):
    from PIL import Image

    out = str(cli_env[0] / "shot.png")
    res = _cli(cli_env, out, "--device", "cpu")
    assert res.returncode == 0, res.stderr[-3000:]
    assert f"wrote {out}" in res.stdout
    with Image.open(out) as im:
        assert im.format == "PNG" and im.mode == "RGBA"
        assert im.size == (1280, 800)
        img = np.asarray(im)
    assert (img[..., 3] == 255).all()
    assert len(np.unique(img.reshape(-1, 4), axis=0)) > 50


def test_cli_cuda_without_gpu_fails(cli_env):
    out = str(cli_env[0] / "never.png")
    res = _cli(cli_env, out)  # --device defaults to cuda
    assert res.returncode != 0
    assert "CUDA is not available" in res.stderr
    assert not os.path.exists(out)


def test_cli_refuses_jax_where_a_view_reaches_it(cli_env):
    """The diff view of a large diff reaches the word-diff op
    (`ops/diffword.py`), which runs on JAX in the reference. The port's
    own op (torch, on the CLI's device) serves it, JAX is refused in the
    process even where it is installed, and the view renders: the child
    exits 0 only if no module of JAX was loaded (mode "check")."""
    out = str(cli_env[0] / "diff.png")
    res = _cli(cli_env, out, "--device", "cpu", "--screenshot-state",
               "diff", mode="check", repo=_big_diff_repo(cli_env[0]))
    assert res.returncode == 0, res.stderr[-3000:]
    assert os.path.getsize(out) > 0


def test_renderer_cuda_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Renderer(device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_renderer("cuda")


def test_render_tiles_rejects_other_devices():
    font = torch.empty((64, 64), dtype=torch.uint8, device="meta")
    atlas = torch.empty((64, 64, 4), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        K.render_tiles((), font, atlas, (0.0, 0.0, 0.0), 1, 1, (), 64, 128)


def test_png_writer_round_trips_through_pillow(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(0)
    for shape in ((1, 1, 4), (37, 53, 4), (64, 128, 4)):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        path = str(tmp_path / f"{shape[0]}x{shape[1]}.png")
        save_png(img, path)
        with Image.open(path) as im:
            assert im.mode == "RGBA" and im.size == (shape[1], shape[0])
            assert np.array_equal(np.asarray(im), img)
    with pytest.raises(ValueError):
        png_bytes(np.zeros((4, 4, 3), np.uint8))


def test_cli_dump_bundles_writes_the_references_files(cli_env, monkeypatch):
    """`--dump-bundles` through the port, with jax, PIL and matplotlib
    blocked, writes the same SVG, tree and lint files as the reference's
    `dump_all` on the same fixture repository, byte for byte."""
    from whisper_git_tpu.tools.dump_bundles import dump_all, make_fixture_repo

    base = cli_env[0]
    repo = make_fixture_repo(str(base / "dump-fixture"))
    out = base / "dump-port"
    res = subprocess.run(
        [sys.executable, cli_env[3], "block", "--dump-bundles", str(out),
         "--repo", repo, "--device", "cpu"],
        cwd=ROOT, env=cli_env[2], capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    monkeypatch.setenv("WGIT_SKIP_AVATARS", "1")
    want_dir = base / "dump-ref"
    # The port's dump ran in a fresh process; the reference's runs in this
    # one, whose layout memos (keyed by content alone) an earlier test may
    # have filled under the atlas measurer: start it from empty memos too.
    fresh_compile_caches()
    count = dump_all(str(want_dir), repo_path=repo)
    assert f"wrote {count} scenes to {out}" in res.stdout
    want = sorted(os.listdir(want_dir))
    assert sorted(os.listdir(out)) == want and len(want) == 3 * count
    for name in want:
        assert (out / name).read_bytes() == (want_dir / name).read_bytes(), \
            name
