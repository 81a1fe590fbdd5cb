"""The port is a package of its own: nothing in it, and nothing in
`chip_smoke.py`, imports the JAX package, JAX, Pillow or matplotlib, and
importing it leaves the JAX package as it was."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "whisper_git_tpu_torch")
FORBIDDEN = ("whisper_git_tpu", "jax", "jaxlib", "PIL", "matplotlib")

# Imports inside a function, on the same calls where the reference makes
# them, of libraries the machine with the card does not have; each call
# copes with their absence (tests/test_torch_fallback.py, the CLI's tests
# with Pillow and matplotlib unimportable): the avatar decode falls back
# to Pillow only for what the port's PNG decoder does not read; the atlas
# build (Pillow, DejaVu from matplotlib) never runs at start-up; the
# fallback bank's chain font loads with Pillow, and its DejaVu tier comes
# from matplotlib.
LAZY_OPTIONAL = {("services/avatar.py", "PIL"), ("render/atlas.py", "PIL"),
                 ("render/atlas.py", "matplotlib"),
                 ("render/fallback.py", "PIL")}


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for base, dirs, files in os.walk(PORT):
        dirs[:] = [d for d in dirs if d not in ("__pycache__", "_build")]
        out += [os.path.join(base, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imports(path: str):
    """(root module, line, at module level) of every import in a file."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    top = {id(n) for n in tree.body}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.partition(".")[0], node.lineno, id(node) in top
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield ((node.module or "").partition(".")[0], node.lineno,
                   id(node) in top)


def test_port_has_a_full_set_of_modules():
    files = _port_files()
    rel = {os.path.relpath(f, PORT) for f in files}
    assert len(files) > 60
    for name in ("app/ui_app.py", "ui/layout.py", "engine/refresh.py",
                 "gitcore/repo.py", "services/config.py", "ops/lanes.py",
                 "render/scene.py", "render/shaping.py", "render/frame.py",
                 "render/blocks_kernel.py", "host/main.py", "host/loop.py",
                 "host/term_display.py", "host/term_input.py",
                 "host/sixel.py", "host/gctune.py", "host/degraded.py",
                 "ledger.py", "bench.py", "ops/diffword.py",
                 "tools/ptydrive.py", "ops/sdf.py", "render/fallback.py",
                 "tools/goldens.py", "tools/dump_bundles.py",
                 "tools/mask_font.py", "render/meshstate.py",
                 "parallel/mesh.py", "tools/fixtures.py",
                 "tools/vector_smoke.py", "tools/scale_repo.py",
                 "tools/soak.py", "tools/compose_probe.py"):
        assert name in rel, name


def test_no_module_of_the_port_imports_the_reference_or_jax():
    found = []
    for path in _port_files():
        rel = os.path.relpath(path, PORT)
        for root, line, at_top in _imports(path):
            if root not in FORBIDDEN:
                continue
            if not at_top and (rel, root) in LAZY_OPTIONAL:
                continue
            found.append(f"{os.path.relpath(path, ROOT)}:{line} imports "
                         f"{root}")
    assert not found, "\n".join(found)


def test_the_exemptions_are_lazy_and_still_there():
    """An exemption that no longer matches anything is dropped, and one
    never covers an import at module level."""
    for rel, root in LAZY_OPTIONAL:
        hits = [at_top for r, _, at_top in
                _imports(os.path.join(PORT, rel)) if r == root]
        assert hits and not any(hits), (rel, root)


REFUSING_RUN = """
import importlib.abc, os, sys
REFUSED = ("whisper_git_tpu", "jax", "jaxlib", "PIL", "matplotlib")
class _Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError(f"{name} is refused")
        return None
sys.meta_path.insert(0, _Refuse())
import chip_smoke                       # imports nothing of the port yet
from whisper_git_tpu_torch.host import main as cli
from whisper_git_tpu_torch.render import (blocks_kernel, compose,  # noqa: F401
                                          compose_kernel, frame)
repo = chip_smoke.build_history_repo(sys.argv[1], 20)
rc = cli.main(["--screenshot", sys.argv[2], "--size", "640x400", "--repo",
               repo, "--device", "cpu"])
loaded = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)
print("loaded:", loaded)
sys.exit(rc if not loaded else 3)
"""


def test_cli_renders_with_the_reference_refused(tmp_path):
    """A process in which every import of the JAX package, JAX, Pillow and
    matplotlib raises imports `chip_smoke`, the port's CLI, the frame
    cache and compose, and renders a screenshot on the CPU through the
    default path."""
    script = tmp_path / "refusing_run.py"
    script.write_text(REFUSING_RUN)
    out = tmp_path / "shot.png"
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "WGIT_DEVICE", "XLA_FLAGS",
                        "WGIT_FRAME_CACHE", "WGIT_FRAME_COMPOSE")}
    env.update(PYTHONPATH=ROOT, WGIT_SKIP_AVATARS="1",
               XDG_STATE_HOME=str(tmp_path / "state"),
               XDG_CACHE_HOME=str(tmp_path / "cache"),
               XDG_CONFIG_HOME=str(tmp_path / "config"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, str(script), str(tmp_path),
                          str(out)], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "loaded: []" in res.stdout
    with open(out, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_cli_refuses_the_reference_in_its_own_process():
    """`main` installs the refusal itself, so every run of the CLI proves
    the rule; a finder installed twice is kept once."""
    from whisper_git_tpu_torch.host import main as cli

    before = list(sys.meta_path)
    try:
        cli.refuse_reference()
        cli.refuse_reference()
        cli.refuse_jax()
        mine = [f for f in sys.meta_path if isinstance(f, cli._Refuse)]
        assert sorted(f.roots for f in mine) == [("jax", "jaxlib"),
                                                 ("whisper_git_tpu",)]
        ref = next(f for f in mine if f.roots == ("whisper_git_tpu",))
        with pytest.raises(ImportError, match="imports nothing of the "
                                              "reference"):
            ref.find_spec("whisper_git_tpu.render.compose")
        for f in mine:  # the port itself is not refused
            assert f.find_spec("whisper_git_tpu_torch.render.frame") is None
    finally:
        sys.meta_path[:] = before


def test_importing_the_port_leaves_the_reference_as_it_was():
    """Importing the whole port changes no attribute of the reference:
    its scene module keeps its own `_bucket` (which the scene compiler
    calls for every buffer), and the two packages share no module."""
    import whisper_git_tpu.render.scene as ref_scene
    import whisper_git_tpu_torch.host.main  # noqa: F401  (the whole port)
    import whisper_git_tpu_torch.render.frame  # noqa: F401
    import whisper_git_tpu_torch.render.scene as port_scene

    assert ref_scene._bucket.__module__ == "whisper_git_tpu.render.scene"
    assert ref_scene._bucket is not port_scene._bucket
    assert ref_scene._bucket.__code__.co_filename == \
        ref_scene.__file__.replace(".pyc", ".py")
    assert port_scene.SceneCompiler is not ref_scene.SceneCompiler
    shared = [name for name, mod in sys.modules.items()
              if name.startswith("whisper_git_tpu_torch.")
              and getattr(mod, "__name__", name).split(".")[0]
              == "whisper_git_tpu"]
    assert not shared
