"""The port's interactive CLI, end to end on a pty: the REAL process
(`python -m whisper_git_tpu_torch <repo> --device cpu`) with its
stdin/stdout on a pseudo-terminal, spoken to in the wire protocol — the
alt screen, half-block frames, SGR mouse bytes, keystrokes, the palette,
the context menu and the Escape quit ladder — as `tests/test_pty_e2e.py`
drives the reference's. And the same CLI asked for cuda on a machine
without a GPU exits non-zero before it enters the alt screen."""

from __future__ import annotations

import os
import subprocess
import sys
import time

from whisper_git_tpu_torch.tools.ptydrive import (
    ALT_ENTER,
    ALT_EXIT,
    HALF_BLOCK,
    drain,
    open_sized_pty,
    wait_for,
    wait_growth,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Runs the CLI with the JAX package and JAX refused in its process.
REFUSING_RUN = """
import importlib.abc, runpy, sys
class _Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("whisper_git_tpu", "jax", "jaxlib"):
            raise ImportError(f"{name} is refused")
        return None
sys.meta_path.insert(0, _Refuse())
sys.argv = ["whisper_git_tpu_torch"] + sys.argv[1:]
runpy.run_module("whisper_git_tpu_torch", run_name="__main__")
"""


def _mk_repo(tmp_path) -> str:
    repo = str(tmp_path / "ptyrepo")
    os.makedirs(repo)

    def g(*args):
        subprocess.run(["git", "-C", repo, *args], check=True,
                       capture_output=True)

    g("init", "-q")
    g("config", "user.email", "t@t.t")
    g("config", "user.name", "T")
    for i in range(3):
        with open(os.path.join(repo, f"f{i}.txt"), "w") as f:
            f.write(f"line {i}\n")
        g("add", "-A")
        g("commit", "-qm", f"commit number {i}")
    with open(os.path.join(repo, "f0.txt"), "a") as f:
        f.write("dirty\n")
    return repo


def _env(tmp_path) -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "WGIT_DEVICE", "XLA_FLAGS")}
    env.update(PYTHONPATH=ROOT, WGIT_SKIP_AVATARS="1",
               XDG_CONFIG_HOME=str(tmp_path / "cfg"),
               XDG_CACHE_HOME=str(tmp_path / "cache"),
               XDG_STATE_HOME=str(tmp_path / "state"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2")
    # A small window: few tiles, so the plain versions keep the first
    # frame to seconds.
    cfg_dir = tmp_path / "cfg" / "whisper-git"
    cfg_dir.mkdir(parents=True)
    (cfg_dir / "settings.json").write_text(
        '{"window_width": 480.0, "window_height": 320.0}')
    script = tmp_path / "refusing_run.py"
    script.write_text(REFUSING_RUN)
    return env


def _spawn(tmp_path, *args):
    master, slave = open_sized_pty(30, 100, 800, 480)
    proc = subprocess.Popen(
        [sys.executable, str(tmp_path / "refusing_run.py"), *args],
        stdin=slave, stdout=slave, stderr=subprocess.PIPE,
        env=_env(tmp_path), cwd=ROOT, close_fds=True)
    os.close(slave)
    return master, proc


def test_pty_session_end_to_end_on_the_cpu(tmp_path):
    repo = _mk_repo(tmp_path)
    master, proc = _spawn(tmp_path, repo, "--device", "cpu")
    buf = bytearray()
    try:
        # 1) The alt screen, then half-block frames.
        assert wait_for(master, buf, ALT_ENTER, 20), \
            f"no alt-screen entry; stderr: {proc.stderr.peek()[:2000]}"
        assert wait_for(master, buf, HALF_BLOCK, 20), \
            "no frame cells painted"

        # 2) Click a history row, open search, type a query.
        os.write(master, b"\x1b[<0;40;6M\x1b[<0;40;6m")   # click+release
        os.write(master, b"/")
        time.sleep(0.2)
        os.write(master, b"commit")
        assert wait_growth(master, buf, 8.0) is not None, \
            "no repaint after input events"

        # 3) Command palette: Ctrl+P, type, close; a right-click context
        # menu on a history row, close.
        os.write(master, b"\x1b")          # close search first
        drain(master, buf, 0.4)
        os.write(master, b"\x10")          # Ctrl+P
        drain(master, buf, 0.6)
        os.write(master, b"rewi")
        assert wait_growth(master, buf, 8.0) is not None, \
            "no repaint while typing in the palette"
        os.write(master, b"\x1b")          # close the palette
        drain(master, buf, 0.4)
        os.write(master, b"\x1b[<2;40;6M\x1b[<2;40;6m")  # right-click
        assert wait_growth(master, buf, 8.0) is not None, \
            "no repaint after the right-click menu"

        # 4) Quit through the Escape ladder, draining the pty meanwhile.
        for _ in range(8):
            os.write(master, b"\x1b")
            drain(master, buf, 0.35)
            if proc.poll() is not None:
                break
        end = time.monotonic() + 15
        while proc.poll() is None and time.monotonic() < end:
            drain(master, buf, 0.25)
        assert proc.poll() is not None, "child did not exit after the ladder"

        # 5) The terminal restored, a clean exit.
        drain(master, buf, 0.5)
        assert ALT_EXIT in buf, "terminal not restored on exit"
        assert buf.rindex(ALT_EXIT) > buf.index(ALT_ENTER)
        assert proc.returncode == 0, proc.stderr.read()[:2000].decode(
            "utf-8", "replace")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        proc.stderr.close()
        os.close(master)


def test_pty_cuda_without_a_gpu_fails_before_the_alt_screen(tmp_path):
    repo = _mk_repo(tmp_path)
    master, proc = _spawn(tmp_path, repo)   # --device defaults to cuda
    buf = bytearray()
    try:
        end = time.monotonic() + 60
        while proc.poll() is None and time.monotonic() < end:
            drain(master, buf, 0.25)
        assert proc.poll() is not None, "the CLI did not exit"
        drain(master, buf, 0.2)
        assert proc.returncode != 0
        assert b"CUDA is not available" in proc.stderr.read()
        assert ALT_ENTER not in buf and HALF_BLOCK not in buf
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        proc.stderr.close()
        os.close(master)
