"""Large-repo scale fixture — ~100k commits / ~25k files, built once
and cached. A copy of `whisper_git_tpu/tools/scale_repo.py`, host code
alone: the reference's async engine was designed around a 25k-file
submodule and 1000-commit walks (its src/git_async.rs:29-32), and this
fixture times the rebuild at that scale.

`git fast-import` writes the whole history in seconds: one root commit
carrying the 25k-file tree, a linear bulk chain, merge topology in the
final window (inside the walk cap, so lane assignment sees it), branch
refs every 20k commits and a handful of tags. `git reset --hard`
materializes the working tree for the status-scan budgets.

    python -m whisper_git_tpu_torch.tools.scale_repo
"""

from __future__ import annotations

import os
import subprocess
import tempfile

COMMITS = 100_000
FILES = 25_000
_VERSION = 2   # bump to invalidate cached fixtures


def _gen_stream(commits: int, files: int):
    """Yield fast-import stream chunks (bytes)."""
    ident = b"Scale Fixture <scale@example.com>"
    t0 = 1_500_000_000
    yield b"blob\nmark :1\ndata 14\nscale content\n\n"
    # Root commit: the 25k-file tree (250 files across 100 dirs).
    lines = [b"commit refs/heads/main\nmark :2\n",
             b"author " + ident + b" %d +0000\n" % t0,
             b"committer " + ident + b" %d +0000\n" % t0,
             b"data 9\nroot tree\n"]
    per_dir = max(1, files // 100)
    for i in range(files):
        d, f = divmod(i, per_dir)
        lines.append(b"M 100644 :1 dir%03d/file%05d.txt\n" % (d, f))
    lines.append(b"\n")
    yield b"".join(lines)

    mark = 3
    last = 2
    merge_window = commits - 500   # merge topology inside the walk cap
    chunk: list[bytes] = []
    for i in range(commits):
        t = t0 + (i + 1) * 60
        path = b"dir%03d/file%05d.txt" % (i % 100, (i * 7) % per_dir)
        if i >= merge_window and i % 100 == 0:
            # Short side branch + merge (two parents).
            chunk.append(
                b"commit refs/heads/side\nmark :%d\n" % mark
                + b"author " + ident + b" %d +0000\n" % t
                + b"committer " + ident + b" %d +0000\n" % t
                + b"data 12\nside branch\n"
                + b"from :%d\n" % last
                + b"M 100644 :1 side%05d.txt\n\n" % i)
            side = mark
            mark += 1
            t += 30
            chunk.append(
                b"commit refs/heads/main\nmark :%d\n" % mark
                + b"author " + ident + b" %d +0000\n" % t
                + b"committer " + ident + b" %d +0000\n" % t
                + b"data 12\nmerge side \n"
                + b"from :%d\nmerge :%d\n" % (last, side)
                + b"M 100644 :1 " + path + b"\n\n")
        else:
            chunk.append(
                b"commit refs/heads/main\nmark :%d\n" % mark
                + b"author " + ident + b" %d +0000\n" % t
                + b"committer " + ident + b" %d +0000\n" % t
                + b"data 11\ncommit %04d\n" % (i % 10_000)
                + b"from :%d\n" % last
                + b"M 100644 :1 " + path + b"\n\n")
        last = mark
        mark += 1
        if i % 20_000 == 0 and i:
            chunk.append(b"reset refs/heads/branch-%d\nfrom :%d\n\n"
                         % (i, last))
        if i % 25_000 == 0 and i:
            chunk.append(b"reset refs/tags/v%d\nfrom :%d\n\n"
                         % (i // 25_000, last))
        if len(chunk) >= 2000:
            yield b"".join(chunk)
            chunk = []
    if chunk:
        yield b"".join(chunk)


def build_scale_repo(commits: int = COMMITS, files: int = FILES,
                     cache_root: str | None = None) -> str:
    """Build (or reuse) the cached scale fixture; returns its path."""
    root = cache_root or tempfile.gettempdir()
    path = os.path.join(root,
                        f"wgit-scale-{commits}c-{files}f-v{_VERSION}")
    marker = os.path.join(path, ".wgit-scale-ready")
    if os.path.isfile(marker):
        return path

    import shutil

    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)

    def git(*args, **kw):
        subprocess.run(["git", "-C", path, *args], check=True,
                       capture_output=True, **kw)

    subprocess.run(["git", "init", "-q", "-b", "main", path], check=True,
                   capture_output=True)
    git("config", "user.email", "scale@example.com")
    git("config", "user.name", "Scale Fixture")
    git("config", "gc.auto", "0")
    # stderr to a FILE, not a pipe: a warning-chatty fast-import would
    # fill a 64 KB pipe while we are blocked writing its stdin —
    # mutual deadlock with nothing draining either side.
    err_path = os.path.join(path, ".fast-import-err")
    with open(err_path, "wb") as err_f:
        proc = subprocess.Popen(
            ["git", "-C", path, "fast-import", "--quiet"],
            stdin=subprocess.PIPE, stdout=subprocess.DEVNULL,
            stderr=err_f)
        try:
            for chunk in _gen_stream(commits, files):
                proc.stdin.write(chunk)
            proc.stdin.close()
            rc = proc.wait(timeout=600)
            if rc != 0:
                with open(err_path, "rb") as ef:
                    tail = ef.read()[-500:].decode("utf-8", "replace")
                raise RuntimeError("fast-import failed: " + tail)
        finally:
            if proc.poll() is None:
                proc.kill()
    os.unlink(err_path)
    git("checkout", "-q", "main")   # materialize the 25k-file tree
    with open(marker, "w") as f:
        f.write("ok\n")
    return path


if __name__ == "__main__":
    import time

    t0 = time.monotonic()
    p = build_scale_repo()
    print(f"{p} ({time.monotonic() - t0:.1f}s)")
