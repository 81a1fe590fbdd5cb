"""The history a run scrolls through, made from the seed.

`history(seed, spec)` draws the commits (authors with Zipf weights, dates,
subject lengths, feature branches merged every `merge_every` commits)
and `tags(spec, commits)` the tags, as plain data; `build_repo` writes them with one `git fast-import`
stream (every commit has the empty tree, so nothing is checked out) and
adds one untracked file; `prime_avatars` writes a seeded 64x64 PNG for
each author into the avatar disk cache, where the app finds it without a
network. The reference (`reference.py`) reads the same data to know which
rows, subjects and avatars a frame has to show.
"""

from __future__ import annotations

import hashlib
import os
import struct
import subprocess
import zlib

import numpy as np

AUTHORS = (
    "Ada Lovelace", "Grace Hopper", "Linus Torvalds", "Margaret Hamilton",
    "Ken Thompson", "Barbara Liskov", "Dennis Ritchie", "Frances Allen",
    "Edsger Dijkstra", "Radia Perlman", "Guido Rossum", "Sophie Wilson",
)
WORDS = (
    "fix", "add", "render", "layout", "cache", "scroll", "history", "graph",
    "lane", "avatar", "tile", "kernel", "glyph", "atlas", "diff", "status",
    "branch", "merge", "refresh", "widget", "panel", "sidebar", "commit",
    "refactor", "tidy", "handle", "empty", "state", "when", "the", "for",
    "and", "in", "of", "stale", "offset", "clip", "frame", "upload", "bins",
    "pills", "colors", "timeout", "error", "path", "config", "window",
    "repaint", "pointer", "wheel", "thumb", "drag", "row", "height", "gap",
)
AVATAR_PX = 64
T0 = 1_600_000_000


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & 0xFFFFFFFFFFFFFFFF, stream])


_BY_LEN: dict = {}
for _w in WORDS:
    _BY_LEN.setdefault(len(_w), []).append(_w)


def _subject(shape, words, tag: str, n: int) -> str:
    """`tag` and words, cut to `n` characters: each word's length is
    drawn from `shape`, the word of that length from `words`, so the
    spaces, and the count of glyphs, are the shape's alone."""
    out = [tag]
    while len(" ".join(out)) < n:
        k = len(WORDS[int(shape.integers(len(WORDS)))])
        pool = _BY_LEN[k]
        out.append(pool[int(words.integers(len(pool)))])
    return " ".join(out)[:n].rstrip()


def history(seed: int, spec: dict) -> list:
    """The commits, oldest first, as dicts: `mark` (1-based), `ref`
    ("main" or a feature branch), `parents` (marks), `author` (index),
    `time` (s), `subject`. Every subject starts with a tag `WG-<mark>:`
    that names its commit, so a row can be told from its text alone.

    The history's shape (the gaps between commits, so the rows' heights;
    each subject's length; each commit's author; the merges) comes from
    the configuration's `shape_seed`, the words of the subjects from the
    run's seed: every seed gets rows of the same sizes, with other text,
    so the work a frame asks for does not move with the seed."""
    rng = _rng(int(spec["shape_seed"]), 1)
    words = _rng(seed, 3)
    n = int(spec["commits"])
    k = len(AUTHORS)
    w = 1.0 / np.arange(1, k + 1) ** float(spec["author_zipf_s"])
    w /= w.sum()
    lo, hi = spec["subject_chars"]
    gap_lo, gap_hi = spec["gap_s"]
    every = int(spec["merge_every"])
    commits = []
    t = T0
    main = None
    i = 0
    while len(commits) < n:
        gap = float(np.exp(rng.uniform(np.log(gap_lo), np.log(gap_hi))))
        t += int(gap)
        mark = len(commits) + 1
        author = int(rng.choice(k, p=w))
        if i % every == every - 4 and len(commits) + 2 <= n and main:
            branch = f"feature/{mark}"
            commits.append({"mark": mark, "ref": branch, "parents": [main],
                            "author": author, "time": t,
                            "subject": _subject(
                                rng, words, f"WG-{mark}:",
                                int(rng.integers(lo, hi + 1)))})
            t += int(rng.integers(300, 3600))
            merge = mark + 1
            commits.append({"mark": merge, "ref": "main",
                            "parents": [main, mark],
                            "author": int(rng.choice(k, p=w)), "time": t,
                            "subject": f"WG-{merge}: Merge {branch}"})
            main = merge
            i += 2
            continue
        commits.append({"mark": mark, "ref": "main",
                        "parents": [main] if main else [],
                        "author": author, "time": t,
                        "subject": _subject(rng, words, f"WG-{mark}:",
                                            int(rng.integers(lo, hi + 1)))})
        main = mark
        i += 1
    return commits


def tags(spec: dict, commits: list) -> dict:
    """{tag name: mark}: `tags` main commits drawn from the shape seed."""
    rng = _rng(int(spec["shape_seed"]), 2)
    mains = [c["mark"] for c in commits if c["ref"] == "main"]
    picks = sorted(rng.choice(len(mains), int(spec["tags"]), replace=False))
    return {f"v0.{j + 1}": mains[int(p)] for j, p in enumerate(picks)}


def email(author: int) -> str:
    return AUTHORS[author].lower().replace(" ", ".") + "@example.org"


def _ident(author: int, t: int) -> bytes:
    return f"{AUTHORS[author]} <{email(author)}> {t} +0000".encode()


def fast_import_stream(commits: list, tag_marks: dict) -> bytes:
    out = []
    for c in commits:
        msg = c["subject"].encode() + b"\n"
        lines = [b"commit refs/heads/" + c["ref"].encode(),
                 b"mark :%d" % c["mark"],
                 b"author " + _ident(c["author"], c["time"]),
                 b"committer " + _ident(c["author"], c["time"]),
                 b"data %d" % len(msg)]
        out.append(b"\n".join(lines) + b"\n" + msg)
        if c["parents"]:
            out.append(b"from :%d\n" % c["parents"][0])
        for p in c["parents"][1:]:
            out.append(b"merge :%d\n" % p)
        out.append(b"\n")
    for name, mark in tag_marks.items():
        out.append(b"reset refs/tags/%s\nfrom :%d\n\n" % (name.encode(),
                                                          mark))
    return b"".join(out)


def build_repo(base: str, commits: list, tag_marks: dict) -> str:
    """Write the history into a new repository under `base` with one
    `git fast-import` stream, and an untracked file. → its path."""
    path = os.path.join(base, "history")
    env = dict(os.environ, GIT_TERMINAL_PROMPT="0", LC_ALL="C",
               GIT_CONFIG_NOSYSTEM="1", GIT_CONFIG_GLOBAL=os.devnull)
    subprocess.run(["git", "init", "-q", "-b", "main", path], check=True,
                   capture_output=True, env=env)
    subprocess.run(["git", "-C", path, "config", "gc.auto", "0"],
                   check=True, capture_output=True, env=env)
    res = subprocess.run(["git", "-C", path, "fast-import", "--quiet"],
                         input=fast_import_stream(commits, tag_marks),
                         capture_output=True, env=env, timeout=300)
    if res.returncode != 0:
        raise RuntimeError("git fast-import failed: "
                           + res.stderr.decode(errors="replace")[-500:])
    with open(os.path.join(path, "dirty.txt"), "w") as f:
        f.write("uncommitted\n")
    return path


def display_order(commits: list) -> list:
    """The commits as `git log --topo-order` lists them from every branch
    tip: newest first. Each feature commit is the second parent of the
    merge right after it and the child of the main commit right before
    it, so the list is the generation order reversed."""
    return commits[::-1]


# -- avatars -------------------------------------------------------------


def avatar_image(seed: int, author: int) -> np.ndarray:
    """A seeded, opaque (64, 64, 4) u8 avatar: a two-colour gradient with
    noise."""
    rng = _rng(seed, 100 + author)
    t = np.linspace(0.0, 1.0, AVATAR_PX, dtype=np.float32)
    ramp = (t[:, None] + t[None, :]) / 2.0
    a, b = rng.integers(0, 256, (2, 3)).astype(np.float32)
    rgb = a + (b - a) * ramp[..., None] + rng.normal(
        0, 12, (AVATAR_PX, AVATAR_PX, 3))
    img = np.empty((AVATAR_PX, AVATAR_PX, 4), np.uint8)
    img[..., :3] = np.clip(rgb, 0, 255).astype(np.uint8)
    img[..., 3] = 255
    return img


def png_bytes(img: np.ndarray) -> bytes:
    """(H, W, 4) u8 → an 8-bit RGBA PNG, no filtering."""
    h, w = img.shape[:2]
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          img.reshape(h, w * 4)], axis=1).tobytes()

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def avatar_path(cache_home: str, address: str) -> str:
    """Where the app's avatar cache keeps `address`'s picture:
    $XDG_CACHE_HOME/whisper-git/avatars/<md5 of the address>.png."""
    digest = hashlib.md5(address.strip().lower().encode()).hexdigest()
    return os.path.join(cache_home, "whisper-git", "avatars",
                        f"{digest}.png")


def prime_avatars(cache_home: str, seed: int) -> list:
    """Write every author's avatar into the cache. → the addresses."""
    out = []
    for a in range(len(AUTHORS)):
        path = avatar_path(cache_home, email(a))
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(png_bytes(avatar_image(seed, a)))
        out.append(email(a))
    return out
