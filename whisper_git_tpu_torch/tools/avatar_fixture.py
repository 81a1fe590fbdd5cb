"""A history with several authors and an avatar cache primed for them, so
that the history view draws real avatars with no network.

`build_authors_repo` makes a repository whose commits come from
`N_AUTHORS` emails in turn, on pinned dates. `prime_avatar_cache` writes
seeded PNGs (`render/renderer.py::png_bytes`) into the avatar disk cache
under `$XDG_CACHE_HOME` for those emails: the first ones at the avatar's
64×64, one at 96×96 (the cache's decode resizes it with Lanczos), and one
corrupt file (the decode fails: the avatar fails and the view draws the
identicon). `chip_smoke.py` and the tests use both.
"""

from __future__ import annotations

import os
import subprocess

import numpy as np

N_AUTHORS = 8
# What each author's cache file holds, in order of the emails.
KINDS = ("64",) * 6 + ("96", "corrupt")


def author_emails(n: int = N_AUTHORS) -> list:
    return [f"author{i}@example.com" for i in range(n)]


def build_authors_repo(base: str, n_commits: int = 48) -> str:
    """A linear history of `n_commits` empty commits by the authors of
    `author_emails()` in turn, on pinned dates. → its path."""
    path = os.path.join(base, "authors-repo")
    env = dict(os.environ, GIT_TERMINAL_PROMPT="0")
    os.makedirs(path, exist_ok=True)
    subprocess.run(["git", "init", "-q", "-b", "main", path], check=True,
                   capture_output=True, env=env)
    emails = author_emails()
    for i in range(n_commits):
        email = emails[i % len(emails)]
        name = email.partition("@")[0].capitalize()
        date = str(1_700_000_000 + i * 3600)
        env.update(GIT_AUTHOR_NAME=name, GIT_AUTHOR_EMAIL=email,
                   GIT_COMMITTER_NAME=name, GIT_COMMITTER_EMAIL=email,
                   GIT_AUTHOR_DATE=date, GIT_COMMITTER_DATE=date)
        subprocess.run(["git", "-C", path, "commit", "-q", "--allow-empty",
                        "-m", f"change {i}: tune the avatar column"],
                       check=True, capture_output=True, env=env)
    return path


def avatar_image(seed: int, size: int) -> np.ndarray:
    """A seeded (size, size, 4) u8 avatar: a smooth two-colour gradient
    with noise, opaque but for the first one, whose alpha ramps."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 1.0, size, dtype=np.float32)
    ramp = (t[:, None] + t[None, :]) / 2.0
    a, b = rng.integers(0, 256, (2, 3)).astype(np.float32)
    rgb = a + (b - a) * ramp[..., None] + rng.normal(0, 12, (size, size, 3))
    img = np.empty((size, size, 4), np.uint8)
    img[..., :3] = np.clip(rgb, 0, 255).astype(np.uint8)
    img[..., 3] = 255 if seed else np.clip(ramp * 255, 0, 255).astype(
        np.uint8)
    return img


def prime_avatar_cache(emails: list, seed: int = 0) -> dict:
    """Write the cache file of each email (kinds in `KINDS` order) under
    the avatar cache of `$XDG_CACHE_HOME`. → {email: kind}."""
    from ..render.renderer import PNG_SIGNATURE, png_bytes
    from ..services.avatar import _cache_path

    kinds = {}
    for i, (email, kind) in enumerate(zip(emails, KINDS)):
        if kind == "corrupt":
            data = PNG_SIGNATURE + np.random.default_rng(seed + i).integers(
                0, 256, 300, dtype=np.uint8).tobytes()
        else:
            data = png_bytes(avatar_image(seed + i, int(kind)))
        with open(_cache_path(email), "wb") as f:
            f.write(data)
        kinds[email] = kind
    return kinds
