"""Gravatar avatar cache.

Capability parity with reference src/avatar.rs: md5(email) URL with
`d=404`, one worker thread per email, disk cache at
$XDG_CACHE_HOME/whisper-git/avatars/{hash}.png, in-memory
InFlight/Loaded/Failed states with no retry in-session, Lanczos3 resize
to 64×64 RGBA (ours runs on the accelerator via ops.image), and a sync
prefetch variant for screenshots.

The port's copy of `whisper_git_tpu/services/avatar.py`, with one
departure: the cache's PNGs are read and written with zlib alone
(`render/renderer.py`: `decode_png`, `png_bytes`); Pillow, where it is
importable, decodes only what that decoder does not read (another image
format, a 16-bit PNG). Without Pillow such an avatar fails and the view
draws the identicon, as a failed decode does in the reference.
"""

from __future__ import annotations

import hashlib
import io
import os
import threading
import urllib.error
import urllib.request
from enum import Enum
from typing import Optional

import numpy as np

AVATAR_PIXELS = 64  # reference: avatar.rs:25


class AvatarState(Enum):
    IN_FLIGHT = "in_flight"
    LOADED = "loaded"
    FAILED = "failed"


def email_hash(email: str) -> str:
    return hashlib.md5(email.strip().lower().encode()).hexdigest()


def gravatar_url(email: str, size: int = AVATAR_PIXELS) -> str:
    return (f"https://www.gravatar.com/avatar/{email_hash(email)}"
            f"?s={size}&d=404")


_CACHE_DIR: dict = {}


def _cache_dir() -> str:
    # Memoized per XDG base: _cache_path runs per visible history row
    # per frame, and the makedirs probe costs a stat each call (plus
    # tens of ms on the very first cold-disk creation — measured inside
    # a first-frame budget).
    base = os.environ.get("XDG_CACHE_HOME", os.path.expanduser("~/.cache"))
    hit = _CACHE_DIR.get(base)
    if hit is None:
        hit = os.path.join(base, "whisper-git", "avatars")
        os.makedirs(hit, exist_ok=True)
        _CACHE_DIR[base] = hit
    return hit


def _cache_path(email: str) -> str:
    return os.path.join(_cache_dir(), f"{email_hash(email)}.png")


def _decode_and_resize(data: bytes) -> Optional[np.ndarray]:
    from ..render.renderer import decode_png

    arr = decode_png(data)
    if arr is None:
        try:
            from PIL import Image

            img = Image.open(io.BytesIO(data)).convert("RGBA")
            arr = np.asarray(img, np.uint8)
        except Exception:   # no Pillow, or no image Pillow reads
            return None
    if arr.shape[:2] != (AVATAR_PIXELS, AVATAR_PIXELS):
        from ..ops.image import resize_lanczos

        arr = resize_lanczos(arr, AVATAR_PIXELS, AVATAR_PIXELS)
    return arr


def download_avatar(email: str, timeout: float = 10.0
                    ) -> Optional[np.ndarray]:
    """Disk cache first, then Gravatar (reference: avatar.rs:183-231)."""
    path = _cache_path(email)
    if os.path.exists(path):
        try:
            with open(path, "rb") as f:
                arr = _decode_and_resize(f.read())
            if arr is not None:
                return arr
        except OSError:
            pass
    req = urllib.request.Request(gravatar_url(email),
                                 headers={"User-Agent": "whisper-git-tpu"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            data = resp.read()
    except (urllib.error.URLError, urllib.error.HTTPError, OSError,
            TimeoutError):
        return None
    arr = _decode_and_resize(data)
    if arr is not None:
        from ..render.renderer import png_bytes

        try:
            with open(path, "wb") as f:
                f.write(png_bytes(arr))
        except OSError:
            pass
    return arr


class AvatarCache:
    """In-memory avatar state machine (reference: AvatarCache, avatar.rs:45).
    Failed entries never retry within the session."""

    def __init__(self, proxy=None, enabled: bool = True):
        self._states: dict[str, AvatarState] = {}
        self._images: dict[str, np.ndarray] = {}
        self._lock = threading.Lock()
        self._proxy = proxy
        self.enabled = enabled

    def get(self, email: str) -> Optional[np.ndarray]:
        """Returns the avatar if loaded; kicks off a fetch on first ask."""
        if not self.enabled or not email:
            return None
        with self._lock:
            state = self._states.get(email)
            if state is AvatarState.LOADED:
                return self._images.get(email)
            if state is not None:  # in flight or failed: no retry
                return None
            self._states[email] = AvatarState.IN_FLIGHT

        def worker():
            arr = download_avatar(email)
            with self._lock:
                if arr is None:
                    self._states[email] = AvatarState.FAILED
                else:
                    self._states[email] = AvatarState.LOADED
                    self._images[email] = arr
            if self._proxy is not None:
                self._proxy.send_event()

        threading.Thread(target=worker, daemon=True,
                         name=f"avatar-{email_hash(email)[:8]}").start()
        return None

    def prefetch_sync(self, emails: list[str], timeout: float = 5.0) -> None:
        """Blocking prefetch for screenshot mode (reference: main.rs:307;
        WGIT_SKIP_AVATARS skips it).

        Fetches fan out over a thread pool under ONE shared wall-clock
        deadline (`timeout` total, not per email): a slow or dead network
        costs at most ~`timeout` seconds of pre-render stall, never
        len(emails) × timeout (20 serial 3 s timeouts ≈ 60 s)."""
        if not self.enabled or os.environ.get("WGIT_SKIP_AVATARS"):
            return
        import concurrent.futures
        import time

        if not emails:
            return
        deadline = time.monotonic() + timeout
        pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=min(8, len(emails)),
            thread_name_prefix="avatar-prefetch")
        futures = {pool.submit(download_avatar, e, timeout): e
                   for e in emails}
        try:
            for fut in concurrent.futures.as_completed(
                    futures, timeout=max(0.1, deadline - time.monotonic())):
                email = futures[fut]
                try:
                    arr = fut.result()
                except Exception:
                    arr = None
                with self._lock:
                    if arr is None:
                        self._states[email] = AvatarState.FAILED
                    else:
                        self._states[email] = AvatarState.LOADED
                        self._images[email] = arr
        except concurrent.futures.TimeoutError:
            # Deadline hit. A future can complete BETWEEN the timeout
            # and this loop — harvest those results (the download
            # succeeded; dropping it would also leave the email
            # state-less and trigger a duplicate fetch later), then mark
            # true stragglers failed-for-this-session (identicons).
            with self._lock:
                for fut, email in futures.items():
                    if email in self._states:
                        continue  # already folded by the main loop
                    arr = None
                    if fut.done():
                        try:
                            arr = fut.result(timeout=0)
                        except Exception:
                            arr = None
                    if arr is not None:
                        self._states[email] = AvatarState.LOADED
                        self._images[email] = arr
                    else:
                        self._states[email] = AvatarState.FAILED
        finally:
            # No wait: in-flight downloads may finish in the background,
            # but the caller's pre-render stall ends at the deadline.
            pool.shutdown(wait=False, cancel_futures=True)
