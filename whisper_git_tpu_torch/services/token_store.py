"""Access-token storage.

Capability parity with reference src/token_store.rs: system keychain when
one is reachable (Secret Service via `secret-tool`), an in-process cache
including negative entries, and an availability probe. When no keychain is
present (headless/CI), falls back to a 0600-permission JSON file under the
config dir — the same graceful degradation the reference's `keyring` crate
performs on headless systems.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import threading
from typing import Optional

_SERVICE = "whisper-git"
_cache: dict[str, Optional[str]] = {}
_cache_lock = threading.Lock()


def _key(provider: str, host: str) -> str:
    return f"{provider}:{host}"


def _secret_tool() -> Optional[str]:
    return shutil.which("secret-tool")


def _file_path() -> str:
    base = os.environ.get("XDG_CONFIG_HOME", os.path.expanduser("~/.config"))
    return os.path.join(base, "whisper-git", "tokens.json")


def _file_load() -> dict:
    try:
        with open(_file_path(), "r", encoding="utf-8") as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return {}


def _file_save(data: dict) -> bool:
    path = _file_path()
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            json.dump(data, f)
        return True
    except OSError:
        return False


def get_token(provider: str, host: str) -> Optional[str]:
    key = _key(provider, host)
    with _cache_lock:
        if key in _cache:  # includes negative entries
            return _cache[key]
    token: Optional[str] = None
    keychain_definitive = True  # rc 1 = "not stored" (a real answer)
    tool = _secret_tool()
    if tool is not None:
        try:
            proc = subprocess.run(
                [tool, "lookup", "service", _SERVICE, "account", key],
                capture_output=True, timeout=5)
            if proc.returncode == 0:
                token = proc.stdout.decode().strip() or None
        except (OSError, subprocess.TimeoutExpired):
            # Transient (locked/slow Secret Service): must NOT become a
            # session-long negative cache entry — the next poll should
            # retry the now-healthy keychain.
            keychain_definitive = False
    if token is None:
        token = _file_load().get(key)
    with _cache_lock:
        if token is not None or keychain_definitive:
            _cache[key] = token
    return token


def set_token(provider: str, host: str, token: str) -> bool:
    key = _key(provider, host)
    ok = False
    tool = _secret_tool()
    if tool is not None:
        try:
            proc = subprocess.run(
                [tool, "store", f"--label=whisper-git {key}",
                 "service", _SERVICE, "account", key],
                input=token.encode(), capture_output=True, timeout=5)
            ok = proc.returncode == 0
        except (OSError, subprocess.TimeoutExpired):
            ok = False
    if not ok:
        data = _file_load()
        data[key] = token
        ok = _file_save(data)
    if ok:
        with _cache_lock:
            _cache[key] = token
    return ok


def delete_token(provider: str, host: str) -> None:
    key = _key(provider, host)
    tool = _secret_tool()
    if tool is not None:
        try:
            subprocess.run([tool, "clear", "service", _SERVICE,
                            "account", key],
                           capture_output=True, timeout=5)
        except (OSError, subprocess.TimeoutExpired):
            pass
    data = _file_load()
    if key in data:
        del data[key]
        _file_save(data)
    with _cache_lock:
        _cache[key] = None


def clear_cache() -> None:
    with _cache_lock:
        _cache.clear()
