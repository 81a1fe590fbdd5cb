"""Batched word-level diff highlight ranges (torch).

The batched analog of gitcore.diff.intra_line_highlight (reference:
src/git/diff.rs:135-250), counterpart of `whisper_git_tpu/ops/diffword.py`:
given B paired (−,+) lines as padded byte arrays, compute the common-prefix
and common-suffix lengths of all pairs in one pass of torch ops. The diff
parser takes it for 64 or more pairs (`gitcore/diff.py`); the per-pair
UTF-8 snapping stays on the host.

It runs on the device the CLI chose (`set_device`, default cuda; asking
for cuda where there is none raises). The parser calls it from the
engine's worker threads: each call moves its inputs to that device and
reads its result back before it returns, so nothing of the calling
thread's state outlives the call.
"""

from __future__ import annotations

import numpy as np
import torch

_DEVICE = ["cuda"]


def set_device(device) -> None:
    """The device `batched_highlights` runs on by default: the CLI's
    `--device` (`host/main.py`)."""
    _DEVICE[0] = str(device)


def prefix_suffix_lengths(old: torch.Tensor, new: torch.Tensor,
                          old_len: torch.Tensor, new_len: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """old, new: (B, L) uint8 padded; old_len/new_len: (B,) int32.
    Returns (prefix_len, suffix_len) per pair, with
    prefix + suffix <= min(old_len, new_len)."""
    B, L = old.shape
    pos = torch.arange(L, dtype=torch.int32, device=old.device).expand(B, L)
    minlen = torch.minimum(old_len, new_len)[:, None]
    big = torch.full_like(pos, L)

    eq = (old == new) & (pos < minlen)
    # prefix: first position where eq is False.
    prefix = torch.where(eq, big, pos).amin(dim=1)
    prefix = torch.minimum(prefix, minlen[:, 0])

    # suffix: align ends, compare old[old_len-1-k] vs new[new_len-1-k].
    oidx = (old_len[:, None] - 1 - pos).clamp(0, L - 1).long()
    nidx = (new_len[:, None] - 1 - pos).clamp(0, L - 1).long()
    eq_s = (old.gather(1, oidx) == new.gather(1, nidx)) & (pos < minlen)
    suffix = torch.where(eq_s, big, pos).amin(dim=1)
    suffix = torch.minimum(suffix, minlen[:, 0] - prefix)
    return prefix, suffix


def batched_highlights(old_lines: list[str], new_lines: list[str],
                       device=None
                       ) -> list[tuple[tuple[int, int], tuple[int, int]]]:
    """Compute highlight byte ranges for B paired lines in one batch on
    `device` (by default the one `set_device` chose). Returns
    [((old_start, old_end), (new_start, new_end))] like
    gitcore.diff.intra_line_highlight, including UTF-8 boundary snapping."""
    from ..gitcore.diff import _snap_utf8
    from ..render.renderer import resolve_device

    dev = resolve_device(device if device is not None else _DEVICE[0])
    if not old_lines or not new_lines:
        return []
    if len(old_lines) != len(new_lines):
        raise ValueError("pairs must align")
    olds = [s.encode() for s in old_lines]
    news = [s.encode() for s in new_lines]
    B = len(olds)
    L = max(1, max(len(b) for b in olds), max(len(b) for b in news))
    old_arr = np.zeros((B, L), np.uint8)
    new_arr = np.zeros((B, L), np.uint8)
    for i, (o, n) in enumerate(zip(olds, news)):
        old_arr[i, :len(o)] = np.frombuffer(o, np.uint8)
        new_arr[i, :len(n)] = np.frombuffer(n, np.uint8)
    old_len = np.array([len(o) for o in olds], np.int32)
    new_len = np.array([len(n) for n in news], np.int32)
    prefix, suffix = prefix_suffix_lengths(
        *(torch.from_numpy(a).to(dev)
          for a in (old_arr, new_arr, old_len, new_len)))
    lengths = torch.stack((prefix, suffix)).cpu().numpy()
    out = []
    for (o, n), p, s in zip(zip(olds, news), lengths[0].tolist(),
                            lengths[1].tolist()):
        oa, ob = _snap_utf8(o, p, False), _snap_utf8(o, len(o) - s, True)
        na, nb = _snap_utf8(n, p, False), _snap_utf8(n, len(n) - s, True)
        if oa >= ob:
            oa = ob = 0
        if na >= nb:
            na = nb = 0
        out.append(((oa, ob), (na, nb)))
    return out
