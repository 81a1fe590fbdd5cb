"""The port's word diff (`ops/diffword.py`, torch ops) against the
reference's JAX op and the scalar `intra_line_highlight`: byte-equal
ranges on seeded pairs, and the diff parser over 64 or more pairs (where
it takes the batched op) equal to the reference's."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from whisper_git_tpu.gitcore import diff as ref_diff
from whisper_git_tpu.ops import diffword as ref_diffword
from whisper_git_tpu_torch.gitcore import diff as port_diff
from whisper_git_tpu_torch.ops import diffword as port_diffword

WORDS = ["let", "x", "=", "5;", "héllo", "wörld", "日本語", "ß", "🙂", "fn",
         "return", "self.value", "", "a" * 70, "é" * 40, "\t", "café"]


def _line(rng) -> str:
    return " ".join(rng.choice(WORDS) for _ in range(rng.integers(0, 9)))


def _pairs(seed: int, n: int):
    """Seeded pairs: a line and an edit of it (a word replaced, inserted
    or dropped, or none), so prefixes and suffixes are long and cut
    through multibyte characters."""
    rng = np.random.default_rng(seed)
    olds, news = [], []
    for _ in range(n):
        old = _line(rng)
        words = old.split(" ")
        k = int(rng.integers(0, len(words) + 1))
        edit = int(rng.integers(0, 4))
        if edit == 0:
            words.insert(k, str(rng.choice(WORDS)))
        elif edit == 1 and words:
            words[min(k, len(words) - 1)] = str(rng.choice(WORDS))
        elif edit == 2 and words:
            del words[min(k, len(words) - 1)]
        olds.append(old)
        news.append(" ".join(words))
    return olds, news


CASES = {
    "ascii": (["let x = 5;", "abc", "fn main() {}"],
              ["let x = 42;", "xyz", "fn main() { 1 }"]),
    "multibyte": (["héllo wörld", "日本語テキスト", "a🙂b", "ßtraße"],
                  ["héllo wörld!", "日本人テキスト", "a🙃b", "straße"]),
    "empty": (["", "x", ""], ["y", "", ""]),
    "identical": (["same", "é", "🙂🙂"], ["same", "é", "🙂🙂"]),
    "not_pow2": _pairs(3, 67),
    "over_64_bytes": (["x" * 65 + "é" * 30 + "tail", "q" * 300],
                      ["x" * 65 + "è" * 30 + "tail", "q" * 299 + "r"]),
    "seeded_200": _pairs(11, 200),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_batched_highlights_match_the_reference(case):
    olds, news = CASES[case]
    want = ref_diffword.batched_highlights(olds, news)
    got = port_diffword.batched_highlights(olds, news, device="cpu")
    assert got == want
    assert got == [ref_diff.intra_line_highlight(o, n)
                   for o, n in zip(olds, news)]
    assert got == [port_diff.intra_line_highlight(o, n)
                   for o, n in zip(olds, news)]


def test_prefix_suffix_lengths_match_the_reference_op():
    """The op itself on one padded batch: equal lengths, int32 on both."""
    olds, news = _pairs(5, 37)
    B = len(olds)
    L = max(len(s.encode()) for s in olds + news)
    arrs = [np.zeros((B, L), np.uint8) for _ in range(2)]
    for arr, lines in zip(arrs, (olds, news)):
        for i, s in enumerate(lines):
            b = s.encode()
            arr[i, :len(b)] = np.frombuffer(b, np.uint8)
    lens = [np.array([len(s.encode()) for s in lines], np.int32)
            for lines in (olds, news)]
    want = ref_diffword.prefix_suffix_lengths(*arrs, *lens)
    got = port_diffword.prefix_suffix_lengths(
        *(torch.from_numpy(a) for a in arrs + lens))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_cuda_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(port_diffword, "_DEVICE", ["cuda"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_diffword.batched_highlights(["a"], ["b"])


def _unified(olds, news) -> str:
    body = "".join(f"-{o}\n" for o in olds) + "".join(f"+{n}\n" for n in news)
    return ("diff --git a/f.txt b/f.txt\n"
            "index 0000001..0000002 100644\n"
            "--- a/f.txt\n+++ b/f.txt\n"
            f"@@ -1,{len(olds)} +1,{len(news)} @@\n" + body)


@pytest.mark.parametrize("n", [64, 130])
def test_diff_parser_batches_like_the_reference(monkeypatch, n):
    """Over `_BATCH_THRESHOLD` pairs the parser takes the batched op; the
    port's, on the device the CLI set, gives the reference's lines."""
    assert n >= port_diff._BATCH_THRESHOLD == ref_diff._BATCH_THRESHOLD
    monkeypatch.setattr(port_diffword, "_DEVICE", ["cpu"])
    calls = []
    real = port_diffword.batched_highlights
    monkeypatch.setattr(port_diffword, "batched_highlights",
                        lambda *a, **k: calls.append(len(a[0])) or real(*a, **k))
    text = _unified(*_pairs(n, n))
    want = ref_diff.parse_unified_diff(text)
    got = port_diff.parse_unified_diff(text)
    assert calls == [n]

    def lines(files):
        return [(ln.origin, ln.content, ln.highlights)
                for f in files for h in f.hunks for ln in h.lines]

    assert lines(got) == lines(want)
    assert sum(1 for _, _, hl in lines(got) if hl) > n // 2
