"""Export DejaVu's glyph masks for the `fallback` golden scene to
`whisper_git_tpu_torch/data/bank_masks.npz`.

    JAX_PLATFORMS=cpu python tests/tools/export_bank_masks.py [OUT.npz]

A developer script, not a module of the port. Run it from the repository
root where Pillow, fontTools and matplotlib's DejaVu fonts are installed.
For every codepoint of the scene's text (after bidi shaping, as the bank
sees it) outside the resident atlas, and for each of DejaVu Sans and DejaVu
Sans Bold that covers it, it stores Pillow's mask, bounding box and advance
at the bank's size, and each face's ascent, descent and OS/2 weight
(`tools/mask_font.py` documents the keys). Rerun it when the scene or the
resident atlas changes; `tests/test_torch_goldens.py` fails until then.
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from whisper_git_tpu_torch.tools.mask_font import (  # noqa: E402
    BANK_MASKS_NPZ, FACES)


def scene_texts(el) -> list:
    """Every text string of an El tree."""
    out = [el.text] if el.kind == "text" else []
    for child in el.children:
        out += scene_texts(child)
    return out


def bank_codepoints() -> list:
    """The fallback scene's codepoints that the resident atlas lacks."""
    from whisper_git_tpu_torch.render.atlas import load_atlases
    from whisper_git_tpu_torch.render.shaping import shape_visual
    from whisper_git_tpu_torch.tools.goldens import SCENES

    regular, _ = load_atlases()
    cps = {ord(c) for s in scene_texts(SCENES["fallback"]())
           for c in shape_visual(s)}
    return sorted(cp for cp in cps
                  if cp >= regular.max_cp or regular.lut[cp, 7] == 0.0)


def build_arrays() -> dict:
    from whisper_git_tpu_torch.render.atlas import _font_path
    from whisper_git_tpu_torch.render.fallback import _ChainFont

    cps = bank_codepoints()
    arrays = {}
    for face in FACES:
        font = _ChainFont(_font_path(bold=face == "bold"))
        covered = [cp for cp in cps if font.covers(cp)]
        bbox, adv, size, masks = [], [], [], []
        for cp in covered:
            mask = font.pil.getmask(chr(cp), mode="L")
            w, h = mask.size
            masks.append(np.asarray(mask, np.uint8).reshape(-1)[:w * h])
            size.append((w, h))
            bbox.append(font.pil.getbbox(chr(cp)))
            adv.append(font.pil.getlength(chr(cp)))
        ascent, descent = font.pil.getmetrics()
        arrays.update({
            f"{face}_cps": np.array(covered, np.int64),
            f"{face}_bbox": np.array(bbox, np.int64).reshape(-1, 4),
            f"{face}_advance": np.array(adv, np.float64),
            f"{face}_size": np.array(size, np.int64).reshape(-1, 2),
            f"{face}_masks": (np.concatenate(masks) if masks
                              else np.zeros(0, np.uint8)),
            f"{face}_ascent": np.int64(ascent),
            f"{face}_descent": np.int64(descent),
            f"{face}_weight": np.int64(font.weight)})
    return arrays


def main(argv: list[str]) -> int:
    out = argv[0] if argv else BANK_MASKS_NPZ
    np.savez_compressed(out, **build_arrays())
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
