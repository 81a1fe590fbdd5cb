"""Export the reference's SDF font atlases to `data/atlas.npz`.

    JAX_PLATFORMS=cpu python tests/tools/export_atlas.py [OUT.npz]

A developer script, not a module of the port: like the tests it imports
both packages (the reference to build, the port for the npz layout). Run
it from the repository root. Runs where the reference's atlas build runs (Pillow, matplotlib's DejaVu
fonts and JAX; `JAX_PLATFORMS=cpu` keeps the EDT on the CPU, through the
reference package's own platform override). It builds both faces fresh
(`build_atlas(use_cache=False)`) and writes their textures, glyph metrics,
chars (as a `<U1` array, no pickle), ascent and descent. The port's loader
(`render/atlas.py`) needs none of those libraries. Rerun it whenever the
reference atlas changes (glyph set, font size, spread); the test
`tests/test_torch_atlas.py` fails until then.
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from whisper_git_tpu_torch.render.atlas import (  # noqa: E402
    ATLAS_NPZ, FACES, atlas_arrays)


def build_arrays() -> dict:
    """All npz arrays, from a fresh reference build of both faces."""
    from whisper_git_tpu.render.atlas import _CHARS, build_atlas

    chars = list(_CHARS)
    arrays = {"chars": np.array(chars, dtype="<U1")}
    for face in FACES:
        atlas = build_atlas(bold=face == "bold", use_cache=False)
        assert sorted(atlas.glyphs) == sorted(chars)
        for key, val in atlas_arrays(atlas, chars).items():
            arrays[f"{face}_{key}"] = val
    return arrays


def main(argv: list[str]) -> int:
    out = argv[0] if argv else ATLAS_NPZ
    np.savez_compressed(out, **build_arrays())
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
