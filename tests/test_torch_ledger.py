"""The port's cache ledger (`whisper_git_tpu_torch/ledger.py`), the four
cases of `tests/test_ledger.py`: the known caches registered under the
reference's names, cap violations detected, sizes of array and tensor
payloads, and a render filling the scene caches of the port's renderer."""

import numpy as np
import torch

from whisper_git_tpu import ledger as ref_ledger
from whisper_git_tpu_torch import ledger


def test_snapshot_covers_known_caches():
    snap = ledger.snapshot()
    for name in ("compose.group", "compose.slab", "compose.plan",
                 "frame.chrome", "raster.win_dev", "layout.subtree",
                 "ui.el_memo", "scene.subtree_cache", "atlas.measure"):
        assert name in snap, f"{name} not registered"
        assert set(snap[name]) == {"entries", "mb", "cap"}
    # Every cache the reference registers, under its name.
    ref_names = set(ref_ledger.snapshot()) - {"jax.live_arrays"}
    assert ref_names <= set(snap)
    if not torch.cuda.is_initialized():
        assert "torch.cuda" not in snap


def test_violation_detection_fires_over_cap():
    d = {i: np.zeros(8, np.uint8) for i in range(10)}
    ledger.register_dict("test.overfull", d, cap=4)
    try:
        viols = ledger.violations()
        assert any(v.startswith("test.overfull:") for v in viols), viols
        # ...and not at exactly cap+1 (eviction leaves cap+1 after an
        # insert in the `while len > cap` callers).
        for k in list(d)[:5]:
            del d[k]
        assert not any(v.startswith("test.overfull:")
                       for v in ledger.violations())
    finally:
        ledger._REGISTRY.pop("test.overfull", None)


def test_sizes_reflect_array_and_tensor_payloads():
    d = {"k": np.zeros((100, 100, 4), np.float32),        # 160 KB
         "t": torch.zeros((100, 100, 4), dtype=torch.int16)}  # 80 KB
    ledger.register_dict("test.sized", d, cap=8)
    try:
        snap = ledger.snapshot()
        assert snap["test.sized"]["entries"] == 2
        assert 0.24 <= snap["test.sized"]["mb"] <= 0.25
    finally:
        ledger._REGISTRY.pop("test.sized", None)


def test_render_populates_scene_caches():
    from whisper_git_tpu_torch.render.renderer import get_renderer
    from whisper_git_tpu_torch.ui import column, rect, text
    from whisper_git_tpu_torch.ui.theme import DARK

    r = get_renderer("cpu")
    ui = column(rect(text("ledger probe", color=DARK.text),
                     fill=DARK.surface, width="fill", height=30),
                width="fill", height="fill", fill=DARK.background)
    root = r.layout(ui, (128, 64))
    r.compile(root, (128, 64), DARK.background)
    snap = ledger.snapshot()
    assert snap["scene.text_cache"]["entries"] >= 1
    # The CPU's image caches hold a quarter of the card's.
    assert snap["compose.slab"]["cap"] == 6
