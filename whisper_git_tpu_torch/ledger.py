"""Aggregate cache ledger — every bounded cache registers here so ONE
report covers the process's memory high-water surfaces.

Counterpart of `whisper_git_tpu/ledger.py`, under the reference's names.
`install()` registers the port's caches (compose layers and plans, frame
cache, packed-path window caches, layout subtree cache, el/row memos,
scene chunk caches and measurer caches of each device's renderer) with
their cap expressions; `snapshot()` sizes them (entries + approximate
bytes, nbytes for arrays and tensors) plus, once CUDA is initialized, the
device memory PyTorch holds; `violations()` lists caches over cap. The
interactive loop dumps snapshots to WGIT_LEDGER=path every few seconds."""

from __future__ import annotations

import sys

_REGISTRY: dict = {}   # name -> {"size": fn() -> (entries, bytes), "cap": fn() -> int | None}


def register(name: str, size_fn, cap_fn=None) -> None:
    _REGISTRY[name] = {"size": size_fn, "cap": cap_fn}


def _approx_bytes(obj, depth: int = 0) -> int:
    """Rough recursive payload size: ndarray / tensor nbytes + container
    overhead. Depth-capped — ledger accuracy beats precision here."""
    nb = getattr(obj, "nbytes", None)
    if nb is not None:
        try:
            return int(nb)
        except (TypeError, ValueError):
            pass
    if depth >= 3:
        return sys.getsizeof(obj) if obj is not None else 0
    if isinstance(obj, dict):
        return sys.getsizeof(obj) + sum(
            _approx_bytes(v, depth + 1) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sys.getsizeof(obj) + sum(
            _approx_bytes(v, depth + 1) for v in obj)
    if isinstance(obj, (bytes, str)):
        return sys.getsizeof(obj)
    return sys.getsizeof(obj) if obj is not None else 0


def register_dict(name: str, d: dict, cap=None) -> None:
    """Register a plain dict cache. `cap` is an int or a zero-arg
    callable returning the current cap (caps here scale with device)."""
    def size():
        try:
            return len(d), _approx_bytes(d)
        except RuntimeError:   # mutated during iteration: retry cheap
            return len(d), 0

    register(name, size, (cap if callable(cap) or cap is None
                          else (lambda c=cap: c)))


def _render_device() -> str:
    """The device of the renderers in use: the image caches' caps depend
    on it (`compose._img_cache_cap`). CUDA when any renderer is on it."""
    from .render import renderer as RR

    return "cuda" if any(k.startswith("cuda") for k in RR._RENDERERS) \
        else "cpu"


_INSTALLED = [False]


def install() -> None:
    """Register every known cache (idempotent). Imports are local so
    the ledger can load before the renderer is initialized."""
    if _INSTALLED[0]:
        return
    _INSTALLED[0] = True
    from .render import compose as C
    from .render import frame as F
    from .render import rasterizer as R
    from .render import scene as SC
    from .ui import layout as L
    from .ui import memo as M

    def img_cap(cap):
        return lambda: C._img_cache_cap(cap, _render_device())

    register_dict("compose.group", C._GROUP_CACHE, img_cap(12))
    register_dict("compose.slab", C._SLAB_CACHE, img_cap(24))
    register_dict("compose.dyn_pack", C._DYN_PACK_CACHE, 512)
    register_dict("compose.plan", C._PLAN_CACHE, img_cap(6))
    register_dict("compose.blob_dev", C._BLOB_DEV_CACHE, 512)
    register_dict("compose.stack", C._STACK_CACHE, img_cap(8))
    register_dict("frame.win_parts_dev", F._WIN_PARTS_DEV, 32)
    register_dict("frame.win_pair_dev", F._WIN_PAIR_DEV, 48)
    register_dict("frame.chrome", F._CHROME_CACHE, 24)
    register_dict("raster.win_host", R._WIN_HOST_CACHE, 33)
    register_dict("raster.win_dev", R._WIN_DEV_CACHE, 16)
    register_dict("layout.subtree", L._SUBTREE_LAYOUT_CACHE, 8192)
    register_dict("scene.splice_shift", SC._SPLICE_SHIFT_CACHE, 2048)
    register_dict("ui.el_memo", M._EL_MEMO, M._MAX_ENTRIES)
    from .app.views import commit_graph as CG
    from .app.views import diff as DV

    register_dict("views.row_el_memo", CG._ROW_EL_MEMO, 4096)
    register_dict("views.diff_row_memo", DV._ROW_MODEL_MEMO, 4)

    def renderers():
        from .render import renderer as RR

        return list(RR._RENDERERS.values())

    def scene_size(attr):
        def size():
            ds = [getattr(r.compiler, attr) for r in renderers()]
            return (sum(len(d) for d in ds),
                    sum(_approx_bytes(d) for d in ds))
        return size

    register("scene.text_cache", scene_size("_text_cache"))
    register("scene.subtree_cache", scene_size("_subtree_cache"))
    register("scene.window_cache", scene_size("_window_cache"))

    def measurer_size():
        n = b = 0
        for r in renderers():
            d = getattr(r.measurer, "_measure_cache", {}) or {}
            e = getattr(r.measurer, "_elide_cache", {}) or {}
            n += len(d) + len(e)
            b += _approx_bytes(d) + _approx_bytes(e)
        return n, b

    register("atlas.measure", measurer_size)


def snapshot() -> dict:
    """name -> {entries, mb, cap}, plus `torch.cuda` (the bytes PyTorch's
    allocator has handed out and holds) once CUDA is initialized."""
    install()
    out = {}
    for name, ent in sorted(_REGISTRY.items()):
        try:
            n, b = ent["size"]()
        except Exception:
            n, b = -1, 0
        cap = ent["cap"]
        try:
            cap_v = cap() if callable(cap) else cap
        except Exception:
            cap_v = None
        out[name] = {"entries": n, "mb": round(b / 1e6, 2), "cap": cap_v}
    import torch

    if torch.cuda.is_initialized():
        out["torch.cuda"] = {
            "memory_allocated_mb": round(
                torch.cuda.memory_allocated() / 1e6, 1),
            "memory_reserved_mb": round(
                torch.cuda.memory_reserved() / 1e6, 1),
            "cap": None}
    return out


def violations(snap: dict | None = None) -> list:
    """Registered caches over their caps (entries > cap + 1 — inserts
    evict with `while len > cap` after the insert in some callers)."""
    snap = snap or snapshot()
    out = []
    for name, row in snap.items():
        cap = row.get("cap")
        if cap is not None and row["entries"] > cap + 1:
            out.append(f"{name}: {row['entries']} entries > cap {cap}")
    return out
