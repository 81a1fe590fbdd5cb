"""Scene compiler hook: a jax-free `_bucket`.

The port compiles scenes with the reference's `SceneCompiler`
(`whisper_git_tpu/render/scene.py`), which sizes every command buffer
through `_bucket`. The reference's `_bucket` asks
`rasterizer._coarse_buckets()` which ladder to use, and importing that
module imports jax. Coarse ladders exist only to keep jit signatures
stable; eager PyTorch has no jit, so the port always uses the fine ladder.

Importing this module installs `_bucket` over
`whisper_git_tpu.render.scene._bucket` — the port's only run-time hook
into the reference. With JAX on the CPU the two functions agree for every
n, so reference code running in the same process sees no change.
"""

from __future__ import annotations

import whisper_git_tpu.render.scene as _ref_scene
from whisper_git_tpu.render.scene import (  # noqa: F401  (re-exports)
    _NOCLIP,
    MAX_LAYERS,
    LayerBuffers,
    Scene,
    SceneCompiler,
    SubtreeChunks,
    WindowPart,
)

_FINE_LADDER = (64, 256, 1024, 4096, 16384, 65536)


def _bucket(n: int, hw_key=None) -> int:
    """Buffer capacity for n commands: 0 for none, else the next rung of
    the fine ladder, past it a multiple of 4096. `hw_key` is accepted for
    signature compatibility and unused (no high-water marks without jit)."""
    if n == 0:
        return 0
    return next((b for b in _FINE_LADDER if n <= b),
                ((n + 4095) // 4096) * 4096)


_ref_scene._bucket = _bucket
