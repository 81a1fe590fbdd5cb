"""The import guard: no module of JAX or of the JAX package may be loaded
in the process that prints a result. Names are compared by their
top-level part, whole: `whisper_git_tpu_torch` is the port and passes,
`whisper_git_tpu` is the JAX package and fails."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "whisper_git_tpu"})


def forbidden_modules(names=None) -> list:
    names = sys.modules if names is None else names
    return sorted(n for n in names if n.partition(".")[0] in FORBIDDEN)
