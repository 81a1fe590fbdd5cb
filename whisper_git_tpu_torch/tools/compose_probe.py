"""K3's device time by op kind on the card: `python -m
whisper_git_tpu_torch.tools.compose_probe [--root DIR]`.

The counterpart of `whisper_git_tpu/tools/compose_probe.py`: the `compose`
mode of `tools/kernel_times.py`, which says what it measures and how.
"""

from __future__ import annotations

import sys

from .kernel_times import main

if __name__ == "__main__":
    sys.exit(main(["compose", *sys.argv[1:]]))
