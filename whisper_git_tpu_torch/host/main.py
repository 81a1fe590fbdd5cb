"""CLI entry point of the port: the headless screenshot.

    python -m whisper_git_tpu_torch --screenshot OUT.png [--size WxH]
        [--scale S] [--repo P] [--screenshot-state STATE]
        [--device cuda|cpu]

The options are the reference CLI's (`whisper_git_tpu/host/main.py`
`parse_args`), plus `--device` (default cuda; asking for cuda without a
GPU is an error). Screenshot states are injected by the reference's
`apply_screenshot_state`. Avatars are off: decoding them needs Pillow.
The interactive frame loop and `--dump-bundles` are not ported.

The CLI refuses every import of JAX in its process (`refuse_jax`), so a
view that reaches one of the reference's JAX ops fails the same way
whether or not JAX is installed, instead of quietly running it.
"""

from __future__ import annotations

import argparse
import importlib.abc
import sys

from whisper_git_tpu.app.ui_app import WhisperApp
from whisper_git_tpu.host.main import apply_screenshot_state
from whisper_git_tpu.host.main import parse_args as _reference_parse_args
from whisper_git_tpu.services.config import Config

from ..render.renderer import resolve_device


class _RefuseJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.partition(".")[0] in ("jax", "jaxlib"):
            raise ImportError(
                f"{name}: this view reaches a JAX op of the reference "
                "package, which whisper_git_tpu_torch has not ported")
        return None


def refuse_jax() -> None:
    """Make every later import of jax or jaxlib in this process raise."""
    if not any(isinstance(f, _RefuseJax) for f in sys.meta_path):
        sys.meta_path.insert(0, _RefuseJax())


def parse_args(argv: list[str]) -> argparse.Namespace:
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                     help="device to render on (default: cuda)")
    ours, rest = pre.parse_known_args(argv)
    args = _reference_parse_args(rest)
    args.device = ours.device
    return args


def open_app(paths: list[str]) -> WhisperApp:
    """The app with `paths` open as tabs, refreshed synchronously, with
    avatars off (their decoding needs Pillow; not ported)."""
    app = WhisperApp.from_paths(paths, config=Config())
    app.avatar_cache.enabled = False
    for tab in app.tabs:
        tab.refresh_sync()  # sync full refresh — no event loop
    return app


def main(argv: list[str] | None = None) -> int:
    refuse_jax()
    args = parse_args(argv if argv is not None else sys.argv[1:])
    if not args.screenshot:
        print("whisper_git_tpu_torch: only --screenshot is ported; the "
              "interactive loop and --dump-bundles run in whisper_git_tpu",
              file=sys.stderr)
        return 2
    resolve_device(args.device)  # no GPU for --device cuda: fail first
    paths = list(args.paths)
    if args.repo:
        paths = [args.repo] + paths
    app = open_app(paths)
    if args.screenshot_state:
        apply_screenshot_state(app, args.screenshot_state)
    w, h = (int(v) for v in args.size.lower().split("x"))
    from . import screenshot_mode

    screenshot_mode.run(args.screenshot, w, h, args.scale, app,
                        device=args.device)
    print(f"wrote {args.screenshot}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
