"""Provider brand marks for CI badges.

Capability parity with reference src/widgets/brand_icons.rs (GitHub/GitLab
marks). The reference embeds Simple Icons vector paths; our renderer's
primitive set favors SDF shapes, so these are stylized monogram badges in
the providers' brand colors — same role (visually distinguishing CI
providers in badges and token dialogs).
"""

from __future__ import annotations

from ...ui import El, rect, text

GITHUB_BG = (0.09, 0.105, 0.13, 1.0)
GITLAB_BG = (0.89, 0.42, 0.16, 1.0)


def github_mark(size: float = 16.0) -> El:
    return rect(text("GH", font_size=size * 0.52, bold=True,
                     color=(1, 1, 1, 0.95)),
                width=size, height=size, radius=size / 2, fill=GITHUB_BG,
                align="center")


def gitlab_mark(size: float = 16.0) -> El:
    return rect(text("GL", font_size=size * 0.52, bold=True,
                     color=(1, 1, 1, 0.95)),
                width=size, height=size, radius=size * 0.25, fill=GITLAB_BG,
                align="center")


def provider_mark(provider: str, size: float = 16.0) -> El:
    return github_mark(size) if provider == "github" else gitlab_mark(size)
