"""Cubic bezier math, batched over segments, in numpy on the host.

The port's copy of the host half of `whisper_git_tpu/ops/bezier.py`
(y_at, t_at_y bisection root-find, De Casteljau split, subcurve
extraction). Every operation is vectorized over a leading batch axis so
the graph layout can decompose all edges' curves at once. These are
control-plane functions (a refresh decomposes at most a few hundred
curves), so they take numpy arrays and run on the host; the reference's
second namespace (jax arrays in, jax.numpy math) is not ported.

Control points are (B, 4, 2) float32: P0, P1, P2, P3 in pixel space.
"""

from __future__ import annotations

import numpy as np

_T_ITERS = 24  # bisection iterations: |y error| < span / 2^24 — sub-pixel


def _ns(*arrays):
    """The array namespace of the inputs: numpy (the host control path).
    Anything else is refused; the port has no device variant."""
    if all(isinstance(a, (np.ndarray, float, int)) for a in arrays):
        return np
    raise TypeError("ops.bezier takes numpy arrays and Python scalars; got "
                    + ", ".join(type(a).__name__ for a in arrays))


def point_at(cubics, t):
    """Evaluate (B,4,2) cubics at (B,) params → (B,2)."""
    t = t[:, None]
    mt = 1.0 - t
    p0, p1, p2, p3 = cubics[:, 0], cubics[:, 1], cubics[:, 2], cubics[:, 3]
    return (mt ** 3 * p0 + 3 * mt ** 2 * t * p1
            + 3 * mt * t ** 2 * p2 + t ** 3 * p3)


def y_at(cubics, t):
    return point_at(cubics, t)[:, 1]


def t_at_y(cubics, y):
    """Bisection root-find for the param where the curve crosses height
    `y`. Assumes y is monotonic in t (true for the graph's S-curves,
    which run top-to-bottom). (B,4,2), (B,) → (B,). The fixed-count loop
    unrolls under jit and runs as a plain Python loop on numpy."""
    xp = _ns(cubics, y)
    lo = xp.zeros(cubics.shape[0], xp.float32)
    hi = xp.ones(cubics.shape[0], xp.float32)
    for _ in range(_T_ITERS):
        mid = 0.5 * (lo + hi)
        ym = y_at(cubics, mid)
        below = ym < y
        lo = xp.where(below, mid, lo)
        hi = xp.where(below, hi, mid)
    return 0.5 * (lo + hi)


def split(cubics, t):
    """De Casteljau split at (B,) params → two (B,4,2) halves."""
    xp = _ns(cubics, t)
    t = t[:, None, None]
    p0 = cubics[:, 0:1]
    p1 = cubics[:, 1:2]
    p2 = cubics[:, 2:3]
    p3 = cubics[:, 3:4]
    q0 = p0 + t * (p1 - p0)
    q1 = p1 + t * (p2 - p1)
    q2 = p2 + t * (p3 - p2)
    r0 = q0 + t * (q1 - q0)
    r1 = q1 + t * (q2 - q1)
    s = r0 + t * (r1 - r0)
    left = xp.concatenate([p0, q0, r0, s], axis=1)
    right = xp.concatenate([s, r1, q2, p3], axis=1)
    return left, right


def subcurve(cubics, t0, t1):
    """Extract the sub-segment [t0, t1] of each curve → (B,4,2)."""
    xp = _ns(cubics, t0, t1)
    _, right = split(cubics, t0)
    # Re-parametrize t1 into the right half's domain.
    denom = xp.maximum(1.0 - t0, 1e-8)
    t1r = (t1 - t0) / denom
    left, _ = split(right, t1r)
    return left


def s_curve(x0, y0, x1, y1):
    """The graph's merge/fork connector: a vertical-tangent S-curve between
    two lane positions (control points at 50% vertical span, matching the
    reference's smooth S-curve connectors)."""
    xp = _ns(x0, y0, x1, y1)
    midy = 0.5 * (y0 + y1)
    p0 = xp.stack([x0, y0], axis=-1)
    p1 = xp.stack([x0, midy], axis=-1)
    p2 = xp.stack([x1, midy], axis=-1)
    p3 = xp.stack([x1, y1], axis=-1)
    return xp.stack([p0, p1, p2, p3], axis=-2)


def flatten(cubics, segments: int = 16):
    """Tessellate (B,4,2) cubics into (B, segments+1, 2) polylines (the
    reference tessellates splines into 16 segments by default)."""
    xp = _ns(cubics)
    ts = np.linspace(0.0, 1.0, segments + 1)
    B = cubics.shape[0]
    pts = xp.stack([point_at(cubics, xp.full((B,), t, xp.float32))
                    for t in ts], axis=0)  # (S+1, B, 2)
    return xp.transpose(pts, (1, 0, 2))
