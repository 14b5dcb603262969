"""Copies on a ring: copy k of ``copies`` turned about its own tilted
axis and set on a circle of ``radius`` around the origin. A frozen copy
of the ring of ``chip_smoke.py:3209-3222`` (phase 21)."""

import numpy as np

from rtbench.scenes import compose, rotate, translate


def make(copies: int = 10, radius: float = 3.5) -> list:
    """The 4x4 float64 transform of each copy on the ring."""
    out = []
    for k in range(int(copies)):
        a = 2.0 * np.pi * k / copies
        t = (radius * np.cos(a), 0.25 * (k % 3) - 0.25, radius * np.sin(a))
        axis = (0.15 * k - 0.6, 1.0, 0.2)
        out.append(compose(translate(t), rotate(axis, 0.6 * k + 0.3)))
    return out
