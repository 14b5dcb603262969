"""A character's head of hair as cubic Bezier curves, the primitive of
upstream nanort's curve example (``examples/curves_primitive/main.cc:
481-800``): ``n_strands`` strands of ``segments`` cubic segments each, in
metres, y up, the scalp a sphere of ``head_radius`` about the origin (the
scalp itself is not in the scene).

Everything comes from ``seed`` (the configuration's, never the run's):

* roots uniform on the upper ``scalp_share`` of the scalp's height (y
  from ``head_radius`` (1 - 2 ``scalp_share``) up);
* each strand's length uniform in ``length``; it leaves the scalp along
  the normal and bends towards gravity over a stiffness length uniform in
  ``stiffness``, its nodes kept a millimetre off the scalp, so the strands
  drape over the head and fall below it;
* a seeded wave across the strand (in the scalp's tangent plane, about
  the vertical), of a period uniform in ``wave_period`` and an amplitude
  uniform in ``wave_amplitude``, growing over the first 2 cm from the
  root;
* ``segments + 1`` nodes a strand joined by cubic Bezier segments that are
  C1 at the joints (Catmull-Rom tangents: p1 = n_i + m_i / 3, p2 = n_i+1 -
  m_i+1 / 3);
* the radius tapering linearly from ``radius_root`` at the root to
  ``radius_tip`` at the tip, given at each control point.

``make`` returns (control points (4 N, 3) float32, curve by curve, faces
(0, 3) int32, None, {"radii": (N, 4) float32}): a curve set has no faces
and no materials, and its radii ride in the materials' place.
"""

from __future__ import annotations

import numpy as np


def make(n_strands: int = 100_000, segments: int = 32,
         head_radius: float = 0.1, scalp_share: float = 0.6,
         length=(0.15, 0.35), stiffness=(0.02, 0.06),
         wave_period=(0.01, 0.04), wave_amplitude=(0.001, 0.004),
         radius_root: float = 40e-6, radius_tip: float = 20e-6,
         seed: int = 11):
    rng = np.random.default_rng(int(seed))
    n, k = int(n_strands), int(segments)
    R = float(head_radius)
    # roots: uniform on the sphere's zone above y0 (Archimedes: y uniform)
    y = rng.uniform(R * (1.0 - 2.0 * scalp_share), R, n)
    phi = rng.uniform(0.0, 2.0 * np.pi, n)
    rho = np.sqrt(np.maximum(R * R - y * y, 0.0))
    normal = np.stack([rho * np.cos(phi), y, rho * np.sin(phi)], 1) / R
    root = R * normal
    L = rng.uniform(*length, n)
    ls = rng.uniform(*stiffness, n)
    lam = rng.uniform(*wave_period, n)
    amp = rng.uniform(*wave_amplitude, n)
    ph = rng.uniform(0.0, 2.0 * np.pi, n)
    # the wave's direction: about the vertical, in the scalp's tangent plane
    across = np.stack([-np.sin(phi), np.zeros(n), np.cos(phi)], 1)
    gravity = np.array([0.0, -1.0, 0.0])

    # nodes by arc length: the tangent turns from the normal to gravity;
    # a node that would fall inside the scalp is put back on a sphere a
    # millimetre above it (the strand slides over the head)
    s = np.linspace(0.0, 1.0, k + 1)[None, :] * L[:, None]  # (n, k + 1)
    step = (L / k)[:, None]
    floor = R + 1e-3
    nodes = np.empty((n, k + 1, 3))
    nodes[:, 0] = root
    for i in range(k):
        bend = np.exp(-0.5 * (s[:, i] + s[:, i + 1]) / ls)[:, None]
        tan = bend * normal + (1.0 - bend) * gravity
        tan /= np.linalg.norm(tan, axis=1, keepdims=True)
        nxt = nodes[:, i] + step * tan
        dist = np.linalg.norm(nxt, axis=1, keepdims=True)
        nodes[:, i + 1] = np.where(dist < floor, nxt * (floor / dist), nxt)
    grow = np.minimum(1.0, s / 0.02)
    wave = amp[:, None] * grow * np.sin(2.0 * np.pi * s / lam[:, None]
                                        + ph[:, None])
    nodes = nodes + wave[..., None] * across[:, None, :]

    # C1 cubic segments through the nodes (Catmull-Rom tangents)
    m = np.empty_like(nodes)
    m[:, 1:-1] = 0.5 * (nodes[:, 2:] - nodes[:, :-2])
    m[:, 0] = nodes[:, 1] - nodes[:, 0]
    m[:, -1] = nodes[:, -1] - nodes[:, -2]
    p0, p3 = nodes[:, :-1], nodes[:, 1:]
    p1 = p0 + m[:, :-1] / 3.0
    p2 = p3 - m[:, 1:] / 3.0
    cps = np.stack([p0, p1, p2, p3], 2)  # (n, k, 4, 3)
    u = (np.arange(k)[:, None] + np.arange(4)[None, :] / 3.0) / k
    radii = radius_root + (radius_tip - radius_root) * u  # (k, 4)
    radii = np.broadcast_to(radii, (n, k, 4))
    return (cps.reshape(-1, 3).astype(np.float32),
            np.zeros((0, 3), np.int32), None,
            {"radii": radii.reshape(-1, 4).astype(np.float32)})
