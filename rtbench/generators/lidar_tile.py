"""An airborne LiDAR tile as the LAS viewer draws it: ``n_points`` returns
over one ``size`` x ``size`` m tile at ``pulses_per_m2`` pulses (USGS 3DEP
Quality Level 1: at least 8 pulses/m2), in tile-local float32 metres (x
and z across the tile, centred on it, y up), one constant radius a point
by the rule of the LAS viewer's loader (``io/las.py::to_spheres``: the
extent's length over N^(1/3), times 0.05).

Everything comes from ``seed`` (the configuration's, never the run's):

* the terrain: a smooth height field of ``modes`` random plane waves of
  100-1,000 m wavelength, scaled to +-``relief`` m, plus 5 cm of grain;
* ``buildings`` boxes of 10-40 m sides and 4-20 m height on open ground,
  whose flat roofs take the pulses over them;
* canopy over ``canopy_share`` of the open ground (a smooth random field
  thresholded), each canopy cell with a crown height of 12-25 m;
* pulses on a jittered scan grid of ``pulses_per_m2``: each gives its last
  return on the ground, a roof or, with no ground under the crown, nothing
  else; the rest of the ``n_points`` (``n_points`` / 1.25 pulses: 1.25
  returns a pulse) are first returns in the crowns, 3 m above the ground
  up to the crown height, drawn among the canopy pulses.

``make`` returns (points (N, 3) float32, faces (0, 3) int32, None,
{"radius": r}): a point set has no faces and no materials, and its
radius rides in the materials' place.
"""

from __future__ import annotations

import numpy as np


def _waves(rng, x, z, modes, lo, hi):
    """A sum of ``modes`` random plane waves of wavelengths in [lo, hi] m
    over the points (x, z), in [-1, 1] (float32)."""
    out = np.zeros(x.shape, np.float32)
    k = 2.0 * np.pi / rng.uniform(lo, hi, modes)
    ang = rng.uniform(0.0, 2.0 * np.pi, modes)
    ph = rng.uniform(0.0, 2.0 * np.pi, modes)
    amp = rng.uniform(0.5, 1.0, modes)
    f32 = np.float32
    for i in range(modes):
        arg = f32(k[i] * np.cos(ang[i])) * x + f32(k[i] * np.sin(ang[i])) * z
        arg += f32(ph[i])
        out += f32(amp[i]) * np.sin(arg)
    return out / f32(amp.sum())


def make(n_points: int = 10_000_000, size: float = 1000.0,
         pulses_per_m2: float = 8.0, relief: float = 25.0,
         canopy_share: float = 0.25, buildings: int = 400, modes: int = 6,
         seed: int = 3):
    rng = np.random.default_rng(int(seed))
    n = int(n_points)
    n_pulses = int(round(n / 1.25))
    half = 0.5 * float(size)
    # the scan grid: g_x x g_z cells of one pulse each, jittered in the
    # cell, the first n_pulses in row order
    g = int(np.ceil(np.sqrt(size * size * pulses_per_m2)))
    gz = int(np.ceil(n_pulses / g))
    cell_x, cell_z = size / g, size / gz
    idx = np.arange(n_pulses, dtype=np.int64)
    x = ((idx % g) + rng.random(n_pulses)) * cell_x - half
    z = ((idx // g) + rng.random(n_pulses)) * cell_z - half
    del idx
    x, z = x.astype(np.float32), z.astype(np.float32)

    ground = relief * _waves(rng, x, z, modes, 100.0, 1000.0)
    ground += rng.normal(0.0, 0.05, n_pulses).astype(np.float32)

    # buildings: footprints on the grid of pulses, flat roofs
    roof = np.full(n_pulses, np.nan, np.float32)
    edge = half - min(40.0, 0.5 * half)  # centres 40 m in from the edge
    bx = rng.uniform(-edge, edge, buildings)
    bz = rng.uniform(-edge, edge, buildings)
    bw = rng.uniform(5.0, 20.0, (buildings, 2))
    bh = rng.uniform(4.0, 20.0, buildings)
    cx = np.clip(((x + half) / 40.0).astype(np.int64), 0, int(size) // 40)
    cz = np.clip(((z + half) / 40.0).astype(np.int64), 0, int(size) // 40)
    key = cx * 1000 + cz
    order = np.argsort(key, kind="stable")
    skey = key[order]
    for i in range(buildings):
        # pulses of the 40-m cells the footprint may touch
        x0, x1 = bx[i] - bw[i, 0], bx[i] + bw[i, 0]
        z0, z1 = bz[i] - bw[i, 1], bz[i] + bw[i, 1]
        sel = []
        for ci in range(int((x0 + half) // 40), int((x1 + half) // 40) + 1):
            for cj in range(int((z0 + half) // 40),
                            int((z1 + half) // 40) + 1):
                a, b = np.searchsorted(skey, [ci * 1000 + cj,
                                              ci * 1000 + cj + 1])
                sel.append(order[a:b])
        sel = np.concatenate(sel)
        inside = sel[(x[sel] >= x0) & (x[sel] < x1) & (z[sel] >= z0)
                     & (z[sel] < z1)]
        if inside.size:
            base = float(ground[inside].mean())
            roof[inside] = np.float32(base + bh[i])
    del key, order, skey, cx, cz
    built = ~np.isnan(roof)

    # canopy: a smooth field thresholded at the share of open ground
    field = _waves(rng, x, z, 2 * modes, 20.0, 200.0)
    open_ = ~built
    cut = np.quantile(field[open_], 1.0 - canopy_share)
    canopy = open_ & (field >= cut)
    crown = 12.0 + 13.0 * (0.5 + 0.5 * _waves(rng, x, z, modes, 30.0, 300.0))

    last = np.where(built, roof, ground)
    pts = np.empty((n, 3), np.float32)
    pts[:n_pulses, 0] = x
    pts[:n_pulses, 1] = last
    pts[:n_pulses, 2] = z
    # first returns in the crowns, drawn among the canopy pulses
    n_first = n - n_pulses
    cand = np.nonzero(canopy)[0]
    pick = rng.choice(cand, n_first, replace=cand.size < n_first)
    h = 3.0 + (crown[pick] - 3.0) * rng.random(n_first, np.float32)
    # a first return lies in the pulse's footprint: 10 cm of beam spread
    pts[n_pulses:, 0] = x[pick] + rng.normal(0.0, 0.1, n_first)
    pts[n_pulses:, 1] = ground[pick] + h
    pts[n_pulses:, 2] = z[pick] + rng.normal(0.0, 0.1, n_first)
    ext = pts.max(axis=0).astype(np.float64) - pts.min(axis=0)
    radius = float(np.linalg.norm(ext)) / max(n ** (1.0 / 3.0), 1.0) * 0.05
    return pts, np.zeros((0, 3), np.int32), None, {"radius": max(radius,
                                                                   1e-6)}
