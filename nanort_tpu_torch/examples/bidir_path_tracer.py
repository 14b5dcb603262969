"""Bidirectional path tracer on the Cornell box (the port of
``examples/bidir_path_tracer.py``; reference examples/bidir_path_tracer).

    python -m nanort_tpu_torch.examples.bidir_path_tracer [out.png] [size] [spp] [--device cuda|cpu]

``render_bdpt`` traces through the path tracer's ``_trace``, which
sweeps a scene of at most ``BRUTE_MAX_TRIS`` triangles brute force (the
Cornell box has 32), as the JAX package does; larger scenes built with
``engine="pallas"`` would trace through the packet kernel. The samples
draw from a ``torch.Generator`` seeded with 0 where the JAX program
hands over ``PRNGKey(0)``.
"""

from __future__ import annotations

import time

import numpy as np

from ..io.procedural import make_cornell_pt_scene
from ..models.bdpt import render_bdpt
from ..models.cameras import look_at, pinhole_rays
from ..models.path_tracer import make_pt_scene
from ..utils.image import save_png
from . import parse_device


def main(argv=None) -> dict:
    """Render and write the PNG. Returns ``seconds`` (the render) and the
    linear ``img`` (a tensor on the device)."""
    args, dev = parse_device(argv)
    out = args[0] if len(args) > 0 else "bdpt.png"
    size = int(args[1]) if len(args) > 1 else 128
    spp = int(args[2]) if len(args) > 2 else 16
    v, f, mids, mats = make_cornell_pt_scene()
    scene = make_pt_scene(v, f, mids, mats, engine="pallas", device=dev)
    cam = look_at(eye=(0, 0, 2.3), center=(0, 0, 0), width=size,
                  height=size, fov=55, device=dev)
    rays = pinhole_rays(cam)
    t0 = time.perf_counter()
    img = render_bdpt(scene, rays, seed=0, spp=spp)
    host = img.cpu().numpy()
    seconds = time.perf_counter() - t0
    print(f"Render {seconds:.1f} secs ({spp} spp)")
    save_png(out, np.clip(host, 0, 1))
    print(f"wrote {out}")
    return {"seconds": seconds, "img": img}


if __name__ == "__main__":
    main()
