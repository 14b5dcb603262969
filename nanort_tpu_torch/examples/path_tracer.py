"""Path tracer on the Cornell box (the port of ``examples/path_tracer.py``;
reference examples/path_tracer).

    python -m nanort_tpu_torch.examples.path_tracer [out.png] [size] [spp] [--device cuda|cpu]

The scene (at most 256 triangles) takes the fused route: the whole
render is one launch of the brute-sweep megakernel (K3) on the card, its
plain version on the CPU. The random numbers come from the integer seed
0 where the JAX program hands over ``PRNGKey(0)``.
"""

from __future__ import annotations

import time

import numpy as np

from ..io.procedural import make_cornell_pt_scene
from ..models.cameras import look_at, pinhole_rays
from ..models.path_tracer import make_pt_scene, render_path_traced
from ..utils.image import save_png
from . import parse_device


def main(argv=None) -> dict:
    """Render and write the PNG. Returns ``seconds`` (the render) and the
    linear ``img`` (a tensor on the device)."""
    args, dev = parse_device(argv)
    out = args[0] if len(args) > 0 else "path_tracer.png"
    size = int(args[1]) if len(args) > 1 else 256
    spp = int(args[2]) if len(args) > 2 else 64
    v, f, mids, mats = make_cornell_pt_scene()
    scene = make_pt_scene(v, f, mids, mats, engine="pallas", device=dev)
    cam = look_at(eye=(0, 0, 2.3), center=(0, 0, 0), width=size,
                  height=size, fov=55, device=dev)
    rays = pinhole_rays(cam)
    t0 = time.perf_counter()
    img = render_path_traced(scene, rays, seed=0, spp=spp, max_bounces=8)
    host = img.cpu().numpy()
    seconds = time.perf_counter() - t0
    print(f"Render {seconds:.1f} secs ({spp} spp)")
    save_png(out, np.clip(host, 0, 1))
    print(f"wrote {out}")
    return {"seconds": seconds, "img": img}


if __name__ == "__main__":
    main()
