"""gltfrender: load a glTF/.glb scene, commit the scene graph, render
normal-shaded AOVs (the port of ``examples/gltfrender.py``; reference
examples/gltfrender).

    python -m nanort_tpu_torch.examples.gltfrender scene.gltf [out.png] [size] [--device cuda|cpu]

The graph's walk runs on the wavefront engine (plain torch on the
device), as the JAX package's does; no kernel of the port runs here.
"""

from __future__ import annotations

import time

import numpy as np

from ..io.gltf import load_gltf, to_scene_graph
from ..models.cameras import look_at, pinhole_rays
from ..utils.image import save_png
from . import parse_device, sync


def main(argv=None) -> dict | None:
    """Render and write the PNG. Returns ``seconds`` (commit, walk) and
    the ``hits`` (``SceneHits`` on the device); prints the usage and
    returns None without a scene."""
    args, dev = parse_device(argv)
    if not args:
        print(__doc__)
        return None
    out = args[1] if len(args) > 1 else "gltfrender.png"
    size = int(args[2]) if len(args) > 2 else 512
    g = load_gltf(args[0])
    print(f"{len(g.meshes)} meshes, {len(g.instances)} instances")
    sc = to_scene_graph(g, device=dev)
    seconds = {}
    t0 = time.perf_counter()
    sc.commit()
    sync(dev)
    seconds["commit"] = time.perf_counter() - t0
    print(f"commit (builds + packing): {seconds['commit']:.2f}s")
    lo, hi = sc.bounding_box()
    center = 0.5 * (lo + hi)
    ext = float(np.linalg.norm(hi - lo))
    cam = look_at(eye=center + [0.4 * ext, 0.3 * ext, 1.1 * ext],
                  center=center, width=size, height=size, fov=45, device=dev)
    t0 = time.perf_counter()
    hits = sc.traverse(pinhole_rays(cam))
    n = hits.normal_s.cpu().numpy()
    hit = hits.hit.cpu().numpy()
    img = np.where(hit[..., None], 0.5 * np.abs(n) + 0.3, 0.0)
    seconds["walk"] = time.perf_counter() - t0
    print(f"render: {seconds['walk']:.2f}s ({hit.mean() * 100:.0f}% hit)")
    save_png(out, img, gamma=1.0)
    print(f"wrote {out}")
    return {"seconds": seconds, "hits": hits}


if __name__ == "__main__":
    main()
