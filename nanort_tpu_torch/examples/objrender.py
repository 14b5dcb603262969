"""objrender: OBJ -> BVH build (timed) -> primary rays -> normal-shaded
PNG (the port of ``examples/objrender.py``; reference
examples/objrender/main.cc:581-709).

    python -m nanort_tpu_torch.examples.objrender [scene.obj] [out.png] [size] [--device cuda|cpu]

Without an OBJ it renders the Cornell box with a 32 x 64 UV sphere. The
host SAH build is timed and its statistics printed as in the JAX
program; then the BVH16 tables are built (their time on a line of their
own) and the frame traces through the packet kernel (K1) on the card,
through its plain version on the CPU. (The JAX program traces its stack
engine; the records are the same under the equal-t tie contract.)
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import TriangleMesh, build_triangle_bvh
from ..build.bvh8 import collapse_bvh8
from ..io.obj import load_obj
from ..io.procedural import make_cornell_box, make_uv_sphere, merge_meshes
from ..models.cameras import look_at, pinhole_rays
from ..models.objrender import render_aovs
from ..utils.image import save_png
from . import parse_device, sync


def main(argv=None) -> dict:
    """Render and write the PNG. Returns ``seconds`` (load, build,
    tables, render), ``rgb`` and ``hits`` (tensors on the device), the
    ``rays`` and the BVH16 tables ``scene8``."""
    args, dev = parse_device(argv)
    size = int(args[2]) if len(args) > 2 else 512
    out = args[1] if len(args) > 1 else "objrender.png"
    seconds = {}
    t0 = time.perf_counter()
    if args:
        m = load_obj(args[0])
        v, f = m.vertices, m.faces
        seconds["load"] = time.perf_counter() - t0
        print(f"OBJ load time: {seconds['load']:.3f} secs ({len(f)} tris)")
    else:
        v, f = merge_meshes(make_cornell_box(2.0), make_uv_sphere(32, 64, 0.5))
    mesh = TriangleMesh(vertices=v, faces=f)

    t0 = time.perf_counter()
    bvh, stats = build_triangle_bvh(mesh)
    seconds["build"] = time.perf_counter() - t0
    print(f"BVH build time: {seconds['build']:.3f} secs")
    print(f"  # of leaf   nodes: {stats.num_leaf_nodes}")
    print(f"  # of branch nodes: {stats.num_branch_nodes}")
    print(f"  Max tree depth   : {stats.max_tree_depth}")
    t0 = time.perf_counter()
    scene8 = collapse_bvh8(bvh, v, f, width=16).to(dev)
    sync(dev)
    seconds["tables"] = time.perf_counter() - t0
    print(f"BVH16 tables: {seconds['tables']:.3f} secs")

    center = 0.5 * (v.min(0) + v.max(0))
    ext = float(np.linalg.norm(v.max(0) - v.min(0)))
    cam = look_at(eye=center + [0, 0, 1.2 * ext], center=center,
                  width=size, height=size, fov=45.0, device=dev)
    rays = pinhole_rays(cam)
    mesh_d = TriangleMesh(torch.from_numpy(v).to(dev),
                          torch.from_numpy(f).to(dev))
    sync(dev)
    t0 = time.perf_counter()
    aovs, hits = render_aovs(bvh, mesh_d, rays, scene8=scene8)
    rgb = aovs["rgb"].cpu().numpy()
    seconds["render"] = time.perf_counter() - t0
    print(f"Render {seconds['render']:.3f} secs")
    save_png(out, rgb, gamma=1.0)
    print(f"wrote {out} ({float(hits.hit.float().mean()) * 100:.1f}% hit)")
    return {"seconds": seconds, "rgb": aovs["rgb"], "hits": hits,
            "rays": rays, "scene8": scene8}


if __name__ == "__main__":
    main()
