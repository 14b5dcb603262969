"""The port's counterpart of the repository root's ``__graft_entry__.py``:
one forward step and the multi-device dry run.

``entry(device="cuda")`` returns ``(fn, args)``: the objrender AOV pass
(camera rays -> BVH traversal -> shaded AOVs) on a tiny scene, with its
BVH16 tables built once and bound into ``args``, so ``fn(*args)`` traces
through the packet kernel (K1) on the card and through its plain version
on the CPU. The JAX entry traces the stack engine; the records are the
same under the equal-t tie contract (a hit at equal t may name another
of the tied triangles).

``dryrun_multichip(n_devices, device="cuda")`` is
``parallel.dryrun.dryrun_multichip``: one data-parallel render step and
one chunk-sharded ring over ``n_devices`` spawned ranks.

    python -m nanort_tpu_torch.graft_entry [--device cuda|cpu]
"""

from __future__ import annotations

import torch

from . import build_triangle_bvh
from .build.bvh8 import collapse_bvh8
from .examples import parse_device, resolve_device
from .io.procedural import make_cornell_box, make_uv_sphere, merge_meshes
from .models.cameras import look_at, pinhole_rays
from .models.objrender import render_aovs
from .ops.triangle import TriangleMesh
from .parallel.dryrun import dryrun_multichip

__all__ = ["entry", "dryrun_multichip", "main"]


def _tiny_scene(dev: torch.device):
    """The JAX entry's scene: the Cornell box and an 8 x 16 UV sphere
    (234 triangles), its host-built BVH, the mesh and the BVH16 tables
    on ``dev``."""
    v, f = merge_meshes(make_cornell_box(2.0), make_uv_sphere(8, 16, 0.5))
    bvh, _ = build_triangle_bvh(TriangleMesh(v, f))
    mesh = TriangleMesh(torch.from_numpy(v).to(dev),
                        torch.from_numpy(f).to(dev))
    return bvh, mesh, collapse_bvh8(bvh, v, f, width=16).to(dev)


def _camera_rays(n_side: int, dev: torch.device):
    cam = look_at(eye=(0.0, 0.0, 2.5), center=(0.0, 0.0, 0.0), width=n_side,
                  height=n_side, fov=60.0, device=dev)
    return pinhole_rays(cam)


def _forward(bvh, mesh, rays, scene8):
    aovs, _ = render_aovs(bvh, mesh, rays, scene8=scene8)
    return aovs["rgb"]


def entry(device="cuda"):
    """``(fn, example_args)``: the single-device forward step, 16^2 rays
    on ``device`` (the card unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    bvh, mesh, scene8 = _tiny_scene(dev)
    return _forward, (bvh, mesh, _camera_rays(16, dev), scene8)


def main(argv=None):
    """Run ``entry``'s step once, then the multi-device dry run over the
    cards there are (at most 8; one rank on the CPU)."""
    _, dev = parse_device(argv)
    fn, args = entry(dev)
    out = fn(*args)
    print("entry:", tuple(out.shape), float(out.mean()))
    n = min(8, torch.cuda.device_count()) if dev.type == "cuda" else 1
    dryrun_multichip(n, device=dev.type)
    return out


if __name__ == "__main__":
    main()
