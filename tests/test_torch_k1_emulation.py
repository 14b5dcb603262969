"""PyTorch port, K1's walk logic on the CPU: the source of the CUDA kernel
(nanort_tpu_torch/csrc/packet_traverse.cu) compiled with g++ against a
small mock of the CUDA API (``testing.build_with_cuda_mock``), its
per-ray functions (``begin``, ``step``, ``finish``) run one ray after
another, and held to the plain version
(traverse/packet.py::_traverse_reference) bit for bit.

This reaches the kernel's node step (slab tests, the child metadata read
a quad at a time, the far-first stores by rank in the hit mask, the
stack bound checked once a node), its leaf step (the 16-byte leaf loads,
watertight with the Dekker recompute, Woop, skip, range, cull, any-hit),
the counters, the zero-edge flags, per-packet roots and K1b's
interleaved steps on a machine without a card. The persistent warps'
claims need the card and are held there by test_torch_gpu.py. g++
builds with -ffp-contract=off and no -ffast-math, as nvcc builds with
--fmad=false: every product rounded on its own, IEEE division.
"""

import ctypes

import numpy as np
import pytest
import torch

import nanort_tpu_torch as nt
from nanort_tpu_torch.build.bvh8 import collapse_bvh8
from nanort_tpu_torch.io.procedural import (make_cornell_box, make_uv_sphere,
                                            merge_meshes)
from nanort_tpu_torch.ops.triangle import TriangleMesh
from nanort_tpu_torch.testing import (build_with_cuda_mock, overlap_soup,
                                      zero_edge_rays)
from nanort_tpu_torch.traverse import packet, treelet

torch.set_num_threads(1)

# appended to the kernel source: each ray walked alone (K1), or K rays
# stepped in turns (K1b), with the kernel's own functions
HARNESS = r"""
uint3 threadIdx, blockIdx;
namespace {
template <int W, bool kWoop, bool kCounts, bool kFlags, bool kRoots>
void walk_all(const Params& p) {
  int stack[kStackCap];
  for (long long i = 0; i < p.n_rays; ++i) {
    Walk w;
    begin<kRoots>(p, i, w);
    while (w.e != kNone) step<W, kWoop, kCounts, kFlags>(p, w, stack);
    finish<kCounts, kFlags>(p, i, w);
  }
}
template <int W, bool kWoop, int kK>
void walk_il(const Params& p) {
  static int stack[kK][kStackCap];
  for (long long first = 0; first < p.n_rays; first += kK) {
    Walk w[kK];
    for (int k = 0; k < kK; ++k) {
      w[k].e = kNone;
      if (first + k < p.n_rays) begin<true>(p, first + k, w[k]);
    }
    for (bool live = true; live;) {
      live = false;
      for (int k = 0; k < kK; ++k) {
        if (w[k].e != kNone) step<W, kWoop, false, false>(p, w[k], stack[k]);
        live |= w[k].e != kNone;
      }
    }
    for (int k = 0; k < kK; ++k) {
      if (first + k < p.n_rays) finish<false, false>(p, first + k, w[k]);
    }
  }
}
template <int W, bool kWoop>
void pick(const Params& p, int counts, int flags, int il) {
  if (il == 2) return walk_il<W, kWoop, 2>(p);
  if (il == 4) return walk_il<W, kWoop, 4>(p);
  if (counts) return walk_all<W, kWoop, true, false, true>(p);
  if (flags) return walk_all<W, false, false, true, true>(p);
  if (p.roots) return walk_all<W, kWoop, false, false, true>(p);
  walk_all<W, kWoop, false, false, false>(p);
}
}  // namespace

extern "C" void emulate_k1(
    const float* nodes, const float* leafs, const float* org, const float* dir,
    const float* min_t, const float* max_t, const int* skip, const int* roots,
    float* t_out, float* u_out, float* v_out, long long* pid_out, int* flags,
    unsigned long long* scratch, long long n_rays, long long packet,
    int width, int stack_size, int occlusion, int cull_back_face,
    int exact_edge, int use_range, int range_lo, int range_hi, int woop,
    int counts, int zero_flags, int interleave) {
  const Params p{nodes, leafs, org, dir, min_t, max_t, skip, roots, t_out,
                 u_out, v_out, pid_out, flags, scratch, scratch + 1, n_rays,
                 packet, stack_size, occlusion, cull_back_face, exact_edge,
                 use_range, range_lo, range_hi};
  if (width == 16) {
    woop ? pick<16, true>(p, counts, zero_flags, interleave)
         : pick<16, false>(p, counts, zero_flags, interleave);
  } else {
    woop ? pick<8, true>(p, counts, zero_flags, interleave)
         : pick<8, false>(p, counts, zero_flags, interleave);
  }
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    lib = build_with_cuda_mock("packet_traverse.cu", HARNESS,
                               tmp_path_factory.mktemp("k1_emulation"))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.emulate_k1.argtypes = [P] * 14 + [L] * 2 + [I] * 12
    lib.emulate_k1.restype = None
    return lib


def _emulate(lib, scene, rays, options=nt.BVHTraceOptions(),
             skip_prim_id=None, occlusion=False, intersector="watertight",
             sub=32, packet_roots=None, debug_counts=False, interleave=1,
             _flag_zero_edges=False, slots=None):
    """The emulated kernel with traverse_bvh8's arguments: its records
    (and flags) and the overflow word."""
    woop = intersector == "woop"
    n = rays.org.shape[0]
    nodes = torch.as_tensor(scene.nodes)
    leafs = torch.as_tensor(scene.leafs_woop if woop else scene.leafs)
    skip = None if skip_prim_id is None else skip_prim_id.to(torch.int32)
    lo, hi = options.prim_ids_range
    use_range = (lo, hi) != (0, packet.PRIM_RANGE_MAX)
    roots = (None if packet_roots is None
             else packet_roots.to(torch.int32).contiguous())
    t, u, v = torch.empty(n), torch.empty(n), torch.empty(n)
    pid = torch.empty(n, dtype=torch.int64)
    flags = torch.empty(n, dtype=torch.int32) if _flag_zero_edges else None
    scratch = torch.zeros(2, dtype=torch.int64)

    def ptr(x):
        return None if x is None else ctypes.c_void_p(x.data_ptr())

    lib.emulate_k1(
        ptr(nodes), ptr(leafs), ptr(rays.org), ptr(rays.dir),
        ptr(rays.min_t), ptr(rays.max_t), ptr(skip), ptr(roots), ptr(t),
        ptr(u), ptr(v), ptr(pid), ptr(flags), ptr(scratch), n,
        sub * packet.LANES, scene.width,
        packet.stack_slots(scene) if slots is None else slots,
        int(occlusion), int(options.cull_back_face),
        int(options.exact_edge_fallback and not woop), int(use_range),
        int(lo), int(hi), int(woop), int(debug_counts),
        int(_flag_zero_edges), interleave)
    out = [t, u, v, pid] + ([flags] if flags is not None else [])
    return out, int(scratch[1])


def _plain(scene, rays, **kw):
    out = packet.traverse_bvh8(scene, rays, **kw)
    if isinstance(out, nt.Hits):
        return list(out)
    return list(out[0]) + [out[1]]


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    org = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng.uniform(-0.8, 0.8, (n, 3)) - org
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    org[0::10, 0] = np.nan  # degenerate rays among them
    d[2::10] = 0.0
    d[4::10, 1] = np.inf
    d[6::10, 2] = -3.1e38
    return nt.make_rays(torch.from_numpy(org), torch.from_numpy(d))


def _build(v, f, leaf, width, woop=False):
    bvh, _ = nt.build_triangle_bvh(TriangleMesh(v, f), nt.BVHBuildOptions(
        min_leaf_primitives=leaf, max_leaf_primitives=leaf))
    return collapse_bvh8(bvh, v, f, width=width, woop=woop)


@pytest.fixture(scope="module")
def scenes():
    vb, fb = merge_meshes(make_cornell_box(2.0), make_uv_sphere(16, 32, 0.5))
    vs, fs, so, sd = overlap_soup(400, 600)
    out = {}
    for w in (8, 16):
        for woop in (False, True):
            out["box", w, woop] = _build(vb, fb, 9, w, woop)
            out["soup", w, woop] = _build(vs, fs, 1, w, woop)
    out["box_rays"] = _rays(1500, 5)
    out["soup_rays"] = nt.make_rays(torch.from_numpy(so), torch.from_numpy(sd))
    return out


FAST = nt.BVHTraceOptions(exact_edge_fallback=False)
MODES = {
    "closest": {}, "any_hit": dict(occlusion=True),
    "cull": dict(options=nt.BVHTraceOptions(cull_back_face=True)),
    "range": dict(options=nt.BVHTraceOptions(prim_ids_range=(100, 900))),
    "no_exact": dict(options=FAST),
    "woop": dict(intersector="woop"),
    "woop_any_hit": dict(intersector="woop", occlusion=True),
    "counts": dict(debug_counts=True),
    "counts_any_hit": dict(debug_counts=True, occlusion=True),
    "flags": dict(options=FAST, _flag_zero_edges=True),
    "interleave2": dict(interleave=2),
    "interleave4_woop": dict(interleave=4, intersector="woop"),
}


@pytest.mark.parametrize("kind", ["box", "soup"])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("width", [8, 16])
def test_emulated_kernel_matches_plain(lib, scenes, width, mode, kind):
    kw = MODES[mode]
    scene = scenes[kind, width, "intersector" in kw]
    rays = scenes[f"{kind}_rays"]
    got, err = _emulate(lib, scene, rays, **kw)
    assert err == 0
    for a, b in zip(got, _plain(scene, rays, **kw)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("intersector", ["watertight", "woop"])
def test_emulated_kernel_skip_matches_plain(lib, scenes, intersector):
    scene = scenes["box", 16, intersector == "woop"]
    rays = scenes["box_rays"]
    skip = packet.traverse_bvh8(scene, rays).prim_id
    got, _ = _emulate(lib, scene, rays, skip_prim_id=skip,
                      intersector=intersector)
    for a, b in zip(got, _plain(scene, rays, skip_prim_id=skip,
                                intersector=intersector)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("occlusion", [False, True])
def test_emulated_kernel_zero_edge_flags_match_plain(lib, occlusion):
    v, f, org, d = zero_edge_rays(512)
    scene = _build(v, f, 2, 8)
    rays = nt.make_rays(torch.from_numpy(org), torch.from_numpy(d))
    kw = dict(options=FAST, _flag_zero_edges=True, occlusion=occlusion)
    got, _ = _emulate(lib, scene, rays, **kw)
    want = _plain(scene, rays, **kw)
    assert int(want[4].sum()) > 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("extra", [{}, dict(debug_counts=True),
                                   dict(interleave=2)])
@pytest.mark.parametrize("sub", [1, 3])
def test_emulated_kernel_roots_match_plain(lib, scenes, sub, extra):
    tl, scene = treelet.make_treelets(scenes["box", 8, False], 24)
    rays = scenes["box_rays"]
    n_pk = -(-rays.org.shape[0] // (sub * packet.LANES))
    roots = torch.from_numpy(tl.roots[np.random.default_rng(2).integers(
        0, tl.count, n_pk)])
    kw = dict(sub=sub, packet_roots=roots, **extra)
    got, _ = _emulate(lib, scene, rays, **kw)
    for a, b in zip(got, _plain(scene, rays, **kw)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("width", [8, 16])
def test_emulated_kernel_sets_the_overflow_word(lib, scenes, width):
    # the plain version raises where the kernel sets its error word: the
    # pushes of a node would pass stack_size
    scene = scenes["soup", width, False]
    rays = scenes["soup_rays"]
    _, err = _emulate(lib, scene, rays, slots=3)
    assert err == 1
    with pytest.raises(RuntimeError, match="stack overflow"):
        packet._traverse_reference(
            torch.as_tensor(scene.nodes), torch.as_tensor(scene.leafs), width,
            rays.org, rays.dir, rays.min_t, rays.max_t, None, None, False,
            True, False, 3)
