"""PyTorch port, K5's per-warp schedule on the CPU: the source of the CUDA
kernel (nanort_tpu_torch/csrc/ao_fused.cu) compiled with g++ against a
small mock of the CUDA API (``testing.build_with_cuda_mock``), its
per-lane functions (``tile_primary``, ``tile_compact``, ``tile_items``,
``tile_item``, ``tile_finish``) run for a set of warps in turns, as the
kernel's loop runs them, with 32-pixel tiles claimed in a shuffled order
and the lanes of each step taken in a shuffled order, and held to the
plain version (models/ao_fused.py::_ao_fused_reference) bit for bit.

This reaches the schedule: a tile's primaries one lane each, the pixel's
state in the warp's slot, the hit pixels listed by a ballot and a popc
prefix, their L x S occlusion samples taken sample-major by the 32 lanes
in steps, each unoccluded sample counted in the pixel's integer count,
the tile's outputs written once, a ragged last tile, tiles with no hit
and tiles of hits only. Every output (ao, t, u, v, prim id, hit) must be
equal bit for bit, and the items traced must equal the plain version's
samples of hit pixels (a missed pixel traces none). The warp-level claim
(one atomicAdd by lane 0) needs the card and is held there by
test_torch_gpu.py. g++ builds with -ffp-contract=off and no -ffast-math,
as nvcc builds with --fmad=false.
"""

import ctypes

import numpy as np
import pytest
import torch

import nanort_tpu_torch as nt
from nanort_tpu_torch.build.bvh8 import collapse_bvh8
from nanort_tpu_torch.io.procedural import (
    make_cornell_box, make_quad, make_uv_sphere, merge_meshes)
from nanort_tpu_torch.models import ao_fused, objrender
from nanort_tpu_torch.models.cameras import look_at, pinhole_rays
from nanort_tpu_torch.testing import build_with_cuda_mock
from nanort_tpu_torch.traverse import fused_trace

torch.set_num_threads(1)

# appended to the kernel source: ``warps`` warps stepped in turns, one
# stage of the kernel's tile loop a turn (claim, the 32 primaries and the
# ballot, the compaction, one step of 32 items, the outputs); claim c
# takes the tile order[c]; each stage runs its lanes in a shuffled order
HARNESS = r"""
#include <vector>
uint3 threadIdx, blockIdx;
extern "C" void emulate_k5(
    const float* nodes, const float* leafs, const float* aux,
    const float* org, const float* dir, const float* tmin, const float* tmax,
    const float* draws, float* ao, float* t, float* u, float* v, int* pid,
    int* hit, int* err, long long n, int n_samples, float ao_radius,
    float inv_s, int stack_size, int warps, const long long* order,
    unsigned seed, unsigned long long* items) {
  const Params p{nodes, leafs, aux,  org, dir, tmin, tmax, draws,
                 ao,    t,     u,    v,   pid, hit,  err,  nullptr,
                 n,     n_samples, ao_radius, inv_s, stack_size};
  struct Warp {
    Slot s;
    long long base = 0;
    int stage = 0, L = 0, step = 0;
    unsigned hits = 0;
    bool hit[32] = {};
    bool done = false;
  };
  std::vector<Warp> ws(warps);
  const long long tiles = (n + 31) / 32;
  long long next = 0;
  int lanes[32];
  for (int k = 0; k < 32; ++k) lanes[k] = k;
  auto shuffle = [&]() {
    for (int k = 31; k > 0; --k) {
      seed = seed * 1664525u + 1013904223u;
      const int r = (int)((seed >> 8) % (unsigned)(k + 1));
      const int x = lanes[k];
      lanes[k] = lanes[r];
      lanes[r] = x;
    }
  };
  for (bool any = true; any;) {
    any = false;
    for (Warp& w : ws) {
      if (w.done) continue;
      any = true;
      shuffle();
      switch (w.stage) {
        case 0:  // the claim
          if (next >= tiles) {
            w.done = true;
          } else {
            w.base = 32 * order[next++];
            w.stage = 1;
          }
          break;
        case 1:  // primaries, then the ballot
          w.hits = 0u;
          for (int lane : lanes) {
            w.hit[lane] = tile_primary(p, w.s, w.base, lane);
            w.hits |= (unsigned)w.hit[lane] << lane;
          }
          w.stage = 2;
          break;
        case 2:
          for (int lane : lanes) w.L = tile_compact(w.s, w.hits, lane);
          w.step = 0;
          w.stage = 3;
          break;
        case 3: {  // one step of the flat loop over the items
          const int m = tile_items(w.L, n_samples);
          if (32 * w.step >= m) {
            w.stage = 4;
            break;
          }
          for (int lane : lanes) {
            const int j = 32 * w.step + lane;
            if (j < m) {
              tile_item(p, w.s, w.base, w.L, j);
              ++*items;
            }
          }
          ++w.step;
          break;
        }
        default:
          for (int lane : lanes) tile_finish(p, w.s, w.base, lane, w.hit[lane]);
          w.stage = 0;
      }
    }
  }
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    lib = build_with_cuda_mock("ao_fused.cu", HARNESS,
                               tmp_path_factory.mktemp("k5_emulation"))
    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
    lib.emulate_k5.argtypes = ([P] * 15 + [L, I, F, F, I, I, P, ctypes.c_uint,
                                            P])
    lib.emulate_k5.restype = None
    return lib


@pytest.fixture(scope="module")
def scenes():
    """Config A's scene at the graft size (the Cornell box and a 224-tri
    UV sphere, leaf 8, BVH16), the same box closed by a front wall, and
    the open one scaled by 10^4, where the hit point's 1e-4 offset is
    below an ulp and only the skip keeps a sample off its own triangle."""
    box = make_cornell_box(2.0)
    sphere = make_uv_sphere(8, 16, 0.6)
    front = make_quad([-1, -1, 1], [-1, 1, 1], [1, 1, 1], [1, -1, 1])
    out = {}
    for name, parts, scale in (("open", (box, sphere), 1.0),
                               ("closed", (box, sphere, front), 1.0),
                               ("large", (box, sphere), BIG)):
        v, f = merge_meshes(*parts)
        v = (v * np.float32(scale)).astype(np.float32)
        mesh = nt.TriangleMesh(v, f)
        bvh, _ = nt.build_triangle_bvh(mesh, nt.BVHBuildOptions(
            min_leaf_primitives=8, max_leaf_primitives=8))
        s16 = collapse_bvh8(bvh, v, f, width=16).to("cpu")
        out[name] = fused_trace._check_tables(
            s16, ao_fused.build_ao_aux(mesh, s16), torch.device("cpu"))
    return out


def _inputs(eye, center, w, h, S, seed=2):
    rays = pinhole_rays(look_at(eye=eye, center=center, width=w, height=h,
                                fov=45.0, device="cpu"))
    flat = [x.reshape(-1, *x.shape[2:]).contiguous() for x in rays]
    draws = objrender.ao_hemisphere_draws(
        torch.Generator().manual_seed(seed), S, (h, w))
    return flat, draws.reshape(S, w * h, 3).contiguous()


def _emulate(lib, tables, flat, draws, radius, warps, order, seed=1):
    nodes, leafs, aux, slots = tables
    n, S = flat[0].shape[0], draws.shape[0]
    ao, t, u, v = (torch.full((n,), float("nan")) for _ in range(4))
    pid, hit = (torch.full((n,), -7, dtype=torch.int32) for _ in range(2))
    err = torch.zeros(1, dtype=torch.int32)
    items = np.zeros(1, np.uint64)
    order = np.ascontiguousarray(order, np.int64)

    def ptr(x):
        return ctypes.c_void_p(x.data_ptr() if hasattr(x, "data_ptr")
                               else x.ctypes.data)

    lib.emulate_k5(*(ptr(x) for x in (nodes, leafs, aux, *flat, draws, ao, t,
                                      u, v, pid, hit, err)),
                   n, S, float(np.float32(radius)),
                   float(np.float32(1.0) / np.float32(S)), slots, warps,
                   ptr(order), seed, ptr(items))
    assert int(err[0]) == 0
    return (ao, t, u, v, pid, hit != 0), int(items[0])


def _order(n, how):
    tiles = -(-n // 32)
    return {"order": np.arange(tiles), "reversed": np.arange(tiles)[::-1],
            "shuffled": np.random.default_rng(tiles).permutation(tiles)}[how]


EYE = (0.31, 0.17, 5.0)
INSIDE = (0.0, 0.0, 0.9)  # inside the box, outside the sphere
BIG = 1e4

# name: (scene, eye, (w, h), S, ao_radius, warps, tile order); the first
# holds tiles with no hit, tiles of both hits and misses, and a ragged
# last tile (851 = 26 x 32 + 19 pixels); all_hit's tiles hold hits only
CASES = {
    "config_s8": ("open", EYE, (37, 23), 8, 1e30, 3, "shuffled"),
    "s1": ("open", EYE, (37, 23), 1, 1e30, 3, "shuffled"),
    "small_radius": ("open", EYE, (37, 23), 8, 0.05, 3, "shuffled"),
    "one_warp": ("open", EYE, (20, 13), 8, 1e30, 1, "order"),
    "n7": ("open", EYE, (7, 1), 8, 1e30, 3, "order"),
    "all_miss": ("open", (0.0, 0.0, -5.0), (19, 7), 8, 1e30, 2, "shuffled"),
    "all_hit": ("open", INSIDE, (23, 11), 8, 1e30, 3, "reversed"),
    "all_occluded": ("closed", INSIDE, (23, 11), 4, 1e30, 3, "shuffled"),
    "large": ("large", tuple(BIG * c for c in EYE), (37, 23), 4, 1e30, 3,
              "shuffled"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_emulated_k5_matches_plain(lib, scenes, case, monkeypatch):
    scene, eye, (w, h), S, radius, warps, how = CASES[case]
    tables = scenes[scene]
    # all_miss looks away from the box: from z = -5 towards -z
    center = (0.0, 0.0, -10.0) if case == "all_miss" else (0.0, 0.0, 0.0)
    flat, draws = _inputs(eye, center, w, h, S)
    n = w * h
    got, items = _emulate(lib, tables, flat, draws, radius, warps,
                          _order(n, how))
    stats = {}
    want = ao_fused._ao_fused_reference(*tables[:3], *flat, draws, radius,
                                        tables[3], stats=stats)
    for name, a, b in zip(("ao", "t", "u", "v", "prim_id", "hit"), got, want):
        assert torch.equal(a, b.to(a.dtype)), name
    hit = want[5]
    assert items == stats["samples"] == S * int(hit.sum())
    per_tile = torch.nn.functional.pad(hit, (0, -n % 32)).reshape(-1, 32)
    per_tile = per_tile.sum(1)
    if case == "config_s8":
        assert n % 32 and bool((per_tile == 0).any())
        assert bool(((per_tile > 0) & (per_tile < 32)).any())
        assert 0.0 < float(want[0][hit].mean()) < 1.0
    if case == "small_radius":
        assert float(want[0][hit].mean()) > 0.5
    if case == "all_miss":
        assert items == 0 and not bool(hit.any())
    if case in ("all_hit", "all_occluded"):
        assert bool(hit.all())
    if case == "all_occluded":
        assert not bool(want[0].any())
    if case == "large":
        # the skip decides: without it, samples find their own prim
        real = fused_trace.trace_bvh16_reference
        monkeypatch.setattr(fused_trace, "trace_bvh16_reference",
                            lambda *a, skip=None, **k: real(*a, **k))
        selfish = ao_fused._ao_fused_reference(
            *tables[:3], *flat, draws, radius, tables[3])[0]
        assert float(selfish[hit].mean()) < float(want[0][hit].mean())


def test_emulated_k5_claim_order_changes_no_bit(lib, scenes):
    """The same pixels through 1, 2 and 5 warps, tiles in order and
    shuffled, lanes in three shuffles: one set of outputs, bit for bit."""
    flat, draws = _inputs(EYE, (0.0, 0.0, 0.0), 30, 17, 5)
    n = 30 * 17
    runs = [_emulate(lib, scenes["open"], flat, draws, 1e30, warps,
                     order, seed)
            for warps, seed in ((1, 3), (2, 5), (5, 7))
            for order in (_order(n, "order"), _order(n, "shuffled"))]
    for outs, items in runs[1:]:
        assert items == runs[0][1]
        for a, b in zip(outs, runs[0][0]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("n,bps,sms,grid", [
    (1, 5, 132, 1), (128, 5, 132, 1), (129, 5, 132, 2), (4096, 5, 132, 32),
    (262_144, 5, 132, 660), (262_144, 8, 132, 1056), (1 << 40, 1, 1, 1)])
def test_ao_grid(n, bps, sms, grid):
    # the resident blocks, or one tile a warp for a smaller batch
    assert ao_fused.ao_grid(n, bps, sms) == grid


def test_ao_grid_refuses_a_kernel_that_does_not_fit():
    with pytest.raises(ValueError, match="does not fit"):
        ao_fused.ao_grid(1000, 0, 132)
