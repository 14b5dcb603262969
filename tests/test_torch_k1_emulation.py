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
the counters, the zero-edge flags and per-packet roots on a machine
without a card. K1b's schedule is stepped as its kernel runs it
(``walk_il``): warps in turns, claims taken in a shuffled order through
the kernel's ``claim_ray``, ``claims_of`` and ``lock_vote``, lock-step
claims walked packet after packet, other claims handed to free lanes by
rank (``slot_fill``, ``claim_advance``) 16 at a time, ended walks
written by ``slot_end``, lanes in a shuffled order; each ray's record is
held to the plain version bit for bit at K = 2 and 4: widths 8 and 16,
watertight and Woop, closest and any-hit, roots, camera claims beside
incoherent ones, ray counts below and across a claim, claims of K
packets and of one (as an any-hit launch takes),
dead rays, and the overflow word. The atomicAdd and the ballots need the
card and are held there by test_torch_gpu.py. g++ builds with
-ffp-contract=off and no -ffast-math, as nvcc builds with --fmad=false:
every product rounded on its own, IEEE division.
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
#include <vector>
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
// K1b's schedule: ``warps`` warps of 32 lanes, stepped in turns, one pass
// of the kernel's inner loop a turn (one step of every live walk), with
// the kernel's round (the records of ended walks, then a lock-step
// claim's packets walked one after another when the warp is idle, or
// the free lanes' rays by rank in a ballot) before the first step and
// after each break. The c-th claim taken is claim order[c], so claims
// land on the warps in a shuffled order; the lanes of each round and
// step run in a shuffled order.
template <int W, bool kWoop>
void walk_il(const Params& p, int warps, const long long* order,
             unsigned seed) {
  struct Warp {
    std::vector<Walk> w = std::vector<Walk>(32);
    std::vector<int> ray = std::vector<int>(32, -1);
    std::vector<int> stack = std::vector<int>(32 * kStackCap);
    unsigned q = 0;
    unsigned r = 0;
    bool drained = false, done = false, lock = false, stepping = false;
    bool refill = false;
  };
  const unsigned kRun = claim_rays(p);
  std::vector<Warp> ws(warps);
  for (Warp& wp : ws) {
    for (Walk& x : wp.w) x.e = kNone;
    wp.r = kRun;
  }
  const long long n_claims = (long long)claims_of(p);
  long long next = 0;
  int lanes[32];
  for (int l = 0; l < 32; ++l) lanes[l] = l;
  auto shuffle = [&]() {
    for (int l = 31; l > 0; --l) {
      seed = seed * 1664525u + 1013904223u;
      const int x = (int)((seed >> 8) % (unsigned)(l + 1));
      const int y = lanes[l];
      lanes[l] = lanes[x];
      lanes[x] = y;
    }
  };
  auto claim = [&](Warp& wp) {
    wp.r = 0;
    wp.drained = next >= n_claims;
    if (wp.drained) return;
    wp.q = (unsigned)order[next++];
    bool all = true;
    for (unsigned l = 0; l < 32; ++l) all &= lock_vote(p, wp.q, l);
    wp.lock = all;
  };
  // the kernel's round; false when the warp retires
  auto round = [&](Warp& wp) {
    shuffle();
    bool idle = true;
    for (int l : lanes) {
      wp.ray[l] = slot_end(p, wp.ray[l], wp.w[l]);
      idle &= wp.ray[l] < 0;
    }
    if (idle && !wp.drained && wp.r == kRun) claim(wp);
    if (wp.lock && idle && !wp.drained) {
      // the claim's packets one after another, each lane's ray walked to
      // its end
      for (unsigned k = 0; k < kRun; k += 32u) {
        shuffle();
        for (int l : lanes) {
          wp.ray[l] = slot_fill(p, ~0u, l, wp.q, k, -1, wp.w[l]);
          while (wp.w[l].e != kNone) {
            step<W, kWoop, false, false>(p, wp.w[l],
                                         &wp.stack[l * kStackCap]);
          }
          wp.ray[l] = slot_end(p, wp.ray[l], wp.w[l]);
        }
      }
      wp.r = kRun;
      return true;
    }
    if (!wp.lock) {
      for (;;) {
        unsigned empty = 0u;
        for (int l = 0; l < 32; ++l) empty |= (unsigned)(wp.ray[l] < 0) << l;
        if (wp.drained || __popc(empty) < kRefill) break;
        if (wp.r == kRun) {
          claim(wp);
          if (wp.drained || wp.lock) break;
        }
        shuffle();
        for (int l : lanes) {
          wp.ray[l] = slot_fill(p, empty, l, wp.q, wp.r, wp.ray[l],
                                wp.w[l]);
        }
        wp.r = claim_advance(wp.r, empty, kRun);
      }
    }
    bool live = false;
    for (int x : wp.ray) live |= x >= 0;
    if (!live) return !wp.drained;
    wp.stepping = true;
    wp.refill = !wp.lock && !wp.drained;
    return true;
  };
  for (bool any = true; any;) {
    any = false;
    for (Warp& wp : ws) {
      if (wp.done) continue;
      any = true;
      if (!wp.stepping) {
        if (!round(wp)) wp.done = true;
        continue;
      }
      shuffle();
      int ended = 0;
      for (int l : lanes) {
        if (wp.w[l].e != kNone) {
          step<W, kWoop, false, false>(p, wp.w[l], &wp.stack[l * kStackCap]);
        }
        ended += wp.w[l].e == kNone;
      }
      if (ended == 32 || (wp.refill && ended >= kRefill)) wp.stepping = false;
    }
  }
}
template <int W, bool kWoop>
void pick(const Params& p, int counts, int flags, int il, int warps,
          const long long* order, unsigned seed) {
  if (il > 1) return walk_il<W, kWoop>(p, warps, order, seed);
  if (counts) return walk_all<W, kWoop, true, false, true>(p);
  if (flags) return walk_all<W, false, false, true, true>(p);
  if (p.roots) return walk_all<W, kWoop, false, false, true>(p);
  walk_all<W, kWoop, false, false, false>(p);
}
}  // namespace

// The rays of K1b's claims for a batch of n_rays: claim q's r-th ray at
// out[q * claim_rays + r]. Returns claims_of, or -1 when cap is short.
extern "C" long long claim_map(long long n_rays, int packets,
                               unsigned long long* out, long long cap) {
  Params p{};
  p.n_rays = n_rays;
  p.packets = packets;
  const unsigned long long claims = claims_of(p);
  const unsigned run = claim_rays(p);
  if ((long long)(claims * run) > cap) return -1;
  for (unsigned long long q = 0; q < claims; ++q) {
    for (unsigned r = 0; r < run; ++r) out[q * run + r] = claim_ray(p, q, r);
  }
  return (long long)claims;
}

extern "C" void emulate_k1(
    const float* nodes, const float* leafs, const float* org, const float* dir,
    const float* min_t, const float* max_t, const int* skip, const int* roots,
    float* t_out, float* u_out, float* v_out, long long* pid_out, int* flags,
    unsigned long long* scratch, long long n_rays, long long packet,
    int width, int stack_size, int occlusion, int cull_back_face,
    int exact_edge, int use_range, int range_lo, int range_hi, int woop,
    int counts, int zero_flags, int interleave, int warps,
    const long long* order, unsigned seed, int packets) {
  const Params p{nodes, leafs, org, dir, min_t, max_t, skip, roots, t_out,
                 u_out, v_out, pid_out, flags, scratch, scratch + 1, n_rays,
                 packet, stack_size, occlusion, cull_back_face, exact_edge,
                 use_range, range_lo, range_hi, packets};
  if (width == 16) {
    woop ? pick<16, true>(p, counts, zero_flags, interleave, warps, order, seed)
         : pick<16, false>(p, counts, zero_flags, interleave, warps, order,
                           seed);
  } else {
    woop ? pick<8, true>(p, counts, zero_flags, interleave, warps, order, seed)
         : pick<8, false>(p, counts, zero_flags, interleave, warps, order,
                          seed);
  }
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    lib = build_with_cuda_mock("packet_traverse.cu", HARNESS,
                               tmp_path_factory.mktemp("k1_emulation"))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.emulate_k1.argtypes = ([P] * 14 + [L] * 2 + [I] * 13
                               + [P, ctypes.c_uint, I])
    lib.emulate_k1.restype = None
    lib.claim_map.argtypes = [L, I, P, L]
    lib.claim_map.restype = L
    return lib


def _emulate(lib, scene, rays, options=nt.BVHTraceOptions(),
             skip_prim_id=None, occlusion=False, intersector="watertight",
             sub=32, packet_roots=None, debug_counts=False, interleave=1,
             _flag_zero_edges=False, slots=None, warps=3, claims_seed=0,
             spread=0):
    """The emulated kernel with traverse_bvh8's arguments: its records
    (and flags) and the overflow word. K1b runs ``warps`` warps, its
    claims (of ``interleave`` packets of 32 rays, or of one with
    ``spread``) in an order shuffled by ``claims_seed``."""
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
    packets = 1 if spread else interleave
    order = np.random.default_rng(claims_seed).permutation(
        max(1, packet.k1b_claims(n, packets))).astype(np.int64)

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
        int(_flag_zero_edges), interleave, warps,
        ctypes.c_void_p(order.ctypes.data), claims_seed + 1, packets)
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


# ------------------------------ K1b: claims of 32 K rays, idle lanes refilled

@pytest.mark.parametrize("spread", [0, 1])
@pytest.mark.parametrize("n", [1, 31, 32, 33, 517, 1000, 4096])
@pytest.mark.parametrize("K", [2, 4])
def test_il_claims_tile_the_batch(lib, K, n, spread):
    # the kernel's claims_of, claim_rays and claim_ray: claims of P packets
    # of 32 consecutive rays (P = K, or 1 as on any-hit), packet k of a
    # claim 128 rays after packet k - 1, every ray of the batch in exactly
    # one claim, and rays past it only in the last four claims
    P = 1 if spread else K
    claims = packet.k1b_claims(n, P)
    out = np.empty(claims * 32 * P, np.uint64)
    assert lib.claim_map(n, P, out.ctypes.data, out.size) == claims
    m = out.astype(np.int64).reshape(claims, P, 32)
    assert (np.diff(m, axis=2) == 1).all()
    assert (np.diff(m[:, :, 0], axis=1) == 128).all()
    assert np.array_equal(np.sort(m[m < n]), np.arange(n))
    assert (m[:max(0, claims - 4)] < n).all()
    if spread:
        assert np.array_equal(m[:, 0, 0], 32 * np.arange(claims))


def _held(lib, scene, rays, **kw):
    got, err = _emulate(lib, scene, rays, **kw)
    kw = {k: v for k, v in kw.items()
          if k not in ("warps", "claims_seed", "slots", "spread")}
    for a, b in zip(got, _plain(scene, rays, **kw)):
        assert torch.equal(a, b)
    return err


@pytest.mark.parametrize("spread", [0, 1])
@pytest.mark.parametrize("occlusion", [False, True])
@pytest.mark.parametrize("intersector", ["watertight", "woop"])
@pytest.mark.parametrize("kind", ["box", "soup"])
@pytest.mark.parametrize("width", [8, 16])
@pytest.mark.parametrize("K", [2, 4])
def test_emulated_il_schedule_matches_plain(lib, scenes, K, width, kind,
                                            intersector, occlusion, spread):
    # 1500 rays (box) or 600 (soup) over 3 warps: many claims a warp, a
    # ragged last claim, refills of slots whose walks end at different
    # steps (closest hit) or lock-step claims (any-hit); the soup's walks
    # leave entries on many levels
    scene = scenes[kind, width, intersector == "woop"]
    assert _held(lib, scene, scenes[f"{kind}_rays"], interleave=K,
                 intersector=intersector, occlusion=occlusion,
                 claims_seed=K * width, spread=spread) == 0


def _camera_and_scatter(n_cam, n_rand, seed):
    """``n_cam`` rays from one eye (a camera's: lock-step claims), then
    ``n_rand`` incoherent ones (refilled claims), as phase 5's batch."""
    rng = np.random.default_rng(seed)
    side = int(np.ceil(np.sqrt(n_cam)))
    a, b = np.meshgrid(np.linspace(-0.6, 0.6, side),
                       np.linspace(-0.6, 0.6, side))
    d = np.stack([a.ravel(), b.ravel(), -np.ones(side * side)], 1)[:n_cam]
    org = np.tile([0.1, -0.2, 3.0], (n_cam, 1))
    org = np.concatenate([org, rng.uniform(-3, 3, (n_rand, 3))])
    d = np.concatenate([d, rng.normal(size=(n_rand, 3))])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return nt.make_rays(torch.from_numpy(org.astype(np.float32)),
                        torch.from_numpy(d.astype(np.float32)))


@pytest.mark.parametrize("spread", [0, 1])
@pytest.mark.parametrize("n_cam", [512, 700, 1000])
@pytest.mark.parametrize("K", [2, 4])
def test_emulated_il_camera_claims_match_plain(lib, scenes, K, n_cam, spread):
    # claims whose rays share one origin walk in lock-step, the others
    # refill; a claim may hold both (n_cam not a multiple of 128 K)
    rays = _camera_and_scatter(n_cam, 900, n_cam)
    for width in (8, 16):
        _held(lib, scenes["box", width, False], rays, interleave=K,
              spread=spread, claims_seed=n_cam + K)


@pytest.mark.parametrize("n", [1, 5, 31, 33, 64 + 5, 128 + 5, 1000])
@pytest.mark.parametrize("warps", [1, 2, 7])
@pytest.mark.parametrize("K", [2, 4])
def test_emulated_il_ray_counts_match_plain(lib, scenes, K, warps, n):
    # n < 32, n not a multiple of 32 K, more warps than claims
    rays = nt.Rays(*(x[:n].contiguous() for x in scenes["box_rays"]))
    _held(lib, scenes["box", 16, False], rays, interleave=K, warps=warps,
          claims_seed=n)


@pytest.mark.parametrize("case", ["all_dead", "dead_tail", "dead_every_3rd"])
@pytest.mark.parametrize("K", [2, 4])
def test_emulated_il_dead_rays_match_plain(lib, scenes, K, case):
    # rays that retire before their first node are written at refill and
    # free their lane at once (ray_sort puts them last)
    rays = scenes["box_rays"]
    n = rays.org.shape[0]
    dead = torch.ones(n, dtype=torch.bool)
    if case == "dead_tail":
        dead[:900] = False
    elif case == "dead_every_3rd":
        dead = torch.arange(n) % 3 == 0
    rays = rays._replace(max_t=torch.where(dead, -1.0, rays.max_t))
    for occlusion in (False, True):
        _held(lib, scenes["box", 8, False], rays, interleave=K,
              occlusion=occlusion)


@pytest.mark.parametrize("sub", [1, 3])
@pytest.mark.parametrize("K", [2, 4])
def test_emulated_il_roots_across_claims_match_plain(lib, scenes, K, sub):
    # packets of 128 or 384 rays span several claims of 32 K rays
    tl, scene = treelet.make_treelets(scenes["box", 8, False], 24)
    rays = scenes["box_rays"]
    n_pk = -(-rays.org.shape[0] // (sub * packet.LANES))
    roots = torch.from_numpy(tl.roots[np.random.default_rng(3).integers(
        0, tl.count, n_pk)])
    for occlusion in (False, True):
        _held(lib, scene, rays, interleave=K, sub=sub, packet_roots=roots,
              occlusion=occlusion, warps=2)


@pytest.mark.parametrize("K", [2, 4])
@pytest.mark.parametrize("width", [8, 16])
def test_emulated_il_sets_the_overflow_word(lib, scenes, K, width):
    # a stack too small for the walks: the lane's walk stops, the lane
    # takes the next ray, and the launch's error word is set
    _, err = _emulate(lib, scenes["soup", width, False], scenes["soup_rays"],
                      interleave=K, slots=3)
    assert err == 1
