"""PyTorch port, K3's per-lane loop on the CPU: the source of the CUDA
kernel (nanort_tpu_torch/csrc/pt_fused.cu) compiled with g++ against a
small mock of the CUDA API (``testing.build_with_cuda_mock``), its
per-lane functions (``brute_load_rows``, ``brute_take``,
``brute_advance``, ``brute_bounce``) run for a set of lanes in turns, as
the kernel's loop runs a warp's lanes, with pixels claimed in a shuffled
order, and held to the plain version
(models/pt_fused.py::_render_fused_reference) bit for bit with
``trig="poly"``.

This reaches the flat (sample, bounce) loop: roulette before each bounce,
a path ended as soon as roulette, a miss, an emitter pick or absorption
kills it or after max_bounces, its radiance added to the pixel's sum in
sample order, the next sample started at bounce 0, the pixel written
once and the next one claimed; the float4 triangle rows, the sweeps,
face-varying normals, NEE with and without lights, azimuth strata. The
kernel's sweep counts must equal the live sweeps the plain version
runs. The warp-aggregated claim needs the card and is held there by
test_torch_gpu.py. g++ builds with -ffp-contract=off and no -ffast-math,
as nvcc builds with --fmad=false.
"""

import ctypes

import numpy as np
import pytest
import torch

from nanort_tpu_torch.io.procedural import make_cornell_pt_scene
from nanort_tpu_torch.models import path_tracer, pt_fused
from nanort_tpu_torch.models.cameras import look_at, pinhole_rays
from nanort_tpu_torch.testing import build_with_cuda_mock

torch.set_num_threads(1)

# appended to the kernel source: ``lanes`` lanes stepped in turns as the
# kernel steps a warp's lanes (the lanes without a live bounce claim
# pixels in the order ``order`` gives, then every lane with one runs it);
# stats: closest-hit sweeps, shadow sweeps, and the paths that ended
# after roulette killed them, at their first bounce's shading, and after
# max_bounces bounces
HARNESS = r"""
#include <vector>
uint3 threadIdx, blockIdx;
extern "C" void emulate_k3(
    const float* tri, int F, const float* face, int C, const float* light,
    int n_lights, float inv_lights, const float* org, const float* dir,
    float* out, long long n, int seed, int spp, int max_bounces,
    int rr_start, int trig, int az_strata, int lanes,
    const long long* order, unsigned long long* stats) {
  const BruteParams p{tri, F, face, C, Lights{light, n_lights, inv_lights},
                      org, dir, out, nullptr, n,
                      Loop{(uint32_t)seed, spp, max_bounces, rr_start, trig,
                           az_strata, 1}};
  static float4 rows[kMaxTris * 3];
  for (unsigned t = 0; t < (unsigned)kBlock; ++t) {
    threadIdx.x = t;
    brute_load_rows(p, rows);
  }
  long long next = 0;
  std::vector<BruteLane> ls(lanes);
  std::vector<char> live(lanes, 0), done(lanes, 0);
  for (BruteLane& l : ls) l.closest = l.shadows = 0u;
  for (;;) {
    // the lanes without a live bounce take pixels, in lane order, until
    // they hold one or none is left
    for (bool asked = true; asked;) {
      asked = false;
      for (int k = 0; k < lanes; ++k) {
        if (live[k] || done[k]) continue;
        asked = true;
        const long long pix = next < n ? order[next++] : n;
        if (pix >= n) {
          done[k] = 1;
        } else {
          brute_take(p, ls[k], pix);
          live[k] = brute_advance(p, ls[k]);
        }
      }
    }
    bool any = false;
    for (int k = 0; k < lanes; ++k) {
      if (!live[k]) continue;
      any = true;
      BruteLane& l = ls[k];
      const int s = l.s, b = l.b;
      brute_bounce(p, rows, l);
      const bool alive = l.st.alive;
      live[k] = brute_advance(p, l);
      if (live[k] && l.s == s) continue;
      if (!alive) {
        stats[3] += b == 0;
      } else if (b + 1 == max_bounces) {
        stats[4] += 1;
      } else {
        stats[2] += 1;
      }
    }
    if (!any) break;
  }
  for (const BruteLane& l : ls) {
    stats[0] += l.closest;
    stats[1] += l.shadows;
  }
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    lib = build_with_cuda_mock("pt_fused.cu", HARNESS,
                               tmp_path_factory.mktemp("k3_emulation"))
    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
    lib.emulate_k3.argtypes = ([P, I, P, I, P, I, F, P, P, P, L] + [I] * 7
                               + [P, P])
    lib.emulate_k3.restype = None
    return lib


@pytest.fixture(scope="module")
def cornell():
    scene = path_tracer.make_pt_scene(*make_cornell_pt_scene(2.0),
                                      device="cpu")
    tri, face, light = pt_fused.build_fused_tables(scene)
    return tri, face, light


def _tables(cornell, F, C, lights):
    """(tri (F, 9), face (F, C), light (L, 16)) from the Cornell box's
    32 triangles: F = 1 keeps the floor's first, F = 256 adds 224 seeded
    small triangles inside the box with the box's materials; C = 26 adds
    per-vertex normals tilted off the face normal."""
    tri, face, light = cornell
    if F == 1:
        tri, face = tri[:1], face[:1]
    elif F > tri.shape[0]:
        rng = np.random.default_rng(F)
        k = F - tri.shape[0]
        v0 = rng.uniform(-0.9, 0.9, (k, 3))
        e = rng.uniform(-0.25, 0.25, (k, 6))
        extra = torch.from_numpy(np.concatenate([v0, e], 1).astype(np.float32))
        pick = torch.from_numpy(rng.integers(0, face.shape[0], k))
        tri = torch.cat([tri, extra])
        face = torch.cat([face, face[pick]])
    if C == 26:
        rng = np.random.default_rng(2)
        fvn = face[:, None, 0:3] + torch.from_numpy(
            rng.normal(0, 0.2, (face.shape[0], 3, 3)).astype(np.float32))
        face = torch.cat([face, fvn.reshape(-1, 9)], 1)
    if not lights:
        light = light[:0]
    return tri.contiguous(), face.contiguous(), light.contiguous()


def _rays(w, h):
    # from the config-B eye: the image's edge misses the box
    cam = look_at(eye=(0, 0.0, 5.0), center=(0, 0, 0), width=w, height=h,
                  fov=45.0, device="cpu")
    r = pinhole_rays(cam)
    return (r.org.reshape(-1, 3).contiguous(),
            r.dir.reshape(-1, 3).contiguous())


def _emulate(lib, tri, face, light, org, dirs, seed, spp, max_bounces,
             rr_start, az, lanes, order):
    n = org.shape[0]
    out = torch.full((n, 3), float("nan"))
    stats = np.zeros(5, np.uint64)
    order = np.ascontiguousarray(order, np.int64)

    def ptr(x):
        return ctypes.c_void_p(x.data_ptr() if hasattr(x, "data_ptr")
                               else x.ctypes.data)

    L = light.shape[0]
    lib.emulate_k3(ptr(tri), tri.shape[0], ptr(face), face.shape[1],
                   ptr(light), L, pt_fused._f(1.0 / max(L, 1)), ptr(org),
                   ptr(dirs), ptr(out), n, seed, spp, max_bounces, rr_start,
                   1, az, lanes, ptr(order), ptr(stats))
    return out, dict(zip(("closest", "shadows", "killed", "first", "full"),
                         stats.tolist()))


def _plain(tri, face, light, org, dirs, seed, spp, max_bounces, rr_start,
           az):
    """The plain version's sums, and the sweeps it runs for live rays:
    closest hits with tmax > tmin, and the shadow rays it is asked."""
    count = {"closest": 0, "shadows": 0}
    real = pt_fused._brute_mt

    def counting(t, *c):
        tmin, tmax = c[-2], c[-1]
        if tmin.numel() and float(tmin[0]) == pt_fused._EPS_T:
            count["closest"] += int((tmax > tmin).sum())
        else:
            count["shadows"] += tmin.numel()
        return real(t, *c)

    lights = (light, light.shape[0], pt_fused._f(1.0 / max(light.shape[0], 1)))
    pt_fused._brute_mt = counting
    try:
        sums = pt_fused._render_fused_reference(
            tri, face, lights, org, dirs, seed, spp, max_bounces, rr_start,
            "poly", az)
    finally:
        pt_fused._brute_mt = real
    return sums, count


# name: (F, C, lights, (w, h), spp, max_bounces, rr_start, azimuth
# strata, lanes, claim order); the first holds roulette kills, paths
# ended at their first bounce (escapes) and paths that ran max_bounces
CASES = {
    "cornell": (32, 17, True, (12, 10), 7, 10, 3, 1, 37, "shuffled"),
    "strata4": (32, 17, True, (12, 10), 7, 10, 3, 4, 37, "shuffled"),
    "no_lights": (32, 17, False, (12, 10), 7, 10, 3, 1, 37, "shuffled"),
    "facevarying": (32, 26, True, (12, 10), 5, 8, 3, 2, 37, "shuffled"),
    "one_tri": (1, 17, True, (8, 6), 7, 10, 3, 1, 5, "shuffled"),
    "f256": (256, 17, True, (8, 6), 3, 6, 2, 1, 11, "shuffled"),
    "f256_facevarying": (256, 26, False, (8, 6), 3, 6, 2, 4, 11, "shuffled"),
    "rr_past_max": (32, 17, True, (12, 10), 7, 4, 4, 1, 37, "shuffled"),
    "rr_far_past_max": (32, 17, True, (12, 10), 3, 3, 9, 2, 37, "shuffled"),
    "mb1": (32, 17, True, (12, 10), 7, 1, 3, 1, 37, "shuffled"),
    "spp1": (32, 17, True, (12, 10), 1, 10, 3, 1, 37, "shuffled"),
    "spp1_mb1": (32, 17, True, (12, 10), 1, 1, 3, 1, 37, "shuffled"),
    "mb0": (32, 17, True, (12, 10), 7, 0, 3, 1, 37, "shuffled"),
    "one_lane_in_order": (32, 17, True, (12, 10), 7, 10, 3, 1, 1, "order"),
    "more_lanes_than_pixels": (32, 17, True, (6, 5), 7, 10, 3, 1, 64,
                               "reversed"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_emulated_k3_matches_plain(lib, cornell, case):
    F, C, lights, (w, h), spp, mb, rr, az, lanes, how = CASES[case]
    tri, face, light = _tables(cornell, F, C, lights)
    org, dirs = _rays(w, h)
    n = org.shape[0]
    order = {"order": np.arange(n), "reversed": np.arange(n)[::-1],
             "shuffled": np.random.default_rng(n).permutation(n)}[how]
    seed = 11
    got, stats = _emulate(lib, tri, face, light, org, dirs, seed, spp, mb,
                          rr, az, lanes, order)
    want, count = _plain(tri, face, light, org, dirs, seed, spp, mb, rr, az)
    assert torch.equal(got, want)
    assert bool(torch.isfinite(got).all())
    assert stats["closest"] == count["closest"]
    assert stats["shadows"] == count["shadows"]
    assert stats["closest"] <= n * spp * mb
    if case == "cornell":
        assert stats["killed"] > 0 and stats["first"] > 0 and stats["full"] > 0
        assert float(got.sum()) > 0
    if case.startswith("rr_"):
        assert stats["killed"] == 0 and stats["full"] > 0
    if case == "no_lights":
        assert stats["shadows"] == 0


def test_emulated_k3_claim_order_changes_no_bit(lib, cornell):
    """The same pixels through 1, 7 and 64 lanes, in order and shuffled:
    one image, bit for bit."""
    tri, face, light = _tables(cornell, 32, 17, True)
    org, dirs = _rays(10, 8)
    n = org.shape[0]
    images = [
        _emulate(lib, tri, face, light, org, dirs, 5, 4, 10, 3, 2, lanes,
                 order)[0]
        for lanes in (1, 7, 64)
        for order in (np.arange(n), np.random.default_rng(lanes).permutation(n))
    ]
    for img in images[1:]:
        assert torch.equal(img, images[0])


@pytest.mark.parametrize("n,bps,sms,grid", [
    (1, 6, 132, 1), (128, 6, 132, 1), (129, 6, 132, 2), (4096, 6, 132, 32),
    (262_144, 6, 132, 792), (262_144, 8, 132, 1056), (1 << 40, 1, 1, 1)])
def test_brute_grid(n, bps, sms, grid):
    # the resident blocks, or one lane a pixel for a smaller batch
    assert pt_fused.brute_grid(n, bps, sms) == grid


def test_brute_grid_refuses_a_kernel_that_does_not_fit():
    with pytest.raises(ValueError, match="does not fit"):
        pt_fused.brute_grid(1000, 0, 132)
