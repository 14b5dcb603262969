// The perspective camera's ray batch for NVIDIA Hopper (sm_90a): every
// pixel's origin, direction, min_t and max_t of an (H, W) image, in ONE
// pass.
//
// Replaces no TPU kernel: the JAX package makes the batch in XLA
// (nanort_tpu/models/cameras.py::pinhole_rays), which fuses it into one
// loop. The port's plain torch version (models/cameras.py::
// _pinhole_plain) runs some 20 passes over the batch, each with its
// intermediates in device memory; on the 8192^2 frame they were a third
// of the frame's time. Each pixel's arithmetic mirrors _pinhole_plain op
// for op:
//   1. the pixel centre x = i + 0.5, y = (H - 1 - j) + 0.5 for column i
//      and row j (row 0 the top of the image; models/cameras.py::
//      pixel_grid);
//   2. corner = (-w) flen - 0.5 (W u + H v), with flen, W and H rounded
//      to float32 on the host as torch rounds a Python scalar;
//   3. d = (corner + x u) + y v;
//   4. normalize: len = sqrtf((dx dx + dy dy) + dz dz), IEEE (the plain
//      version takes the root in float64 and rounds once, the same
//      value), and d / len where len > 1e-17f, else d unchanged
//      (core/math.py::normalize, its guard compared in float32);
//   5. origin = eye, min_t = 0, max_t = the largest float.
// The basis (eye, u, v, w: 3 floats each) is read from the camera's
// device tensors, so the host neither reads nor waits for it.
//
// What bounds it on this card: bytes written. A pixel reads nothing and
// writes 32 B (origin, direction, min_t, max_t); at 8192^2 that is 2.15
// GB, 0.64 ms at 3.35 TB/s. The design: a thread per quad of 4
// consecutive pixels of the flat batch (a quad may run past the end of a
// row into the next), every store 16 bytes, and every store of a warp
// 512 contiguous bytes: min_t and max_t are one float4 a quad, and a
// warp's 128 origins and directions are 96 float4 each, which its lanes
// store in turn (ray_warp), each lane making the two directions its
// float4 holds components of (6 a lane where its own quad has 4). No
// shared memory. On an H100 at 8192^2 this takes 0.68 ms (95% of the
// bound); a lane storing its own quad's three float4 (48-byte strides
// across the warp) took 1.37 ms. The last warp, if its 32 quads are not
// all whole, and every quad where an output is not 16-byte aligned take
// one pixel at a time (ray_pixel, 4-byte stores, the same bits).
//
// Numerics: compile with --fmad=false, IEEE division and square root, no
// -ftz, as the plain torch version computes every product on its own.
//
// Interface: plain C functions (ctypes, no PyTorch headers); the launch
// runs on the caller's stream, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr float kMaxT = 3.40282347e+38f;  // torch.finfo(torch.float32).max

struct Params {
  const float* eye;  // (3,)
  const float* u;    // (3,) right
  const float* v;    // (3,) up
  const float* w;    // (3,) backward
  float* org;        // (n, 3)
  float* dir;        // (n, 3)
  float* min_t;      // (n,)
  float* max_t;      // (n,)
  long long width, height;
  float flen;        // 0.5 H / tan(fov / 2), rounded to float32
  float fwidth, fheight;  // W and H as float32
};

struct Basis {
  float eye[3], u[3], v[3], corner[3];
};

__device__ __forceinline__ Basis load_basis(const Params& p) {
  Basis b;
  for (int c = 0; c < 3; ++c) {
    b.eye[c] = __ldg(p.eye + c);
    b.u[c] = __ldg(p.u + c);
    b.v[c] = __ldg(p.v + c);
    const float w = __ldg(p.w + c);
    b.corner[c] = -w * p.flen - 0.5f * (p.fwidth * b.u[c] +
                                        p.fheight * b.v[c]);
  }
  return b;
}

// The unit direction through the centre of pixel (i, j).
__device__ __forceinline__ void direction(const Params& p, const Basis& b,
                                          long long i, long long j,
                                          float* d) {
  const float x = (float)i + 0.5f;
  const float y = (float)(p.height - 1 - j) + 0.5f;
  for (int c = 0; c < 3; ++c) d[c] = (b.corner[c] + x * b.u[c]) + y * b.v[c];
  const float len = sqrtf((d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]);
  if (len > 1e-17f) {
    for (int c = 0; c < 3; ++c) d[c] = d[c] / len;
  }
}

// Flat pixel k alone, with 4-byte stores.
__device__ void ray_pixel(const Params& p, const Basis& b, long long k) {
  const long long j = k / p.width;
  float d[3];
  direction(p, b, k - j * p.width, j, d);
  for (int c = 0; c < 3; ++c) {
    p.org[3 * k + c] = b.eye[c];
    p.dir[3 * k + c] = d[c];
  }
  p.min_t[k] = 0.0f;
  p.max_t[k] = kMaxT;
}

__device__ __forceinline__ void put4(float* dst, long long q,
                                     const float* src) {
  reinterpret_cast<float4*>(dst)[q] =
      make_float4(src[0], src[1], src[2], src[3]);
}

// The 128 pixels of the warp whose first quad is q0, lane ``lane`` of
// it: the warp's origins and directions are 96 float4 each, and the lane
// stores the float4s lane, lane + 32 and lane + 64 of both, so that each
// store of the warp writes 512 contiguous bytes. Float4 g of a 3-vector
// stream holds floats 4g .. 4g + 3: from component r = g % 3 of pixel
// 4g / 3 on, into pixel 4g / 3 + 1; the lane makes both pixels'
// directions. min_t and max_t: the lane's own quad.
__device__ void ray_warp(const Params& p, const Basis& b, long long q0,
                         int lane) {
  for (int k = 0; k < 3; ++k) {
    const long long g = 3 * q0 + 32 * k + lane;
    const int r = (int)(g % 3);
    const long long pa = 4 * g / 3;
    long long j = pa / p.width;
    long long i = pa - j * p.width;
    float d[6];
    direction(p, b, i, j, d);
    if (++i == p.width) {
      i = 0;
      ++j;
    }
    direction(p, b, i, j, d + 3);
    const float e[6] = {b.eye[0], b.eye[1], b.eye[2],
                        b.eye[0], b.eye[1], b.eye[2]};
    float o4[4], d4[4];
    for (int c = 0; c < 4; ++c) {
      // r + c < 6: the element of pixel 4g / 3's and the next one's
      // components, taken by a compare a component (no local array)
      const int m = r + c;
      d4[c] = m == 0 ? d[0] : m == 1 ? d[1] : m == 2 ? d[2]
            : m == 3 ? d[3] : m == 4 ? d[4] : d[5];
      o4[c] = m == 0 ? e[0] : m == 1 ? e[1] : m == 2 ? e[2]
            : m == 3 ? e[3] : m == 4 ? e[4] : e[5];
    }
    put4(p.org, g, o4);
    put4(p.dir, g, d4);
  }
  const long long q = q0 + lane;
  reinterpret_cast<float4*>(p.min_t)[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  reinterpret_cast<float4*>(p.max_t)[q] =
      make_float4(kMaxT, kMaxT, kMaxT, kMaxT);
}

// Thread q takes quad q: with its warp's coalesced stores where the
// warp's 32 quads are all whole and every output aligned (ray_warp), else
// one pixel at a time, the last n % 4 pixels by thread n / 4.
__global__ void __launch_bounds__(kBlock) pinhole_kernel(Params p, int vec) {
  const long long n = p.width * p.height;
  const long long q = (long long)blockIdx.x * kBlock + threadIdx.x;
  const int lane = threadIdx.x % 32;
  const Basis b = load_basis(p);
  if (vec && q - lane + 32 <= n / 4) {
    ray_warp(p, b, q - lane, lane);
    return;
  }
  for (long long k = 4 * q; k < 4 * q + 4 && k < n; ++k) ray_pixel(p, b, k);
}

bool aligned(const void* x) {
  return reinterpret_cast<uintptr_t>(x) % 16 == 0;
}

// 1 when every output takes 16-byte stores, else 0.
int quads_aligned(const Params& p) {
  return aligned(p.org) && aligned(p.dir) && aligned(p.min_t) &&
         aligned(p.max_t);
}

long long grid_blocks(long long n) {
  return (n / 4 + 1 + kBlock - 1) / kBlock;
}

}  // namespace

// The rays of a width x height image from the device basis eye, u, v, w;
// flen, fwidth, fheight: the focal length, width and height as float32.
extern "C" int nrt_pinhole(const float* eye, const float* u, const float* v,
                           const float* w, float* org, float* dir,
                           float* min_t, float* max_t, long long width,
                           long long height, float flen, float fwidth,
                           float fheight, void* stream) {
  if (width <= 0 || height <= 0) return 0;
  const Params p{eye,   u,      v,    w,      org,    dir,    min_t,
                 max_t, width, height, flen, fwidth, fheight};
  const long long blocks = grid_blocks(width * height);
  if (blocks > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  pinhole_kernel<<<(unsigned)blocks, kBlock, 0,
                   reinterpret_cast<cudaStream_t>(stream)>>>(
      p, quads_aligned(p));
  return (int)cudaGetLastError();
}
