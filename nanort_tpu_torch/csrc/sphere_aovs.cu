// The LAS viewer's sphere AOVs for NVIDIA Hopper (sm_90a): rgb, normal,
// position, depth, texcoord and hit of every pixel from its primary-hit
// record over spheres, in ONE pass.
//
// Replaces no TPU kernel: the JAX package derives a sphere hit's UV in
// XLA (nanort_tpu/ops/sphere.py::sphere_post), which fuses it into one
// loop. The port's plain torch version (models/pointcloud.py::
// _sphere_aovs_plain, ops/sphere.py::sphere_surface and sphere_uv) runs
// some 30 passes over the batch, each with its intermediates in device
// memory; on the LiDAR tile's 3840 x 2160 frame, on an H100, they took
// 1.97 ms of 8.3.
// Each pixel's arithmetic mirrors the plain version op for op:
//   1. hit = prim != 0xFFFFFFFF (the record's miss id); a miss reads no
//      sphere, gets zeros in rgb, normal, position and depth, and keeps
//      the record's (u, v) as its texcoord;
//   2. p = o + t d, each product rounded on its own, then the sum;
//      n = p - c, c the centre of the sphere the record names;
//   3. len = sqrtf((x x + y y) + z z), IEEE (the plain version takes the
//      root in float64 and rounds once, the same value); n / max(len,
//      1e-30f), where a NaN length stays NaN as torch.clamp keeps it;
//   4. u = (atan2f(n.x, n.z) + pi_f) (0.5 / pi)_f; v = acosf(clamp(n.y,
//      -1, 1)) (1 / pi_f), which is what ATen computes on the card for a
//      division by the Python scalar math.pi (a product by the float32
//      reciprocal; the CPU divides, so there the two differ in the last
//      ulp);
//   5. rgb = 0.5 n + 0.5, depth = t.
// A hit's prim id outside the centres fails the launch (__trap), as the
// plain version's gather fails on the card (a device-side assert) or on
// the CPU (IndexError).
//
// What bounds it on this card: bytes. A pixel reads 36 B (t, prim id,
// origin, direction), a hit its sphere's centre (12 B, mostly a cache hit:
// neighbouring primary rays hit the same or nearby spheres) and a miss
// its record's u and v (8 B); it writes 49 B (three 3-vectors, depth,
// texcoord, hit). The returned records' u and v are views of texcoord's
// columns and cost nothing more. At 3840 x 2160 that is 0.70-0.87 GB,
// 0.21-0.26 ms at 3.35 TB/s. The design is aovs.cu's, which measured it:
// one thread takes 4 consecutive pixels, so that every stream is read and
// written with 16-byte accesses (a 3-vector of 4 pixels is three float4,
// the hits one 32-bit word); a quad reads its records' u and v only when
// one of its pixels misses; no shared memory; blocks of 256. Where a
// pointer is not 16-byte aligned the quads take one pixel at a time
// (sphere_pixel, the same arithmetic); the last n % 4 pixels always do.
//
// Numerics: compile with --fmad=false, IEEE division and square root, no
// -ftz, as the plain torch version computes every product on its own.
//
// Interface: a plain C function (ctypes, no PyTorch headers); the launch
// runs on the caller's stream, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr long long kMiss = 0xFFFFFFFFll;
constexpr double kPiD = 3.14159265358979323846;  // math.pi
// the Python scalars as ATen hands them to a float32 kernel: rounded once
constexpr float kPi = (float)kPiD;
constexpr float kHalfInvPi = (float)(0.5 / kPiD);
constexpr float kInvPi = 1.0f / kPi;
constexpr float kMinLen = (float)1e-30;

struct Params {
  const float* t;          // (n,)
  const float* u;          // (n,) read on a miss
  const float* v;          // (n,) read on a miss
  const long long* prim;   // (n,), kMiss on a miss
  const float* org;        // (n, 3)
  const float* dir;        // (n, 3)
  const float* centers;    // (N, 3)
  float* rgb;              // (n, 3)
  float* nrm;              // (n, 3)
  float* pos;              // (n, 3)
  float* depth;            // (n,)
  float* uv;               // (n, 2)
  unsigned char* hit;      // (n,) bool
  long long n;
  long long spheres;       // N
};

struct Aov {
  float rgb[3], n[3], p[3], depth, u, v;
  bool hit;
};

// One pixel's AOVs from its record (t, prim) and ray (o, d); on a miss
// the caller fills u and v from the record.
__device__ __forceinline__ Aov shade(const Params& p, float t, long long prim,
                                     const float* o, const float* d) {
  Aov a;
  a.hit = prim != kMiss;
  if (!a.hit) {
    for (int c = 0; c < 3; ++c) a.rgb[c] = a.n[c] = a.p[c] = 0.0f;
    a.depth = a.u = a.v = 0.0f;
    return a;
  }
  if (prim < 0 || prim >= p.spheres) __trap();
  const float* cen = p.centers + 3 * prim;
  float n[3];
  for (int c = 0; c < 3; ++c) {
    a.p[c] = o[c] + t * d[c];
    n[c] = a.p[c] - __ldg(cen + c);
  }
  float len = sqrtf((n[0] * n[0] + n[1] * n[1]) + n[2] * n[2]);
  len = len < kMinLen ? kMinLen : len;
  for (int c = 0; c < 3; ++c) n[c] = n[c] / len;
  a.u = (atan2f(n[0], n[2]) + kPi) * kHalfInvPi;
  const float y = n[1] < -1.0f ? -1.0f : n[1] > 1.0f ? 1.0f : n[1];
  a.v = acosf(y) * kInvPi;
  for (int c = 0; c < 3; ++c) {
    a.n[c] = n[c];
    a.rgb[c] = 0.5f * n[c] + 0.5f;
  }
  a.depth = t;
  return a;
}

// Pixel i alone, with 4-byte accesses.
__device__ void sphere_pixel(const Params& p, long long i) {
  float o[3], d[3];
  for (int c = 0; c < 3; ++c) {
    o[c] = p.org[3 * i + c];
    d[c] = p.dir[3 * i + c];
  }
  Aov a = shade(p, p.t[i], p.prim[i], o, d);
  if (!a.hit) {
    a.u = p.u[i];
    a.v = p.v[i];
  }
  for (int c = 0; c < 3; ++c) {
    p.rgb[3 * i + c] = a.rgb[c];
    p.nrm[3 * i + c] = a.n[c];
    p.pos[3 * i + c] = a.p[c];
  }
  p.depth[i] = a.depth;
  p.uv[2 * i] = a.u;
  p.uv[2 * i + 1] = a.v;
  p.hit[i] = a.hit;
}

__device__ __forceinline__ void get4(const float* src, long long q,
                                     float* dst) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(src) + q);
  dst[0] = x.x;
  dst[1] = x.y;
  dst[2] = x.z;
  dst[3] = x.w;
}

__device__ __forceinline__ void put4(float* dst, long long q,
                                     const float* src) {
  reinterpret_cast<float4*>(dst)[q] =
      make_float4(src[0], src[1], src[2], src[3]);
}

// Pixels 4q .. 4q + 3 with 16-byte accesses (every pointer aligned).
__device__ void sphere_quad(const Params& p, long long q) {
  float t[4], o[12], d[12];
  long long prim[4];
  get4(p.t, q, t);
  const longlong2* pp = reinterpret_cast<const longlong2*>(p.prim) + 2 * q;
  const longlong2 pa = __ldg(pp), pb = __ldg(pp + 1);
  prim[0] = pa.x;
  prim[1] = pa.y;
  prim[2] = pb.x;
  prim[3] = pb.y;
  for (int j = 0; j < 3; ++j) {
    get4(p.org, 3 * q + j, o + 4 * j);
    get4(p.dir, 3 * q + j, d + 4 * j);
  }
  float ru[4] = {0.0f, 0.0f, 0.0f, 0.0f}, rv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (prim[0] == kMiss || prim[1] == kMiss || prim[2] == kMiss ||
      prim[3] == kMiss) {
    get4(p.u, q, ru);
    get4(p.v, q, rv);
  }
  float rgb[12], nrm[12], pos[12], depth[4], uv[8];
  unsigned hits = 0;
  for (int k = 0; k < 4; ++k) {
    const Aov a = shade(p, t[k], prim[k], o + 3 * k, d + 3 * k);
    for (int c = 0; c < 3; ++c) {
      rgb[3 * k + c] = a.rgb[c];
      nrm[3 * k + c] = a.n[c];
      pos[3 * k + c] = a.p[c];
    }
    depth[k] = a.depth;
    uv[2 * k] = a.hit ? a.u : ru[k];
    uv[2 * k + 1] = a.hit ? a.v : rv[k];
    hits |= (unsigned)a.hit << (8 * k);  // little-endian bytes of 4 bools
  }
  for (int j = 0; j < 3; ++j) {
    put4(p.rgb, 3 * q + j, rgb + 4 * j);
    put4(p.nrm, 3 * q + j, nrm + 4 * j);
    put4(p.pos, 3 * q + j, pos + 4 * j);
  }
  put4(p.depth, q, depth);
  put4(p.uv, 2 * q, uv);
  put4(p.uv, 2 * q + 1, uv + 4);
  reinterpret_cast<unsigned*>(p.hit)[q] = hits;
}

// Thread q takes quad q; thread n / 4 takes the last n % 4 pixels.
__global__ void __launch_bounds__(kBlock) sphere_aovs_kernel(Params p,
                                                             int vec) {
  const long long q = (long long)blockIdx.x * kBlock + threadIdx.x;
  const long long quads = p.n / 4;
  if (q < quads) {
    if (vec) {
      sphere_quad(p, q);
    } else {
      for (long long i = 4 * q; i < 4 * q + 4; ++i) sphere_pixel(p, i);
    }
  } else if (q == quads) {
    for (long long i = 4 * quads; i < p.n; ++i) sphere_pixel(p, i);
  }
}

bool aligned(const void* x, uintptr_t to) {
  return reinterpret_cast<uintptr_t>(x) % to == 0;
}

// 1 when every stream takes sphere_quad's 16-byte (the hits' 4-byte)
// accesses, else 0.
int quads_aligned(const Params& p) {
  const void* v16[] = {p.t,   p.u,   p.v,   p.prim,  p.org, p.dir,
                       p.rgb, p.nrm, p.pos, p.depth, p.uv};
  int vec = aligned(p.hit, 4);
  for (const void* x : v16) vec &= aligned(x, 16);
  return vec;
}

long long grid_blocks(long long n) {
  return (n / 4 + 1 + kBlock - 1) / kBlock;
}

}  // namespace

// The sphere AOVs of n pixels over N = spheres centres.
extern "C" int nrt_sphere_aovs(const float* t, const float* u,
                               const float* v, const long long* prim,
                               const float* org, const float* dir,
                               const float* centers, float* rgb, float* nrm,
                               float* pos, float* depth, float* uv,
                               unsigned char* hit, long long n,
                               long long spheres, void* stream) {
  if (n <= 0) return 0;
  const Params p{t,   u,   v,   prim,  org, dir, centers, rgb,
                 nrm, pos, depth, uv, hit, n,   spheres};
  const long long blocks = grid_blocks(n);
  if (blocks > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  sphere_aovs_kernel<<<(unsigned)blocks, kBlock, 0,
                       reinterpret_cast<cudaStream_t>(stream)>>>(
      p, quads_aligned(p));
  return (int)cudaGetLastError();
}
