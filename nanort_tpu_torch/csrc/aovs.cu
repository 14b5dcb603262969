// objrender's AOVs for NVIDIA Hopper (sm_90a): rgb, normal, position,
// depth, texcoord and hit of every pixel from its primary-hit record, in
// ONE pass.
//
// Replaces no TPU kernel: the JAX package derives the AOVs in XLA
// (nanort_tpu/models/objrender.py::aovs_from_hits), which fuses them into
// one loop. The port's plain torch version (models/objrender.py::
// _aovs_plain) runs some 25 passes over the batch, each with its
// intermediates in device memory; on the 8192^2 frame they were half the
// frame's time. Each pixel's arithmetic mirrors _aovs_plain op for op:
//   1. hit = prim != 0xFFFFFFFF (the record's miss id); a miss reads no
//      triangle and gets zeros in rgb, normal, position and depth;
//   2. the normal: with facevarying normals (F, 3, 3), w = (1 - u) - v and
//      n = (w n0 + u n1) + v n2 (objrender.shading_normals); else the
//      geometric normal cross(v1 - v0, v2 - v0), each component p - q of
//      two products rounded on their own (core/math.py::cross);
//   3. normalize: len = sqrtf((x x + y y) + z z), IEEE (the plain version
//      takes the root in float64 and rounds once, the same value), and
//      n / len where len > 1e-17f, else n unchanged (core/math.py::
//      normalize, its guard compared in float32);
//   4. rgb = 0.5 n + 0.5, position = o + t d, depth = t; texcoord =
//      (u, v) on every pixel.
// A hit's prim id outside the table it indexes (the facevarying normals'
// rows, else the faces'), or a face's vertex id outside the vertices,
// fails the launch (__trap), as the plain version's gather fails on the
// card (a device-side assert) or on the CPU (IndexError).
// The faces are read as they come, int32 or int64 (a template parameter).
//
// What bounds it on this card: bytes. A pixel reads 44 B (t, u, v, prim
// id, origin, direction) and writes 49 B (three 3-vectors, depth,
// texcoord, hit); its triangle's indices and vertices are mostly cache
// hits, since neighbouring primary rays hit the same triangles. At
// 8192^2 that is 6.2 GB, 1.9 ms at 3.35 TB/s. The design: one thread
// takes 4 consecutive pixels, so that every stream is read and written
// with 16-byte accesses (a 3-vector of 4 pixels is three float4, the
// hits one 32-bit word); no shared memory; one quad a thread. Where a
// pointer is not 16-byte aligned the quads take one pixel at a time
// (aov_pixel, the same arithmetic); the last n % 4 pixels always do.
// Measured on an H100 at 8192^2 and left out: evict-first hints on the
// streams (2% slower), 64 registers (14% slower), blocks of 128 (5%
// slower); one pixel a thread was 3.4 times slower.
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
constexpr long long kMiss = 0xFFFFFFFFll;

struct Params {
  const float* t;          // (n,)
  const float* u;          // (n,)
  const float* v;          // (n,)
  const long long* prim;   // (n,), kMiss on a miss
  const float* org;        // (n, 3)
  const float* dir;        // (n, 3)
  const void* faces;       // (F, 3) int32 or int64
  const float* verts;      // (V, 3)
  const float* fnrm;       // (F, 3, 3) facevarying normals, or null
  float* rgb;              // (n, 3)
  float* nrm;              // (n, 3)
  float* pos;              // (n, 3)
  float* depth;            // (n,)
  float* uv;               // (n, 2)
  unsigned char* hit;      // (n,) bool
  long long n;
  long long rows;          // F: rows of fnrm if given, else of faces
  long long nverts;        // V
};

struct Aov {
  float rgb[3], n[3], p[3], depth;
  bool hit;
};

// i, where 0 <= i < n; else the launch fails.
__device__ __forceinline__ long long checked(long long i, long long n) {
  if (i < 0 || i >= n) __trap();
  return i;
}

// One pixel's AOVs from its record (t, u, v, prim) and ray (o, d).
template <class FaceT>
__device__ __forceinline__ Aov shade(const Params& p, float t, float u,
                                     float v, long long prim, const float* o,
                                     const float* d) {
  Aov a;
  a.hit = prim != kMiss;
  if (!a.hit) {
    for (int c = 0; c < 3; ++c) a.rgb[c] = a.n[c] = a.p[c] = 0.0f;
    a.depth = 0.0f;
    return a;
  }
  checked(prim, p.rows);
  float n[3];
  if (p.fnrm != nullptr) {
    const float* fn = p.fnrm + 9 * prim;
    const float w = (1.0f - u) - v;
    for (int c = 0; c < 3; ++c) {
      n[c] = (w * __ldg(fn + c) + u * __ldg(fn + 3 + c)) +
             v * __ldg(fn + 6 + c);
    }
  } else {
    const FaceT* f = static_cast<const FaceT*>(p.faces) + 3 * prim;
    const float* p0 = p.verts + 3 * checked(__ldg(f), p.nverts);
    const float* p1 = p.verts + 3 * checked(__ldg(f + 1), p.nverts);
    const float* p2 = p.verts + 3 * checked(__ldg(f + 2), p.nverts);
    float e1[3], e2[3];
    for (int c = 0; c < 3; ++c) {
      const float q0 = __ldg(p0 + c);
      e1[c] = __ldg(p1 + c) - q0;
      e2[c] = __ldg(p2 + c) - q0;
    }
    n[0] = e1[1] * e2[2] - e1[2] * e2[1];
    n[1] = e1[2] * e2[0] - e1[0] * e2[2];
    n[2] = e1[0] * e2[1] - e1[1] * e2[0];
  }
  const float len = sqrtf((n[0] * n[0] + n[1] * n[1]) + n[2] * n[2]);
  if (len > 1e-17f) {
    for (int c = 0; c < 3; ++c) n[c] = n[c] / len;
  }
  for (int c = 0; c < 3; ++c) {
    a.n[c] = n[c];
    a.rgb[c] = 0.5f * n[c] + 0.5f;
    a.p[c] = o[c] + t * d[c];
  }
  a.depth = t;
  return a;
}

// Pixel i alone, with 4-byte accesses.
template <class FaceT>
__device__ void aov_pixel(const Params& p, long long i) {
  float o[3], d[3];
  for (int c = 0; c < 3; ++c) {
    o[c] = p.org[3 * i + c];
    d[c] = p.dir[3 * i + c];
  }
  const float u = p.u[i], v = p.v[i];
  const Aov a = shade<FaceT>(p, p.t[i], u, v, p.prim[i], o, d);
  for (int c = 0; c < 3; ++c) {
    p.rgb[3 * i + c] = a.rgb[c];
    p.nrm[3 * i + c] = a.n[c];
    p.pos[3 * i + c] = a.p[c];
  }
  p.depth[i] = a.depth;
  p.uv[2 * i] = u;
  p.uv[2 * i + 1] = v;
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
template <class FaceT>
__device__ void aov_quad(const Params& p, long long q) {
  float t[4], u[4], v[4], o[12], d[12];
  long long prim[4];
  get4(p.t, q, t);
  get4(p.u, q, u);
  get4(p.v, q, v);
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
  float rgb[12], nrm[12], pos[12], depth[4], uv[8];
  unsigned hits = 0;
  for (int k = 0; k < 4; ++k) {
    const Aov a = shade<FaceT>(p, t[k], u[k], v[k], prim[k], o + 3 * k,
                               d + 3 * k);
    for (int c = 0; c < 3; ++c) {
      rgb[3 * k + c] = a.rgb[c];
      nrm[3 * k + c] = a.n[c];
      pos[3 * k + c] = a.p[c];
    }
    depth[k] = a.depth;
    uv[2 * k] = u[k];
    uv[2 * k + 1] = v[k];
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
template <class FaceT>
__global__ void __launch_bounds__(kBlock) aovs_kernel(Params p, int vec) {
  const long long q = (long long)blockIdx.x * kBlock + threadIdx.x;
  const long long quads = p.n / 4;
  if (q < quads) {
    if (vec) {
      aov_quad<FaceT>(p, q);
    } else {
      for (long long i = 4 * q; i < 4 * q + 4; ++i) aov_pixel<FaceT>(p, i);
    }
  } else if (q == quads) {
    for (long long i = 4 * quads; i < p.n; ++i) aov_pixel<FaceT>(p, i);
  }
}

bool aligned(const void* x, uintptr_t to) {
  return reinterpret_cast<uintptr_t>(x) % to == 0;
}

// 1 when every stream takes aov_quad's 16-byte (the hits' 4-byte)
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

template <class FaceT>
int launch(const Params& p, void* stream) {
  const long long blocks = grid_blocks(p.n);
  if (blocks > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  aovs_kernel<FaceT><<<(unsigned)blocks, kBlock, 0,
                       reinterpret_cast<cudaStream_t>(stream)>>>(
      p, quads_aligned(p));
  return (int)cudaGetLastError();
}

}  // namespace

// The AOVs of n pixels; faces of face_bytes 4 (int32) or 8 (int64); fnrm
// null for geometric normals; rows: fnrm's rows if given, else faces';
// nverts: the vertices' rows.
extern "C" int nrt_aovs(const float* t, const float* u, const float* v,
                        const long long* prim, const float* org,
                        const float* dir, const void* faces, int face_bytes,
                        const float* verts, const float* fnrm, float* rgb,
                        float* nrm, float* pos, float* depth, float* uv,
                        unsigned char* hit, long long n, long long rows,
                        long long nverts, void* stream) {
  if (n <= 0) return 0;
  const Params p{t,   u,   v,   prim,  org, dir, faces, verts, fnrm, rgb,
                 nrm, pos, depth, uv, hit, n, rows, nverts};
  if (face_bytes == 4) return launch<int>(p, stream);
  if (face_bytes == 8) return launch<long long>(p, stream);
  return (int)cudaErrorInvalidValue;
}
