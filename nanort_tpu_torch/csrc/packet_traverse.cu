// Wide-BVH ray traversal for NVIDIA Hopper (sm_90a): closest-hit or
// any-hit, watertight triangle test with the Dekker exact-edge fallback.
//
// Replaces nanort_tpu/traverse/pallas_packet.py::_kernel_body (the TPU
// kernel behind traverse_bvh8). It computes what that kernel computes per
// ray, over the SAME BVH8/BVH16 node rows and leaf rows that
// build/bvh8.py::collapse_bvh8 emits, but not the way it computes it:
// the TPU kernel walks a (sub, 128) packet through one scalar stack held
// in SMEM, OR-reducing every ray's slab vote into one mask per node. Here
// each thread owns one ray and a short private stack (local memory), so
// no ray ever visits a node that it does not hit itself.
//
// What bounds it on this card: dependent global-memory fetches — a node
// row (512 bytes) must arrive before the next node index is known, and a
// leaf row before its triangles are tested. The 1M-triangle BVH16 tables
// are 97.6 MB (27 MB of node rows, 70 MB of leaf rows), about twice the
// H100's 50 MB L2, so deep fetches pay L2 or HBM latency. The second bound is warp divergence: the 32 rays of a
// warp follow different stack paths and the warp runs their union. The
// design's answer for now is coherence: rays arrive in tile_image_rays
// order, so a warp's 32 rays are neighbouring pixels of one 128x64
// tile, take nearly the same path and share every row fetch. Faster
// schemes (warp-cooperative node tests, treelet scheduling, a persistent
// ray queue) are later work.
//
// Numerics: this file must be compiled with --fmad=false. The leaf test
// evaluates a*b - c*d with every product rounded on its own, as the plain
// torch version (traverse/packet.py::_traverse_reference, built on
// ops/triangle.py) does; an FMA would change U/V/W in the last bit and
// break the Dekker split, which assumes separately rounded products.
// Divisions are IEEE (no -use_fast_math), denormals are kept (no -ftz).
//
// Interface: a plain C function (ctypes, no PyTorch headers) that
// launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kStackCap = 512;     // per-thread stack ceiling (entries)
constexpr int kBlock = 128;        // threads per block, one ray each
constexpr float kBig = 3.0e38f;    // degenerate-ray threshold (TPU kernel)
constexpr float kMaxMult = 1.00000024f;  // 4-ulp exit-plane inflation
constexpr float kSplit = 4097.0f;  // Veltkamp split constant for f32
constexpr long long kInvalidPrim = 0xFFFFFFFFLL;

struct Params {
  const float* nodes;   // (N+1, 128) node rows
  const float* leafs;   // (M, 128) leaf rows
  const float* org;     // (R, 3)
  const float* dir;     // (R, 3)
  const float* min_t;   // (R,)
  const float* max_t;   // (R,)
  const int* skip;      // (R,) per-ray skip prim id, or null
  float* t_out;         // (R,)
  float* u_out;         // (R,)
  float* v_out;         // (R,)
  long long* pid_out;   // (R,) 0xFFFFFFFF on a miss
  int* err;             // (1,) set to 1 when a stack overflows
  long long n_rays;
  int stack_size;       // <= kStackCap
  int occlusion;        // any-hit: stop at the first accepted hit
  int cull_back_face;
  int exact_edge;       // Dekker recompute where an edge function is 0
  int use_range;        // prim_ids_range filter: lo <= pid < hi
  int range_lo;
  int range_hi;
};

__device__ __forceinline__ float sel3(int k, float x, float y, float z) {
  return k == 0 ? x : (k == 1 ? y : z);
}

// copysign(inf, d) for |d| < eps, taking the sign from the sign bit so
// -0.0 maps to -inf (pallas_packet.py:177-183, core/math.py)
__device__ __forceinline__ float safe_inv(float d) {
  if (fabsf(d) < FLT_EPSILON) {
    return __float_as_int(d) < 0 ? -INFINITY : INFINITY;
  }
  return 1.0f / d;
}

// exact a*b = p + err (Dekker); needs separately rounded products
__device__ __forceinline__ void two_prod(float a, float b, float& p,
                                         float& err) {
  p = a * b;
  const float a1 = a * kSplit;
  const float ah = a1 - (a1 - a);
  const float al = a - ah;
  const float b1 = b * kSplit;
  const float bh = b1 - (b1 - b);
  const float bl = b - bh;
  err = ((ah * bh - p) + ah * bl + al * bh) + al * bl;
}

__device__ __forceinline__ float prod_diff(float a, float b, float c,
                                           float d) {
  float p1, e1, p2, e2;
  two_prod(a, b, p1, e1);
  two_prod(c, d, p2, e2);
  return (p1 - p2) + (e1 - e2);
}

struct RayState {
  float ox, oy, oz;     // sanitized origin
  float ix, iy, iz;     // safe inverse direction
  bool nx, ny, nz;      // direction sign (d < 0) for slab planes and order
  int kx, ky, kz;       // watertight shear axes
  float sx, sy, sz;     // shear constants
  float min_t;
};

// Robust slab test of one child box (pallas_packet.py:593-643): planes by
// the ray's sign, 4-ulp inflated exits, NaN-skipping where-folds, so an
// empty slot's inverted EMPTY_BIG box never passes.
__device__ __forceinline__ bool slab(const RayState& r, float t_best,
                                     float b0x, float b0y, float b0z,
                                     float b1x, float b1y, float b1z) {
  const float lox = r.nx ? b1x : b0x;
  const float hix = r.nx ? b0x : b1x;
  const float loy = r.ny ? b1y : b0y;
  const float hiy = r.ny ? b0y : b1y;
  const float loz = r.nz ? b1z : b0z;
  const float hiz = r.nz ? b0z : b1z;
  const float t0x = (lox - r.ox) * r.ix;
  const float t0y = (loy - r.oy) * r.iy;
  const float t0z = (loz - r.oz) * r.iz;
  const float t1x = (hix - r.ox) * r.ix * kMaxMult;
  const float t1y = (hiy - r.oy) * r.iy * kMaxMult;
  const float t1z = (hiz - r.oz) * r.iz * kMaxMult;
  float tmin = r.min_t;
  tmin = t0x > tmin ? t0x : tmin;
  tmin = t0y > tmin ? t0y : tmin;
  tmin = t0z > tmin ? t0z : tmin;
  float tmax = t_best;
  tmax = t1x < tmax ? t1x : tmax;
  tmax = t1y < tmax ? t1y : tmax;
  tmax = t1z < tmax ? t1z : tmax;
  return tmin <= tmax;
}

// Watertight test of one triangle (ops/triangle.py::intersect_triangles,
// same operations in the same order). Returns true on acceptance.
__device__ __forceinline__ bool hit_triangle(const RayState& r,
                                             const float* v, float t_cur,
                                             int cull, int exact, float& tt,
                                             float& uu, float& vv) {
  const float ax3 = __ldg(v + 0) - r.ox, ay3 = __ldg(v + 1) - r.oy,
              az3 = __ldg(v + 2) - r.oz;
  const float bx3 = __ldg(v + 3) - r.ox, by3 = __ldg(v + 4) - r.oy,
              bz3 = __ldg(v + 5) - r.oz;
  const float cx3 = __ldg(v + 6) - r.ox, cy3 = __ldg(v + 7) - r.oy,
              cz3 = __ldg(v + 8) - r.oz;
  const float Az = sel3(r.kz, ax3, ay3, az3);
  const float Bz = sel3(r.kz, bx3, by3, bz3);
  const float Cz = sel3(r.kz, cx3, cy3, cz3);
  const float Ax = sel3(r.kx, ax3, ay3, az3) - r.sx * Az;
  const float Ay = sel3(r.ky, ax3, ay3, az3) - r.sy * Az;
  const float Bx = sel3(r.kx, bx3, by3, bz3) - r.sx * Bz;
  const float By = sel3(r.ky, bx3, by3, bz3) - r.sy * Bz;
  const float Cx = sel3(r.kx, cx3, cy3, cz3) - r.sx * Cz;
  const float Cy = sel3(r.ky, cx3, cy3, cz3) - r.sy * Cz;
  float U = Cx * By - Cy * Bx;
  float V = Ax * Cy - Ay * Cx;
  float W = Bx * Ay - By * Ax;
  if (exact && (U == 0.0f || V == 0.0f || W == 0.0f)) {
    U = prod_diff(Cx, By, Cy, Bx);
    V = prod_diff(Ax, Cy, Ay, Cx);
    W = prod_diff(Bx, Ay, By, Ax);
  }
  const bool any_neg = U < 0.0f || V < 0.0f || W < 0.0f;
  const bool any_pos = U > 0.0f || V > 0.0f || W > 0.0f;
  const bool edge_ok = cull ? !any_neg : !(any_neg && any_pos);
  const float det = U + V + W;
  const bool det_ok = det != 0.0f;
  const float t_num = U * (r.sz * Az) + V * (r.sz * Bz) + W * (r.sz * Cz);
  const float rcp = 1.0f / (det_ok ? det : 1.0f);
  tt = t_num * rcp;
  uu = V * rcp;
  vv = W * rcp;
  return edge_ok && det_ok && tt <= t_cur && tt >= r.min_t;
}

// Node row layouts (build/bvh8.py):
//   W == 16: child w box at lanes [6w, 6w+6), meta at 96+w, leaf count at
//            112+w; the order axis rides the child-0 count as cnt + 16*axis
//   W == 8:  child c box at lanes [8c, 8c+6), meta at 64+c, count at 72+c,
//            order axis at lane 80
// meta >= 0: internal node row; meta < 0: leaf row -(meta + 1).
// Stack entries: node row >= 0, or -1 - (leaf_row << 4 | count) for a leaf.
template <int W>
__global__ void __launch_bounds__(kBlock) traverse_kernel(Params p) {
  const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (i >= p.n_rays) return;

  float ox = p.org[3 * i], oy = p.org[3 * i + 1], oz = p.org[3 * i + 2];
  float dx = p.dir[3 * i], dy = p.dir[3 * i + 1], dz = p.dir[3 * i + 2];
  const float max_t_in = p.max_t[i];
  float min_t = p.min_t[i];
  float t_best = max_t_in;
  // degenerate rays (NaN/inf/huge origin or direction, zero direction)
  // become inert dummies that miss and report t = +inf
  // (pallas_packet.py:138-162)
  const bool ok = fabsf(ox) < kBig && fabsf(oy) < kBig && fabsf(oz) < kBig &&
                  fabsf(dx) < kBig && fabsf(dy) < kBig && fabsf(dz) < kBig &&
                  fabsf(dx) + fabsf(dy) + fabsf(dz) > 0.0f;
  if (!ok) {
    ox = oy = oz = 0.0f;
    dx = 1.0f;
    dy = dz = 0.0f;
    min_t = INFINITY;
    t_best = INFINITY;
  }

  RayState r;
  r.ox = ox; r.oy = oy; r.oz = oz;
  r.ix = safe_inv(dx); r.iy = safe_inv(dy); r.iz = safe_inv(dz);
  r.nx = dx < 0.0f; r.ny = dy < 0.0f; r.nz = dz < 0.0f;
  r.min_t = min_t;
  {
    // strict > chain, first max wins; swap kx/ky when d[kz] < 0
    const float adx = fabsf(dx), ady = fabsf(dy), adz = fabsf(dz);
    int kz = ady > adx ? 1 : 0;
    const float amax = ady > adx ? ady : adx;
    if (adz > amax) kz = 2;
    int kx = (kz + 1) % 3;
    int ky = (kx + 1) % 3;
    const float dkz = sel3(kz, dx, dy, dz);
    if (dkz < 0.0f) {
      const int tmp = kx;
      kx = ky;
      ky = tmp;
    }
    r.kx = kx; r.ky = ky; r.kz = kz;
    r.sx = sel3(kx, dx, dy, dz) / dkz;
    r.sy = sel3(ky, dx, dy, dz) / dkz;
    r.sz = 1.0f / dkz;
  }
  const int skip = p.skip ? p.skip[i] : -1;

  float u_best = 0.0f, v_best = 0.0f;
  int pid_best = -1;
  bool found = false;

  int stack[kStackCap];
  int sp = 0;
  stack[sp++] = 0;  // root node row
  while (sp > 0) {
    const int e = stack[--sp];
    if (e >= 0) {
      const float* row = p.nodes + (size_t)e * 128;
      unsigned mask = 0u;
      if (W == 16) {
#pragma unroll
        for (int q = 0; q < 8; ++q) {  // two children per 3 float4 loads
          const float4 a = __ldg(reinterpret_cast<const float4*>(row + 12 * q));
          const float4 b = __ldg(reinterpret_cast<const float4*>(row + 12 * q + 4));
          const float4 c = __ldg(reinterpret_cast<const float4*>(row + 12 * q + 8));
          mask |= (unsigned)slab(r, t_best, a.x, a.y, a.z, a.w, b.x, b.y) << (2 * q);
          mask |= (unsigned)slab(r, t_best, b.z, b.w, c.x, c.y, c.z, c.w) << (2 * q + 1);
        }
      } else {
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const float4 a = __ldg(reinterpret_cast<const float4*>(row + 8 * c));
          const float2 b = __ldg(reinterpret_cast<const float2*>(row + 8 * c + 4));
          mask |= (unsigned)slab(r, t_best, a.x, a.y, a.z, a.w, b.x, b.y) << c;
        }
      }
      if (mask == 0u) continue;
      constexpr int kMeta = W == 16 ? 96 : 64;
      constexpr int kCount = W == 16 ? 112 : 72;
      int axis;
      if (W == 16) {
        const float v112 = __ldg(row + 112);
        axis = v112 >= 32.0f ? 2 : (v112 >= 16.0f ? 1 : 0);
      } else {
        const float a80 = __ldg(row + 80);
        axis = a80 == 0.0f ? 0 : (a80 == 1.0f ? 1 : 2);
      }
      // children are stored near-to-far along the order axis; the LIFO
      // stack takes them far-first so the nearest pops first
      const bool neg = axis == 0 ? r.nx : (axis == 1 ? r.ny : r.nz);
      for (int j = 0; j < W; ++j) {
        const int cc = neg ? j : W - 1 - j;
        if (!((mask >> cc) & 1u)) continue;
        const int meta = (int)__ldg(row + kMeta + cc);
        int entry = meta;
        if (meta < 0) {
          const int cnt = ((int)__ldg(row + kCount + cc)) & 15;
          entry = -1 - (((-meta - 1) << 4) | cnt);
        }
        if (sp >= p.stack_size) {  // never truncate silently
          atomicOr(p.err, 1);
          sp = 0;
          break;
        }
        stack[sp++] = entry;
      }
    } else {
      const int packed = -1 - e;
      const float* row = p.leafs + (size_t)(packed >> 4) * 128;
      const int cnt = packed & 15;
      for (int ti = 0; ti < cnt; ++ti) {
        float tt, uu, vv;
        if (!hit_triangle(r, row + 9 * ti, t_best, p.cull_back_face,
                          p.exact_edge, tt, uu, vv)) {
          continue;
        }
        const int pid = (int)__ldg(row + 90 + ti);
        if (pid == skip) continue;
        if (p.use_range && (pid < p.range_lo || pid >= p.range_hi)) continue;
        t_best = tt;
        u_best = uu;
        v_best = vv;
        pid_best = pid;
        found = true;
        if (p.occlusion) break;
      }
      if (p.occlusion && found) break;
    }
  }

  // decode as traverse_bvh8 does (pallas_packet.py:2289-2304)
  const bool hit = p.occlusion ? found : t_best < max_t_in;
  p.t_out[i] = p.occlusion ? (hit ? t_best : max_t_in) : t_best;
  p.u_out[i] = hit ? u_best : 0.0f;
  p.v_out[i] = hit ? v_best : 0.0f;
  p.pid_out[i] = hit ? (long long)pid_best : kInvalidPrim;
}

}  // namespace

extern "C" int nrt_packet_traverse(
    const float* nodes, const float* leafs, const float* org, const float* dir,
    const float* min_t, const float* max_t, const int* skip, float* t_out,
    float* u_out, float* v_out, long long* pid_out, int* err, long long n_rays,
    int width, int stack_size, int occlusion, int cull_back_face,
    int exact_edge, int use_range, int range_lo, int range_hi,
    void* stream) {
  if (stack_size < 1 || stack_size > kStackCap) return (int)cudaErrorInvalidValue;
  if (width != 8 && width != 16) return (int)cudaErrorInvalidValue;
  if (n_rays <= 0) return 0;
  Params p{nodes, leafs, org, dir, min_t, max_t, skip, t_out, u_out, v_out,
           pid_out, err, n_rays, stack_size, occlusion, cull_back_face,
           exact_edge, use_range, range_lo, range_hi};
  const unsigned grid = (unsigned)((n_rays + kBlock - 1) / kBlock);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (width == 16) {
    traverse_kernel<16><<<grid, kBlock, 0, s>>>(p);
  } else {
    traverse_kernel<8><<<grid, kBlock, 0, s>>>(p);
  }
  return (int)cudaGetLastError();
}
