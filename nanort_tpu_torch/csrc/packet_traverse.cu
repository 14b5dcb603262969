// Wide-BVH ray traversal for NVIDIA Hopper (sm_90a): closest-hit or
// any-hit, watertight triangle test with the Dekker exact-edge fallback,
// or the Woop unit-triangle test (the "turbo" intersector).
//
// Replaces nanort_tpu/traverse/pallas_packet.py::_kernel_body (the TPU
// kernel behind traverse_bvh8), with its intersector="woop" leaf test
// (pallas_packet.py:283-332). It computes what that kernel computes per
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
// The Woop test's 1/d'z must stay a true division: for a ray parallel to
// the triangle's plane it is +-inf, and the inf or NaN t that follows
// fails every comparison, so the triangle is missed.
//
// The leaf test is a template parameter, so the watertight instantiation
// is the same code, with the same registers, as without the Woop test.
//
// The TPU kernel's other modes, each a template parameter, so the
// instantiations above keep their code when a mode is off:
//   kRoots     (packet_roots, pallas_packet.py:256): each ray starts at
//              its packet's root row, roots[i / packet], in place of row
//              0 (the treelet engine roots each packet at its treelet).
//              The mode kernels below take roots too, when given.
//   kCounts    (debug_counts, :556-558, :1050-1053): u and v carry this
//              ray's node pops and leaf pops as floats (exact below
//              2^24). The TPU kernel counts per packet; here each thread
//              walks one ray, so the counters are per ray.
//   kFlags     (_flag_zero_edges, :376-381, :1047-1048): an int32 a ray,
//              set when the ray tested a triangle whose U, V or W was 0
//              before any exact recompute: the rays whose records could
//              change with the exact-edge recompute.
//   kK > 1     (interleave, K1b, _kernel_body_il :1060): K rays a
//              thread, each with its own stack, one pop per live ray per
//              loop step, so a thread has K independent row fetches to
//              wait on. Each ray's pop sequence is that of kK == 1, so
//              its records are bit-identical. The TPU reason for K1b
//              (amortising the vector-to-scalar drain) has no Hopper
//              counterpart; this is the nearest one, latency hiding.
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
  const int* roots;     // (ceil(R / packet),) start node rows, or null
  float* t_out;         // (R,)
  float* u_out;         // (R,) node pops with kCounts
  float* v_out;         // (R,) leaf pops with kCounts
  long long* pid_out;   // (R,) 0xFFFFFFFF on a miss
  int* flags;           // (R,) zero-edge flags with kFlags, else null
  int* err;             // (1,) set to 1 when a stack overflows
  long long n_rays;
  long long packet;     // rays per packet of ``roots``
  int stack_size;       // <= kStackCap
  int occlusion;        // any-hit: stop at the first accepted hit
  int cull_back_face;
  int exact_edge;       // Dekker recompute where an edge function is 0
  int use_range;        // prim_ids_range filter: lo <= pid < hi
  int range_lo;
  int range_hi;
};
// With the Woop test, ``leafs`` is the scene's leafs_woop table: one row
// for each watertight leaf row, triangle t at lanes [12t, 12t+12) as its
// row-major unit-triangle transform M (9 lanes) and anchor vertex p0 (3),
// its prim id at lane 108 + t.

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
  float dx, dy, dz;     // sanitized direction (Woop test)
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
// same operations in the same order). Returns true on acceptance. With
// kFlag, ORs into ``zero`` whether U, V or W was 0 before the recompute.
template <bool kFlag>
__device__ __forceinline__ bool hit_triangle(const RayState& r,
                                             const float* v, float t_cur,
                                             int cull, int exact, float& tt,
                                             float& uu, float& vv,
                                             int& zero) {
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
  const bool any_zero = U == 0.0f || V == 0.0f || W == 0.0f;
  if (kFlag) zero |= (int)any_zero;
  if (exact && any_zero) {
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

// Woop unit-triangle test of one triangle of a leafs_woop row
// (traverse/packet.py::_woop_test, pallas_packet.py:287-330): o' = M (o -
// p0), d' = M d, t = -o'z / d'z, u = o'x + t d'x, v = o'y + t d'y, sums in
// that order. Returns true on acceptance.
__device__ __forceinline__ bool hit_triangle_woop(const RayState& r,
                                                  const float* m,
                                                  float t_cur, int cull,
                                                  float& tt, float& uu,
                                                  float& vv) {
  const float rx = r.ox - __ldg(m + 9);
  const float ry = r.oy - __ldg(m + 10);
  const float rz = r.oz - __ldg(m + 11);
  const float m00 = __ldg(m + 0), m01 = __ldg(m + 1), m02 = __ldg(m + 2);
  const float m10 = __ldg(m + 3), m11 = __ldg(m + 4), m12 = __ldg(m + 5);
  const float m20 = __ldg(m + 6), m21 = __ldg(m + 7), m22 = __ldg(m + 8);
  const float opz = m20 * rx + m21 * ry + m22 * rz;
  const float dpz = m20 * r.dx + m21 * r.dy + m22 * r.dz;
  const float rcp = 1.0f / dpz;
  tt = -opz * rcp;
  uu = (m00 * rx + m01 * ry + m02 * rz) +
       tt * (m00 * r.dx + m01 * r.dy + m02 * r.dz);
  vv = (m10 * rx + m11 * ry + m12 * rz) +
       tt * (m10 * r.dx + m11 * r.dy + m12 * r.dz);
  return uu >= 0.0f && vv >= 0.0f && uu + vv <= 1.0f && tt <= t_cur &&
         tt >= r.min_t && (!cull || dpz < 0.0f);
}

// One ray's walk: its set-up, its best record and its stack pointer (the
// stack itself is the caller's), plus the counters and the flag of the
// debug modes (dead code, and no registers, when those are off).
struct Walk {
  RayState r;
  float t_best, max_t_in, u_best, v_best;
  int pid_best, skip, sp;
  bool found;
  int n_nodes, n_leaves, zero;
};

// Set up ray i and push its start node: row 0, or (kRoots, when the
// launch has roots) its packet's root.
template <bool kRoots>
__device__ __forceinline__ void begin(const Params& p, long long i, Walk& w,
                                      int* stack) {
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

  RayState& r = w.r;
  r.ox = ox; r.oy = oy; r.oz = oz;
  r.dx = dx; r.dy = dy; r.dz = dz;
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
  w.skip = p.skip ? p.skip[i] : -1;
  w.t_best = t_best;
  w.max_t_in = max_t_in;
  w.u_best = 0.0f;
  w.v_best = 0.0f;
  w.pid_best = -1;
  w.found = false;
  w.n_nodes = 0;
  w.n_leaves = 0;
  w.zero = 0;
  w.sp = 0;
  // a ray whose interval is empty or NaN fails every slab test: retire it
  // before its first node (ray_sort.py sorts such rays last, and the
  // treelet engine's padding slots are such rays, so whole warps of them
  // exit here)
  if (min_t <= t_best) {
    stack[w.sp++] = kRoots && p.roots ? p.roots[i / p.packet] : 0;
  }
}

// Node row layouts (build/bvh8.py):
//   W == 16: child w box at lanes [6w, 6w+6), meta at 96+w, leaf count at
//            112+w; the order axis rides the child-0 count as cnt + 16*axis
//   W == 8:  child c box at lanes [8c, 8c+6), meta at 64+c, count at 72+c,
//            order axis at lane 80 (make_treelets' synthetic rows fold it
//            into lane 72 instead and leave lane 80 at 0, so they are
//            walked in x order: only the order changes, never a record)
// meta >= 0: internal node row; meta < 0: leaf row -(meta + 1).
// Stack entries: node row >= 0, or -1 - (leaf_row << 4 | count) for a leaf.
//
// Pops one entry of a live ray's stack and runs it: a node's slab tests
// and pushes, or a leaf row's triangle tests.
template <int W, bool kWoop, bool kCounts, bool kFlags>
__device__ __forceinline__ void step(const Params& p, Walk& w, int* stack) {
  const RayState& r = w.r;
  const int e = stack[--w.sp];
  if (e >= 0) {
    if (kCounts) ++w.n_nodes;
    const float* row = p.nodes + (size_t)e * 128;
    unsigned mask = 0u;
    if (W == 16) {
#pragma unroll
      for (int q = 0; q < 8; ++q) {  // two children per 3 float4 loads
        const float4 a = __ldg(reinterpret_cast<const float4*>(row + 12 * q));
        const float4 b = __ldg(reinterpret_cast<const float4*>(row + 12 * q + 4));
        const float4 c = __ldg(reinterpret_cast<const float4*>(row + 12 * q + 8));
        mask |= (unsigned)slab(r, w.t_best, a.x, a.y, a.z, a.w, b.x, b.y) << (2 * q);
        mask |= (unsigned)slab(r, w.t_best, b.z, b.w, c.x, c.y, c.z, c.w) << (2 * q + 1);
      }
    } else {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(row + 8 * c));
        const float2 b = __ldg(reinterpret_cast<const float2*>(row + 8 * c + 4));
        mask |= (unsigned)slab(r, w.t_best, a.x, a.y, a.z, a.w, b.x, b.y) << c;
      }
    }
    if (mask == 0u) return;
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
      if (w.sp >= p.stack_size) {  // never truncate silently
        atomicOr(p.err, 1);
        w.sp = 0;
        return;
      }
      stack[w.sp++] = entry;
    }
  } else {
    if (kCounts) ++w.n_leaves;
    const int packed = -1 - e;
    const float* row = p.leafs + (size_t)(packed >> 4) * 128;
    const int cnt = packed & 15;
    for (int ti = 0; ti < cnt; ++ti) {
      float tt, uu, vv;
      const bool ok =
          kWoop ? hit_triangle_woop(r, row + 12 * ti, w.t_best,
                                    p.cull_back_face, tt, uu, vv)
                : hit_triangle<kFlags>(r, row + 9 * ti, w.t_best,
                                       p.cull_back_face, p.exact_edge, tt,
                                       uu, vv, w.zero);
      if (!ok) continue;
      const int pid = (int)__ldg(row + (kWoop ? 108 : 90) + ti);
      if (pid == w.skip) continue;
      if (p.use_range && (pid < p.range_lo || pid >= p.range_hi)) continue;
      w.t_best = tt;
      w.u_best = uu;
      w.v_best = vv;
      w.pid_best = pid;
      w.found = true;
      if (p.occlusion) break;
    }
    if (p.occlusion && w.found) w.sp = 0;  // any-hit: retire
  }
}

// Decode as traverse_bvh8 does (pallas_packet.py:2289-2304) and store.
template <bool kCounts, bool kFlags>
__device__ __forceinline__ void finish(const Params& p, long long i,
                                       const Walk& w) {
  const bool hit = p.occlusion ? w.found : w.t_best < w.max_t_in;
  p.t_out[i] = p.occlusion ? (hit ? w.t_best : w.max_t_in) : w.t_best;
  if (kCounts) {
    p.u_out[i] = (float)w.n_nodes;
    p.v_out[i] = (float)w.n_leaves;
  } else {
    p.u_out[i] = hit ? w.u_best : 0.0f;
    p.v_out[i] = hit ? w.v_best : 0.0f;
  }
  p.pid_out[i] = hit ? (long long)w.pid_best : kInvalidPrim;
  if (kFlags) p.flags[i] = w.zero;
}

// One thread, one ray. kRoots is a template parameter so that the
// instantiations without modes keep the code they had before roots.
template <int W, bool kWoop, bool kCounts, bool kFlags, bool kRoots>
__global__ void __launch_bounds__(kBlock) traverse_kernel(Params p) {
  const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (i >= p.n_rays) return;
  int stack[kStackCap];
  Walk w;
  begin<kRoots>(p, i, w, stack);
  while (w.sp > 0) step<W, kWoop, kCounts, kFlags>(p, w, stack);
  finish<kCounts, kFlags>(p, i, w);
}

// One thread, kK rays (K1b): block b holds rays [b*kBlock*kK,
// (b+1)*kBlock*kK), ray k of a thread at threadIdx.x + k*kBlock, so the
// 32 lanes of a warp walk 32 neighbouring rays at every k.
template <int W, bool kWoop, int kK>
__global__ void __launch_bounds__(kBlock) traverse_kernel_il(Params p) {
  const long long first = (long long)blockIdx.x * (kBlock * kK) + threadIdx.x;
  int stack[kK][kStackCap];
  Walk w[kK];
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    const long long i = first + (long long)k * kBlock;
    w[k].sp = 0;
    if (i < p.n_rays) begin<true>(p, i, w[k], stack[k]);
  }
  for (;;) {
    bool live = false;
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      if (w[k].sp > 0) step<W, kWoop, false, false>(p, w[k], stack[k]);
      live |= w[k].sp > 0;
    }
    if (!live) break;
  }
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    const long long i = first + (long long)k * kBlock;
    if (i < p.n_rays) finish<false, false>(p, i, w[k]);
  }
}

template <int W, bool kWoop>
void launch(const Params& p, int counts, int flags, int interleave,
            cudaStream_t s) {
  const long long n = p.n_rays;
  const unsigned g1 = (unsigned)((n + kBlock - 1) / kBlock);
  if (interleave == 2) {
    const unsigned g = (unsigned)((n + 2 * kBlock - 1) / (2 * kBlock));
    traverse_kernel_il<W, kWoop, 2><<<g, kBlock, 0, s>>>(p);
  } else if (interleave == 4) {
    const unsigned g = (unsigned)((n + 4 * kBlock - 1) / (4 * kBlock));
    traverse_kernel_il<W, kWoop, 4><<<g, kBlock, 0, s>>>(p);
  } else if (counts) {
    traverse_kernel<W, kWoop, true, false, true><<<g1, kBlock, 0, s>>>(p);
  } else if (flags) {
    if constexpr (!kWoop) {
      traverse_kernel<W, false, false, true, true><<<g1, kBlock, 0, s>>>(p);
    }
  } else if (p.roots) {
    traverse_kernel<W, kWoop, false, false, true><<<g1, kBlock, 0, s>>>(p);
  } else {
    traverse_kernel<W, kWoop, false, false, false><<<g1, kBlock, 0, s>>>(p);
  }
}

}  // namespace

// counts, flags and interleave > 1 are exclusive modes; flags need the
// watertight test; roots (with packet > 0) combine with any mode.
extern "C" int nrt_packet_traverse(
    const float* nodes, const float* leafs, const float* org, const float* dir,
    const float* min_t, const float* max_t, const int* skip, const int* roots,
    float* t_out, float* u_out, float* v_out, long long* pid_out, int* flags,
    int* err, long long n_rays, long long packet, int width, int stack_size,
    int occlusion, int cull_back_face, int exact_edge, int use_range,
    int range_lo, int range_hi, int woop, int counts, int zero_flags,
    int interleave, void* stream) {
  if (stack_size < 1 || stack_size > kStackCap) return (int)cudaErrorInvalidValue;
  if (width != 8 && width != 16) return (int)cudaErrorInvalidValue;
  if (interleave != 1 && interleave != 2 && interleave != 4)
    return (int)cudaErrorInvalidValue;
  if ((counts != 0) + (zero_flags != 0) + (interleave > 1) > 1)
    return (int)cudaErrorInvalidValue;
  if (zero_flags && (woop || flags == nullptr)) return (int)cudaErrorInvalidValue;
  if (roots && packet < 1) return (int)cudaErrorInvalidValue;
  if (n_rays <= 0) return 0;
  Params p{nodes, leafs, org, dir, min_t, max_t, skip, roots, t_out,
           u_out, v_out, pid_out, flags, err, n_rays, packet, stack_size,
           occlusion, cull_back_face, exact_edge, use_range, range_lo,
           range_hi};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (width == 16) {
    if (woop) {
      launch<16, true>(p, counts, zero_flags, interleave, s);
    } else {
      launch<16, false>(p, counts, zero_flags, interleave, s);
    }
  } else if (woop) {
    launch<8, true>(p, counts, zero_flags, interleave, s);
  } else {
    launch<8, false>(p, counts, zero_flags, interleave, s);
  }
  return (int)cudaGetLastError();
}
