// In-kernel BVH16 trace for NVIDIA Hopper (sm_90a): one ray per thread,
// closest-hit (with the aux row's material id and geometric normal) or
// occlusion, with the Moller-Trumbore leaf test or the watertight one, and
// an optional per-ray skip of one prim id.
//
// Replaces nanort_tpu/traverse/fused_trace.py::make_tracer (K2), the
// trace primitive that the TPU's megakernels call from inside: the fused
// path tracer (models/pt_fused.py::_pt_kernel_bvh, K4) with the "mt"
// intersector, the fused AO pass (models/ao_fused.py::_ao_kernel, K5) with
// "watertight" and skip. It walks the SAME dense BVH16 node rows
// (build/bvh8.py::collapse_bvh8(width=16)), leaf rows and aux rows
// (traverse/fused_trace.py::build_aux_rows), and keeps make_tracer's
// semantics op for op:
//   * degenerate rays (NaN/inf or |x| >= 3e38 origin or direction, zero
//     direction) become misses (fused_trace.py:134-145);
//   * safe_inv maps |d| < FLT_EPSILON to inf signed by the sign bit;
//   * the slab test takes (lo - o) * inv and (hi - o) * inv * 1.00000024
//     and folds them with NaN-PROPAGATING max/min, bounded by s_min and
//     the ray's current t: a child whose slab gives 0 * inf is never
//     visited (jnp.maximum propagates NaN; fmaxf would drop it);
//   * "mt" (kWatertight false): Moller-Trumbore on (p0, e1, e2)
//     (fused_trace.py:264-313). "watertight": the per-trace shear of
//     fused_trace.py:159-195 (kz the first axis of largest |d|, kx/ky
//     swapped when d[kz] < 0), then per triangle the shear-space edge
//     functions U, V, W, their Dekker double-word recompute when any is
//     exactly zero, the sign test, det = (U + V) + W, rcp = 1 / det and
//     t = ((U (shz Az) + V (shz Bz)) + W (shz Cz)) rcp, u = V rcp,
//     v = W rcp (fused_trace.py:329-390). det == 0 is not tested: with
//     agreeing signs it forces U = V = W = 0 and t = 0 * inf = NaN, which
//     fails the range tests. These are not K1's formulas
//     (packet_traverse.cu): K1 tests det != 0 and divides by a guarded det;
//   * kSkip: a triangle whose prim id (leaf lane 90 + slot, an exact
//     float integer) equals the ray's skip is not a hit; -1 skips nothing;
//   * both tests accept tt >= s_min && tt <= t and replace on <= in slot
//     order; occlusion stores t = -(tt + 1) and answers t < 0, so a
//     blocker at exactly tt == tmax occludes, and a ray whose tmax is
//     negative reports occluded without a walk (the fused AO pass's dead
//     rays, which it never counts);
//   * closest-hit answers hit = t < s_max && ok && s_max > s_min, so a
//     hit at exactly tt == tmax is a miss; a miss reports t = tmax,
//     u = v = 0, prim -1, material 0 and a zero normal.
// It does not copy the TPU's scheme, one SMEM stack per (S, 128) block
// with OR-reduced slab votes and a child order from ray 0's octant. Each
// thread has a private stack of depth * 15 + 1 entries (a near-first walk
// never holds more, as for K1; the local array holds the 512-entry
// ceiling, which ran no slower than one sized to the tree's depth) and
// takes the child order from its own ray's octant: that changes the prim
// only between hits at exactly equal t, the repository's tie contract. A
// node's 16 child boxes (its row's first 384 bytes) arrive in 24 16-byte
// loads.
//
// What bounds it on this card: dependent row fetches (a 512-byte node row
// must arrive before the next node index is known) and divergence: bounce
// and shadow rays of neighbouring lanes point anywhere, so a warp runs the
// union of 32 unrelated walks. The design keeps the per-ray work minimal
// (no ray tests a node or leaf it does not hit itself, occlusion exits at
// its first blocker, rays with an empty [tmin, tmax] skip the walk) and
// leaves coherence to the caller (K4's pooled kernel sorts its rays).
//
// Numerics: compile with --fmad=false (every product separately rounded,
// as the plain torch version, traverse/fused_trace.py::
// trace_bvh16_reference, computes it, and as the Dekker split needs),
// IEEE division, no -ftz.

#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace bvh16 {

constexpr int kStackCap = 512;           // per-thread stack ceiling
constexpr float kBig = 3.0e38f;          // degenerate-ray threshold
constexpr float kMaxMult = 1.00000024f;  // 4-ulp exit-plane inflation
constexpr float kSplit = 4097.0f;        // Veltkamp split constant for f32

struct Record {
  float t, u, v;
  int pid;
  bool hit;
  int mid;
  float gx, gy, gz;
};

// jnp.maximum / jnp.minimum: NaN in either operand gives NaN
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

__device__ __forceinline__ float safe_inv(float d) {
  if (fabsf(d) < FLT_EPSILON) {
    return __float_as_int(d) < 0 ? -INFINITY : INFINITY;
  }
  return 1.0f / d;
}

// component k of (x, y, z), as jnp.where selects it
__device__ __forceinline__ float comp(float x, float y, float z, int k) {
  return k == 0 ? x : (k == 1 ? y : z);
}

// a * b = p + err exactly (Dekker/Veltkamp), every product rounded alone
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

// a * b - c * d in double-word arithmetic (fused_trace.py:167-181)
__device__ __forceinline__ float prod_diff(float a, float b, float c,
                                           float d) {
  float p1, e1, p2, e2;
  two_prod(a, b, p1, e1);
  two_prod(c, d, p2, e2);
  return (p1 - p2) + (e1 - e2);
}

// Node row (width 16): child w box at lanes [6w, 6w+6), meta at 96+w
// (>= 0 internal row, < 0 leaf row -(meta+1)), leaf count at 112+w, the
// order axis riding lane 112 as cnt + 16 * axis. Stack entries: node row
// >= 0, or -1 - (leaf_row << 4 | count) for a leaf.
//
// Occlusion: rec.hit is the answer, the other fields are unset.
// kAux: fill mid / normal from the aux row (closest-hit only).
// kWatertight: the watertight leaf test, else Moller-Trumbore.
// kSkip: triangles of prim id ``skip`` are not hits.
template <bool kOcclusion, bool kAux, bool kWatertight = false,
          bool kSkip = false>
__device__ Record trace(const float* __restrict__ nodes,
                        const float* __restrict__ leafs,
                        const float* __restrict__ aux, int stack_size,
                        int* err, float ox, float oy, float oz, float dx,
                        float dy, float dz, float tmin, float tmax,
                        int skip = -1) {
  const bool okr = fabsf(ox) < kBig && fabsf(oy) < kBig && fabsf(oz) < kBig &&
                   fabsf(dx) < kBig && fabsf(dy) < kBig && fabsf(dz) < kBig &&
                   fabsf(dx) + fabsf(dy) + fabsf(dz) > 0.0f;
  const float sox = okr ? ox : 0.0f, soy = okr ? oy : 0.0f,
              soz = okr ? oz : 0.0f;
  const float sdx = okr ? dx : 1.0f, sdy = okr ? dy : 0.0f,
              sdz = okr ? dz : 0.0f;
  const float s_min = okr ? tmin : INFINITY;
  const float s_max = okr ? tmax : INFINITY;
  const float ix = safe_inv(sdx), iy = safe_inv(sdy), iz = safe_inv(sdz);
  const bool snx = sdx < 0.0f, sny = sdy < 0.0f, snz = sdz < 0.0f;

  // watertight shear, once per trace (fused_trace.py:183-195)
  int kx = 0, ky = 0, kz = 0;
  float shx = 0.0f, shy = 0.0f, shz = 0.0f;
  if (kWatertight) {
    const float adx = fabsf(sdx), ady = fabsf(sdy), adz = fabsf(sdz);
    kz = ady > adx ? 1 : 0;
    const float amax = ady > adx ? ady : adx;
    kz = adz > amax ? 2 : kz;
    kx = (kz + 1) % 3;
    ky = (kx + 1) % 3;
    const float dkz = comp(sdx, sdy, sdz, kz);
    if (dkz < 0.0f) {
      const int k = kx;
      kx = ky;
      ky = k;
    }
    shx = comp(sdx, sdy, sdz, kx) / dkz;
    shy = comp(sdx, sdy, sdz, ky) / dkz;
    shz = 1.0f / dkz;
  }

  float t_b = s_max, u_b = 0.0f, v_b = 0.0f;
  float gx = 0.0f, gy = 0.0f, gz = 0.0f;
  int p_b = -1, m_b = 0;
  bool found = false;

  // with s_min > s_max (or NaN) no slab and no triangle can pass
  if (s_min <= s_max) {
    int stack[kStackCap];
    int sp = 0;
    stack[sp++] = 0;
    while (sp > 0) {
      const int e = stack[--sp];
      if (e >= 0) {
        const float* row = nodes + (size_t)e * 128;
        // the 16 child boxes are the row's first 384 bytes: 24 16-byte
        // loads, three for each pair of children (the caller checks that
        // the table is 16-byte aligned)
        const float4* row4 = reinterpret_cast<const float4*>(row);
        auto slab = [&](float b0x, float b0y, float b0z, float b1x, float b1y,
                        float b1z) {
          const float lox = snx ? b1x : b0x, hix = snx ? b0x : b1x;
          const float loy = sny ? b1y : b0y, hiy = sny ? b0y : b1y;
          const float loz = snz ? b1z : b0z, hiz = snz ? b0z : b1z;
          const float t0 = max_nan(max_nan((lox - sox) * ix, (loy - soy) * iy),
                                   max_nan((loz - soz) * iz, s_min));
          const float t1 =
              min_nan(min_nan((hix - sox) * ix * kMaxMult,
                              (hiy - soy) * iy * kMaxMult),
                      min_nan((hiz - soz) * iz * kMaxMult, t_b));
          return (unsigned)(t0 <= t1);
        };
        unsigned mask = 0u;
#pragma unroll
        for (int pr = 0; pr < 8; ++pr) {
          const float4 a = __ldg(row4 + 3 * pr);
          const float4 b = __ldg(row4 + 3 * pr + 1);
          const float4 c = __ldg(row4 + 3 * pr + 2);
          mask |= slab(a.x, a.y, a.z, a.w, b.x, b.y) << (2 * pr);
          mask |= slab(b.z, b.w, c.x, c.y, c.z, c.w) << (2 * pr + 1);
        }
        if (mask == 0u) continue;
        const float v112 = __ldg(row + 112);
        const int axis = v112 >= 32.0f ? 2 : (v112 >= 16.0f ? 1 : 0);
        // children are stored near-to-far along the order axis; the LIFO
        // stack takes them far-first so the nearest pops first
        const bool neg = axis == 0 ? snx : (axis == 1 ? sny : snz);
        for (int j = 0; j < 16; ++j) {
          const int cc = neg ? j : 15 - j;
          if (!((mask >> cc) & 1u)) continue;
          const int meta = (int)__ldg(row + 96 + cc);
          int entry = meta;
          if (meta < 0) {
            const int cnt = ((int)__ldg(row + 112 + cc)) & 15;
            entry = -1 - (((-meta - 1) << 4) | cnt);
          }
          if (sp >= stack_size) {  // never truncate silently
            atomicOr(err, 1);
            sp = 0;
            break;
          }
          stack[sp++] = entry;
        }
      } else {
        const int packed = -1 - e;
        const float* lrow = leafs + (size_t)(packed >> 4) * 128;
        const int cnt = packed & 15;
        for (int ti = 0; ti < cnt; ++ti) {
          const float* q = lrow + 9 * ti;
          float tt, uu, vv;
          bool ok;
          if (kWatertight) {
            const float ax = __ldg(q) - sox, ay = __ldg(q + 1) - soy,
                        az = __ldg(q + 2) - soz;
            const float bx = __ldg(q + 3) - sox, by = __ldg(q + 4) - soy,
                        bz = __ldg(q + 5) - soz;
            const float cx = __ldg(q + 6) - sox, cy = __ldg(q + 7) - soy,
                        cz = __ldg(q + 8) - soz;
            const float Az = comp(ax, ay, az, kz), Bz = comp(bx, by, bz, kz),
                        Cz = comp(cx, cy, cz, kz);
            const float Ax = comp(ax, ay, az, kx) - shx * Az;
            const float Ay = comp(ax, ay, az, ky) - shy * Az;
            const float Bx = comp(bx, by, bz, kx) - shx * Bz;
            const float By = comp(bx, by, bz, ky) - shy * Bz;
            const float Cx = comp(cx, cy, cz, kx) - shx * Cz;
            const float Cy = comp(cx, cy, cz, ky) - shy * Cz;
            float U = Cx * By - Cy * Bx;
            float V = Ax * Cy - Ay * Cx;
            float W = Bx * Ay - By * Ax;
            if (U == 0.0f || V == 0.0f || W == 0.0f) {
              U = prod_diff(Cx, By, Cy, Bx);
              V = prod_diff(Ax, Cy, Ay, Cx);
              W = prod_diff(Bx, Ay, By, Ax);
            }
            const bool edge_ok = min_nan(min_nan(U, V), W) >= 0.0f ||
                                 max_nan(max_nan(U, V), W) <= 0.0f;
            const float det = U + V + W;
            const float rcp = 1.0f / det;
            tt = (U * (shz * Az) + V * (shz * Bz) + W * (shz * Cz)) * rcp;
            uu = V * rcp;
            vv = W * rcp;
            ok = edge_ok && tt >= s_min && tt <= t_b;
          } else {
            const float p0x = __ldg(q), p0y = __ldg(q + 1), p0z = __ldg(q + 2);
            const float e1x = __ldg(q + 3) - p0x, e1y = __ldg(q + 4) - p0y,
                        e1z = __ldg(q + 5) - p0z;
            const float e2x = __ldg(q + 6) - p0x, e2y = __ldg(q + 7) - p0y,
                        e2z = __ldg(q + 8) - p0z;
            const float pvx = sdy * e2z - sdz * e2y;
            const float pvy = sdz * e2x - sdx * e2z;
            const float pvz = sdx * e2y - sdy * e2x;
            const float det = e1x * pvx + e1y * pvy + e1z * pvz;
            const float invd = 1.0f / (det == 0.0f ? 1.0f : det);
            const float tx = sox - p0x, ty = soy - p0y, tz = soz - p0z;
            uu = (tx * pvx + ty * pvy + tz * pvz) * invd;
            const float qx = ty * e1z - tz * e1y;
            const float qy = tz * e1x - tx * e1z;
            const float qz = tx * e1y - ty * e1x;
            vv = (sdx * qx + sdy * qy + sdz * qz) * invd;
            tt = (e2x * qx + e2y * qy + e2z * qz) * invd;
            ok = det != 0.0f && uu >= 0.0f && vv >= 0.0f &&
                 uu + vv <= 1.0f && tt >= s_min && tt <= t_b;
          }
          if (kSkip) ok = ok && (int)__ldg(lrow + 90 + ti) != skip;
          if (!ok) continue;
          if (kOcclusion) {
            t_b = -tt - 1.0f;
            found = true;
            break;
          }
          t_b = tt;
          u_b = uu;
          v_b = vv;
          p_b = (int)__ldg(lrow + 90 + ti);
          if (kAux) {
            const float* arow = aux + (size_t)(packed >> 4) * 128;
            m_b = (int)__ldg(arow + 32 + ti);
            gx = __ldg(arow + 3 * ti);
            gy = __ldg(arow + 3 * ti + 1);
            gz = __ldg(arow + 3 * ti + 2);
          }
        }
        if (kOcclusion && found) break;
      }
    }
  }

  Record r;
  if (kOcclusion) {
    r.hit = t_b < 0.0f;
    return r;
  }
  const bool hit = t_b < s_max && okr && s_max > s_min;
  r.hit = hit;
  r.t = hit ? t_b : tmax;
  r.u = hit ? u_b : 0.0f;
  r.v = hit ? v_b : 0.0f;
  r.pid = hit ? p_b : -1;
  r.mid = hit ? m_b : 0;
  r.gx = hit ? gx : 0.0f;
  r.gy = hit ? gy : 0.0f;
  r.gz = hit ? gz : 0.0f;
  return r;
}

}  // namespace bvh16
