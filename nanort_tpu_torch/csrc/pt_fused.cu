// Fused path-tracing megakernels for NVIDIA Hopper (sm_90a): a whole
// spp x bounce render in one launch.
//
// Replaces two TPU kernels of nanort_tpu/models/pt_fused.py:
//   * K3, _pt_kernel (brute-force Moller-Trumbore sweep over <= 256
//     triangles): pt_brute_kernel below;
//   * K4, _pt_kernel_bvh (the same loop, tracing a BVH16 with
//     traverse/fused_trace.py::make_tracer, K2): pt_bvh_kernel below,
//     which calls bvh16::trace (bvh16_trace.cuh).
// Both share one __device__ bounce_step, the counterpart of _bounce_step
// (pt_fused.py:137-311): Russian roulette after bounce rr_start, lobe
// pick, next-event estimation with one shadow ray, emission, cosine /
// specular / refracted next direction, all driven by the TPU kernels'
// counter-based lowbias32 generator, ported bit for bit in uint32
// arithmetic (the counter base seed + (s_eff * (max_bounces + 1) + b) * 16
// wraps mod 2^32 as the TPU's int32 does).
//
// Layout: each thread owns one lane (one camera ray, or one sample-major
// copy of one in K4) and runs its spp x bounce loop in registers, as the
// TPU kernel runs it per (sub, 128) block; it writes its radiance SUMS
// (R, 3) once at the end. The wrapper (models/pt_fused.py) divides by spp.
//
// What bounds it on this card:
//   * K3: the per-lane triangle loop. Every bounce sweeps all F triangles
//     twice (closest hit, then the shadow ray), ~40 flops each; the
//     triangle table sits in shared memory and every lane of a warp reads
//     the same row at once (a broadcast), so the sweep runs at the FP32
//     issue rate; the shadow sweep exits at its first blocker.
//   * K4: divergent bounce rays and dependent row fetches inside K2 (see
//     bvh16_trace.cuh). Lanes of a warp are neighbouring pixels (the
//     caller's 32 x 128 tile order) and, with spp_lanes > 1, copies of ONE
//     pixel that share a primary hit and an azimuth wedge, so their first
//     bounces walk similar subtrees; beyond that the warp runs the union
//     of its lanes' walks. Path regeneration, ray queues and node caches
//     are later work.
//
// Numerics: compile with --fmad=false, IEEE division and sqrt, no -ftz,
// so every value is the separately rounded f32 the plain torch version
// (pt_fused.py::_render_lanes_reference) computes; max/min propagate NaN
// as jnp.maximum does. trig == 1 ("poly") is bit-exact with it; trig == 0
// ("native") uses the CUDA libm's cosf/sinf, which differ from the CPU's
// in the last ulp.
//
// Interface: plain C functions (ctypes, no PyTorch headers) that launch on
// the caller's stream, allocate nothing, and return cudaGetLastError().

#include "bvh16_trace.cuh"

namespace {

constexpr int kBlock = 128;
constexpr int kMaxTris = 256;  // PT_FUSED_MAX_TRIS
// the JAX package's multipliers: its second one is the int32
// -2073352565 = 0x846B268B (lowbias32 publishes 0x846CA68B); ported as is
constexpr uint32_t kH1 = 0x7FEB352Du;
constexpr uint32_t kH2 = 0x846B268Bu;
constexpr float kFar = 1.0e30f;
constexpr float kEpsT = 0.001f;
constexpr float kRayEps = 0.00001f;

using bvh16::max_nan;

__device__ __forceinline__ uint32_t hash32(uint32_t x) {
  x ^= x >> 16;
  x *= kH1;
  x ^= x >> 15;
  x *= kH2;
  x ^= x >> 16;
  return x;
}

// U[0,1) from hash(ray_id ^ hash(counter)) (pt_fused.py:72-75)
__device__ __forceinline__ float uniform01(uint32_t ray_id, uint32_t ctr) {
  const uint32_t h = hash32(ray_id ^ hash32(ctr));
  return (float)(h >> 8) * (1.0f / 16777216.0f);
}

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return ax * bx + ay * by + az * bz;
}

// x * (1 / max(|v|, eps)): a multiply, not a divide (pt_fused.py:86-89)
__device__ __forceinline__ float normalize3(float& x, float& y, float& z) {
  const float n = sqrtf(x * x + y * y + z * z);
  const float inv = 1.0f / max_nan(n, 1e-30f);
  x = x * inv;
  y = y * inv;
  z = z * inv;
  return n;
}

// (cos 2 pi u, sin 2 pi u): quadrant reduction + Taylor (trig == 1), or
// libm (trig == 0) (pt_fused.py:92-119)
__device__ __forceinline__ void sincos_2pi(float u, int trig, float& c_out,
                                           float& s_out) {
  if (trig == 0) {
    const float a = u * (float)(2.0 * 3.141592653589793);
    c_out = cosf(a);
    s_out = sinf(a);
    return;
  }
  const float t4 = u * 4.0f;
  const float q = floorf(t4);
  const float y = (t4 - q) * (float)(3.141592653589793 / 2.0);
  const float y2 = y * y;
  const float s =
      y * (1.0f + y2 * ((float)(-1.0 / 6.0) +
                        y2 * ((float)(1.0 / 120.0) +
                              y2 * ((float)(-1.0 / 5040.0) +
                                    y2 * (float)(1.0 / 362880.0)))));
  const float c =
      1.0f + y2 * (-0.5f + y2 * ((float)(1.0 / 24.0) +
                                 y2 * ((float)(-1.0 / 720.0) +
                                       y2 * (float)(1.0 / 40320.0))));
  const int qi = ((int)q) & 3;
  c_out = qi == 0 ? c : (qi == 1 ? -s : (qi == 2 ? -c : s));
  s_out = qi == 0 ? s : (qi == 1 ? c : (qi == 2 ? -s : -c));
}

struct PathState {
  float px, py, pz, dx, dy, dz, cr, cg, cb, wr, wg, wb;
  bool alive, do_em;
};

struct Material {
  float kdx, kdy, kdz, kex, key, kez, ksx, ksy, ksz, ktx, kty, ktz, ior,
      dissolve;
};

// 14 consecutive floats: [kd 3 | ke 3 | ks 3 | kt 3 | ior | dissolve]
__device__ __forceinline__ Material load_material(const float* r) {
  Material m;
  m.kdx = __ldg(r + 0); m.kdy = __ldg(r + 1); m.kdz = __ldg(r + 2);
  m.kex = __ldg(r + 3); m.key = __ldg(r + 4); m.kez = __ldg(r + 5);
  m.ksx = __ldg(r + 6); m.ksy = __ldg(r + 7); m.ksz = __ldg(r + 8);
  m.ktx = __ldg(r + 9); m.kty = __ldg(r + 10); m.ktz = __ldg(r + 11);
  m.ior = __ldg(r + 12); m.dissolve = __ldg(r + 13);
  return m;
}

struct Lights {
  const float* table;  // (L, 16): v0 3 | v1 3 | v2 3 | unit normal 3 | area | emission 3
  int n;
  float inv_n;         // f32(1 / L)
};

// One bounce's shading, NEE, emission and next direction given the
// closest-hit record (pt_fused.py:137-311, op for op). ``shadow(hx, hy,
// hz, dx, dy, dz, smax)`` answers whether [ray_eps, smax] is blocked; it is
// only asked for lanes with NEE active (the TPU traces the others with
// smax = 0, which can block nothing).
template <class Shadow>
__device__ __forceinline__ void bounce_step(
    uint32_t ray_id, uint32_t base, PathState& st, float t, bool hitf,
    bool alive, float nx0, float ny0, float nz0, const Material& m,
    const Lights& lights, int trig, int az_strata, int wedge,
    Shadow shadow) {
  const bool hit = hitf && alive;
  const float hx = st.px + st.dx * t;
  const float hy = st.py + st.dy * t;
  const float hz = st.pz + st.dz * t;
  const float dx = st.dx, dy = st.dy, dz = st.dz;

  const float onx = nx0, ony = ny0, onz = nz0;
  const bool facing = dot3(nx0, ny0, nz0, dx, dy, dz) > 0.0f;
  const float nx = facing ? -nx0 : nx0;
  const float ny = facing ? -ny0 : ny0;
  const float nz = facing ? -nz0 : nz0;

  const float inside = dot3(dx, dy, dz, onx, ony, onz) < 0.0f ? -1.0f : 1.0f;
  const float n1 = inside < 0.0f ? 1.0f / m.ior : m.ior;
  const float n2 = 1.0f / n1;
  float r0 = (n1 - n2) / (n1 + n2);
  r0 = r0 * r0;
  const float cth = 1.0f - dot3(-dx, -dy, -dz, nx, ny, nz);
  const float fres = r0 + (1.0f - r0) * cth * cth * cth * cth * cth;

  const float third = (float)(1.0 / 3.0);
  float rho_s = (m.ksx + m.ksy + m.ksz) * third * fres;
  float rho_d =
      (m.kdx + m.kdy + m.kdz) * third * (1.0f - fres) * (1.0f - m.dissolve);
  float rho_r = (m.ktx + m.kty + m.ktz) * third * (1.0f - fres) * m.dissolve;
  const float rho_e = (m.kex + m.key + m.kez) * third;
  const float total = rho_s + rho_d + rho_r + rho_e;
  const bool absorbed = total < 1e-4f;
  const float tot = absorbed ? 1.0f : total;
  rho_s = rho_s / tot;
  rho_d = rho_d / tot;
  rho_r = rho_r / tot;

  const float rnd = uniform01(ray_id, base + 1u);
  const bool pick_s = rnd < rho_s;
  const bool pick_d = !pick_s && (rnd < rho_s + rho_d);
  const bool pick_r = !pick_s && !pick_d && (rnd < rho_s + rho_d + rho_r);
  const bool pick_e = !pick_s && !pick_d && !pick_r;

  float cr = st.cr, cg = st.cg, cb = st.cb;
  float wr = st.wr, wg = st.wg, wb = st.wb;

  // ---- NEE (MeshLight::sampleDirect) ----
  if (lights.n > 0) {
    const int L = lights.n;
    float xi1 = uniform01(ray_id, base + 2u);
    const float xi2 = uniform01(ray_id, base + 3u);
    const int li = min((int)(xi1 * (float)L), L - 1);
    xi1 = xi1 * (float)L - (float)li;
    const float* lr = lights.table + (size_t)li * 16;
    const float l0x = __ldg(lr + 0), l0y = __ldg(lr + 1), l0z = __ldg(lr + 2);
    const float l1x = __ldg(lr + 3), l1y = __ldg(lr + 4), l1z = __ldg(lr + 5);
    const float l2x = __ldg(lr + 6), l2y = __ldg(lr + 7), l2z = __ldg(lr + 8);
    const float lnx = __ldg(lr + 9), lny = __ldg(lr + 10), lnz = __ldg(lr + 11);
    const float larea = __ldg(lr + 12);
    const float lex = __ldg(lr + 13), ley = __ldg(lr + 14), lez = __ldg(lr + 15);
    const float srt = sqrtf(xi1);
    const float c0 = 1.0f - srt;
    const float c1 = srt * (1.0f - xi2);
    const float c2 = srt * xi2;
    const float lpx = c0 * l0x + c1 * l1x + c2 * l2x;
    const float lpy = c0 * l0y + c1 * l1y + c2 * l2y;
    const float lpz = c0 * l0z + c1 * l1z + c2 * l2z;
    float ldx = lpx - hx, ldy = lpy - hy, ldz = lpz - hz;
    const float ldist = normalize3(ldx, ldy, ldz);
    const bool ok_l = ldist > 1e-6f;
    const float cos_l = max_nan(-dot3(ldx, ldy, ldz, lnx, lny, lnz), 0.0f);
    const float area_pdf = lights.inv_n / max_nan(larea, 1e-30f);
    const float lpdf = (ok_l && cos_l > 1e-12f)
                           ? area_pdf * ldist * ldist / max_nan(cos_l, 1e-30f)
                           : 0.0f;
    const float shadow_max = max_nan(ldist - kRayEps, 0.0f);
    const bool nee_active = hit && pick_d && (lpdf > 0.0f) && !absorbed;
    const bool blocked =
        nee_active && shadow(hx, hy, hz, ldx, ldy, ldz, shadow_max);
    const float cos_t = fabsf(dot3(ldx, ldy, ldz, nx, ny, nz));
    const float invpi = (float)(1.0 / 3.141592653589793);
    const float scale = cos_l * cos_t / max_nan(lpdf, 1e-30f);
    const bool gate = nee_active && !blocked;
    cr = cr + (gate ? m.kdx * invpi * lex * scale * wr : 0.0f);
    cg = cg + (gate ? m.kdy * invpi * ley * scale * wg : 0.0f);
    cb = cb + (gate ? m.kdz * invpi * lez * scale * wb : 0.0f);
  }

  // ---- emission ----
  const bool emit_gate = hit && pick_e && st.do_em && !absorbed;
  const float cos_e = max_nan(-dot3(onx, ony, onz, dx, dy, dz), 0.0f);
  cr = cr + (emit_gate ? cos_e * m.kex * wr : 0.0f);
  cg = cg + (emit_gate ? cos_e * m.key * wg : 0.0f);
  cb = cb + (emit_gate ? cos_e * m.kez * wb : 0.0f);

  // ---- next direction ----
  const float ddn = dot3(dx, dy, dz, nx, ny, nz);
  const float sx = dx - 2.0f * ddn * nx;
  const float sy = dy - 2.0f * ddn * ny;
  const float sz = dz - 2.0f * ddn * nz;

  const float u1 = uniform01(ray_id, base + 4u);
  float u2 = uniform01(ray_id, base + 5u);
  if (az_strata > 1) u2 = ((float)wedge + u2) / (float)az_strata;
  float cphi, sphi;
  sincos_2pi(u2, trig, cphi, sphi);
  const float rr = sqrtf(u1);
  const float cdx = rr * cphi;
  const float cdy = rr * sphi;
  const float cdz = sqrtf(max_nan(1.0f - u1, 0.0f));
  // revised ONB, both sign branches by select (pt_fused.py:122-134)
  const bool oneg = nz < 0.0f;
  const float a = 1.0f / (oneg ? 1.0f - nz : 1.0f + nz);
  const float bb = nx * ny * a;
  const float b1x = 1.0f - nx * nx * a;
  const float b1y = -bb;
  const float b1z = oneg ? nx : -nx;
  const float b2x = oneg ? bb : -bb;
  const float b2y = oneg ? ny * ny * a - 1.0f : 1.0f - ny * ny * a;
  const float b2z = -ny;
  const float ddx = b1x * cdx + b2x * cdy + nx * cdz;
  const float ddy = b1y * cdx + b2y * cdy + ny * cdz;
  const float ddz = b1z * cdx + b2z * cdy + nz * cdz;

  const float rnx = -inside * onx;
  const float rny = -inside * ony;
  const float rnz = -inside * onz;
  const float ndi = dot3(rnx, rny, rnz, dx, dy, dz);
  const float kk = 1.0f - n1 * n1 * (1.0f - ndi * ndi);
  const float kroot = sqrtf(max_nan(kk, 0.0f));
  const bool tir = kk < 0.0f;
  const float rxx = tir ? 0.0f : n1 * dx - (n1 * ndi + kroot) * rnx;
  const float rxy = tir ? 0.0f : n1 * dy - (n1 * ndi + kroot) * rny;
  const float rxz = tir ? 0.0f : n1 * dz - (n1 * ndi + kroot) * rnz;

  const float ndx = pick_s ? sx : (pick_d ? ddx : rxx);
  const float ndy = pick_s ? sy : (pick_d ? ddy : rxy);
  const float ndz = pick_s ? sz : (pick_d ? ddz : rxz);
  const float lwx = pick_s ? m.ksx : (pick_d ? m.kdx : m.ktx);
  const float lwy = pick_s ? m.ksy : (pick_d ? m.kdy : m.kty);
  const float lwz = pick_s ? m.ksz : (pick_d ? m.kdz : m.ktz);
  st.wr = wr * (hit ? lwx : 1.0f);
  st.wg = wg * (hit ? lwy : 1.0f);
  st.wb = wb * (hit ? lwz : 1.0f);
  st.cr = cr;
  st.cg = cg;
  st.cb = cb;
  st.alive = hit && !pick_e && !absorbed;
  st.do_em = hit ? !pick_d : st.do_em;
  st.px = hit ? hx : st.px;
  st.py = hit ? hy : st.py;
  st.pz = hit ? hz : st.pz;
  st.dx = hit ? ndx : dx;
  st.dy = hit ? ndy : dy;
  st.dz = hit ? ndz : dz;
}

struct Loop {
  uint32_t seed;
  int spp_iters;    // sample-loop iterations (spp / spp_lanes)
  int max_bounces;
  int rr_start;
  int trig;         // 0 native, 1 poly
  int az_strata;
  int spp_lanes;    // 1 for K3
};

// Russian roulette for bounce b (pt_fused.py:401-408); returns the
// lane's alive flag after it and scales the path weight.
__device__ __forceinline__ bool roulette(uint32_t ray_id, uint32_t base,
                                         int b, const Loop& lp,
                                         PathState& st) {
  const bool rr_apply = b > lp.rr_start;
  const float u_rr = uniform01(ray_id, base);
  const bool alive = st.alive && !(rr_apply && u_rr < 0.2f);
  const float rr_fac = rr_apply ? 1.25f : 1.0f;
  st.wr = st.wr * rr_fac;
  st.wg = st.wg * rr_fac;
  st.wb = st.wb * rr_fac;
  return alive;
}

// Brute Moller-Trumbore over tri rows [v0 | e1 | e2] (pt_fused.py:
// 351-383): accept tt in [tmin, t], replace on <= in prim order. With
// kAny it stops at the first accepted triangle (the shadow ray only
// needs whether there is one).
template <bool kAny>
__device__ __forceinline__ bool brute_trace(const float* tri, int F,
                                            float px, float py, float pz,
                                            float dx, float dy, float dz,
                                            float tmin, float& t, float& u,
                                            float& v, int& fid) {
  bool hit = false;
  for (int i = 0; i < F; ++i) {
    const float* r = tri + 9 * i;
    const float v0x = r[0], v0y = r[1], v0z = r[2];
    const float e1x = r[3], e1y = r[4], e1z = r[5];
    const float e2x = r[6], e2y = r[7], e2z = r[8];
    const float pvx = dy * e2z - dz * e2y;
    const float pvy = dz * e2x - dx * e2z;
    const float pvz = dx * e2y - dy * e2x;
    const float det = e1x * pvx + e1y * pvy + e1z * pvz;
    const float inv = 1.0f / (det == 0.0f ? 1.0f : det);
    const float tx = px - v0x, ty = py - v0y, tz = pz - v0z;
    const float uu = dot3(tx, ty, tz, pvx, pvy, pvz) * inv;
    const float qx = ty * e1z - tz * e1y;
    const float qy = tz * e1x - tx * e1z;
    const float qz = tx * e1y - ty * e1x;
    const float vv = dot3(dx, dy, dz, qx, qy, qz) * inv;
    const float tt = dot3(e2x, e2y, e2z, qx, qy, qz) * inv;
    const bool ok = det != 0.0f && uu >= 0.0f && vv >= 0.0f &&
                    uu + vv <= 1.0f && tt >= tmin && tt <= t;
    if (!ok) continue;
    hit = true;
    if (kAny) return true;
    t = tt;
    u = uu;
    v = vv;
    fid = i;
  }
  return hit;
}

struct BruteParams {
  const float* tri;    // (F, 9)
  int F;
  const float* face;   // (F, C), C = 17 or 26
  int C;
  Lights lights;
  const float* org;    // (R, 3)
  const float* dir;    // (R, 3)
  float* out;          // (R, 3) radiance sums over spp
  long long n;
  Loop lp;
};

__global__ void __launch_bounds__(kBlock) pt_brute_kernel(BruteParams p) {
  __shared__ float s_tri[kMaxTris * 9];
  for (int k = threadIdx.x; k < p.F * 9; k += kBlock) s_tri[k] = p.tri[k];
  __syncthreads();
  const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (i >= p.n) return;
  const uint32_t ray_id = (uint32_t)i;
  const Loop lp = p.lp;
  const float ox0 = p.org[3 * i], oy0 = p.org[3 * i + 1], oz0 = p.org[3 * i + 2];
  const float dx0 = p.dir[3 * i], dy0 = p.dir[3 * i + 1], dz0 = p.dir[3 * i + 2];

  float ar = 0.0f, ag = 0.0f, ab = 0.0f;
  for (int s = 0; s < lp.spp_iters; ++s) {
    PathState st{ox0, oy0, oz0, dx0, dy0, dz0, 0.0f, 0.0f, 0.0f,
                 1.0f, 1.0f, 1.0f, true, true};
    for (int b = 0; b < lp.max_bounces; ++b) {
      const uint32_t base =
          lp.seed +
          ((uint32_t)s * (uint32_t)(lp.max_bounces + 1) + (uint32_t)b) * 16u;
      const bool alive = roulette(ray_id, base, b, lp, st);
      float t = alive ? kFar : 0.0f, hu = 0.0f, hv = 0.0f;
      int fid = 0;  // a miss reads face row 0 (gated off below)
      const bool hitf = brute_trace<false>(s_tri, p.F, st.px, st.py, st.pz,
                                           st.dx, st.dy, st.dz, kEpsT, t, hu,
                                           hv, fid);
      const float* fr = p.face + (size_t)fid * p.C;
      float nx = __ldg(fr), ny = __ldg(fr + 1), nz = __ldg(fr + 2);
      if (p.C >= 26) {
        const float w0 = 1.0f - hu - hv;
        nx = w0 * __ldg(fr + 17) + hu * __ldg(fr + 20) + hv * __ldg(fr + 23);
        ny = w0 * __ldg(fr + 18) + hu * __ldg(fr + 21) + hv * __ldg(fr + 24);
        nz = w0 * __ldg(fr + 19) + hu * __ldg(fr + 22) + hv * __ldg(fr + 25);
        normalize3(nx, ny, nz);
      }
      const Material m = load_material(fr + 3);
      const int wedge = (s + b * 3) % lp.az_strata;
      auto shadow = [&](float hx, float hy, float hz, float ldx, float ldy,
                        float ldz, float smax) {
        float ts = smax, us, vs;
        int fs;
        return brute_trace<true>(s_tri, p.F, hx, hy, hz, ldx, ldy, ldz,
                                 kRayEps, ts, us, vs, fs);
      };
      bounce_step(ray_id, base, st, t, hitf, alive, nx, ny, nz, m, p.lights,
                  lp.trig, lp.az_strata, wedge, shadow);
    }
    ar = ar + st.cr;
    ag = ag + st.cg;
    ab = ab + st.cb;
  }
  p.out[3 * i] = ar;
  p.out[3 * i + 1] = ag;
  p.out[3 * i + 2] = ab;
}

struct BvhParams {
  const float* mat;    // (M, 14)
  int n_mats;
  Lights lights;
  const float* nodes;  // BVH16 node rows
  const float* leafs;  // leaf rows
  const float* aux;    // aux rows, parallel to the leaf rows
  const float* org;    // (RL, 3): each pixel ray spp_lanes times in a row
  const float* dir;
  float* out;          // (RL, 3) radiance sums over the lane's samples
  int* err;            // (1,) set when a trace stack overflows
  long long n;
  int stack_size;
  Loop lp;
};

__global__ void __launch_bounds__(kBlock) pt_bvh_kernel(BvhParams p) {
  const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (i >= p.n) return;
  const uint32_t ray_id = (uint32_t)i;
  const Loop lp = p.lp;
  const uint32_t lane_s = (uint32_t)(i % lp.spp_lanes);
  const float ox0 = p.org[3 * i], oy0 = p.org[3 * i + 1], oz0 = p.org[3 * i + 2];
  const float dx0 = p.dir[3 * i], dy0 = p.dir[3 * i + 1], dz0 = p.dir[3 * i + 2];

  float ar = 0.0f, ag = 0.0f, ab = 0.0f;
  for (int s = 0; s < lp.spp_iters; ++s) {
    // sample-major lanes: the lane's true sample index seeds its stream
    // (pt_fused.py:586-590); the wedge below stays per iteration
    const uint32_t s_eff = (uint32_t)s * (uint32_t)lp.spp_lanes + lane_s;
    PathState st{ox0, oy0, oz0, dx0, dy0, dz0, 0.0f, 0.0f, 0.0f,
                 1.0f, 1.0f, 1.0f, true, true};
    for (int b = 0; b < lp.max_bounces; ++b) {
      const uint32_t base =
          lp.seed +
          (s_eff * (uint32_t)(lp.max_bounces + 1) + (uint32_t)b) * 16u;
      const bool alive = roulette(ray_id, base, b, lp, st);
      const bvh16::Record rec = bvh16::trace<false, true>(
          p.nodes, p.leafs, p.aux, p.stack_size, p.err, st.px, st.py, st.pz,
          st.dx, st.dy, st.dz, kEpsT, alive ? kFar : 0.0f);
      // a miss reads material row 0 (gated off below); an id past the
      // table selects nothing, as the TPU's select loop does
      const int mid = rec.mid > 0 ? rec.mid : 0;
      Material m{};
      if (mid < p.n_mats) m = load_material(p.mat + (size_t)mid * 14);
      const int wedge = (s + b * 3) % lp.az_strata;
      auto shadow = [&](float hx, float hy, float hz, float ldx, float ldy,
                        float ldz, float smax) {
        return bvh16::trace<true, false>(p.nodes, p.leafs, nullptr,
                                         p.stack_size, p.err, hx, hy, hz, ldx,
                                         ldy, ldz, kRayEps, smax)
            .hit;
      };
      bounce_step(ray_id, base, st, rec.t, rec.hit, alive, rec.gx, rec.gy,
                  rec.gz, m, p.lights, lp.trig, lp.az_strata, wedge, shadow);
    }
    ar = ar + st.cr;
    ag = ag + st.cg;
    ab = ab + st.cb;
  }
  p.out[3 * i] = ar;
  p.out[3 * i + 1] = ag;
  p.out[3 * i + 2] = ab;
}

bool loop_ok(const Loop& lp) {
  return lp.spp_iters >= 0 && lp.max_bounces >= 0 && lp.az_strata >= 1 &&
         lp.spp_lanes >= 1 && (lp.trig == 0 || lp.trig == 1);
}

}  // namespace

extern "C" int nrt_pt_fused_brute(
    const float* tri, int F, const float* face, int C, const float* light,
    int n_lights, float inv_lights, const float* org, const float* dir,
    float* out, long long n, int seed, int spp, int max_bounces, int rr_start,
    int trig, int az_strata, void* stream) {
  const Loop lp{(uint32_t)seed, spp, max_bounces, rr_start, trig, az_strata, 1};
  if (F < 0 || F > kMaxTris || (C != 17 && C != 26) || n_lights < 0 ||
      !loop_ok(lp)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n <= 0) return 0;
  BruteParams p{tri, F, face, C, Lights{light, n_lights, inv_lights},
                org, dir, out, n, lp};
  const unsigned grid = (unsigned)((n + kBlock - 1) / kBlock);
  pt_brute_kernel<<<grid, kBlock, 0, reinterpret_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

extern "C" int nrt_pt_fused_bvh(
    const float* mat, int n_mats, const float* light, int n_lights,
    float inv_lights, const float* nodes, const float* leafs, const float* aux,
    const float* org, const float* dir, float* out, int* err, long long n,
    int stack_size, int seed, int spp_iters, int max_bounces, int rr_start,
    int trig, int az_strata, int spp_lanes, void* stream) {
  const Loop lp{(uint32_t)seed, spp_iters, max_bounces, rr_start,
                trig,           az_strata, spp_lanes};
  if (stack_size < 1 || stack_size > bvh16::kStackCap || n_mats < 0 ||
      n_lights < 0 || !loop_ok(lp)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n <= 0) return 0;
  BvhParams p{mat, n_mats, Lights{light, n_lights, inv_lights}, nodes, leafs,
              aux, org,    dir,    out, err, n, stack_size, lp};
  const unsigned grid = (unsigned)((n + kBlock - 1) / kBlock);
  pt_bvh_kernel<<<grid, kBlock, 0, reinterpret_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
