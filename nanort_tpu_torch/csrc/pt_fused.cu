// Fused path-tracing megakernels for NVIDIA Hopper (sm_90a): a whole
// spp x bounce render in one launch.
//
// Replaces two TPU kernels of nanort_tpu/models/pt_fused.py:
//   * K3, _pt_kernel (brute-force Moller-Trumbore sweep over <= 256
//     triangles): pt_brute_kernel below (persistent lanes, one flat
//     (sample, bounce) loop a lane);
//   * K4, _pt_kernel_bvh (the same loop, tracing a BVH16 with
//     traverse/fused_trace.py::make_tracer, K2): pt_bvh_pool_kernel below,
//     which calls bvh16::trace (bvh16_trace.cuh).
// All share one __device__ bounce_shade, the counterpart of _bounce_step
// (pt_fused.py:137-311) up to its NEE shadow ray: Russian roulette after
// bounce rr_start, lobe pick, next-event estimation, emission, cosine /
// specular / refracted next direction, all driven by the TPU kernels'
// counter-based lowbias32 generator, ported bit for bit in uint32
// arithmetic (the counter base seed + (s_eff * (max_bounces + 1) + b) * 16
// wraps mod 2^32 as the TPU's int32 does). bounce_step adds the shadow
// ray's answer for K3, which traces it in the same thread.
//
// Layout: K3 runs persistent lanes, one a thread, that claim pixels and
// run each pixel's spp paths in registers, bounce by bounce, and write the
// pixel's radiance SUM (R, 3) once (see "K3" below). K4 runs each (lane,
// sample) path, a lane being one sample-major copy of a pixel ray, from a
// pool in shared memory and writes its radiance to (spp_iters, R, 3) (see
// "pool" below). The wrapper (models/pt_fused.py) sums the samples in
// order and divides by spp.
//
// What bounds them on this card:
//   * K3: the triangle sweeps (closest hit, then the shadow ray, ~50 flops
//     a triangle over all F of them); the table sits in shared memory and
//     every lane of a warp reads the same row at once (a broadcast), so
//     the sweeps run at the FP32 issue rate. The design runs them for live
//     bounces only (see "K3" below).
//   * K4: divergent bounce rays and dependent row fetches inside K2 (see
//     bvh16_trace.cuh). Were a warp's lanes neighbouring pixels and sample
//     copies, after the first diffuse bounce the warp would walk the union
//     of 32 unrelated subtrees, and a lane whose path had ended would idle
//     until the warp's longest path ended. The pooled kernel refills ended
//     paths and sorts its pool by origin and direction before every trace,
//     so a warp's 32 rays are alike and all live.
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

// What one bounce leaves behind (bounce_shade): the path state after it
// with the NEE shadow ray blocked, the radiance with it unblocked, and
// the shadow query from the hit point (hx, hy, hz) that decides between
// the two. ``nee`` false: there is no query, and ``next`` is final.
struct Shade {
  PathState next;
  float ur, ug, ub;
  float hx, hy, hz, ldx, ldy, ldz, smax;
  bool nee;
};

// One bounce's shading, NEE, emission and next direction given the
// closest-hit record (pt_fused.py:137-311, op for op), up to the NEE
// shadow ray, which the caller answers (bounce_step, or the pooled
// kernel's shadow pass). The radiance is carried both ways: with the
// shadow ray blocked, c + 0 then + emission, and unblocked, c + NEE then
// + emission: the same two additions in the same order as the one-pass
// ``c + (gate ? nee : 0) + emission``.
__device__ __forceinline__ Shade bounce_shade(
    uint32_t ray_id, uint32_t base, const PathState& st, float t, bool hitf,
    bool alive, float nx0, float ny0, float nz0, const Material& m,
    const Lights& lights, int trig, int az_strata, int wedge) {
  Shade o;
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
  float ur = cr, ug = cg, ub = cb;
  const float wr = st.wr, wg = st.wg, wb = st.wb;
  o.nee = false;
  o.hx = hx;
  o.hy = hy;
  o.hz = hz;
  o.ldx = o.ldy = o.ldz = o.smax = 0.0f;

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
    const float cos_t = fabsf(dot3(ldx, ldy, ldz, nx, ny, nz));
    const float invpi = (float)(1.0 / 3.141592653589793);
    const float scale = cos_l * cos_t / max_nan(lpdf, 1e-30f);
    // the gate is nee_active && !blocked: blocked adds 0, unblocked adds
    // the light's term (an inactive NEE adds 0 either way)
    ur = cr + (nee_active ? m.kdx * invpi * lex * scale * wr : 0.0f);
    ug = cg + (nee_active ? m.kdy * invpi * ley * scale * wg : 0.0f);
    ub = cb + (nee_active ? m.kdz * invpi * lez * scale * wb : 0.0f);
    cr = cr + 0.0f;
    cg = cg + 0.0f;
    cb = cb + 0.0f;
    o.nee = nee_active;
    o.ldx = ldx;
    o.ldy = ldy;
    o.ldz = ldz;
    o.smax = shadow_max;
  }

  // ---- emission ----
  const bool emit_gate = hit && pick_e && st.do_em && !absorbed;
  const float cos_e = max_nan(-dot3(onx, ony, onz, dx, dy, dz), 0.0f);
  const float er = emit_gate ? cos_e * m.kex * wr : 0.0f;
  const float eg = emit_gate ? cos_e * m.key * wg : 0.0f;
  const float eb = emit_gate ? cos_e * m.kez * wb : 0.0f;
  o.next.cr = cr + er;
  o.next.cg = cg + eg;
  o.next.cb = cb + eb;
  o.ur = ur + er;
  o.ug = ug + eg;
  o.ub = ub + eb;

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
  o.next.wr = wr * (hit ? lwx : 1.0f);
  o.next.wg = wg * (hit ? lwy : 1.0f);
  o.next.wb = wb * (hit ? lwz : 1.0f);
  o.next.alive = hit && !pick_e && !absorbed;
  o.next.do_em = hit ? !pick_d : st.do_em;
  o.next.px = hit ? hx : st.px;
  o.next.py = hit ? hy : st.py;
  o.next.pz = hit ? hz : st.pz;
  o.next.dx = hit ? ndx : dx;
  o.next.dy = hit ? ndy : dy;
  o.next.dz = hit ? ndz : dz;
  return o;
}

// One whole bounce: bounce_shade, then ``shadow(hx, hy, hz, dx, dy, dz,
// smax)`` answers whether [ray_eps, smax] is blocked. It is only asked
// for lanes with NEE active (the TPU traces the others with smax = 0,
// which can block nothing).
template <class Shadow>
__device__ __forceinline__ void bounce_step(
    uint32_t ray_id, uint32_t base, PathState& st, float t, bool hitf,
    bool alive, float nx0, float ny0, float nz0, const Material& m,
    const Lights& lights, int trig, int az_strata, int wedge,
    Shadow shadow) {
  const Shade o = bounce_shade(ray_id, base, st, t, hitf, alive, nx0, ny0,
                               nz0, m, lights, trig, az_strata, wedge);
  const bool blocked =
      o.nee && shadow(o.hx, o.hy, o.hz, o.ldx, o.ldy, o.ldz, o.smax);
  st = o.next;
  if (o.nee && !blocked) {
    st.cr = o.ur;
    st.cg = o.ug;
    st.cb = o.ub;
  }
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

struct BvhParams {
  const float* mat;    // (M, 14)
  int n_mats;
  Lights lights;
  const float* nodes;  // BVH16 node rows
  const float* leafs;  // leaf rows
  const float* aux;    // aux rows, parallel to the leaf rows
  const float* org;    // (RL, 3): each pixel ray spp_lanes times in a row
  const float* dir;
  float* out;          // (iters, RL, 3): one path's radiance each
  int* err;            // (1,) set when a trace stack overflows
  long long n;         // RL
  int stack_size;
  Loop lp;
};

// The material row of a closest-hit record: a miss reads row 0 (gated
// off by bounce_shade); an id past the table selects nothing, as the
// TPU's select loop does.
__device__ __forceinline__ Material hit_material(const BvhParams& p,
                                                 const bvh16::Record& rec) {
  const int mid = rec.mid > 0 ? rec.mid : 0;
  Material m{};
  if (mid < p.n_mats) m = load_material(p.mat + (size_t)mid * 14);
  return m;
}

__device__ __forceinline__ uint32_t counter_base(const Loop& lp,
                                                 uint32_t s_eff, int b) {
  return lp.seed +
         (s_eff * (uint32_t)(lp.max_bounces + 1) + (uint32_t)b) * 16u;
}

// ------------------------------------------------------------- K3
//
// One lane a thread, persistent: a lane claims a pixel, runs its spp
// paths one after another and writes the pixel's sum once, then claims
// the next pixel. Its loop is flat over (sample, bounce): each iteration
// is one live bounce of the lane's current path (the closest-hit sweep,
// bounce_shade, the shadow sweep where NEE is active), and brute_advance
// then moves the lane to its next live bounce: it rolls the next bounce's
// roulette, ends a path that roulette killed, that bounce_shade left dead
// (a miss, an emitter pick, absorption) or that ran max_bounces bounces,
// adds the ended path's radiance to the pixel's sum, starts the next
// sample, and writes the pixel once all spp are in; the lane then claims
// another.
//
// Why every bit stays: the random stream is a counter hash of (pixel,
// sample, bounce) alone, and a dead bounce of the TPU's fixed spp x
// max_bounces nest adds exactly +0 to a radiance that is +0 or more
// (hit = hitf && alive is false, so the NEE and emission terms are 0);
// only the weights move, and nothing reads them after. So ending a path
// when it dies leaves each sample's radiance as it was, and one thread
// still adds a pixel's samples in order.
//
// What bounds it on this card: the triangle sweeps, ~50 FP32 operations
// a triangle (the operations bound). The design spends them on live
// bounces only (on config B's view about one in five of the nest's
// bounces is live), keeps a warp's 32 lanes in the same bounce body (each
// on its own (sample, bounce)) and converged (the claims are taken where
// all 32 lanes meet), lets no lane wait for a slower pixel, and reads a
// triangle as three 16-byte shared-memory broadcasts, [v0 | e1 | e2] each
// padded to a float4.

struct BruteParams {
  const float* tri;    // (F, 9) [v0 | e1 | e2]
  int F;
  const float* face;   // (F, C), C = 17 or 26
  int C;
  Lights lights;
  const float* org;    // (R, 3)
  const float* dir;    // (R, 3)
  float* out;          // (R, 3) radiance sums over spp
  unsigned long long* scratch;  // (3,) zeros: pixels claimed, closest-hit
                                // sweeps, shadow sweeps
  long long n;
  Loop lp;
};

// Brute Moller-Trumbore over float4 rows [v0 | e1 | e2] (pt_fused.py:
// 351-383): accept tt in [tmin, t], replace on <= in prim order. With
// kAny it stops at the first accepted triangle (the shadow ray only
// needs whether there is one).
template <bool kAny>
__device__ __forceinline__ bool brute_trace(const float4* tri, int F,
                                            float px, float py, float pz,
                                            float dx, float dy, float dz,
                                            float tmin, float& t, float& u,
                                            float& v, int& fid) {
  bool hit = false;
  for (int i = 0; i < F; ++i) {
    const float4 v0 = tri[3 * i], e1 = tri[3 * i + 1], e2 = tri[3 * i + 2];
    const float pvx = dy * e2.z - dz * e2.y;
    const float pvy = dz * e2.x - dx * e2.z;
    const float pvz = dx * e2.y - dy * e2.x;
    const float det = e1.x * pvx + e1.y * pvy + e1.z * pvz;
    const float inv = 1.0f / (det == 0.0f ? 1.0f : det);
    const float tx = px - v0.x, ty = py - v0.y, tz = pz - v0.z;
    const float uu = dot3(tx, ty, tz, pvx, pvy, pvz) * inv;
    const float qx = ty * e1.z - tz * e1.y;
    const float qy = tz * e1.x - tx * e1.z;
    const float qz = tx * e1.y - ty * e1.x;
    const float vv = dot3(dx, dy, dz, qx, qy, qz) * inv;
    const float tt = dot3(e2.x, e2.y, e2.z, qx, qy, qz) * inv;
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

// The (F, 9) table as 3F float4 rows, [v0 | e1 | e2] each with a zero pad
// (this thread's share; the caller synchronises).
__device__ __forceinline__ void brute_load_rows(const BruteParams& p,
                                                float4* rows) {
  for (int k = threadIdx.x; k < 3 * p.F; k += kBlock) {
    rows[k] = make_float4(__ldg(p.tri + 3 * k), __ldg(p.tri + 3 * k + 1),
                          __ldg(p.tri + 3 * k + 2), 0.0f);
  }
}

// One lane: its pixel, the sample and bounce of its current path, the
// path, the pixel's running sum, and its sweeps so far.
struct BruteLane {
  long long pix;
  int s, b;
  PathState st;
  float ar, ag, ab;
  unsigned closest, shadows;
};

__device__ __forceinline__ void brute_start_path(const BruteParams& p,
                                                 BruteLane& l) {
  const float* o = p.org + 3 * l.pix;
  const float* d = p.dir + 3 * l.pix;
  l.st = PathState{__ldg(o),    __ldg(o + 1), __ldg(o + 2), __ldg(d),
                   __ldg(d + 1), __ldg(d + 2), 0.0f,         0.0f,
                   0.0f,         1.0f,         1.0f,         1.0f,
                   true,         true};
  l.b = 0;
}

// Lane l takes pixel ``pix``: its sum starts at 0, its first path at
// the pixel's camera ray.
__device__ __forceinline__ void brute_take(const BruteParams& p, BruteLane& l,
                                           long long pix) {
  l.pix = pix;
  l.s = 0;
  l.ar = l.ag = l.ab = 0.0f;
  brute_start_path(p, l);
}

// Moves lane l to its next live bounce (see the note above): true when it
// holds one, false when its pixel has all spp samples and is written.
__device__ __forceinline__ bool brute_advance(const BruteParams& p,
                                              BruteLane& l) {
  const Loop& lp = p.lp;
  for (;;) {
    if (l.s >= lp.spp_iters) {
      float* o = p.out + 3 * l.pix;
      o[0] = l.ar;
      o[1] = l.ag;
      o[2] = l.ab;
      return false;
    }
    // roulette returns false for a path that is already dead
    if (l.b < lp.max_bounces &&
        roulette((uint32_t)l.pix, counter_base(lp, (uint32_t)l.s, l.b), l.b,
                 lp, l.st)) {
      return true;
    }
    l.ar = l.ar + l.st.cr;
    l.ag = l.ag + l.st.cg;
    l.ab = l.ab + l.st.cb;
    ++l.s;
    brute_start_path(p, l);
  }
}

// One live bounce of lane l (roulette already rolled): the closest-hit
// sweep, its shading normal and material, bounce_shade and the shadow
// sweep where NEE is active (pt_fused.py:409-461 for one (s, b)).
__device__ __forceinline__ void brute_bounce(const BruteParams& p,
                                             const float4* rows,
                                             BruteLane& l) {
  const Loop& lp = p.lp;
  const uint32_t ray_id = (uint32_t)l.pix;
  const uint32_t base = counter_base(lp, (uint32_t)l.s, l.b);
  PathState& st = l.st;
  float t = kFar, hu = 0.0f, hv = 0.0f;
  int fid = 0;  // a miss reads face row 0 (gated off by bounce_shade)
  const bool hitf = brute_trace<false>(rows, p.F, st.px, st.py, st.pz, st.dx,
                                       st.dy, st.dz, kEpsT, t, hu, hv, fid);
  ++l.closest;
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
  const int wedge = (l.s + l.b * 3) % lp.az_strata;
  auto shadow = [&](float hx, float hy, float hz, float ldx, float ldy,
                    float ldz, float smax) {
    float ts = smax, us, vs;
    int fs;
    ++l.shadows;
    return brute_trace<true>(rows, p.F, hx, hy, hz, ldx, ldy, ldz, kRayEps,
                             ts, us, vs, fs);
  };
  bounce_step(ray_id, base, st, t, hitf, true, nx, ny, nz, m, p.lights,
              lp.trig, lp.az_strata, wedge, shadow);
  ++l.b;
}

// The next pixel for each lane in ``need`` (a ballot that all 32 lanes of
// the warp take): one atomicAdd by lane 0, ranks in lane order.
__device__ __forceinline__ long long claim_pixels(unsigned long long* counter,
                                                  unsigned need) {
  const unsigned lane = threadIdx.x & 31u;
  unsigned long long base = 0;
  if (lane == 0) base = atomicAdd(counter, (unsigned long long)__popc(need));
  base = __shfl_sync(0xffffffffu, base, 0);
  return (long long)(base + (unsigned)__popc(need & ((1u << lane) - 1u)));
}

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// At most 80 registers a thread: 6 blocks an SM (82 unbounded fit 5; no
// spill either way), 2-3% faster on config B.
__global__ void __launch_bounds__(kBlock, 6) pt_brute_kernel(BruteParams p) {
  __shared__ float4 rows[kMaxTris * 3];
  brute_load_rows(p, rows);
  __syncthreads();
  BruteLane l;
  l.closest = l.shadows = 0u;
  // Every iteration the warp's 32 lanes meet: those without a live bounce
  // claim pixels (one atomicAdd a warp) until each holds one or none is
  // left, then every lane that holds one runs it. (Claiming in the
  // divergent branch where a lane's pixel ends ran 1.4x slower.)
  bool live = false, done = false;
  for (;;) {
    for (;;) {
      const unsigned need = __ballot_sync(0xffffffffu, !live && !done);
      if (need == 0u) break;
      const long long pix = claim_pixels(p.scratch, need);
      if (!live && !done) {
        if (pix >= p.n) {
          done = true;
        } else {
          brute_take(p, l, pix);
          live = brute_advance(p, l);
        }
      }
    }
    if (__all_sync(0xffffffffu, done)) break;
    if (live) {
      brute_bounce(p, rows, l);
      live = brute_advance(p, l);
    }
  }
  const unsigned long long c = warp_sum(l.closest), s = warp_sum(l.shadows);
  if ((threadIdx.x & 31u) == 0) {
    atomicAdd(p.scratch + 1, c);
    atomicAdd(p.scratch + 2, s);
  }
}

// ------------------------------------------------------------ pool
//
// The pooled schedule (the default). A work item is one path: (lane,
// s), item j = (s - s0) * RL + lane for the launch's sample iterations
// [s0, s0 + iters), so items run in lane order (the lanes of one pixel,
// then the next pixel of its tile) and each writes its radiance once, to
// out[s - s0][lane]; the wrapper adds out to its running sums over s in
// order, as the plain version sums a lane's samples. Every random number
// depends on (lane, s, b) alone, so the order in which paths run, and
// how the iterations are split between launches, changes no bit.
//
// One persistent block an SM (512 threads) keeps 2,048 paths in shared
// memory and runs waves until the items run out: roulette every path,
// refill the free slots from a global item counter (one chunk a block),
// key every live path with the megabatch route's ray-sort key (origin
// Morton code over the root box, then the direction octant; ray_sort.py),
// sort the slots by key with a stable radix sort in shared memory, and
// trace the k-th live path in sorted order: closest hit, then
// bounce_shade. The NEE shadow rays are keyed and sorted the same way and
// traced; each answer picks the slot's blocked or unblocked radiance. A
// path ends at a miss, an emitter pick, absorption, roulette or
// max_bounces; its slot takes the next item in the next wave, so warps
// stay full until the items run out.
//
// What bounds it: lane divergence inside the traversal (a warp waits for
// its longest walk) and dependent node fetches. The sorts (both the
// closest-hit and the shadow rays) and warps taking 32-ray chunks from a
// counter each bought 1.13-1.31x on the midscale render (PERF.md); the
// larger the pool the more coherence: 2,048 slots of 101 bytes fill the 227 KB
// a block may hold, and 512 threads at <= 128 registers fill the
// register file. A path's state stays in shared memory between waves;
// registers hold only the ray in flight.

constexpr int kPoolThreads = 512;
constexpr int kPoolWarps = kPoolThreads / 32;
constexpr int kSlotsPerThread = 4;
constexpr int kPoolSlots = kPoolThreads * kSlotsPerThread;
constexpr int kGroups = kPoolSlots / 32;       // 32 slots a radix group
constexpr int kRadixBits = 5;
constexpr int kRadix = 1 << kRadixBits;
constexpr int kCounts = kRadix * kGroups;
constexpr int kScanPer = kCounts / kPoolThreads;
constexpr int kKeyBits = 19;                   // dead . Morton 15 . octant 3
constexpr uint32_t kDeadKey = 1u << 18;
static_assert(kCounts % kPoolThreads == 0 && kPoolSlots <= 65536,
              "pool shape");

// the kernel's counters (the wrapper's ``stats``, int64): the item
// counter, then totals over the blocks
enum Stat { kItems = 0, kWaves, kPaths, kClosest, kShadows, kBlocks, kNumStats };

// slot flags
constexpr uint8_t kOcc = 1;      // holds a live path (alive, b < max_bounces)
constexpr uint8_t kDoEm = 2;     // the path's do_em
constexpr uint8_t kShadow = 4;   // a shadow query waits in ur.. / l* / sm
constexpr uint8_t kEnd = 8;      // the path ends once its query is answered

struct Pool {
  float px[kPoolSlots], py[kPoolSlots], pz[kPoolSlots];
  float dx[kPoolSlots], dy[kPoolSlots], dz[kPoolSlots];
  float cr[kPoolSlots], cg[kPoolSlots], cb[kPoolSlots];
  float wr[kPoolSlots], wg[kPoolSlots], wb[kPoolSlots];
  // the pending shadow query: unblocked radiance, direction, tmax
  float ur[kPoolSlots], ug[kPoolSlots], ub[kPoolSlots];
  float lx[kPoolSlots], ly[kPoolSlots], lz[kPoolSlots], sm[kPoolSlots];
  int lane[kPoolSlots], s[kPoolSlots], b[kPoolSlots];
  uint8_t flags[kPoolSlots];
  uint32_t key[2][kPoolSlots];
  uint16_t idx[2][kPoolSlots];
  int cnt[kCounts];
  int wsum[kPoolWarps];
  unsigned long long item0;
  int nfree, ngot, ticket, nlive, nshadow, chunk_c, chunk_s;
  bool exhausted;
  unsigned long long stat[kNumStats];  // this block's totals
};

struct PoolParams {
  BvhParams bp;
  unsigned long long* stats;  // (kNumStats,), see Stat
  const float* box;  // (6,): the root box's lo, max(hi - lo, 1e-30)
  int s0, iters;     // the launch's sample iterations [s0, s0 + iters)
  int chunk;         // most items a block claims at once
};

struct SortBox {
  float lox, loy, loz, ex, ey, ez;
};

__device__ __forceinline__ uint32_t expand_bits(uint32_t v) {
  v = (v * 0x00010001u) & 0xFF0000FFu;
  v = (v * 0x00000101u) & 0x0F00F00Fu;
  v = (v * 0x00000011u) & 0xC30C30C3u;
  v = (v * 0x00000005u) & 0x49249249u;
  return v;
}

// cell of one axis on the 32^3 grid: clamp to [0, 31], NaN to 0
__device__ __forceinline__ uint32_t grid_cell(float o, float lo, float ext) {
  const float c = (o - lo) / ext * 32.0f;
  if (c != c) return 0u;
  return (uint32_t)(int)fminf(fmaxf(c, 0.0f), 31.0f);
}

// ray_sort.ray_sort_keys (octant_major False) without its dead bit:
// Morton code of the origin's cell, then the direction octant
__device__ __forceinline__ uint32_t ray_key(const SortBox& q, float ox,
                                            float oy, float oz, float dx,
                                            float dy, float dz) {
  const uint32_t morton = (expand_bits(grid_cell(ox, q.lox, q.ex)) << 2) |
                          (expand_bits(grid_cell(oy, q.loy, q.ey)) << 1) |
                          expand_bits(grid_cell(oz, q.loz, q.ez));
  const uint32_t oct = (dx < 0.0f ? 4u : 0u) | (dy < 0.0f ? 2u : 0u) |
                       (dz < 0.0f ? 1u : 0u);
  return (morton << 3) | oct;
}

// Exclusive prefix sum of sh.cnt in place (all threads).
__device__ __forceinline__ void scan_counts(Pool& sh) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int v[kScanPer];
  int sum = 0;
#pragma unroll
  for (int j = 0; j < kScanPer; ++j) {
    v[j] = sh.cnt[tid * kScanPer + j];
    sum += v[j];
  }
  int inc = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) sh.wsum[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kPoolWarps ? sh.wsum[lane] : 0;
    int wi = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, wi, o);
      if (lane >= o) wi += y;
    }
    if (lane < kPoolWarps) sh.wsum[lane] = wi - w;
  }
  __syncthreads();
  int run = inc - sum + sh.wsum[warp];
#pragma unroll
  for (int j = 0; j < kScanPer; ++j) {
    sh.cnt[tid * kScanPer + j] = run;
    run += v[j];
  }
  __syncthreads();
}

// Stable LSD radix sort of the slots' (key, slot) pairs in sh.key[0] /
// sh.idx[0] (slot k at k) over all kKeyBits key bits; dead slots (bit 18)
// go to the tail. Each pass is a counting sort: per 32-slot group the
// slots of each digit are ranked with __match_any_sync, the (digit, group)
// counts are scanned in digit-major order, and every pair scatters to its
// digit's base + rank. Returns the buffer holding the result.
__device__ __forceinline__ int sort_slots(Pool& sh) {
  constexpr int kPasses = (kKeyBits + kRadixBits - 1) / kRadixBits;
  const int tid = threadIdx.x;
  const uint32_t below = (1u << (tid & 31)) - 1u;
  int cur = 0;
  for (int pass = 0; pass < kPasses; ++pass) {
    const int shift = pass * kRadixBits;
    for (int j = tid; j < kCounts; j += kPoolThreads) sh.cnt[j] = 0;
    __syncthreads();
    uint32_t kk[kSlotsPerThread];
    int dg[kSlotsPerThread], rk[kSlotsPerThread];
#pragma unroll
    for (int r = 0; r < kSlotsPerThread; ++r) {
      const int k = r * kPoolThreads + tid;
      kk[r] = sh.key[cur][k];
      dg[r] = (int)((kk[r] >> shift) & (kRadix - 1));
      const uint32_t peers = __match_any_sync(0xffffffffu, dg[r]);
      rk[r] = __popc(peers & below);
      if (rk[r] == 0) sh.cnt[dg[r] * kGroups + (k >> 5)] = __popc(peers);
    }
    __syncthreads();
    scan_counts(sh);
#pragma unroll
    for (int r = 0; r < kSlotsPerThread; ++r) {
      const int k = r * kPoolThreads + tid;
      const int dst = sh.cnt[dg[r] * kGroups + (k >> 5)] + rk[r];
      sh.key[cur ^ 1][dst] = kk[r];
      sh.idx[cur ^ 1][dst] = sh.idx[cur][k];
    }
    __syncthreads();
    cur ^= 1;
  }
  return cur;
}

// The 32-ray chunks of a wave's n sorted rays: a warp takes the next one
// from ``counter``; ``fn(k)`` runs for each ray k < n, in the lane that
// owns it.
template <class Fn>
__device__ __forceinline__ void for_chunks(int n, int& counter, Fn&& fn) {
  const int lane_id = threadIdx.x & 31;
  for (;;) {
    int c = 0;
    if (lane_id == 0) c = atomicAdd(&counter, 1);
    c = __shfl_sync(0xffffffffu, c, 0);
    if (c * 32 >= n) break;
    const int k = c * 32 + lane_id;
    if (k < n) fn(k);
  }
}

__device__ __forceinline__ void finish_path(const PoolParams& q, Pool& sh,
                                            int i) {
  float* o = q.bp.out +
             ((size_t)(sh.s[i] - q.s0) * (size_t)q.bp.n + sh.lane[i]) * 3;
  o[0] = sh.cr[i];
  o[1] = sh.cg[i];
  o[2] = sh.cb[i];
  sh.flags[i] = 0;
}

// Russian roulette for slot i's bounce b (as ``roulette``): ends the
// path, or scales its weight and keeps it.
__device__ __forceinline__ void pool_roulette(const PoolParams& q, Pool& sh,
                                              int i) {
  const Loop& lp = q.bp.lp;
  const uint32_t lane = (uint32_t)sh.lane[i];
  const uint32_t s_eff = (uint32_t)sh.s[i] * (uint32_t)lp.spp_lanes +
                         lane % (uint32_t)lp.spp_lanes;
  const int b = sh.b[i];
  const uint32_t base = counter_base(lp, s_eff, b);
  const bool rr_apply = b > lp.rr_start;
  const float u_rr = uniform01(lane, base);
  const float rr_fac = rr_apply ? 1.25f : 1.0f;
  sh.wr[i] = sh.wr[i] * rr_fac;
  sh.wg[i] = sh.wg[i] * rr_fac;
  sh.wb[i] = sh.wb[i] * rr_fac;
  if (rr_apply && u_rr < 0.2f) finish_path(q, sh, i);
}

__global__ void __launch_bounds__(kPoolThreads, 1)
    pt_bvh_pool_kernel(PoolParams q) {
  extern __shared__ __align__(16) unsigned char smem[];
  Pool& sh = *reinterpret_cast<Pool*>(smem);
  const BvhParams& p = q.bp;
  const Loop& lp = p.lp;
  const int tid = threadIdx.x, lane_id = tid & 31;
  const unsigned long long total =
      (unsigned long long)p.n * (unsigned long long)q.iters;
  const SortBox box{__ldg(q.box), __ldg(q.box + 1), __ldg(q.box + 2),
                    __ldg(q.box + 3), __ldg(q.box + 4), __ldg(q.box + 5)};

  for (int k = tid; k < kPoolSlots; k += kPoolThreads) sh.flags[k] = 0;
  for (int k = tid; k < kNumStats; k += kPoolThreads) sh.stat[k] = 0ull;
  if (tid == 0) sh.exhausted = false;
  __syncthreads();

  for (;;) {
    // ---- roulette the live paths; count the free slots (every thread
    // has read the last wave's counters before they are reset)
    __syncthreads();
    if (tid == 0) {
      sh.nfree = 0;
      sh.ticket = 0;
      sh.nlive = 0;
      sh.nshadow = 0;
      sh.chunk_c = 0;
      sh.chunk_s = 0;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kSlotsPerThread; ++r) {
      const int i = r * kPoolThreads + tid;
      if (sh.flags[i] & kOcc) pool_roulette(q, sh, i);
      const unsigned free_mask =
          __ballot_sync(0xffffffffu, !(sh.flags[i] & kOcc));
      if (lane_id == 0 && free_mask) atomicAdd(&sh.nfree, __popc(free_mask));
    }
    __syncthreads();
    // ---- claim a chunk of items for the free slots
    if (tid == 0) {
      sh.ngot = 0;
      if (sh.nfree > 0 && !sh.exhausted) {
        const int want = min(sh.nfree, q.chunk);
        const unsigned long long i0 =
            atomicAdd(q.stats + kItems, (unsigned long long)want);
        sh.item0 = i0;
        if (i0 < total) {
          const unsigned long long left = total - i0;
          sh.ngot = left < (unsigned long long)want ? (int)left : want;
        }
        if (sh.ngot < want) sh.exhausted = true;
        sh.stat[kPaths] += (unsigned long long)sh.ngot;
      }
    }
    __syncthreads();
    // ---- start new paths in the free slots; key every slot
#pragma unroll
    for (int r = 0; r < kSlotsPerThread; ++r) {
      const int i = r * kPoolThreads + tid;
      if (!(sh.flags[i] & kOcc)) {
        const int tk = atomicAdd(&sh.ticket, 1);
        if (tk < sh.ngot) {
          const unsigned long long item = sh.item0 + (unsigned long long)tk;
          const long long lane = (long long)(item % (unsigned long long)p.n);
          sh.lane[i] = (int)lane;
          sh.s[i] = q.s0 + (int)(item / (unsigned long long)p.n);
          sh.b[i] = 0;
          sh.px[i] = p.org[3 * lane];
          sh.py[i] = p.org[3 * lane + 1];
          sh.pz[i] = p.org[3 * lane + 2];
          sh.dx[i] = p.dir[3 * lane];
          sh.dy[i] = p.dir[3 * lane + 1];
          sh.dz[i] = p.dir[3 * lane + 2];
          sh.cr[i] = sh.cg[i] = sh.cb[i] = 0.0f;
          sh.wr[i] = sh.wg[i] = sh.wb[i] = 1.0f;
          sh.flags[i] = kOcc | kDoEm;
          if (lp.max_bounces == 0) {
            finish_path(q, sh, i);
          } else {
            pool_roulette(q, sh, i);
          }
        }
      }
      const bool live = (sh.flags[i] & kOcc) != 0;
      sh.key[0][i] = live ? ray_key(box, sh.px[i], sh.py[i], sh.pz[i],
                                    sh.dx[i], sh.dy[i], sh.dz[i])
                          : kDeadKey;
      sh.idx[0][i] = (uint16_t)i;
      const unsigned live_mask = __ballot_sync(0xffffffffu, live);
      if (lane_id == 0 && live_mask) atomicAdd(&sh.nlive, __popc(live_mask));
    }
    __syncthreads();
    const int nlive = sh.nlive;
    if (nlive == 0) {
      if (sh.ngot == 0) break;  // every item claimed, every path done
      continue;                 // (all new paths ended at once)
    }
    if (tid == 0) {
      sh.stat[kWaves] += 1ull;
      sh.stat[kClosest] += (unsigned long long)nlive;
    }
    // ---- closest hit and shading, the k-th sorted path in turn
    const int cur = sort_slots(sh);
    for_chunks(nlive, sh.chunk_c, [&](int k) {
      const int i = sh.idx[cur][k];
      const uint32_t ray_id = (uint32_t)sh.lane[i];
      const int s = sh.s[i], b = sh.b[i];
      const uint32_t s_eff = (uint32_t)s * (uint32_t)lp.spp_lanes +
                             ray_id % (uint32_t)lp.spp_lanes;
      const uint32_t base = counter_base(lp, s_eff, b);
      PathState st{sh.px[i], sh.py[i], sh.pz[i], sh.dx[i], sh.dy[i],
                   sh.dz[i], sh.cr[i], sh.cg[i], sh.cb[i], sh.wr[i],
                   sh.wg[i], sh.wb[i], true, (sh.flags[i] & kDoEm) != 0};
      const bvh16::Record rec = bvh16::trace<false, true>(
          p.nodes, p.leafs, p.aux, p.stack_size, p.err, st.px, st.py, st.pz,
          st.dx, st.dy, st.dz, kEpsT, kFar);
      const Material m = hit_material(p, rec);
      const int wedge = (s + b * 3) % lp.az_strata;
      const Shade o = bounce_shade(ray_id, base, st, rec.t, rec.hit, true,
                                   rec.gx, rec.gy, rec.gz, m, p.lights,
                                   lp.trig, lp.az_strata, wedge);
      sh.px[i] = o.next.px;
      sh.py[i] = o.next.py;
      sh.pz[i] = o.next.pz;
      sh.dx[i] = o.next.dx;
      sh.dy[i] = o.next.dy;
      sh.dz[i] = o.next.dz;
      sh.cr[i] = o.next.cr;
      sh.cg[i] = o.next.cg;
      sh.cb[i] = o.next.cb;
      sh.wr[i] = o.next.wr;
      sh.wg[i] = o.next.wg;
      sh.wb[i] = o.next.wb;
      sh.b[i] = b + 1;
      const bool ends = !o.next.alive || b + 1 >= lp.max_bounces;
      const uint8_t em = o.next.do_em ? kDoEm : 0;
      if (o.nee) {
        // the query leaves from the hit point, which is the new origin
        sh.ur[i] = o.ur;
        sh.ug[i] = o.ug;
        sh.ub[i] = o.ub;
        sh.lx[i] = o.ldx;
        sh.ly[i] = o.ldy;
        sh.lz[i] = o.ldz;
        sh.sm[i] = o.smax;
        sh.flags[i] = kOcc | kShadow | em | (ends ? kEnd : 0);
      } else if (ends) {
        finish_path(q, sh, i);
      } else {
        sh.flags[i] = kOcc | em;
      }
    });
    __syncthreads();
    if (p.lights.n == 0) continue;
    // ---- the NEE shadow rays, keyed and sorted alike
#pragma unroll
    for (int r = 0; r < kSlotsPerThread; ++r) {
      const int i = r * kPoolThreads + tid;
      const bool q_on = (sh.flags[i] & kShadow) != 0;
      sh.key[0][i] = q_on ? ray_key(box, sh.px[i], sh.py[i], sh.pz[i],
                                    sh.lx[i], sh.ly[i], sh.lz[i])
                          : kDeadKey;
      sh.idx[0][i] = (uint16_t)i;
      const unsigned mask = __ballot_sync(0xffffffffu, q_on);
      if (lane_id == 0 && mask) atomicAdd(&sh.nshadow, __popc(mask));
    }
    __syncthreads();
    const int nsh = sh.nshadow;
    if (nsh == 0) continue;
    if (tid == 0) sh.stat[kShadows] += (unsigned long long)nsh;
    const int cs = sort_slots(sh);
    for_chunks(nsh, sh.chunk_s, [&](int k) {
      const int i = sh.idx[cs][k];
      const bool blocked =
          bvh16::trace<true, false>(
              p.nodes, p.leafs, nullptr, p.stack_size, p.err, sh.px[i],
              sh.py[i], sh.pz[i], sh.lx[i], sh.ly[i], sh.lz[i], kRayEps,
              sh.sm[i])
              .hit;
      if (!blocked) {
        sh.cr[i] = sh.ur[i];
        sh.cg[i] = sh.ug[i];
        sh.cb[i] = sh.ub[i];
      }
      if (sh.flags[i] & kEnd) {
        finish_path(q, sh, i);
      } else {
        sh.flags[i] &= (uint8_t)~kShadow;
      }
    });
    __syncthreads();
  }
  // this block's totals, to the wrapper
  if (tid == 0) sh.stat[kBlocks] = 1ull;
  __syncthreads();
  for (int k = 1 + tid; k < kNumStats; k += kPoolThreads) {
    atomicAdd(q.stats + k, sh.stat[k]);
  }
}

cudaError_t pool_blocks_per_sm(int* per_sm) {
  const cudaError_t e = cudaFuncSetAttribute(
      pt_bvh_pool_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(Pool));
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, pt_bvh_pool_kernel, kPoolThreads, sizeof(Pool));
}

// One block an SM, at most one per 32 items; a block claims at most its
// share of the items at once, so that a small render still spreads over
// every SM (a large one claims a whole pool).
cudaError_t launch_pool(PoolParams q, cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = pool_blocks_per_sm(&per_sm);
  if (e != cudaSuccess) return e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess) {
    return e;
  }
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const unsigned long long items =
      (unsigned long long)q.bp.n * (unsigned long long)q.iters;
  unsigned long long grid =
      (unsigned long long)per_sm * (unsigned long long)sms;
  if ((items + 31) / 32 < grid) grid = (items + 31) / 32;
  const unsigned long long share = (items + grid - 1) / grid;
  q.chunk = share < 32 ? 32 : (share > kPoolSlots ? kPoolSlots : (int)share);
  pt_bvh_pool_kernel<<<(unsigned)grid, kPoolThreads, sizeof(Pool), stream>>>(
      q);
  return cudaGetLastError();
}

bool loop_ok(const Loop& lp) {
  return lp.spp_iters >= 0 && lp.max_bounces >= 0 && lp.az_strata >= 1 &&
         lp.spp_lanes >= 1 && (lp.trig == 0 || lp.trig == 1);
}

}  // namespace

// ``scratch``: three zeroed uint64, the pixel counter and the closest-hit
// and shadow sweeps the launch ran; ``grid``: models/pt_fused.py::
// brute_grid's (the resident blocks, or fewer for a small batch).
extern "C" int nrt_pt_fused_brute(
    const float* tri, int F, const float* face, int C, const float* light,
    int n_lights, float inv_lights, const float* org, const float* dir,
    float* out, unsigned long long* scratch, long long n, int seed, int spp,
    int max_bounces, int rr_start, int trig, int az_strata, int grid,
    void* stream) {
  const Loop lp{(uint32_t)seed, spp, max_bounces, rr_start, trig, az_strata, 1};
  if (F < 0 || F > kMaxTris || (C != 17 && C != 26) || n_lights < 0 ||
      !loop_ok(lp) || grid < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (n <= 0) return 0;
  BruteParams p{tri, F, face, C, Lights{light, n_lights, inv_lights},
                org, dir, out, scratch, n, lp};
  pt_brute_kernel<<<(unsigned)grid, kBlock, 0,
                    reinterpret_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// What the launch needs of K3: out[0] resident blocks per SM (occupancy
// API), out[1] registers a thread, out[2] local (spill) bytes a thread,
// out[3] threads a block.
extern "C" int nrt_pt_fused_brute_occupancy(int* out) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, pt_brute_kernel);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, pt_brute_kernel,
                                                      kBlock, 0);
  }
  if (e != cudaSuccess) return (int)e;
  out[1] = a.numRegs;
  out[2] = (int)a.localSizeBytes;
  out[3] = kBlock;
  return 0;
}

// Runs the paths of sample iterations [s0, s0 + iters) of spp_iters.
// ``out`` (iters, n, 3): their radiance; ``stats`` (kNumStats,) int64
// zeros (see Stat); ``box`` (6,): the root box's lo and max(hi - lo,
// 1e-30) for the sort key.
extern "C" int nrt_pt_fused_bvh_pool(
    const float* mat, int n_mats, const float* light, int n_lights,
    float inv_lights, const float* nodes, const float* leafs, const float* aux,
    const float* org, const float* dir, float* out, int* err, long long n,
    int stack_size, int seed, int spp_iters, int max_bounces, int rr_start,
    int trig, int az_strata, int spp_lanes, int s0, int iters,
    unsigned long long* stats, const float* box, void* stream) {
  const Loop lp{(uint32_t)seed, spp_iters, max_bounces, rr_start,
                trig,           az_strata, spp_lanes};
  if (stack_size < 1 || stack_size > bvh16::kStackCap || n_mats < 0 ||
      n_lights < 0 || !loop_ok(lp) || n > 0x7fffffffLL || s0 < 0 ||
      iters < 0 || iters > spp_iters - s0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n <= 0 || iters == 0) return 0;
  const PoolParams q{
      BvhParams{mat, n_mats, Lights{light, n_lights, inv_lights}, nodes,
                leafs, aux, org, dir, out, err, n, stack_size, lp},
      stats, box, s0, iters, kPoolSlots};
  return (int)launch_pool(q, reinterpret_cast<cudaStream_t>(stream));
}

// Resident blocks per SM of the pooled kernel (512 threads and its pool)
// and the pool's shared bytes: out[0] blocks, out[1] bytes.
extern "C" int nrt_pt_fused_bvh_occupancy(int* out) {
  const cudaError_t e = pool_blocks_per_sm(out);
  if (e != cudaSuccess) return (int)e;
  out[1] = (int)sizeof(Pool);
  return 0;
}
