// Wide-BVH ray traversal for NVIDIA Hopper (sm_90a): closest-hit or
// any-hit, watertight triangle test with the Dekker exact-edge fallback,
// the Woop unit-triangle test (the "turbo" intersector), the sphere test
// of the particle primitive (ops/sphere.py::sphere_hit), or the cubic
// Bezier curve test of hair (ops/curve.py::curve_hit).
//
// Replaces nanort_tpu/traverse/pallas_packet.py::_kernel_body (the TPU
// kernel behind traverse_bvh8), with its intersector="woop" leaf test
// (pallas_packet.py:283-332). It computes what that kernel computes per
// ray, over the SAME BVH8/BVH16 node rows and leaf rows that
// build/bvh8.py::collapse_bvh8 emits, but not the way it computes it:
// the TPU kernel walks a (sub, 128) packet through one scalar stack held
// in SMEM, OR-reducing every ray's slab vote into one mask per node. Here
// each thread walks one ray at a time with its own stack, so no ray ever
// visits a node that it does not hit itself.
//
// What bounds it on this card: dependent global-memory fetches — a node
// row (512 bytes) must arrive before the next node index is known, and a
// leaf row before its triangles are tested. The 1M-triangle BVH16 tables
// are 97.6 MB (27 MB of node rows, 70 MB of leaf rows), about twice the
// H100's 50 MB L2, so deep fetches pay L2 or HBM latency. The second
// bound is warp divergence: the 32 rays of a warp follow different stack
// paths and the warp runs their union. The design:
//   - persistent warps: the grid is the resident blocks (occupancy API x
//     SMs, sized by the wrapper, traverse/packet.py::launch_plan); each
//     warp claims 32 consecutive rays at a time from a global counter
//     (one atomicAdd by lane 0), so a warp's rays keep the coherence of
//     tile_image_rays / ray_sort order and no block waits on its slowest
//     warp before the SM takes new rays;
//   - a node's child metadata (meta and leaf counts) is read with 16-byte
//     loads, a quad of children at a time and only for quads with a hit,
//     and the hit children are stored far-first by their rank in the
//     mask, with the stack bound checked once a node;
//   - leaf rows are read with 16-byte loads (three a triangle);
//   - the stack is a local array, which the L1 caches per thread.
// Measured on an H100 and left out (PERF.md): the nearest hit child
// kept in a register, the top of the stack in shared memory, refilling
// idle lanes mid-walk, while-while node and leaf loops and
// __launch_bounds__ minimum blocks. None of the parts changes which
// entries a ray pops or in what order, so every record, counter and flag
// is the plain version's.
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
// The leaf test is a template parameter (kLeaf: kTriangle, kWoop, kSphere
// or kCurve), so the watertight instantiation is the same code, with the
// same registers, as without the Woop, sphere and curve tests. The sphere
// test is ops/sphere.py::sphere_hit operation for operation
// (sphere_intersect's q-form of the quadratic with a precise
// discriminant, the |disc| < eps double root, the near root in [min_t,
// t_cur] or else the far one, an equal t accepted); with IEEE sqrtf and
// division and no FMA its t is the plain version's bit for bit. A sphere
// is one 16-byte load (centre, radius); u and v stay 0
// (ops/sphere.py::sphere_post fills them for the final hit). The sphere
// instantiations are bound as the triangle ones are, by dependent row
// fetches, and more of them a ray: a LiDAR tile's spheres overlap
// (points closer than their radii), so a ray that grazes the canopy pops
// many leaf rows before the nearest hit prunes the rest.
//
// The curve test is ops/curve.py::curve_hit operation for operation, the
// Nakamaru-Ohno test of make_curve_intersect(4) (upstream
// examples/curves_primitive/main.cc:481-800): the ray's z-align rotation
// and translation (_z_align, with its dxz == 0 branch), computed once a
// ray when it is claimed (curve_ray), then per curve the 4 control points
// projected into that space, the near reject, 5 de Casteljau points at
// s / 4 and the 4 spans between them, each the closest point of a 2D
// segment to the z axis, accepted on d2 <= r^2 and t < best t; a curve
// whose best span lies before min_t is a miss. A curve is four 16-byte
// loads (p0 r0, p1, p2, p3 r1). The stack engine tests a leaf's curves
// against the t it entered the leaf with and keeps the least t; here
// they are tested in turn against the running best, which accepts the
// same curve with the same record (a curve's record depends on the t it
// is tested against only through whether its least span t lies below
// it), the first of a leaf's curves at exactly equal t. The curve
// instantiations are bound by the test itself (~480 float32 operations a
// curve, about ten times the sphere's) above K1's dependent fetches: a
// hair's boxes are long, thin and overlap, so a ray that grazes the hair
// opens many leaves before its nearest hit.
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
//
// K1b (interleave K = 2 or 4, _kernel_body_il :1060) is a kernel of its
// own, traverse_kernel_il, one instantiation a width and leaf test: the
// caller's schedule for incoherent batches, with the records of K1 (each
// ray's pop sequence is K1's). The TPU reason for K1b (amortising the
// vector-to-scalar drain) has no Hopper counterpart. What bounds K1 on
// incoherent rays besides its fetches is lanes that idle while the
// longest walk of their 32 runs on. K1b's design, measured part by part
// on an H100 (PERF.md): persistent warps on the resident grid take
// numbered claims of K packets of 32 rays (K a launch parameter; one
// packet on an any-hit launch), four claims tiling 128 K rays as a block
// would; a claim of a camera's rays (one origin) or of an any-hit launch
// is walked one packet after another as K1 walks; any other claim is
// handed out to free lanes by rank in a ballot, 16 or more lanes at a
// time, so a lane takes its next ray as soon as half its warp idles; one
// ray a lane, on K1's 512-entry stack; 8 resident blocks
// (__launch_bounds__). Measured and left out: K rays in flight a lane,
// each with its own stack, stepped together (the registers of K walks
// cost resident warps: 1.2-1.7x slower than one ray a lane on every
// shape), a lane refilled as soon as its ray ends (lanes drift apart and
// share no rows: the frame 3x slower), whole-packet refills, lane-major
// packets, the next rows prefetched to L1 or L2 before a step, a second
// instantiation with a 128-entry stack (the frame 1-2% faster, no other
// shape).

// Interface: plain C functions (ctypes, no PyTorch headers). The launch
// runs on the caller's stream, allocates nothing (the claim counter and
// the overflow word are the caller's zeroed scratch), and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kStackCap = 512;     // per-thread stack ceiling (entries)
constexpr int kRefill = 16;        // K1b: free lanes that take new rays
constexpr int kThreads = 128;      // threads per block
constexpr int kClaim = 32;         // K1: consecutive rays a warp claims
constexpr float kBig = 3.0e38f;    // degenerate-ray threshold (TPU kernel)
constexpr float kMaxMult = 1.00000024f;  // 4-ulp exit-plane inflation
constexpr float kSplit = 4097.0f;  // Veltkamp split constant for f32
constexpr long long kInvalidPrim = 0xFFFFFFFFLL;
constexpr int kNone = 0x7fffffff;  // no entry to run (no node row has it)
// leaf tests (the kLeaf template parameter and the launch's ``leaf``)
constexpr int kTriangle = 0;       // watertight, leafs rows
constexpr int kWoop = 1;           // Woop unit triangles, leafs_woop rows
constexpr int kSphere = 2;         // spheres, sphere leaf rows
constexpr int kCurve = 3;          // cubic Bezier curves, curve leaf rows
constexpr int kSpans = 4;          // curve spans (num_subdivisions)

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
  unsigned long long* counter;  // rays claimed so far (zero at launch)
  unsigned long long* err;      // set to 1 when a stack overflows
  long long n_rays;
  long long packet;     // rays per packet of ``roots``
  int stack_size;       // <= kStackCap
  int occlusion;        // any-hit: stop at the first accepted hit
  int cull_back_face;
  int exact_edge;       // Dekker recompute where an edge function is 0
  int use_range;        // prim_ids_range filter: lo <= pid < hi
  int range_lo;
  int range_hi;
  int packets;          // K1b: packets of 32 rays a claim (launch_plan's)
};
// With the Woop test, ``leafs`` is the scene's leafs_woop table: one row
// for each watertight leaf row, triangle t at lanes [12t, 12t+12) as its
// row-major unit-triangle transform M (9 lanes) and anchor vertex p0 (3),
// its prim id at lane 108 + t. With the sphere test, ``leafs`` is a
// sphere scene's table: sphere s at lanes [4s, 4s+4) as its centre and
// radius, its prim id at lane 108 + s. With the curve test, a curve
// scene's table: curve c at lanes [16c, 16c+16) as its control points p0,
// p1, p2, p3, each a float4 whose w is r0 (p0), 0 (p1, p2) or r1 (p3),
// its prim id at lane 108 + c.

__device__ __forceinline__ float sel3(int k, float x, float y, float z) {
  return k == 0 ? x : (k == 1 ? y : z);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
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
// the ray's sign, 4-ulp inflated exits, NaN-skipping folds, so an empty
// slot's inverted EMPTY_BIG box never passes. fmaxf/fminf return the
// other operand for a NaN, as the where-folds keep the running bound;
// the folds start from a non-NaN bound (a ray with a NaN interval never
// reaches a node), and only tmin <= tmax is kept, where +0 and -0 agree.
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
  const float tmin = fmaxf(fmaxf(fmaxf(r.min_t, t0x), t0y), t0z);
  const float tmax = fminf(fminf(fminf(t_best, t1x), t1y), t1z);
  return tmin <= tmax;
}

// Watertight test of one triangle (ops/triangle.py::intersect_triangles,
// same operations in the same order), given its vertices a, b, c.
// Returns true on acceptance. With kFlag, ORs into ``zero`` whether U, V
// or W was 0 before the recompute.
template <bool kFlag>
__device__ __forceinline__ bool hit_triangle(
    const RayState& r, float ax, float ay, float az, float bx, float by,
    float bz, float cx, float cy, float cz, float t_cur, int cull, int exact,
    float& tt, float& uu, float& vv, int& zero) {
  const float ax3 = ax - r.ox, ay3 = ay - r.oy, az3 = az - r.oz;
  const float bx3 = bx - r.ox, by3 = by - r.oy, bz3 = bz - r.oz;
  const float cx3 = cx - r.ox, cy3 = cy - r.oy, cz3 = cz - r.oz;
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
// that order. ``m0..m2`` are the triangle's 12 lanes. Returns true on
// acceptance.
__device__ __forceinline__ bool hit_triangle_woop(const RayState& r,
                                                  float4 m0, float4 m1,
                                                  float4 m2, float t_cur,
                                                  int cull, float& tt,
                                                  float& uu, float& vv) {
  const float rx = r.ox - m2.y;
  const float ry = r.oy - m2.z;
  const float rz = r.oz - m2.w;
  const float m00 = m0.x, m01 = m0.y, m02 = m0.z;
  const float m10 = m0.w, m11 = m1.x, m12 = m1.y;
  const float m20 = m1.z, m21 = m1.w, m22 = m2.x;
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

// Sphere test of one sphere (centre c, radius in c.w) of a sphere row
// (ops/sphere.py::sphere_hit, same operations in the same order; ``a`` is
// d . d): sphere_intersect's q-form with the discriminant 4 a (r^2 -
// |l|^2), l the centre's offset from the ray's closest approach, whose
// rounding stays of the order of r^2 ulps where b^2 - 4ac loses the
// sphere ~10^3 radii away. Returns true on acceptance.
__device__ __forceinline__ bool hit_sphere(const RayState& r, float a,
                                           float4 c, float t_cur,
                                           float& tt) {
  const float ocx = r.ox - c.x, ocy = r.oy - c.y, ocz = r.oz - c.z;
  const float beta = r.dx * ocx + r.dy * ocy + r.dz * ocz;
  const float k = beta / a;
  const float lx = ocx - k * r.dx, ly = ocy - k * r.dy, lz = ocz - k * r.dz;
  const float disc = 4.0f * (a * (c.w * c.w - (lx * lx + ly * ly + lz * lz)));
  const float b = 2.0f * beta;
  const float cc = (ocx * ocx + ocy * ocy + ocz * ocz) - c.w * c.w;
  const bool double_root = fabsf(disc) < FLT_EPSILON;
  // sqrt(max(disc, 0)) as the plain version takes it: a NaN stays NaN
  const float ds = sqrtf(disc < 0.0f ? 0.0f : disc);
  const float q = b < 0.0f ? (-b - ds) / 2.0f : (-b + ds) / 2.0f;
  const float sa = a != 0.0f ? a : 1.0f;
  const float sq = q != 0.0f ? q : 1.0f;
  const float r0 = double_root ? -0.5f * b / sa : q / sa;
  const float r1 = double_root ? r0 : cc / sq;
  // the roots' min and max: NaN if either is, else (equal roots) the
  // second
  const bool nan = r0 != r0 || r1 != r1;
  const float t0 = nan ? NAN : (r0 < r1 ? r0 : r1);
  const float t1 = nan ? NAN : (r0 > r1 ? r0 : r1);
  tt = t0 >= r.min_t ? t0 : t1;
  return !(disc < 0.0f) && a != 0.0f && tt >= r.min_t && tt <= t_cur;
}

// A ray's z-align frame (ops/curve.py::_z_align, upstream GetZAlign,
// main.cc:382-417): the rotation m (row-major) and translation t that
// take the ray to the +z axis through the origin; a point x projects to
// x m + t, each coordinate summed over its three products in order.
struct CurveRay {
  float m00, m01, m02, m10, m11, m12, m20, m21, m22;
  float tx, ty, tz;
};

// The frame of the (sanitised) ray r, with _z_align's degenerate branch
// for a ray whose x and z are both 0 (dxz == 0).
__device__ __forceinline__ void curve_ray(const RayState& r, CurveRay& c) {
  const float lx = r.dx, ly = r.dy, lz = r.dz;
  const float dxz = sqrtf(lx * lx + lz * lz);
  if (dxz > 0.0f) {
    c.m00 = lz / dxz;
    c.m01 = -lx / dxz * ly;
    c.m02 = lx;
    c.m10 = 0.0f;
    c.m11 = dxz;
    c.m12 = ly;
    c.m20 = -lx / dxz;
    c.m21 = -ly / dxz * lz;
    c.m22 = lz;
  } else {
    const float sgn = ly > 0.0f ? 1.0f : -1.0f;
    c.m00 = 1.0f;
    c.m01 = 0.0f;
    c.m02 = 0.0f;
    c.m10 = 0.0f;
    c.m11 = 0.0f;
    c.m12 = -sgn;
    c.m20 = 0.0f;
    c.m21 = sgn;
    c.m22 = 0.0f;
  }
  c.tx = -((r.ox * c.m00 + r.oy * c.m10) + r.oz * c.m20);
  c.ty = -((r.ox * c.m01 + r.oy * c.m11) + r.oz * c.m21);
  c.tz = -((r.ox * c.m02 + r.oy * c.m12) + r.oz * c.m22);
}

// A point in ray space: x m + t.
struct P3 {
  float x, y, z;
};

__device__ __forceinline__ P3 project(const CurveRay& c, float4 p) {
  return {((p.x * c.m00 + p.y * c.m10) + p.z * c.m20) + c.tx,
          ((p.x * c.m01 + p.y * c.m11) + p.z * c.m21) + c.ty,
          ((p.x * c.m02 + p.y * c.m12) + p.z * c.m22) + c.tz};
}

__device__ __forceinline__ float lerp1(float u, float a, float t, float b) {
  return u * a + t * b;
}

// de Casteljau at parameter t (u = 1 - t), coordinate by coordinate
// (ops/curve.py::_bezier).
__device__ __forceinline__ float casteljau(float u, float t, float a0,
                                           float a1, float a2, float a3) {
  const float a = lerp1(u, a0, t, a1);
  const float b = lerp1(u, a1, t, a2);
  const float cc = lerp1(u, a2, t, a3);
  const float d = lerp1(u, a, t, b);
  const float e = lerp1(u, b, t, cc);
  return lerp1(u, d, t, e);
}

__device__ __forceinline__ P3 bezier(const P3& a, const P3& b, const P3& c,
                                     const P3& d, float t) {
  const float u = 1.0f - t;
  return {casteljau(u, t, a.x, b.x, c.x, d.x),
          casteljau(u, t, a.y, b.y, c.y, d.y),
          casteljau(u, t, a.z, b.z, c.z, d.z)};
}

// Curve test of one cubic Bezier curve (control points q0..q3, r0 in
// q0.w, r1 in q3.w) of a curve row against the ray of frame c
// (ops/curve.py::curve_hit, the same operations in the same order): its
// best span's t below t_cur, u = (u_s + s) / 4 and v = sqrt(d2); the
// curve is a miss when that t lies before min_t. Returns true on
// acceptance.
__device__ __forceinline__ bool hit_curve(const CurveRay& c, float min_t,
                                          float4 q0, float4 q1, float4 q2,
                                          float4 q3, float t_cur, float& tt,
                                          float& uu, float& vv) {
  const P3 a = project(c, q0), b = project(c, q1), e = project(c, q2),
           f = project(c, q3);
  // the largest projected z (amax; the points are finite)
  float t_z = a.z > b.z ? a.z : b.z;
  t_z = t_z > e.z ? t_z : e.z;
  t_z = t_z > f.z ? t_z : f.z;
  const float r0 = q0.w, r1 = q3.w;
  const float uw = (r0 > r1 ? r0 : r1) / 2.0f;
  if (t_z < 4.0f * uw) return false;  // near reject (main.cc:676-680)
  const float w0 = 0.5f * r0;
  const float w1 = 0.5f * r1;
  const float bw = w1 - w0;
  float best_t = t_cur;
  bool got = false;
  P3 p0 = bezier(a, b, e, f, 0.0f);
#pragma unroll
  for (int s = 0; s < kSpans; ++s) {
    const P3 p1 = bezier(a, b, e, f, (float)(s + 1) * (1.0f / kSpans));
    const float bx = p1.x - p0.x;
    const float by = p1.y - p0.y;
    const float bz = p1.z - p0.z;
    const float d0 = -p0.x * bx + -p0.y * by;
    const float d1 = bx * bx + by * by;
    float us = d0 / (d1 != 0.0f ? d1 : 1.0f);
    us = us < 0.0f ? 0.0f : (us > 1.0f ? 1.0f : us);  // a NaN stays NaN
    const float px = p0.x + us * bx;
    const float py = p0.y + us * by;
    const float t = p0.z + us * bz;
    const float r = w0 + us * bw;
    const float d2 = px * px + py * py;
    if (d2 <= r * r && t < best_t) {
      best_t = t;
      uu = (us + (float)s) * (1.0f / kSpans);
      vv = sqrtf(d2);
      got = true;
    }
    p0 = p1;
  }
  tt = best_t;
  return got && best_t >= min_t;
}

// One ray's walk: its set-up, its best record, the entry it runs next
// and its stack pointer (the stack itself is the caller's), plus the
// counters and the flag of the debug modes (dead code, and no registers,
// when those are off).
struct Walk {
  RayState r;
  float t_best, max_t_in, u_best, v_best;
  int pid_best, skip, sp, e;
  bool found;
  int n_nodes, n_leaves, zero;
  CurveRay c;  // the curve test's frame (kCurve only)
};

// Set up ray i; its first entry is row 0, or (kRoots, when the launch
// has roots) its packet's root. The curve test's frame is set up with
// kLeaf == kCurve alone.
template <bool kRoots, int kLeaf = kTriangle>
__device__ __forceinline__ void begin(const Params& p, long long i, Walk& w) {
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
  if constexpr (kLeaf == kCurve) curve_ray(r, w.c);
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
  // end here)
  w.e = min_t <= t_best ? (kRoots && p.roots ? p.roots[i / p.packet] : 0)
                        : kNone;
}

__device__ __forceinline__ void pop(Walk& w, const int* stack) {
  w.e = w.sp > 0 ? stack[--w.sp] : kNone;
}

// The stack entry of child slot value ``meta`` with leaf count lane
// ``cnt``: the node row, or -1 - (leaf_row << 4 | count) for a leaf.
__device__ __forceinline__ int child_entry(float meta, float cnt) {
  const int m = (int)meta;
  return m >= 0 ? m : -1 - (((-m - 1) << 4) | ((int)cnt & 15));
}

__device__ __forceinline__ float lane4(const float4& v, int k) {
  return k == 0 ? v.x : (k == 1 ? v.y : (k == 2 ? v.z : v.w));
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
// Runs the node ``w.e`` of a live ray: its slab tests, its hit children
// stored far-first, then the top of the stack (the nearest hit child).
template <int W, bool kCounts>
__device__ __forceinline__ void node_step(const Params& p, Walk& w,
                                          int* stack) {
  const RayState& r = w.r;
  if (kCounts) ++w.n_nodes;
  const float* row = p.nodes + (size_t)w.e * 128;
  unsigned mask = 0u;
  if (W == 16) {
#pragma unroll
    for (int q = 0; q < 8; ++q) {  // two children per 3 float4 loads
      const float4 a = ld4(row + 12 * q);
      const float4 b = ld4(row + 12 * q + 4);
      const float4 c = ld4(row + 12 * q + 8);
      mask |= (unsigned)slab(r, w.t_best, a.x, a.y, a.z, a.w, b.x, b.y) << (2 * q);
      mask |= (unsigned)slab(r, w.t_best, b.z, b.w, c.x, c.y, c.z, c.w) << (2 * q + 1);
    }
  } else {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float4 a = ld4(row + 8 * c);
      const float2 b = __ldg(reinterpret_cast<const float2*>(row + 8 * c + 4));
      mask |= (unsigned)slab(r, w.t_best, a.x, a.y, a.z, a.w, b.x, b.y) << c;
    }
  }
  if (mask == 0u) {
    pop(w, stack);
    return;
  }
  // the whole check once a node: the plain version raises, and the
  // kernel sets the error word, when the pushes would pass stack_size
  const int n_hit = __popc(mask);
  if (w.sp + n_hit > p.stack_size) {
    atomicOr(p.err, 1ull);
    w.sp = 0;
    w.e = kNone;
    return;
  }
  constexpr int kMeta = W == 16 ? 96 : 64;
  constexpr int kCount = W == 16 ? 112 : 72;
  // lane 112 (child 0's count) carries a W == 16 row's order axis
  const float4 c0 = ld4(row + kCount);
  int axis;
  if (W == 16) {
    const float v112 = c0.x;
    axis = v112 >= 32.0f ? 2 : (v112 >= 16.0f ? 1 : 0);
  } else {
    const float a80 = __ldg(row + 80);
    axis = a80 == 0.0f ? 0 : (a80 == 1.0f ? 1 : 2);
  }
  // children are stored near-to-far along the order axis; the LIFO
  // stack takes them far-first (for ``neg`` ascending slots, else
  // descending), so a hit child's place is its rank among the hit slots
  // and the nearest is stored last, to pop first
  const bool neg = axis == 0 ? r.nx : (axis == 1 ? r.ny : r.nz);
  const int sp = w.sp;
#pragma unroll
  for (int q = 0; q < W / 4; ++q) {
    if (!((mask >> (4 * q)) & 15u)) continue;
    const float4 mq = ld4(row + kMeta + 4 * q);
    const float4 cq = q == 0 ? c0 : ld4(row + kCount + 4 * q);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = 4 * q + k;
      if (!((mask >> j) & 1u)) continue;
      const int pos = neg ? __popc(mask & ((1u << j) - 1u))
                          : __popc(mask >> (j + 1));
      stack[sp + pos] = child_entry(lane4(mq, k), lane4(cq, k));
    }
  }
  w.sp = sp + n_hit;
  pop(w, stack);
}

// Runs the leaf entry ``w.e`` of a live ray: its row's triangle (sphere,
// curve) tests in slot order, then the top of the stack (any-hit: retire
// on a hit).
template <int kLeaf, bool kCounts, bool kFlags>
__device__ __forceinline__ void leaf_step(const Params& p, Walk& w,
                                          int* stack) {
  const RayState& r = w.r;
  if (kCounts) ++w.n_leaves;
  const int packed = -1 - w.e;
  const float* row = p.leafs + (size_t)(packed >> 4) * 128;
  const int cnt = packed & 15;
  if constexpr (kLeaf == kSphere) {
    const float a = r.dx * r.dx + r.dy * r.dy + r.dz * r.dz;
    for (int s = 0; s < cnt; ++s) {
      float tt;
      if (!hit_sphere(r, a, ld4(row + 4 * s), w.t_best, tt)) continue;
      const int pid = (int)__ldg(row + 108 + s);
      if (pid == w.skip) continue;
      if (p.use_range && (pid < p.range_lo || pid >= p.range_hi)) continue;
      w.t_best = tt;
      w.u_best = 0.0f;
      w.v_best = 0.0f;
      w.pid_best = pid;
      w.found = true;
      if (p.occlusion) break;
    }
    if (p.occlusion && w.found) {  // any-hit: retire
      w.sp = 0;
      w.e = kNone;
    } else {
      pop(w, stack);
    }
    return;
  }
  if constexpr (kLeaf == kCurve) {
    for (int s = 0; s < cnt; ++s) {
      const float* q = row + 16 * s;
      float tt, uu, vv;
      if (!hit_curve(w.c, r.min_t, ld4(q), ld4(q + 4), ld4(q + 8),
                     ld4(q + 12), w.t_best, tt, uu, vv)) {
        continue;
      }
      const int pid = (int)__ldg(row + 108 + s);
      if (pid == w.skip) continue;
      if (p.use_range && (pid < p.range_lo || pid >= p.range_hi)) continue;
      w.t_best = tt;
      w.u_best = uu;
      w.v_best = vv;
      w.pid_best = pid;
      w.found = true;
      if (p.occlusion) break;
    }
    if (p.occlusion && w.found) {  // any-hit: retire
      w.sp = 0;
      w.e = kNone;
    } else {
      pop(w, stack);
    }
    return;
  }
  constexpr bool kWoopTest = kLeaf == kWoop;
  // triangle ti's lanes: [12 ti, 12 ti + 12) (Woop), else [9 ti, 9 ti +
  // 9), which sit at offset ti % 4 of the three float4s from lane
  // 36 (ti / 4) + 8 ((ti % 4) * 9 / 8): groups of four, slot k static
  bool stop = false;
  for (int g = 0; g * 4 < cnt && !stop; ++g) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int ti = 4 * g + k;
      if (ti >= cnt) break;
      float tt, uu, vv;
      bool ok;
      if (kWoopTest) {
        const float* m = row + 12 * ti;
        ok = hit_triangle_woop(r, ld4(m), ld4(m + 4), ld4(m + 8), w.t_best,
                               p.cull_back_face, tt, uu, vv);
      } else {
        const float* q = row + 36 * g + (k * 9 / 4) * 4;
        const float4 a = ld4(q), b = ld4(q + 4), c = ld4(q + 8);
        const float f[12] = {a.x, a.y, a.z, a.w, b.x, b.y,
                             b.z, b.w, c.x, c.y, c.z, c.w};
        ok = hit_triangle<kFlags>(
            r, f[k], f[k + 1], f[k + 2], f[k + 3], f[k + 4], f[k + 5],
            f[k + 6], f[k + 7], f[k + 8], w.t_best, p.cull_back_face,
            p.exact_edge, tt, uu, vv, w.zero);
      }
      if (!ok) continue;
      const int pid = (int)__ldg(row + (kWoopTest ? 108 : 90) + ti);
      if (pid == w.skip) continue;
      if (p.use_range && (pid < p.range_lo || pid >= p.range_hi)) continue;
      w.t_best = tt;
      w.u_best = uu;
      w.v_best = vv;
      w.pid_best = pid;
      w.found = true;
      if (p.occlusion) {
        stop = true;
        break;
      }
    }
  }
  if (p.occlusion && w.found) {  // any-hit: retire
    w.sp = 0;
    w.e = kNone;
  } else {
    pop(w, stack);
  }
}

// Runs the entry ``w.e`` of a live ray and sets the next one.
template <int W, int kLeaf, bool kCounts, bool kFlags>
__device__ __forceinline__ void step(const Params& p, Walk& w, int* stack) {
  if (w.e >= 0) {
    node_step<W, kCounts>(p, w, stack);
  } else {
    leaf_step<kLeaf, kCounts, kFlags>(p, w, stack);
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

// Persistent warps: each warp claims kClaim consecutive rays at a time
// (lane 0's atomicAdd on the claim counter) and walks them one a lane
// until the counter passes n_rays. The grid is what stays resident.
// kRoots is a template parameter so that the instantiations without
// modes keep the code they had before roots.
template <int W, int kLeaf, bool kCounts, bool kFlags, bool kRoots>
__global__ void __launch_bounds__(kThreads) traverse_kernel(Params p) {
  int stack[kStackCap];
  const unsigned lane = threadIdx.x & 31u;
  const unsigned long long n = (unsigned long long)p.n_rays;
  for (;;) {
    unsigned long long base = 0;
    if (lane == 0) base = atomicAdd(p.counter, (unsigned long long)kClaim);
    base = __shfl_sync(0xffffffffu, base, 0);
    if (base >= n) return;
    const unsigned long long i = base + lane;
    if (i < n) {
      Walk w;
      begin<kRoots, kLeaf>(p, (long long)i, w);
      while (w.e != kNone) step<W, kLeaf, kCounts, kFlags>(p, w, stack);
      finish<kCounts, kFlags>(p, (long long)i, w);
    }
  }
}

// K1b's schedule: its warps' claims, each lane's ray refilled from them.
// The per-lane parts are functions of their own, so that a CPU build of
// this file can step the schedule lane by lane
// (tests/test_torch_k1_emulation.py).
//
// Claim q holds P = p.packets packets of 32 rays, its r-th ray at
// claim_ray(q, r): four claims tile 128 P consecutive rays as one block
// of 128 threads with P rays each would, so each packet of 32 is
// consecutive and packet k starts 128 rays after packet k - 1 (a
// 128-wide image tile's next row). With P = 1 claim q is rays
// [32 q, 32 q + 32), as K1's claims are.
__device__ __forceinline__ unsigned long long claim_ray(const Params& p,
                                                        unsigned long long q,
                                                        unsigned r) {
  return (q >> 2) * (128ull * p.packets) + 32ull * (q & 3ull) + (r & 31u) +
         128ull * (r >> 5);
}

// Rays a claim, and the claims that cover n_rays (the last four may hold
// rays past it, which slot_take skips).
__device__ __forceinline__ unsigned claim_rays(const Params& p) {
  return kClaim * p.packets;
}

__device__ __forceinline__ unsigned long long claims_of(const Params& p) {
  const unsigned long long n = (unsigned long long)p.n_rays;
  const unsigned long long group = 128ull * p.packets;
  return (n + group - 1) / group * 4ull;
}

// A free lane takes ray i (< n): its set-up; a ray that retires before
// its first node is written at once and leaves the lane free. Returns
// the lane's ray, or -1.
__device__ __forceinline__ int slot_take(const Params& p, unsigned long long i,
                                         Walk& w) {
  if (i >= (unsigned long long)p.n_rays) return -1;
  begin<true>(p, (long long)i, w);
  if (w.e != kNone) return (int)i;
  finish<false, false>(p, (long long)i, w);
  return -1;
}

// Refill: this lane, free when ``ray`` < 0, takes the ray of claim q
// whose rank is r plus its rank among the warp's free lanes (``empty``, a
// ballot), while the claim has that many.
__device__ __forceinline__ int slot_fill(const Params& p, unsigned empty,
                                         unsigned lane, unsigned q, unsigned r,
                                         int ray, Walk& w) {
  if (ray >= 0) return ray;
  const unsigned rank = r + __popc(empty & ((1u << lane) - 1u));
  if (rank >= claim_rays(p)) return -1;
  return slot_take(p, claim_ray(p, q, rank), w);
}

// The rays of claim q handed out after a refill gave ``empty``'s lanes the
// ranks from r on.
__device__ __forceinline__ unsigned claim_advance(unsigned r, unsigned empty,
                                                  unsigned run) {
  return min(r + (unsigned)__popc(empty), run);
}

// This lane's vote on whether claim q is walked in lock-step, one packet
// after another as K1 walks: the launch is any-hit (short walks,
// measured faster so), or the lane's ray r = lane has ray 0's origin (a
// ray past n agrees): a camera's rays, whose walks end together. The
// claim locks when all 32 agree.
__device__ __forceinline__ bool lock_vote(const Params& p, unsigned q,
                                          unsigned lane) {
  if (p.occlusion) return true;
  const unsigned long long i = claim_ray(p, q, lane);
  const unsigned long long i0 = claim_ray(p, q, 0);
  if (i >= (unsigned long long)p.n_rays) return true;
  return p.org[3 * i] == p.org[3 * i0] &&
         p.org[3 * i + 1] == p.org[3 * i0 + 1] &&
         p.org[3 * i + 2] == p.org[3 * i0 + 2];
}

// A lane whose walk has ended (its entry is kNone) writes its ray's
// record and is free again. Returns the lane's ray, or -1.
__device__ __forceinline__ int slot_end(const Params& p, int ray,
                                        const Walk& w) {
  if (ray < 0 || w.e != kNone) return ray;
  finish<false, false>(p, ray, w);
  return -1;
}

// K1b: persistent warps take numbered claims of 32 P rays (lane 0's
// atomicAdd; claim_ray) in rounds, each lane walking one ray at a time
// with its own stack of kStackCap entries. A round writes the record of a
// lane whose walk ended, then gives free lanes rays. A lock-step claim
// (lock_vote: a camera's rays or any-hit) waits until
// the whole warp is free and walks its packets of 32 rays one after
// another, as K1 walks its claims. Any other claim is handed out by rank
// in a ballot of the free lanes, kRefill or more at a time: the warp
// steps its walks until kRefill lanes are free again (or all are), so a
// lane takes its next ray as soon as enough lanes idle, where K1 waits
// for the longest walk of its 32. The warp retires when the counter has
// passed the claims and no walk is live.
template <int W, int kLeaf>
__global__ void __launch_bounds__(kThreads, 8) traverse_kernel_il(Params p) {
  const unsigned kRun = claim_rays(p);  // rays a claim
  int stack[kStackCap];
  Walk w;
  int ray = -1;  // the lane's ray, or -1 (K1b takes n_rays < 2^31)
  w.e = kNone;
  const unsigned lane = threadIdx.x & 31u;
  const unsigned n_claims = (unsigned)claims_of(p);
  unsigned q = 0;            // the warp's claim
  unsigned r = kRun;         // rays of claim q handed out
  bool drained = false;      // the counter passed n_claims
  bool lock = false;         // claim q waits for an idle warp
  auto claim = [&]() {
    unsigned c = 0;
    if (lane == 0) c = (unsigned)atomicAdd(p.counter, 1ull);
    q = __shfl_sync(0xffffffffu, c, 0);
    r = 0;
    drained = q >= n_claims;
    if (!drained) {
      lock = __ballot_sync(0xffffffffu, lock_vote(p, q, lane)) ==
             0xffffffffu;
    }
  };
  for (;;) {
    // the round: the record of an ended walk, then the fill
    ray = slot_end(p, ray, w);
    const bool idle = __ballot_sync(0xffffffffu, ray >= 0) == 0u;
    if (idle && !drained && r == kRun) claim();
    if (lock && idle && !drained) {
      // a lock-step claim: its packets of 32 rays one after another, each
      // ray walked to its end, as K1 walks its claims
#pragma unroll 1
      for (unsigned k = 0; k < kRun; k += 32u) {
        ray = slot_fill(p, ~0u, lane, q, k, -1, w);
        while (w.e != kNone) step<W, kLeaf, false, false>(p, w, stack);
        ray = slot_end(p, ray, w);
      }
      r = kRun;
      continue;
    }
    if (!lock) {
      for (;;) {
        const unsigned empty = __ballot_sync(0xffffffffu, ray < 0);
        if (drained || __popc(empty) < kRefill) break;
        if (r == kRun) {
          claim();
          if (drained || lock) break;  // a lock-step claim waits
        }
        ray = slot_fill(p, empty, lane, q, r, ray, w);
        r = claim_advance(r, empty, kRun);
      }
    }
    if (__ballot_sync(0xffffffffu, ray >= 0) == 0u) {
      if (drained) return;
      continue;
    }
    // the steps, until kRefill lanes are free (or all, once no claim can
    // refill them)
    const bool refill = !lock && !drained;
    for (;;) {
      if (w.e != kNone) step<W, kLeaf, false, false>(p, w, stack);
      const unsigned done = __ballot_sync(0xffffffffu, w.e == kNone);
      if (done == 0xffffffffu) break;
      if (refill && __popc(done) >= kRefill) break;
    }
  }
}

// The K1 instantiation of a mode: counts, flags (watertight only), roots
// or none. Null for a combination the launcher refuses.
template <int W, int kLeaf>
const void* k1_kernel(int counts, int flags, int roots) {
  if (counts) return (const void*)traverse_kernel<W, kLeaf, true, false, true>;
  if (flags) {
    if constexpr (kLeaf == kTriangle) {
      return (const void*)traverse_kernel<W, kTriangle, false, true, true>;
    }
    return nullptr;
  }
  if (roots) return (const void*)traverse_kernel<W, kLeaf, false, false, true>;
  return (const void*)traverse_kernel<W, kLeaf, false, false, false>;
}

template <int W>
const void* k1_width(int leaf, int counts, int flags, int roots) {
  if (leaf == kSphere) return k1_kernel<W, kSphere>(counts, flags, roots);
  if (leaf == kCurve) return k1_kernel<W, kCurve>(counts, flags, roots);
  return leaf == kWoop ? k1_kernel<W, kWoop>(counts, flags, roots)
                       : k1_kernel<W, kTriangle>(counts, flags, roots);
}

const void* k1_pick(int width, int leaf, int counts, int flags, int roots) {
  return width == 16 ? k1_width<16>(leaf, counts, flags, roots)
                     : k1_width<8>(leaf, counts, flags, roots);
}

// The K1b instantiation (K is the launch's packets a claim): triangle
// leaves only.
const void* il_pick(int width, int leaf) {
  if (leaf == kSphere || leaf == kCurve) return nullptr;
  if (width == 16) {
    return leaf == kWoop ? (const void*)traverse_kernel_il<16, kWoop>
                         : (const void*)traverse_kernel_il<16, kTriangle>;
  }
  return leaf == kWoop ? (const void*)traverse_kernel_il<8, kWoop>
                       : (const void*)traverse_kernel_il<8, kTriangle>;
}

}  // namespace

// counts, flags and interleave > 1 are exclusive modes; flags need the
// watertight test and interleave > 1 a triangle test; roots (with packet
// > 0) combine with any mode. ``leaf``: kTriangle, kWoop, kSphere or
// kCurve.
// ``scratch``: two zeroed uint64, the claim counter and the overflow
// word. ``grid`` and, for K1b, ``packets`` (packets of 32 rays a claim:
// interleave, or 1) are traverse/packet.py::launch_plan's.
extern "C" int nrt_packet_traverse(
    const float* nodes, const float* leafs, const float* org, const float* dir,
    const float* min_t, const float* max_t, const int* skip, const int* roots,
    float* t_out, float* u_out, float* v_out, long long* pid_out, int* flags,
    unsigned long long* scratch, long long n_rays, long long packet,
    int width, int stack_size, int occlusion, int cull_back_face,
    int exact_edge, int use_range, int range_lo, int range_hi, int leaf,
    int counts, int zero_flags, int interleave, int grid, int packets,
    void* stream) {
  if (stack_size < 1 || stack_size > kStackCap) return (int)cudaErrorInvalidValue;
  if (width != 8 && width != 16) return (int)cudaErrorInvalidValue;
  if (interleave != 1 && interleave != 2 && interleave != 4)
    return (int)cudaErrorInvalidValue;
  if ((counts != 0) + (zero_flags != 0) + (interleave > 1) > 1)
    return (int)cudaErrorInvalidValue;
  if (leaf < kTriangle || leaf > kCurve) return (int)cudaErrorInvalidValue;
  if (zero_flags && (leaf != kTriangle || flags == nullptr))
    return (int)cudaErrorInvalidValue;
  if (roots && packet < 1) return (int)cudaErrorInvalidValue;
  if (grid < 1) return (int)cudaErrorInvalidValue;
  if (interleave > 1 && n_rays > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (interleave > 1 && packets != 1 && packets != interleave)
    return (int)cudaErrorInvalidValue;
  if (n_rays <= 0) return 0;
  Params p{nodes,   leafs,          org,        dir,       min_t,
           max_t,   skip,           roots,      t_out,     u_out,
           v_out,   pid_out,        flags,      scratch,   scratch + 1,
           n_rays,  packet,         stack_size, occlusion, cull_back_face,
           exact_edge, use_range,   range_lo,   range_hi,
           packets};
  const void* fn =
      interleave > 1
          ? il_pick(width, leaf)
          : k1_pick(width, leaf, counts, zero_flags, roots != nullptr);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  void* args[] = {&p};
  const cudaError_t e = cudaLaunchKernel(fn, dim3((unsigned)grid),
                                         dim3(kThreads), args, 0,
                                         reinterpret_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// What the launch plan needs of one K1 or K1b instantiation (K1b when
// interleave > 1): out[0] resident
// blocks per SM (occupancy API), out[1] registers a thread, out[2] local
// bytes a thread (the stack frame), out[3] shared bytes a block, out[4]
// threads a block, out[5] rays a claim.
extern "C" int nrt_packet_traverse_occupancy(int width, int leaf, int counts,
                                             int flags, int roots,
                                             int interleave, int* out) {
  if (width != 8 && width != 16) return (int)cudaErrorInvalidValue;
  if (interleave != 1 && interleave != 2 && interleave != 4)
    return (int)cudaErrorInvalidValue;
  if (leaf < kTriangle || leaf > kCurve) return (int)cudaErrorInvalidValue;
  const void* fn = interleave > 1 ? il_pick(width, leaf)
                                  : k1_pick(width, leaf, counts, flags, roots);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, fn);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  out[0] = blocks;
  out[1] = a.numRegs;
  out[2] = (int)a.localSizeBytes;
  out[3] = (int)a.sharedSizeBytes;
  out[4] = kThreads;
  out[5] = kClaim * interleave;
  return 0;
}
