// Fused ambient occlusion for NVIDIA Hopper (sm_90a): the whole AO pass
// of one pixel in one thread — a watertight closest hit, its normal, an
// orthonormal basis and n_samples occlusion traces — in ONE launch.
//
// Replaces nanort_tpu/models/ao_fused.py::_ao_kernel (K5, called by
// _ao_fused_impl through pl.pallas_call), the one-launch form of
// models/objrender.py::render_ao (config A). The body mirrors
// ao_fused.py:59-111 op for op:
//   1. a primary closest-hit trace with the watertight test (Dekker exact
//      edges) and the aux row's geometric normal (bvh16::trace, K2);
//   2. a miss zeroes the normal; the normal is flipped to face the ray
//      when ((n.x d.x + n.y d.y) + n.z d.z) > 0;
//   3. p = (o + t d) + 1e-4 n;
//   4. the Frisvad basis of objrender.build_onb: s = n.z >= 0 ? 1 : -1,
//      a = -1 / (s + n.z), b = (n.x n.y) a, t = (1 + ((s n.x) n.x) a,
//      s b, -s n.x), bt = (b, s + (n.y n.y) a, -n.y);
//   5. sample k's world direction (l0 t + l1 bt) + l2 n from the
//      caller's local draws (S, R, 3) (objrender.ao_hemisphere_draws);
//   6. far = ao_radius on a hit and -1 on a miss, where the occlusion
//      rays are dead: [0, -1] is empty, bvh16::trace retires them before
//      their first node;
//   7. S watertight occlusion traces over [0, far] that skip the primary
//      prim;
//   8. ao = unoccluded * (1 / S) on a hit (the product XLA makes of the
//      division by S), else 0.
// Outputs per pixel: ao, t (tmax on a miss), u, v, prim id (-1 on a
// miss) and hit.
//
// What it does not copy: the TPU kernel runs a (sub, 128) pixel block
// through one shared SMEM stack per trace, in the (8 + 3S, NB, sub, 128)
// ray-block layout. Here each thread owns one pixel, reads its flat
// (R, 3) rays and its draws, and walks each of its 1 + S traces with a
// private stack (bvh16_trace.cuh).
//
// What bounds it on this card: the S occlusion walks, dependent node and
// leaf row fetches, and divergence between the lanes of a warp. The
// design keeps a warp's 32 pixels neighbours (the caller's order: row
// major, or 32 x 32 tiles) and gives sample k the same azimuth wedge in
// every lane (stratified draws), so the lanes of one occlusion trace
// point into one cone and mostly share their rows; dead rays of missed
// pixels cost nothing. Faster schemes (draws in shared memory, a warp
// scheduling its samples) are later work.
//
// Numerics: compile with --fmad=false, IEEE division, no -ftz, as the
// plain torch version (models/ao_fused.py::_ao_fused_reference) computes
// every product on its own.
//
// Interface: a plain C function (ctypes, no PyTorch headers) that
// launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError().

#include "bvh16_trace.cuh"

namespace {

constexpr int kBlock = 128;
constexpr float kAoEps = 1e-4f;  // hit-point offset along the normal

struct Params {
  const float* nodes;   // (N+1, 128) BVH16 node rows
  const float* leafs;   // (M, 128) leaf rows
  const float* aux;     // (M, 128) aux rows (ao_fused.build_ao_aux)
  const float* org;     // (R, 3)
  const float* dir;     // (R, 3)
  const float* tmin;    // (R,)
  const float* tmax;    // (R,)
  const float* draws;   // (S, R, 3) local hemisphere directions
  float* ao_out;        // (R,)
  float* t_out;
  float* u_out;
  float* v_out;
  int* pid_out;
  int* hit_out;
  int* err;
  long long n;
  int n_samples;
  float ao_radius;
  float inv_s;          // float32(1) / float32(S)
  int stack_size;
};

__global__ void __launch_bounds__(kBlock) ao_kernel(Params p) {
  const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (i >= p.n) return;
  const float ox = p.org[3 * i], oy = p.org[3 * i + 1],
              oz = p.org[3 * i + 2];
  const float dx = p.dir[3 * i], dy = p.dir[3 * i + 1],
              dz = p.dir[3 * i + 2];
  const bvh16::Record rec = bvh16::trace<false, true, true, false>(
      p.nodes, p.leafs, p.aux, p.stack_size, p.err, ox, oy, oz, dx, dy, dz,
      p.tmin[i], p.tmax[i]);
  const bool hit = rec.hit;
  float nx = hit ? rec.gx : 0.0f;
  float ny = hit ? rec.gy : 0.0f;
  float nz = hit ? rec.gz : 0.0f;
  if (nx * dx + ny * dy + nz * dz > 0.0f) {
    nx = -nx;
    ny = -ny;
    nz = -nz;
  }
  const float px = ox + rec.t * dx + kAoEps * nx;
  const float py = oy + rec.t * dy + kAoEps * ny;
  const float pz = oz + rec.t * dz + kAoEps * nz;

  const float s = nz >= 0.0f ? 1.0f : -1.0f;
  const float a = -1.0f / (s + nz);
  const float b = nx * ny * a;
  const float tx = 1.0f + s * nx * nx * a;
  const float ty = s * b;
  const float tz = -s * nx;
  const float bx = b;
  const float by = s + ny * ny * a;
  const float bz = -ny;
  const float far = hit ? p.ao_radius : -1.0f;

  int unocc = 0;
  for (int k = 0; k < p.n_samples; ++k) {
    const float* l = p.draws + ((size_t)k * p.n + i) * 3;
    const float l0 = l[0], l1 = l[1], l2 = l[2];
    const float wx = l0 * tx + l1 * bx + l2 * nx;
    const float wy = l0 * ty + l1 * by + l2 * ny;
    const float wz = l0 * tz + l1 * bz + l2 * nz;
    const bool occ = bvh16::trace<true, false, true, true>(
                         p.nodes, p.leafs, nullptr, p.stack_size, p.err, px,
                         py, pz, wx, wy, wz, 0.0f, far, rec.pid)
                         .hit;
    unocc += occ ? 0 : 1;
  }
  p.ao_out[i] = hit ? (float)unocc * p.inv_s : 0.0f;
  p.t_out[i] = rec.t;
  p.u_out[i] = rec.u;
  p.v_out[i] = rec.v;
  p.pid_out[i] = rec.pid;
  p.hit_out[i] = hit ? 1 : 0;
}

}  // namespace

extern "C" int nrt_ao_fused(
    const float* nodes, const float* leafs, const float* aux,
    const float* org, const float* dir, const float* tmin, const float* tmax,
    const float* draws, float* ao_out, float* t_out, float* u_out,
    float* v_out, int* pid_out, int* hit_out, int* err, long long n,
    int n_samples, float ao_radius, float inv_s, int stack_size,
    void* stream) {
  if (stack_size < 1 || stack_size > bvh16::kStackCap || n_samples < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (n <= 0) return 0;
  Params p{nodes,  leafs, aux,   org,     dir,     tmin, tmax,
           draws,  ao_out, t_out, u_out,  v_out,   pid_out, hit_out,
           err,    n,     n_samples, ao_radius, inv_s, stack_size};
  const unsigned grid = (unsigned)((n + kBlock - 1) / kBlock);
  ao_kernel<<<grid, kBlock, 0, reinterpret_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
