// Fused ambient occlusion for NVIDIA Hopper (sm_90a): the whole AO pass
// of a pixel — a watertight closest hit, its normal, an orthonormal basis
// and n_samples occlusion traces — in ONE launch, with persistent warps
// that claim 32-pixel tiles and share their hit pixels' occlusion samples
// across all 32 lanes.
//
// Replaces nanort_tpu/models/ao_fused.py::_ao_kernel (K5, called by
// _ao_fused_impl through pl.pallas_call), the one-launch form of
// models/objrender.py::render_ao (config A). Each pixel's arithmetic
// mirrors ao_fused.py:59-111 op for op:
//   1. a primary closest-hit trace with the watertight test (Dekker exact
//      edges) and the aux row's geometric normal (bvh16::trace, K2);
//   2. the normal is flipped to face the ray when
//      ((n.x d.x + n.y d.y) + n.z d.z) > 0;
//   3. p = (o + t d) + 1e-4 n;
//   4. the Frisvad basis of objrender.build_onb: s = n.z >= 0 ? 1 : -1,
//      a = -1 / (s + n.z), b = (n.x n.y) a, t = (1 + ((s n.x) n.x) a,
//      s b, -s n.x), bt = (b, s + (n.y n.y) a, -n.y);
//   5. sample k's world direction (l0 t + l1 bt) + l2 n from the
//      caller's local draws (S, R, 3) (objrender.ao_hemisphere_draws);
//   6. S watertight occlusion traces over [0, ao_radius] that skip the
//      primary prim; a missed pixel traces none (the TPU kernel gives its
//      rays far = -1, which K2 retires before their first node);
//   7. ao = unoccluded * (1 / S) on a hit (the product XLA makes of the
//      division by S), else 0. The count is an integer, so the order in
//      which a pixel's samples are traced changes no bit.
// Outputs per pixel: ao, t (tmax on a miss), u, v, prim id (-1 on a
// miss) and hit.
//
// What it does not copy: the TPU kernel runs a (sub, 128) pixel block
// through one shared SMEM stack per trace, in the (8 + 3S, NB, sub, 128)
// ray-block layout. Here the rays are flat (R, 3) and the draws (S, R, 3).
//
// What bounds it on this card: the occlusion walks (dependent node and
// leaf row fetches) and the lanes of a warp that wait for each other. The
// schedule:
//   * persistent warps (the grid is the resident blocks, models/
//     ao_fused.py::ao_grid) claim 32 consecutive pixels, a tile, with one
//     atomicAdd by lane 0 at a point all 32 lanes reach;
//   * each lane traces its pixel's primary and writes the pixel's state
//     (hit point, facing normal, the prim to skip) to the warp's slot in
//     shared memory;
//   * a ballot and a popc prefix list the tile's L hit pixels; their
//     L x S occlusion samples are items, ordered sample-major (k outer,
//     pixel inner), and the 32 lanes take them in steps of 32: the lanes
//     of a step trace one stratified sample k for neighbouring pixels, so
//     they point into one cone and mostly share their rows (the caller's
//     order, row major or 32 x 32 tiles, makes a tile's pixels
//     neighbours), and no lane waits on a missed pixel or on a pixel's
//     samples in series. An unoccluded item adds 1 to its pixel's integer
//     count in shared memory;
//   * the tile's 32 outputs are written once and the warp claims again.
// Most of the time is the occlusion walks (on config A the primaries
// alone take under a fifth of the launch), so K2's node step matters most:
// its child metadata arrives a quad at a time and its NaN-propagating
// folds are single PTX instructions (bvh16_trace.cuh).
//
// Numerics: compile with --fmad=false, IEEE division, no -ftz, as the
// plain torch version (models/ao_fused.py::_ao_fused_reference) computes
// every product on its own.
//
// Interface: plain C functions (ctypes, no PyTorch headers); the launch
// runs on the caller's stream, allocates nothing, and returns
// cudaGetLastError().

#include "bvh16_trace.cuh"

namespace {

constexpr int kBlock = 128;
constexpr int kWarps = kBlock / 32;
constexpr unsigned kFull = 0xffffffffu;
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
  unsigned long long* scratch;  // [0] tile counter, [1] items traced
  long long n;
  int n_samples;
  float ao_radius;
  float inv_s;          // float32(1) / float32(S)
  int stack_size;
};

// One warp's tile of 32 pixels, one entry a lane.
struct Slot {
  float px[32], py[32], pz[32];  // hit point, offset along the normal
  float nx[32], ny[32], nz[32];  // geometric normal facing the ray
  int skip[32];                  // the primary's prim id
  int unocc[32];                 // unoccluded samples so far
  int live[32];                  // live[r]: the lane of the r-th hit pixel
};

// Lane ``lane`` of the tile at ``base``: trace the pixel's primary, write
// its records, and leave its state in the slot. True when the pixel hit,
// and only then does it get occlusion samples.
__device__ bool tile_primary(const Params& p, Slot& s, long long base,
                             int lane) {
  const long long i = base + lane;
  if (i >= p.n) return false;
  const float ox = p.org[3 * i], oy = p.org[3 * i + 1],
              oz = p.org[3 * i + 2];
  const float dx = p.dir[3 * i], dy = p.dir[3 * i + 1],
              dz = p.dir[3 * i + 2];
  const bvh16::Record rec = bvh16::trace<false, true, true, false>(
      p.nodes, p.leafs, p.aux, p.stack_size, p.err, ox, oy, oz, dx, dy, dz,
      p.tmin[i], p.tmax[i]);
  p.t_out[i] = rec.t;
  p.u_out[i] = rec.u;
  p.v_out[i] = rec.v;
  p.pid_out[i] = rec.pid;
  p.hit_out[i] = rec.hit ? 1 : 0;
  s.unocc[lane] = 0;
  if (!rec.hit) return false;
  float nx = rec.gx, ny = rec.gy, nz = rec.gz;
  if (nx * dx + ny * dy + nz * dz > 0.0f) {
    nx = -nx;
    ny = -ny;
    nz = -nz;
  }
  s.px[lane] = ox + rec.t * dx + kAoEps * nx;
  s.py[lane] = oy + rec.t * dy + kAoEps * ny;
  s.pz[lane] = oz + rec.t * dz + kAoEps * nz;
  s.nx[lane] = nx;
  s.ny[lane] = ny;
  s.nz[lane] = nz;
  s.skip[lane] = rec.pid;
  return true;
}

// Lane ``lane``'s part of the tile's list of hit pixels (``hits``: the
// ballot of tile_primary's answers): the r-th hit pixel's lane goes to
// live[r], in lane order. Returns L, the number of hit pixels.
__device__ int tile_compact(Slot& s, unsigned hits, int lane) {
  if ((hits >> lane) & 1u) s.live[__popc(hits & ((1u << lane) - 1u))] = lane;
  return __popc(hits);
}

// The tile's items: sample k of each of its L hit pixels.
__device__ __forceinline__ int tile_items(int L, int n_samples) {
  return L * n_samples;
}

// Sample k of the pixel in lane q of the tile at ``base``: one occlusion
// trace; an unoccluded ray adds 1 to the pixel's count.
__device__ void occlusion_sample(const Params& p, Slot& s, long long base,
                                 int q, int k) {
  const float* l = p.draws + ((size_t)k * p.n + base + q) * 3;
  const float l0 = l[0], l1 = l[1], l2 = l[2];
  const float nx = s.nx[q], ny = s.ny[q], nz = s.nz[q];
  // the basis from the normal, for every item (storing it in the slot ran
  // no faster)
  const float sg = nz >= 0.0f ? 1.0f : -1.0f;
  const float a = -1.0f / (sg + nz);
  const float b = nx * ny * a;
  const float tx = 1.0f + sg * nx * nx * a, ty = sg * b, tz = -sg * nx;
  const float bx = b, by = sg + ny * ny * a, bz = -ny;
  const float wx = l0 * tx + l1 * bx + l2 * nx;
  const float wy = l0 * ty + l1 * by + l2 * ny;
  const float wz = l0 * tz + l1 * bz + l2 * nz;
  const bool occ = bvh16::trace<true, false, true, true>(
                       p.nodes, p.leafs, nullptr, p.stack_size, p.err,
                       s.px[q], s.py[q], s.pz[q], wx, wy, wz, 0.0f,
                       p.ao_radius, s.skip[q])
                       .hit;
  if (!occ) atomicAdd(&s.unocc[q], 1);
}

// Item j of the tile's L x S, sample-major: sample j / L of the pixel
// live[j % L].
__device__ void tile_item(const Params& p, Slot& s, long long base, int L,
                          int j) {
  const int k = j / L;
  occlusion_sample(p, s, base, s.live[j - k * L], k);
}

// Lane ``lane``'s ao, once the tile's items are traced.
__device__ void tile_finish(const Params& p, const Slot& s, long long base,
                            int lane, bool hit) {
  const long long i = base + lane;
  if (i >= p.n) return;
  p.ao_out[i] = hit ? (float)s.unocc[lane] * p.inv_s : 0.0f;
}

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// No minimum of resident blocks: 71 registers give 7 blocks of 128 an SM
// unbounded, and bounds of 7 or 8 blocks ran slower.
__global__ void __launch_bounds__(kBlock) ao_kernel(Params p) {
  __shared__ Slot slots[kWarps];
  const int lane = threadIdx.x & 31;
  Slot& s = slots[threadIdx.x >> 5];
  unsigned long long items = 0;
  for (;;) {
    // every lane of the warp reaches the claim (one taken in a divergent
    // branch cost K3 1.4x)
    unsigned long long claim = 0;
    if (lane == 0) claim = atomicAdd(p.scratch, 32ull);
    const long long base = (long long)__shfl_sync(kFull, claim, 0);
    if (base >= p.n) break;
    const bool hit = tile_primary(p, s, base, lane);
    const int L = tile_compact(s, __ballot_sync(kFull, hit), lane);
    __syncwarp();
    const int m = tile_items(L, p.n_samples);
    for (int j = lane; j < m; j += 32) {
      tile_item(p, s, base, L, j);
      ++items;
    }
    __syncwarp();
    tile_finish(p, s, base, lane, hit);
    __syncwarp();  // the next tile writes the slot again
  }
  items = warp_sum(items);
  if (lane == 0 && items) atomicAdd(p.scratch + 1, items);
}

}  // namespace

// ``scratch``: two zeroed uint64, the tile counter and the items (hit
// pixels x S) the launch traced; ``grid``: models/ao_fused.py::ao_grid's
// (the resident blocks, or fewer for a small batch).
extern "C" int nrt_ao_fused(
    const float* nodes, const float* leafs, const float* aux,
    const float* org, const float* dir, const float* tmin, const float* tmax,
    const float* draws, float* ao_out, float* t_out, float* u_out,
    float* v_out, int* pid_out, int* hit_out, int* err,
    unsigned long long* scratch, long long n, int n_samples, float ao_radius,
    float inv_s, int stack_size, int grid, void* stream) {
  if (stack_size < 1 || stack_size > bvh16::kStackCap || n_samples < 1 ||
      grid < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (n <= 0) return 0;
  Params p{nodes, leafs,  aux,     org,     dir,       tmin,  tmax,
           draws, ao_out, t_out,   u_out,   v_out,     pid_out, hit_out,
           err,   scratch, n,      n_samples, ao_radius, inv_s, stack_size};
  ao_kernel<<<(unsigned)grid, kBlock, 0,
              reinterpret_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// What the launch needs of K5: out[0] resident blocks per SM (occupancy
// API), out[1] registers a thread, out[2] local (spill and stack) bytes a
// thread, out[3] threads a block, out[4] static shared bytes a block.
extern "C" int nrt_ao_fused_occupancy(int* out) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, ao_kernel);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, ao_kernel, kBlock,
                                                      0);
  }
  if (e != cudaSuccess) return (int)e;
  out[1] = a.numRegs;
  out[2] = (int)a.localSizeBytes;
  out[3] = kBlock;
  out[4] = (int)a.sharedSizeBytes;
  return 0;
}
