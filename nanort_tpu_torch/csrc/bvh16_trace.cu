// K2 launched on its own: one thread per ray through bvh16::trace
// (bvh16_trace.cuh, which holds the kernel's note), with either leaf test
// and an optional per-ray skip. The path tracer (pt_fused.cu) and the
// fused AO pass (ao_fused.cu) run the same device function inside their
// megakernels; this launcher exists so that the trace can be held against
// its plain torch version (traverse/fused_trace.py::trace_bvh16_reference)
// on its own, as the JAX package's tests drive make_tracer through a
// small pallas_call.
//
// Interface: a plain C function (ctypes, no PyTorch headers) that
// launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError().

#include "bvh16_trace.cuh"

namespace {

constexpr int kBlock = 128;

struct Params {
  const float* nodes;
  const float* leafs;
  const float* aux;     // null unless want_aux
  const float* org;     // (R, 3)
  const float* dir;     // (R, 3)
  const float* tmin;    // (R,)
  const float* tmax;    // (R,)
  const int* skip;      // (R,) prim id each ray skips; kSkip only
  float* t_out;         // (R,) closest-hit only
  float* u_out;
  float* v_out;
  int* pid_out;
  int* hit_out;         // (R,) 1/0: hit, or occluded
  int* mid_out;         // (R,) want_aux only
  float* gn_out;        // (R, 3) want_aux only
  int* err;
  long long n;
  int stack_size;
};

template <bool kOcclusion, bool kAux, bool kWatertight, bool kSkip>
__global__ void __launch_bounds__(kBlock) trace_kernel(Params p) {
  const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (i >= p.n) return;
  const bvh16::Record r =
      bvh16::trace<kOcclusion, kAux, kWatertight, kSkip>(
          p.nodes, p.leafs, p.aux, p.stack_size, p.err, p.org[3 * i],
          p.org[3 * i + 1], p.org[3 * i + 2], p.dir[3 * i],
          p.dir[3 * i + 1], p.dir[3 * i + 2], p.tmin[i], p.tmax[i],
          kSkip ? p.skip[i] : -1);
  p.hit_out[i] = r.hit ? 1 : 0;
  if (kOcclusion) return;
  p.t_out[i] = r.t;
  p.u_out[i] = r.u;
  p.v_out[i] = r.v;
  p.pid_out[i] = r.pid;
  if (kAux) {
    p.mid_out[i] = r.mid;
    p.gn_out[3 * i] = r.gx;
    p.gn_out[3 * i + 1] = r.gy;
    p.gn_out[3 * i + 2] = r.gz;
  }
}

template <bool kWatertight, bool kSkip>
void launch(const Params& p, int occlusion, int want_aux, unsigned grid,
            cudaStream_t s) {
  if (occlusion) {
    trace_kernel<true, false, kWatertight, kSkip><<<grid, kBlock, 0, s>>>(p);
  } else if (want_aux) {
    trace_kernel<false, true, kWatertight, kSkip><<<grid, kBlock, 0, s>>>(p);
  } else {
    trace_kernel<false, false, kWatertight, kSkip><<<grid, kBlock, 0, s>>>(p);
  }
}

}  // namespace

extern "C" int nrt_bvh16_trace(
    const float* nodes, const float* leafs, const float* aux,
    const float* org, const float* dir, const float* tmin, const float* tmax,
    const int* skip, float* t_out, float* u_out, float* v_out, int* pid_out,
    int* hit_out, int* mid_out, float* gn_out, int* err, long long n,
    int stack_size, int occlusion, int want_aux, int watertight,
    void* stream) {
  if (stack_size < 1 || stack_size > bvh16::kStackCap) {
    return (int)cudaErrorInvalidValue;
  }
  if (n <= 0) return 0;
  Params p{nodes, leafs,   aux,     org,     dir,     tmin,   tmax, skip,
           t_out, u_out,   v_out,   pid_out, hit_out, mid_out, gn_out,
           err,   n,       stack_size};
  const unsigned grid = (unsigned)((n + kBlock - 1) / kBlock);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (watertight) {
    if (skip) {
      launch<true, true>(p, occlusion, want_aux, grid, s);
    } else {
      launch<true, false>(p, occlusion, want_aux, grid, s);
    }
  } else if (skip) {
    launch<false, true>(p, occlusion, want_aux, grid, s);
  } else {
    launch<false, false>(p, occlusion, want_aux, grid, s);
  }
  return (int)cudaGetLastError();
}
