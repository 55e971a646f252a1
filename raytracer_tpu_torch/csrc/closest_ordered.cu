// Ordered closest hit for Hopper (sm_90a): the closest-hit kernel
// (closest.cu) with the near-to-far superchunk walk for a sphere or
// triangle table that ops/ordered.py sorted; one thread per ray, per-ray
// t_min, t_max and alive mask.
//
// Replaces raytracer_tpu/ops/pallas_intersect.py::_closest_kernel_ordered
// (reached through _call_kernel_ordered / _call_kernel / _run), whose plain
// PyTorch twin is
// raytracer_tpu_torch/ops/closest_hit.py::closest_ordered_plain. Its caller
// is the NEE shadow rays (and the unfused bounce) of large scenes.
//
// The TPU kernel gets each ray tile's superchunk order from a separate XLA
// pass through scalar prefetch; here each warp computes its own order in
// its shared memory (sweep.cuh::walk): a warp reduction of the alive
// origins, the gaps, a rank sort of at most MAX_SUPERS keys. That saves a
// launch and the host ops around it per call. Outputs as closest.cu: t
// (+inf on a miss), type (-1), index in the scene's own table order (the
// sorted slot's orig entry, -1 on a miss), b1, b2; dead lanes miss. stats
// (optional, null = off): per warp of 32 lanes, the chunk bodies the sphere
// and triangle walks ran.
//
// What bounds it: FP32 work on the CUDA cores, as for the flat kernel, but
// only on the chunks a warp can reach: at 65,537 spheres a camera-ray warp
// runs a few of the 264 chunks. The walk adds, per warp, the sort (k_sup^2
// compares over 32 lanes) and a few warp votes per superchunk and chunk
// visited; each body goes through the warp's own shared buffer
// (regen_ordered.cu).
//
// Motion blur: rt_closest_ordered_motion launches the kernel with MOTION =
// true (the TPU kernel with has_time=True): the walk tests the sorted
// spheres at c + v t from the stage's sorted vel rows (its boxes dilated
// over the shutter when it was packed), a flat sphere stage reads sph_vel.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sweep.cuh"

namespace {

constexpr int BLOCK = 128;   // 4 warps, each walking its own 32 lanes
static_assert(BLOCK == 4 * WARP, "sweep.cuh sizes shared memory for 4 warps");

template <bool MOTION>
__global__ void __launch_bounds__(BLOCK) closest_ordered_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ tmin, const float* __restrict__ tmax,
    const uint8_t* __restrict__ alive, int n,
    const float* __restrict__ sph, int n_sph,
    const float* __restrict__ rect, int n_rect,
    const float* __restrict__ tri, int n_tri,
    const Stage osph, const Stage otri,
    float* __restrict__ out_t, int* __restrict__ out_ty,
    int* __restrict__ out_ix, float* __restrict__ out_b1,
    float* __restrict__ out_b2, int* __restrict__ stats,
    const float* __restrict__ sph_vel, const float* __restrict__ time,
    int k_sup) {
  extern __shared__ __align__(16) float smem[];
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  const int at = i / WARP;        // this warp's 32-lane tile
  if (at * WARP >= n) return;     // the whole warp: none of its lanes is in
  const WarpShared sh = warp_shared(smem, k_sup);
  const bool in = i < n;
  const bool live = in && alive[i] != 0;
  Ray ray{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, BIG};
  float tm = 0.f;
  if (in) {
    ray = Ray{o[i], o[n + i], o[2 * n + i], d[i], d[n + i], d[2 * n + i],
              tmin[i], tmax[i]};
    if constexpr (MOTION) tm = time[i];
  }
  const Winner w = sweep_ordered<MOTION>(
      sh, live, ray, sph, n_sph, osph, rect, n_rect, tri, n_tri, otri,
      stats == nullptr ? nullptr : stats + 2 * at, sph_vel, tm);
  if (in) {
    const bool hit = w.ty >= 0;
    out_t[i] = hit ? w.t : INFINITY;
    out_ty[i] = w.ty;
    out_ix[i] = hit ? w.ix : -1;
    out_b1[i] = w.b1;
    out_b2[i] = w.b2;
  }
}

// Check the stages, then launch closest_ordered_kernel<MOTION>, a warp per 32
// lanes, with each warp's shared memory sized for the stages.
template <bool MOTION, class... Args>
int launch(int n, const Stage& osph, const Stage& otri, const float* sph,
           const float* rect, const float* tri, const float* sph_vel,
           cudaStream_t stream, Args... args) {
  const cudaError_t e = check_stages<MOTION>(osph, otri, sph, rect, tri,
                                             sph_vel);
  if (e != cudaSuccess) return (int)e;
  const int k_sup = walk_supers(osph, otri);
  const size_t smem = (BLOCK / WARP) * warp_shared_bytes(k_sup);
  closest_ordered_kernel<MOTION>
      <<<(n + BLOCK - 1) / BLOCK, BLOCK, smem, stream>>>(args..., k_sup);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream`, does not
// synchronise, allocates nothing; returns cudaGetLastError() of the launch.
// The flat arguments are rt_closest's; each ordered stage follows as
// (prim, orig, cull, scull, box, k_ch, chunk), null pointers for a stage
// that is swept flat; then stats.
extern "C" int rt_closest_ordered(
    const float* o, const float* d, const float* tmin, const float* tmax,
    const uint8_t* alive, int n,
    const float* sph, int n_sph, const float* rect, int n_rect,
    const float* tri, int n_tri,
    const float* s_prim, const int* s_orig, const float* s_cull,
    const float* s_scull, const float* s_box, int s_k_ch, int s_chunk,
    const float* t_prim, const int* t_orig, const float* t_cull,
    const float* t_scull, const float* t_box, int t_k_ch, int t_chunk,
    float* out_t, int* out_ty, int* out_ix, float* out_b1, float* out_b2,
    int* stats, cudaStream_t stream) {
  if (n <= 0) return 0;
  const Stage osph{s_prim, s_orig, s_cull, s_scull, s_box, s_k_ch, s_chunk};
  const Stage otri{t_prim, t_orig, t_cull, t_scull, t_box, t_k_ch, t_chunk};
  return launch<false>(n, osph, otri, sph, rect, tri, nullptr, stream, o, d,
                       tmin, tmax, alive, n, sph, n_sph, rect, n_rect, tri,
                       n_tri, osph, otri, out_t, out_ty, out_ix, out_b1,
                       out_b2, stats, (const float*)nullptr,
                       (const float*)nullptr);
}

// rt_closest_ordered with motion blur: its arguments up to stats, then the
// sphere velocities sph_vel (n_sph, 4) in scene order, the sphere stage's
// sorted velocities s_vel (s_k_ch * s_chunk, 4; null when the spheres are
// swept flat) and the per-ray shutter time (n,).
extern "C" int rt_closest_ordered_motion(
    const float* o, const float* d, const float* tmin, const float* tmax,
    const uint8_t* alive, int n,
    const float* sph, int n_sph, const float* rect, int n_rect,
    const float* tri, int n_tri,
    const float* s_prim, const int* s_orig, const float* s_cull,
    const float* s_scull, const float* s_box, int s_k_ch, int s_chunk,
    const float* t_prim, const int* t_orig, const float* t_cull,
    const float* t_scull, const float* t_box, int t_k_ch, int t_chunk,
    float* out_t, int* out_ty, int* out_ix, float* out_b1, float* out_b2,
    int* stats, const float* sph_vel, const float* s_vel, const float* time,
    cudaStream_t stream) {
  if (n <= 0) return 0;
  const Stage osph{s_prim, s_orig, s_cull, s_scull, s_box, s_k_ch, s_chunk,
                   s_vel};
  const Stage otri{t_prim, t_orig, t_cull, t_scull, t_box, t_k_ch, t_chunk};
  return launch<true>(n, osph, otri, sph, rect, tri, sph_vel, stream, o, d,
                      tmin, tmax, alive, n, sph, n_sph, rect, n_rect, tri,
                      n_tri, osph, otri, out_t, out_ty, out_ix, out_b1,
                      out_b2, stats, sph_vel, time);
}

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
