// One step of the regeneration loop with the near-to-far superchunk walk
// for Hopper (sm_90a): regen.cu with the walk of bounce_ordered.cu
// (sweep.cuh::sweep_ordered) for a sphere or triangle table that
// ops/ordered.py sorted, then the same epilogue (regen.cuh); one thread per
// lane, the lane state updated in place.
//
// Replaces raytracer_tpu/ops/pallas_intersect.py::_regen_kernel_ordered
// (reached through _call_regen / regen_step_fused), whose plain PyTorch
// twin is raytracer_tpu_torch/ops/regen.py::regen_step_plain on ordered
// tables. stats (optional, null = off): per warp of 32 lanes, the chunk
// bodies the two walks ran.
//
// What bounds it: FP32 work on the chunks a warp can reach, and on
// secondary rays how few lanes share a chunk: at the captured field64k step
// (268,136 of 480,000 lanes alive, the dead ones mostly in whole dead
// warps) a block of 128 lanes ran 8.44 chunk bodies for all its lanes,
// staged by the whole block behind two barriers each, after block-wide
// decisions, where each warp of its own 32 lanes needs 4.70. The design
// (sweep.cuh::sweep_ordered): each warp walks alone, on its own 32 lanes'
// box, reach and culls, so it runs only the bodies its lanes can reach,
// copies them into its own shared buffer and never waits for another warp
// (a warp whose lanes finish early retires). The epilogue is regen.cu's.
// The pairs' arithmetic is sweep.cuh's grouped test. A lane's
// winner is the one the block-wide walk gave, bit for bit (the same pair
// tests and fold, every cull conservative for a true hit), except where
// that walk kept a float32 false hit outside its chunk's box only because
// another lane of the block ran the chunk (sweep.cuh).
//
// Motion blur: rt_regen_ordered_motion launches the kernel with MOTION =
// true (the TPU kernel with has_time=True), as regen.cu's motion entry
// point, with the walk of bounce_ordered.cu's (the sorted velocities in the
// stage's vel rows).

#include <cuda_runtime.h>
#include <stdint.h>

#include "regen.cuh"
#include "scatter.cuh"
#include "sweep.cuh"

namespace {

constexpr int BLOCK = 128;   // 4 warps, each walking its own 32 lanes
static_assert(BLOCK == 4 * WARP, "sweep.cuh sizes shared memory for 4 warps");

template <bool MOTION>
__global__ void __launch_bounds__(BLOCK) regen_ordered_kernel(
    const Lanes L, const RegenParams P, float tmin, int n,
    const float* __restrict__ sph, const int* __restrict__ sph_mat, int n_sph,
    const float* __restrict__ rect, const int* __restrict__ rect_mat,
    int n_rect,
    const float* __restrict__ tri, const float* __restrict__ tri_nrm,
    const int* __restrict__ tri_mat, int n_tri,
    const float* __restrict__ mat, const Stage osph, const Stage otri,
    int* __restrict__ stats, const float* __restrict__ sph_vel,
    float* __restrict__ time, int k_sup) {
  extern __shared__ __align__(16) float smem[];
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  const int at = i / WARP;        // this warp's 32-lane tile
  if (at * WARP >= n) return;     // the whole warp: none of its lanes is in
  const WarpShared sh = warp_shared(smem, k_sup);
  const bool in = i < n;
  const bool live = in && L.alive[i] != 0;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  float tm = 0.f;
  if (in) {
    ox = L.o[i]; oy = L.o[n + i]; oz = L.o[2 * n + i];
    dx = L.d[i]; dy = L.d[n + i]; dz = L.d[2 * n + i];
    if constexpr (MOTION) tm = time[i];
  }
  const Winner w = sweep_ordered<MOTION>(
      sh, live, Ray{ox, oy, oz, dx, dy, dz, tmin, BIG}, sph, n_sph, osph,
      rect, n_rect, tri, n_tri, otri,
      stats == nullptr ? nullptr : stats + 2 * at, sph_vel, tm);
  if (in)
    regen_epilogue<MOTION>(i, n, ox, oy, oz, dx, dy, dz, live, w, sph,
                           sph_mat, rect, rect_mat, tri_nrm, tri_mat, mat,
                           L, P, sph_vel, tm, time);
}

// Check the stages, then launch regen_ordered_kernel<MOTION>, a warp per 32
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
  regen_ordered_kernel<MOTION>
      <<<(n + BLOCK - 1) / BLOCK, BLOCK, smem, stream>>>(args..., k_sup);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream`, does not
// synchronise, allocates nothing; returns cudaGetLastError() of the launch.
// The arguments are rt_regen's; each ordered stage follows the tables as
// (prim, orig, cull, scull, box, k_ch, chunk), null pointers for a stage
// that is swept flat, then stats.
extern "C" int rt_regen_ordered(
    float* o, float* d, float* tput, float* samp, float* acc, uint8_t* alive,
    int* depth, int* done, const float* px, const float* py, const float* U,
    const float* cam, float tmin, float eps, int n, int width, int height,
    int quota, int max_depth, int rr_on, int rr_start,
    const float* sph, const int* sph_mat, int n_sph,
    const float* rect, const int* rect_mat, int n_rect,
    const float* tri, const float* tri_nrm, const int* tri_mat, int n_tri,
    const float* mat,
    const float* s_prim, const int* s_orig, const float* s_cull,
    const float* s_scull, const float* s_box, int s_k_ch, int s_chunk,
    const float* t_prim, const int* t_orig, const float* t_cull,
    const float* t_scull, const float* t_box, int t_k_ch, int t_chunk,
    int* stats, cudaStream_t stream) {
  if (n <= 0) return 0;
  const Lanes L{o, d, tput, samp, acc, alive, depth, done, px, py, U, cam};
  const RegenParams P{eps, width, height, quota, max_depth, rr_on, rr_start};
  const Stage osph{s_prim, s_orig, s_cull, s_scull, s_box, s_k_ch, s_chunk};
  const Stage otri{t_prim, t_orig, t_cull, t_scull, t_box, t_k_ch, t_chunk};
  return launch<false>(n, osph, otri, sph, rect, tri, nullptr, stream, L, P,
                       tmin, n, sph, sph_mat, n_sph, rect, rect_mat, n_rect,
                       tri, tri_nrm, tri_mat, n_tri, mat, osph, otri, stats,
                       (const float*)nullptr, (float*)nullptr);
}

// rt_regen_ordered with motion blur: its arguments up to stats (U now
// (9, n)), then the sphere velocities sph_vel (n_sph, 4) in scene order,
// the sphere stage's sorted velocities s_vel (s_k_ch * s_chunk, 4; null
// when the spheres are swept flat) and the lanes' shutter time (n,),
// updated in place.
extern "C" int rt_regen_ordered_motion(
    float* o, float* d, float* tput, float* samp, float* acc, uint8_t* alive,
    int* depth, int* done, const float* px, const float* py, const float* U,
    const float* cam, float tmin, float eps, int n, int width, int height,
    int quota, int max_depth, int rr_on, int rr_start,
    const float* sph, const int* sph_mat, int n_sph,
    const float* rect, const int* rect_mat, int n_rect,
    const float* tri, const float* tri_nrm, const int* tri_mat, int n_tri,
    const float* mat,
    const float* s_prim, const int* s_orig, const float* s_cull,
    const float* s_scull, const float* s_box, int s_k_ch, int s_chunk,
    const float* t_prim, const int* t_orig, const float* t_cull,
    const float* t_scull, const float* t_box, int t_k_ch, int t_chunk,
    int* stats, const float* sph_vel, const float* s_vel, float* time,
    cudaStream_t stream) {
  if (n <= 0) return 0;
  const Lanes L{o, d, tput, samp, acc, alive, depth, done, px, py, U, cam};
  const RegenParams P{eps, width, height, quota, max_depth, rr_on, rr_start};
  const Stage osph{s_prim, s_orig, s_cull, s_scull, s_box, s_k_ch, s_chunk,
                   s_vel};
  const Stage otri{t_prim, t_orig, t_cull, t_scull, t_box, t_k_ch, t_chunk};
  return launch<true>(n, osph, otri, sph, rect, tri, sph_vel, stream, L, P,
                      tmin, n, sph, sph_mat, n_sph, rect, rect_mat, n_rect,
                      tri, tri_nrm, tri_mat, n_tri, mat, osph, otri, stats,
                      sph_vel, time);
}

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
