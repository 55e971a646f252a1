// One step of the regeneration loop with the near-to-far superchunk walk
// for Hopper (sm_90a): regen.cu with the walk of bounce_ordered.cu
// (sweep.cuh::sweep_ordered) for a sphere or triangle table that
// ops/ordered.py sorted, then the same epilogue (regen.cuh); one thread per
// lane, the lane state updated in place.
//
// Replaces raytracer_tpu/ops/pallas_intersect.py::_regen_kernel_ordered
// (reached through _call_regen / regen_step_fused), whose plain PyTorch
// twin is raytracer_tpu_torch/ops/regen.py::regen_step_plain on ordered
// tables. stats (optional, null = off): per block, the chunk bodies the two
// walks ran.
//
// What bounds it: FP32 work on the chunks a block can reach (see
// closest_ordered.cu); the epilogue is regen.cu's.
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

constexpr int BLOCK = 128;

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
    float* __restrict__ time) {
  __shared__ __align__(16) float tile[TILE_FLOATS];
  __shared__ WalkShared sh;
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  const bool in = i < n;
  const bool live = in && L.alive[i] != 0;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  float tm = 0.f;
  if (in) {
    ox = L.o[i]; oy = L.o[n + i]; oz = L.o[2 * n + i];
    dx = L.d[i]; dy = L.d[n + i]; dz = L.d[2 * n + i];
    if constexpr (MOTION) tm = time[i];
  }
  const Winner w = sweep_ordered<BLOCK, MOTION>(
      tile, sh, live, Ray{ox, oy, oz, dx, dy, dz, tmin, BIG}, sph, n_sph,
      osph, rect, n_rect, tri, n_tri, otri, stats, sph_vel, tm);
  if (!in) return;
  regen_epilogue<MOTION>(i, n, ox, oy, oz, dx, dy, dz, live, w, sph, sph_mat,
                         rect, rect_mat, tri_nrm, tri_mat, mat, L, P, sph_vel,
                         tm, time);
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
  if (s_k_ch / SUPER > MAX_SUPERS || t_k_ch / SUPER > MAX_SUPERS)
    return (int)cudaErrorInvalidValue;
  const Lanes L{o, d, tput, samp, acc, alive, depth, done, px, py, U, cam};
  const RegenParams P{eps, width, height, quota, max_depth, rr_on, rr_start};
  const Stage osph{s_prim, s_orig, s_cull, s_scull, s_box, s_k_ch, s_chunk};
  const Stage otri{t_prim, t_orig, t_cull, t_scull, t_box, t_k_ch, t_chunk};
  const int grid = (n + BLOCK - 1) / BLOCK;
  regen_ordered_kernel<false><<<grid, BLOCK, 0, stream>>>(
      L, P, tmin, n, sph, sph_mat, n_sph, rect, rect_mat, n_rect, tri,
      tri_nrm, tri_mat, n_tri, mat, osph, otri, stats, nullptr, nullptr);
  return (int)cudaGetLastError();
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
  if (s_k_ch / SUPER > MAX_SUPERS || t_k_ch / SUPER > MAX_SUPERS)
    return (int)cudaErrorInvalidValue;
  if (s_prim != nullptr && s_vel == nullptr)
    return (int)cudaErrorInvalidValue;
  const Lanes L{o, d, tput, samp, acc, alive, depth, done, px, py, U, cam};
  const RegenParams P{eps, width, height, quota, max_depth, rr_on, rr_start};
  const Stage osph{s_prim, s_orig, s_cull, s_scull, s_box, s_k_ch, s_chunk,
                   s_vel};
  const Stage otri{t_prim, t_orig, t_cull, t_scull, t_box, t_k_ch, t_chunk};
  const int grid = (n + BLOCK - 1) / BLOCK;
  regen_ordered_kernel<true><<<grid, BLOCK, 0, stream>>>(
      L, P, tmin, n, sph, sph_mat, n_sph, rect, rect_mat, n_rect, tri,
      tri_nrm, tri_mat, n_tri, mat, osph, otri, stats, sph_vel, time);
  return (int)cudaGetLastError();
}

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
