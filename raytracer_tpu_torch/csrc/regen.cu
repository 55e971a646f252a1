// One step of the regeneration loop for Hopper (sm_90a), one thread per
// lane: the flat closest-hit sweep (sweep.cuh), the bounce's values
// (scatter.cuh), then emission, throughput, Russian roulette, retire and
// quota counting and the camera respawn (regen.cuh), the lane state updated
// in place.
//
// Replaces raytracer_tpu/ops/pallas_intersect.py::_regen_kernel (reached
// through _call_regen / regen_step_fused), whose plain PyTorch twin is
// raytracer_tpu_torch/ops/regen.py::regen_step_plain.
//
// What bounds it: the sweep's FP32 work, as in bounce.cu. The bookkeeping
// adds ~60 flops and ~180 bytes of lane state per lane (read and written
// once), which the eager loop spreads over ~30 kernels that each read and
// write whole rows; here it stays in registers. The design is bounce.cu's:
// SoA rows, two lanes per thread (the sweep reads each staged sphere once
// for both and takes the pairs in groups), tables through a 16 KB shared
// tile, the winner in registers, one block per 256-lane tile; the epilogue
// runs once per lane, one after the other.
//
// Motion blur: rt_regen_motion launches the kernel with MOTION = true (the
// TPU kernel with has_time=True): each lane's shutter time (read before the
// sweep) moves the spheres to c + v t in the sweep and the epilogue, and a
// respawned lane writes its next sample's time from U row 8 (regen.cuh).

#include <cuda_runtime.h>
#include <stdint.h>

#include "regen.cuh"
#include "scatter.cuh"
#include "sweep.cuh"

namespace {

constexpr int BLOCK = 128;
constexpr int RAYS = 2;                 // lanes per thread
constexpr int TILE = BLOCK * RAYS;      // lanes per tile

template <bool MOTION>
__global__ void __launch_bounds__(BLOCK) regen_kernel(
    const Lanes L, const RegenParams P, float tmin, int n,
    const float* __restrict__ sph, const int* __restrict__ sph_mat, int n_sph,
    const float* __restrict__ rect, const int* __restrict__ rect_mat,
    int n_rect,
    const float* __restrict__ tri, const float* __restrict__ tri_nrm,
    const int* __restrict__ tri_mat, int n_tri,
    const float* __restrict__ mat, const float* __restrict__ sph_vel,
    float* __restrict__ time) {
  __shared__ __align__(16) float tile[TILE_FLOATS];
  int i[RAYS];
  bool live[RAYS];
  Ray ray[RAYS];
  float tm[RAYS];
#pragma unroll
  for (int k = 0; k < RAYS; ++k) {
    i[k] = blockIdx.x * TILE + k * BLOCK + threadIdx.x;
    const bool in = i[k] < n;
    live[k] = in && L.alive[i[k]] != 0;
    ray[k] = Ray{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, tmin, BIG};
    tm[k] = 0.f;
    if (in) {
      const int j = i[k];
      ray[k] = Ray{L.o[j], L.o[n + j], L.o[2 * n + j], L.d[j], L.d[n + j],
                   L.d[2 * n + j], tmin, BIG};
      if constexpr (MOTION) tm[k] = time[j];
    }
  }
  Winner w[RAYS];
  sweep_rays<BLOCK, RAYS, MOTION>(tile, live, ray, sph, n_sph, rect,
                                  n_rect, tri, n_tri, w, sph_vel, tm);
#pragma unroll
  for (int k = 0; k < RAYS; ++k) {
    if (i[k] < n)
      regen_epilogue<MOTION>(i[k], n, ray[k].ox, ray[k].oy, ray[k].oz,
                             ray[k].dx, ray[k].dy, ray[k].dz, live[k],
                             w[k], sph, sph_mat, rect, rect_mat, tri_nrm,
                             tri_mat, mat, L, P, sph_vel, tm[k], time);
  }
}

// Launch regen_kernel<MOTION>, one block per tile.
template <bool MOTION, class... Args>
int launch(int n, cudaStream_t stream, Args... args) {
  regen_kernel<MOTION><<<(n + TILE - 1) / TILE, BLOCK, 0, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream`, does not
// synchronise, allocates nothing; returns cudaGetLastError() of the launch.
// Lane state (updated in place): o, d, tput, samp, acc (3, n) f32, alive
// (n,) bytes, depth, done (n,) int32; read only: px, py (n,) f32, U (8, n)
// f32, cam (32,) f32. The tables are rt_bounce's.
extern "C" int rt_regen(
    float* o, float* d, float* tput, float* samp, float* acc, uint8_t* alive,
    int* depth, int* done, const float* px, const float* py, const float* U,
    const float* cam, float tmin, float eps, int n, int width, int height,
    int quota, int max_depth, int rr_on, int rr_start,
    const float* sph, const int* sph_mat, int n_sph,
    const float* rect, const int* rect_mat, int n_rect,
    const float* tri, const float* tri_nrm, const int* tri_mat, int n_tri,
    const float* mat, cudaStream_t stream) {
  if (n <= 0) return 0;
  const Lanes L{o, d, tput, samp, acc, alive, depth, done, px, py, U, cam};
  const RegenParams P{eps, width, height, quota, max_depth, rr_on, rr_start};
  return launch<false>(n, stream, L, P, tmin, n, sph, sph_mat, n_sph, rect,
                       rect_mat, n_rect, tri, tri_nrm, tri_mat, n_tri, mat,
                       (const float*)nullptr, (float*)nullptr);
}

// rt_regen with motion blur: its arguments up to mat (U now (9, n)), then
// the sphere velocities sph_vel (n_sph, 4) and the lanes' shutter time
// (n,), updated in place.
extern "C" int rt_regen_motion(
    float* o, float* d, float* tput, float* samp, float* acc, uint8_t* alive,
    int* depth, int* done, const float* px, const float* py, const float* U,
    const float* cam, float tmin, float eps, int n, int width, int height,
    int quota, int max_depth, int rr_on, int rr_start,
    const float* sph, const int* sph_mat, int n_sph,
    const float* rect, const int* rect_mat, int n_rect,
    const float* tri, const float* tri_nrm, const int* tri_mat, int n_tri,
    const float* mat, const float* sph_vel, float* time,
    cudaStream_t stream) {
  if (n <= 0) return 0;
  const Lanes L{o, d, tput, samp, acc, alive, depth, done, px, py, U, cam};
  const RegenParams P{eps, width, height, quota, max_depth, rr_on, rr_start};
  return launch<true>(n, stream, L, P, tmin, n, sph, sph_mat, n_sph, rect,
                      rect_mat, n_rect, tri, tri_nrm, tri_mat, n_tri, mat,
                      sph_vel, time);
}

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
