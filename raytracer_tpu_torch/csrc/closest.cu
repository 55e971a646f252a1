// Closest hit for Hopper (sm_90a): the winner over the sphere, rect and
// triangle tables for each ray, with a per-ray t_min, t_max and alive mask,
// one thread per ray.
//
// Replaces raytracer_tpu/ops/pallas_intersect.py::_closest_kernel (the
// static chunk scan reached through _call_kernel / _run / intersect_pallas),
// whose plain PyTorch twin is
// raytracer_tpu_torch/ops/closest_hit.py::closest_hit_plain. Its callers are
// the NEE shadow rays and the unfused bounce.
//
// Output per ray: t (+inf on a miss), type (-1 on a miss), index in the
// scene's own table order (-1 on a miss) and the triangle barycentrics b1,
// b2. The TPU kernel's 28 winner slots are not carried over: they exist
// because TPU gathers are slow, and the caller reads the winner's record
// from the tables once. Dead lanes miss (on the TPU they miss only when the
// whole ray tile is dead).
//
// What bounds it: FP32 work on the CUDA cores, as for the fused bounce
// (bounce.cu): ~1005 sphere tests of ~17 flops per ray at the main path's
// shape against 53 bytes of ray I/O. The sweep is sweep.cuh's, the same
// code as the fused bounce's, with its design: two rays per thread, the
// pair loop in groups of staged spheres read once for both rays, tables
// through a 16 KB shared-memory tile read as a broadcast, the winner in
// registers, one block per 256-lane tile. No occlusion early exit: the
// kernel computes the same closest hit as the TPU kernel.
//
// Motion blur: rt_closest_motion launches the kernel with MOTION = true
// (the TPU kernel with has_time=True): spheres tested at c + v t, v from
// sph_vel (S, 4) and t the ray's shutter time (the NEE shadow rays inherit
// their lane's). The static entry point compiles to the static code.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sweep.cuh"

namespace {

constexpr int BLOCK = 128;
constexpr int RAYS = 2;                 // rays per thread
constexpr int TILE = BLOCK * RAYS;      // lanes per tile

template <bool MOTION>
__global__ void __launch_bounds__(BLOCK) closest_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ tmin, const float* __restrict__ tmax,
    const uint8_t* __restrict__ alive, int n,
    const float* __restrict__ sph, int n_sph,
    const float* __restrict__ rect, int n_rect,
    const float* __restrict__ tri, int n_tri,
    float* __restrict__ out_t, int* __restrict__ out_ty,
    int* __restrict__ out_ix, float* __restrict__ out_b1,
    float* __restrict__ out_b2, const float* __restrict__ sph_vel,
    const float* __restrict__ time) {
  __shared__ __align__(16) float tile[TILE_FLOATS];
  int i[RAYS];
  bool live[RAYS];
  Ray ray[RAYS];
  float tm[RAYS];
#pragma unroll
  for (int k = 0; k < RAYS; ++k) {
    i[k] = blockIdx.x * TILE + k * BLOCK + threadIdx.x;
    const bool in = i[k] < n;
    live[k] = in && alive[i[k]] != 0;
    ray[k] = Ray{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, BIG};
    tm[k] = 0.f;
    if (in) {
      const int j = i[k];
      ray[k] = Ray{o[j], o[n + j], o[2 * n + j], d[j], d[n + j],
                   d[2 * n + j], tmin[j], tmax[j]};
      if constexpr (MOTION) tm[k] = time[j];
    }
  }
  Winner w[RAYS];
  sweep_rays<BLOCK, RAYS, MOTION>(tile, live, ray, sph, n_sph, rect,
                                  n_rect, tri, n_tri, w, sph_vel, tm);
#pragma unroll
  for (int k = 0; k < RAYS; ++k) {
    const int j = i[k];
    if (j >= n) continue;
    const bool hit = w[k].ty >= 0;
    out_t[j] = hit ? w[k].t : INFINITY;
    out_ty[j] = w[k].ty;
    out_ix[j] = hit ? w[k].ix : -1;
    out_b1[j] = w[k].b1;
    out_b2[j] = w[k].b2;
  }
}

// Launch closest_kernel<MOTION>, one block per tile.
template <bool MOTION, class... Args>
int launch(int n, cudaStream_t stream, Args... args) {
  closest_kernel<MOTION><<<(n + TILE - 1) / TILE, BLOCK, 0, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream`, does not
// synchronise, allocates nothing; returns cudaGetLastError() of the launch.
// o, d (3, n) f32; tmin, tmax (n,) f32 (tmax may be +inf); alive (n,) bool.
extern "C" int rt_closest(
    const float* o, const float* d, const float* tmin, const float* tmax,
    const uint8_t* alive, int n,
    const float* sph, int n_sph, const float* rect, int n_rect,
    const float* tri, int n_tri,
    float* out_t, int* out_ty, int* out_ix, float* out_b1, float* out_b2,
    cudaStream_t stream) {
  if (n <= 0) return 0;
  return launch<false>(n, stream, o, d, tmin, tmax, alive, n, sph, n_sph,
                       rect, n_rect, tri, n_tri, out_t, out_ty, out_ix,
                       out_b1, out_b2, (const float*)nullptr,
                       (const float*)nullptr);
}

// rt_closest with motion blur: its arguments up to out_b2, then the sphere
// velocities sph_vel (n_sph, 4) and the per-ray shutter time (n,).
extern "C" int rt_closest_motion(
    const float* o, const float* d, const float* tmin, const float* tmax,
    const uint8_t* alive, int n,
    const float* sph, int n_sph, const float* rect, int n_rect,
    const float* tri, int n_tri,
    float* out_t, int* out_ty, int* out_ix, float* out_b1, float* out_b2,
    const float* sph_vel, const float* time, cudaStream_t stream) {
  if (n <= 0) return 0;
  return launch<true>(n, stream, o, d, tmin, tmax, alive, n, sph, n_sph,
                      rect, n_rect, tri, n_tri, out_t, out_ty, out_ix, out_b1,
                      out_b2, sph_vel, time);
}

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
