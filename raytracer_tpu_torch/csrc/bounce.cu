// Fused bounce for Hopper (sm_90a): closest hit over the sphere, rect and
// triangle tables, then hit attributes, constant/checker texture, material
// scatter and the spawn offset, one thread per ray.
//
// Replaces raytracer_tpu/ops/pallas_intersect.py::_bounce_kernel (the static
// chunk scan reached through _call_bounce / bounce_fused), whose plain
// PyTorch twin is raytracer_tpu_torch/ops/fused_bounce.py::bounce_fused_plain.
//
// What bounds it: FP32 work on the CUDA cores. At the main path's shape
// (480,000 rays x 1005 spheres) each ray does ~1005 sphere tests of ~20
// flops against ~100 bytes of ray I/O, so memory traffic is negligible.
// The design follows from that:
//   * rays are SoA rows, (3, N): thread i reads o[c*N + i], so loads and
//     stores coalesce;
//   * tables stream through a 16 KB shared-memory tile; every thread of a
//     block reads the same primitive at once (a broadcast, no bank
//     conflicts), so the inner loop is pure arithmetic;
//   * the winner is kept in registers as (t, type, index, b1, b2) and its
//     geometry and material record are read from global memory once, after
//     the sweep (the TPU kernel's one-hot MXU extraction exists only
//     because TPU gathers are slow);
//   * a block whose lanes are all dead skips the sweep; a dead lane inside
//     a live block takes no part in it and writes the miss outputs.
// The sweep is sweep.cuh's, shared with the closest-hit kernel
// (closest.cu); the bounce calls it with t_max = BIG. The epilogue is
// scatter.cuh's, shared with the ordered bounce (bounce_ordered.cu).
//
// Motion blur: rt_bounce_motion launches the same kernel with MOTION = true
// (the TPU kernel with has_time=True): a per-ray shutter time row, spheres
// tested at c + v t from the velocity table sph_vel (S, 4), the winner's
// attributes at the moved centre. The static entry point compiles to the
// static code (sweep.cuh: every motion branch is `if constexpr`).

#include <cuda_runtime.h>
#include <stdint.h>

#include "scatter.cuh"
#include "sweep.cuh"

namespace {

constexpr int BLOCK = 128;

template <bool MOTION>
__global__ void __launch_bounds__(BLOCK) bounce_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const uint8_t* __restrict__ alive, const float* __restrict__ uni,
    float tmin, int n,
    const float* __restrict__ sph, const int* __restrict__ sph_mat, int n_sph,
    const float* __restrict__ rect, const int* __restrict__ rect_mat,
    int n_rect,
    const float* __restrict__ tri, const float* __restrict__ tri_nrm,
    const int* __restrict__ tri_mat, int n_tri,
    const float* __restrict__ mat,
    float* __restrict__ out_no, float* __restrict__ out_nd,
    float* __restrict__ out_att, float* __restrict__ out_emit,
    float* __restrict__ out_p, float* __restrict__ out_n,
    int* __restrict__ out_inter, const float* __restrict__ sph_vel,
    const float* __restrict__ time) {
  __shared__ __align__(16) float tile[TILE_FLOATS];
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  const bool in = i < n;
  const bool live = in && alive[i] != 0;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  float tm = 0.f;
  if (in) {
    ox = o[i]; oy = o[n + i]; oz = o[2 * n + i];
    dx = d[i]; dy = d[n + i]; dz = d[2 * n + i];
    if constexpr (MOTION) tm = time[i];
  }
  const Winner w = sweep<BLOCK, MOTION>(
      tile, live, Ray{ox, oy, oz, dx, dy, dz, tmin, BIG}, sph, n_sph, rect,
      n_rect, tri, n_tri, sph_vel, tm);
  if (!in) return;

  bounce_epilogue<MOTION>(i, n, ox, oy, oz, dx, dy, dz, w, sph, sph_mat,
                          rect, rect_mat, tri_nrm, tri_mat, mat, uni, out_no,
                          out_nd, out_att, out_emit, out_p, out_n, out_inter,
                          sph_vel, tm);
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream`, does not
// synchronise, allocates nothing; returns cudaGetLastError() of the launch.
extern "C" int rt_bounce(
    const float* o, const float* d, const uint8_t* alive, const float* uni,
    float tmin, int n,
    const float* sph, const int* sph_mat, int n_sph,
    const float* rect, const int* rect_mat, int n_rect,
    const float* tri, const float* tri_nrm, const int* tri_mat, int n_tri,
    const float* mat,
    float* out_no, float* out_nd, float* out_att, float* out_emit,
    float* out_p, float* out_n, int* out_inter, cudaStream_t stream) {
  if (n <= 0) return 0;
  const int grid = (n + BLOCK - 1) / BLOCK;
  bounce_kernel<false><<<grid, BLOCK, 0, stream>>>(
      o, d, alive, uni, tmin, n, sph, sph_mat, n_sph, rect, rect_mat, n_rect,
      tri, tri_nrm, tri_mat, n_tri, mat, out_no, out_nd, out_att, out_emit,
      out_p, out_n, out_inter, nullptr, nullptr);
  return (int)cudaGetLastError();
}

// rt_bounce with motion blur: the arguments of rt_bounce, then the sphere
// velocities sph_vel (n_sph, 4) and the per-ray shutter time (n,).
extern "C" int rt_bounce_motion(
    const float* o, const float* d, const uint8_t* alive, const float* uni,
    float tmin, int n,
    const float* sph, const int* sph_mat, int n_sph,
    const float* rect, const int* rect_mat, int n_rect,
    const float* tri, const float* tri_nrm, const int* tri_mat, int n_tri,
    const float* mat,
    float* out_no, float* out_nd, float* out_att, float* out_emit,
    float* out_p, float* out_n, int* out_inter, const float* sph_vel,
    const float* time, cudaStream_t stream) {
  if (n <= 0) return 0;
  const int grid = (n + BLOCK - 1) / BLOCK;
  bounce_kernel<true><<<grid, BLOCK, 0, stream>>>(
      o, d, alive, uni, tmin, n, sph, sph_mat, n_sph, rect, rect_mat, n_rect,
      tri, tri_nrm, tri_mat, n_tri, mat, out_no, out_nd, out_att, out_emit,
      out_p, out_n, out_inter, sph_vel, time);
  return (int)cudaGetLastError();
}

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
