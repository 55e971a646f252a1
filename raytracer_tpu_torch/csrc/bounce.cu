// Fused bounce for Hopper (sm_90a): closest hit over the sphere, rect and
// triangle tables, then hit attributes, constant/checker texture, material
// scatter and the spawn offset, one thread per ray.
//
// Replaces raytracer_tpu/ops/pallas_intersect.py::_bounce_kernel (the static
// chunk scan reached through _call_bounce / bounce_fused), whose plain
// PyTorch twin is raytracer_tpu_torch/ops/fused_bounce.py::bounce_fused_plain.
//
// What bounds it: FP32 work on the CUDA cores. At the main path's shape
// (480,000 rays x 1005 spheres) each ray does ~1005 sphere tests of ~17
// flops against ~100 bytes of ray I/O, so memory traffic is negligible and
// the sweep is what counts. On an H100 (700 W, the SM clock at 1980 MHz
// under this load) it is held by instruction issue: at one ray per thread
// a missed pair took ~29 instructions (12 of them FP32; the rest rebuilt
// the shared address, moved constants, branched and folded), 0.48 ms for
// 4.82e8 pairs launched back to back; the root path runs in 0.2% of
// (warp, sphere) pairs. The design:
//   * rays are SoA rows, (3, N): thread t of a tile reads o[c*N + i], so
//     loads and stores coalesce;
//   * each thread carries RAYS = 2 rays (lanes i and i + 128 of a 256-lane
//     tile), so a staged sphere is read from shared memory once for both,
//     and the pair loop takes sweep.cuh's UNROLL spheres at a time with
//     their loads hoisted: 8 independent discriminant chains, one branch,
//     ~15.4 instructions a missed pair;
//   * tables stream through a 16 KB shared-memory tile that every thread
//     reads at once (a broadcast, no bank conflicts);
//   * one block per 256-lane tile (a persistent grid taking tiles from a
//     counter bought nothing: sweep.cuh);
//   * the winner is kept in registers as (t, type, index, b1, b2) and its
//     geometry and material record are read from global memory once, after
//     the sweep (the TPU kernel's one-hot MXU extraction exists only
//     because TPU gathers are slow).
// A lane's outputs are the same bits as at one ray per thread: its pair
// tests are the same code, folded in the same order (sweep.cuh). The sweep
// is sweep.cuh's, shared with the closest-hit kernel (closest.cu) and the
// regen step (regen.cu); the bounce calls it with t_max = BIG. The epilogue
// is scatter.cuh's, shared with the ordered bounce (bounce_ordered.cu).
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
constexpr int RAYS = 2;                 // rays per thread
constexpr int TILE = BLOCK * RAYS;      // lanes per tile

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
  int i[RAYS];
  bool live[RAYS];
  Ray ray[RAYS];
  float tm[RAYS];
#pragma unroll
  for (int k = 0; k < RAYS; ++k) {
    i[k] = blockIdx.x * TILE + k * BLOCK + threadIdx.x;
    const bool in = i[k] < n;
    live[k] = in && alive[i[k]] != 0;
    ray[k] = Ray{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, tmin, BIG};
    tm[k] = 0.f;
    if (in) {
      const int j = i[k];
      ray[k] = Ray{o[j], o[n + j], o[2 * n + j], d[j], d[n + j],
                   d[2 * n + j], tmin, BIG};
      if constexpr (MOTION) tm[k] = time[j];
    }
  }
  Winner w[RAYS];
  sweep_rays<BLOCK, RAYS, MOTION>(tile, live, ray, sph, n_sph, rect,
                                  n_rect, tri, n_tri, w, sph_vel, tm);
#pragma unroll
  for (int k = 0; k < RAYS; ++k) {
    if (i[k] < n)
      bounce_epilogue<MOTION>(i[k], n, ray[k].ox, ray[k].oy, ray[k].oz,
                              ray[k].dx, ray[k].dy, ray[k].dz, w[k], sph,
                              sph_mat, rect, rect_mat, tri_nrm, tri_mat,
                              mat, uni, out_no, out_nd, out_att, out_emit,
                              out_p, out_n, out_inter, sph_vel, tm[k]);
  }
}

// Launch bounce_kernel<MOTION>, one block per tile.
template <bool MOTION, class... Args>
int launch(int n, cudaStream_t stream, Args... args) {
  bounce_kernel<MOTION><<<(n + TILE - 1) / TILE, BLOCK, 0, stream>>>(args...);
  return (int)cudaGetLastError();
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
  return launch<false>(n, stream, o, d, alive, uni, tmin, n, sph, sph_mat,
                       n_sph, rect, rect_mat, n_rect, tri, tri_nrm, tri_mat,
                       n_tri, mat, out_no, out_nd, out_att, out_emit, out_p,
                       out_n, out_inter, (const float*)nullptr,
                       (const float*)nullptr);
}

// rt_bounce with motion blur: the arguments of rt_bounce up to out_inter,
// then the sphere velocities sph_vel (n_sph, 4) and the per-ray shutter
// time (n,).
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
  return launch<true>(n, stream, o, d, alive, uni, tmin, n, sph, sph_mat,
                      n_sph, rect, rect_mat, n_rect, tri, tri_nrm, tri_mat,
                      n_tri, mat, out_no, out_nd, out_att, out_emit, out_p,
                      out_n, out_inter, sph_vel, time);
}

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
