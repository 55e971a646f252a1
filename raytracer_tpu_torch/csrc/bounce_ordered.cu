// Ordered fused bounce for Hopper (sm_90a): the fused bounce (bounce.cu)
// with the near-to-far superchunk walk for a sphere or triangle table that
// ops/ordered.py sorted, then the same epilogue; one thread per ray.
//
// Replaces raytracer_tpu/ops/pallas_intersect.py::_bounce_kernel_ordered
// (reached through _call_bounce / bounce_fused), whose plain PyTorch twin
// is raytracer_tpu_torch/ops/fused_bounce.py::bounce_ordered_plain.
//
// The walk is sweep.cuh::walk, shared with the ordered closest hit
// (closest_ordered.cu) and the ordered regen step (regen_ordered.cu): each
// warp orders the superchunks itself, in its shared memory, instead of the
// TPU kernel's per-tile order words from a separate pass. The walk reads
// geometry from the sorted copy and folds the slot's scene index (t, then
// type, then scene index), so the epilogue (scatter.cuh) reads the winner's
// record once, after the walk, from the scene-order tables, exactly as the
// flat bounce does. stats (optional, null = off): per warp of 32 lanes, the
// chunk bodies the two walks ran.
//
// What bounds it: FP32 work on the chunks a warp can reach (see
// regen_ordered.cu for the design: per-warp walks, each body through the
// warp's own shared buffer); the epilogue's ~200 flops per ray are the
// same as the flat bounce's.
//
// Motion blur: rt_bounce_ordered_motion launches the kernel with MOTION =
// true (the TPU kernel with has_time=True): the walk tests the sorted
// spheres at c + v t (their velocities in the stage's sorted vel rows, the
// boxes dilated over the shutter when the stage was packed), a flat sphere
// stage reads sph_vel, and the epilogue takes the winner at its moved
// centre.

#include <cuda_runtime.h>
#include <stdint.h>

#include "scatter.cuh"
#include "sweep.cuh"

namespace {

constexpr int BLOCK = 128;   // 4 warps, each walking its own 32 lanes
static_assert(BLOCK == 4 * WARP, "sweep.cuh sizes shared memory for 4 warps");

template <bool MOTION>
__global__ void __launch_bounds__(BLOCK) bounce_ordered_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const uint8_t* __restrict__ alive, const float* __restrict__ uni,
    float tmin, int n,
    const float* __restrict__ sph, const int* __restrict__ sph_mat, int n_sph,
    const float* __restrict__ rect, const int* __restrict__ rect_mat,
    int n_rect,
    const float* __restrict__ tri, const float* __restrict__ tri_nrm,
    const int* __restrict__ tri_mat, int n_tri,
    const float* __restrict__ mat, const Stage osph, const Stage otri,
    float* __restrict__ out_no, float* __restrict__ out_nd,
    float* __restrict__ out_att, float* __restrict__ out_emit,
    float* __restrict__ out_p, float* __restrict__ out_n,
    int* __restrict__ out_inter, int* __restrict__ stats,
    const float* __restrict__ sph_vel, const float* __restrict__ time,
    int k_sup) {
  extern __shared__ __align__(16) float smem[];
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  const int at = i / WARP;        // this warp's 32-lane tile
  if (at * WARP >= n) return;     // the whole warp: none of its lanes is in
  const WarpShared sh = warp_shared(smem, k_sup);
  const bool in = i < n;
  const bool live = in && alive[i] != 0;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  float tm = 0.f;
  if (in) {
    ox = o[i]; oy = o[n + i]; oz = o[2 * n + i];
    dx = d[i]; dy = d[n + i]; dz = d[2 * n + i];
    if constexpr (MOTION) tm = time[i];
  }
  const Winner w = sweep_ordered<MOTION>(
      sh, live, Ray{ox, oy, oz, dx, dy, dz, tmin, BIG}, sph, n_sph, osph,
      rect, n_rect, tri, n_tri, otri,
      stats == nullptr ? nullptr : stats + 2 * at, sph_vel, tm);
  if (in)
    bounce_epilogue<MOTION>(i, n, ox, oy, oz, dx, dy, dz, w, sph, sph_mat,
                            rect, rect_mat, tri_nrm, tri_mat, mat, uni,
                            out_no, out_nd, out_att, out_emit, out_p, out_n,
                            out_inter, sph_vel, tm);
}

// Check the stages, then launch bounce_ordered_kernel<MOTION>, a warp per 32
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
  bounce_ordered_kernel<MOTION>
      <<<(n + BLOCK - 1) / BLOCK, BLOCK, smem, stream>>>(args..., k_sup);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream`, does not
// synchronise, allocates nothing; returns cudaGetLastError() of the launch.
// The flat arguments are rt_bounce's; each ordered stage follows as (prim,
// orig, cull, scull, box, k_ch, chunk), null pointers for a stage that is
// swept flat; then stats.
extern "C" int rt_bounce_ordered(
    const float* o, const float* d, const uint8_t* alive, const float* uni,
    float tmin, int n,
    const float* sph, const int* sph_mat, int n_sph,
    const float* rect, const int* rect_mat, int n_rect,
    const float* tri, const float* tri_nrm, const int* tri_mat, int n_tri,
    const float* mat,
    const float* s_prim, const int* s_orig, const float* s_cull,
    const float* s_scull, const float* s_box, int s_k_ch, int s_chunk,
    const float* t_prim, const int* t_orig, const float* t_cull,
    const float* t_scull, const float* t_box, int t_k_ch, int t_chunk,
    float* out_no, float* out_nd, float* out_att, float* out_emit,
    float* out_p, float* out_n, int* out_inter, int* stats,
    cudaStream_t stream) {
  if (n <= 0) return 0;
  const Stage osph{s_prim, s_orig, s_cull, s_scull, s_box, s_k_ch, s_chunk};
  const Stage otri{t_prim, t_orig, t_cull, t_scull, t_box, t_k_ch, t_chunk};
  return launch<false>(n, osph, otri, sph, rect, tri, nullptr, stream, o, d,
                       alive, uni, tmin, n, sph, sph_mat, n_sph, rect,
                       rect_mat, n_rect, tri, tri_nrm, tri_mat, n_tri, mat,
                       osph, otri, out_no, out_nd, out_att, out_emit, out_p,
                       out_n, out_inter, stats, (const float*)nullptr,
                       (const float*)nullptr);
}

// rt_bounce_ordered with motion blur: its arguments up to stats, then the
// sphere velocities sph_vel (n_sph, 4) in scene order, the sphere stage's
// sorted velocities s_vel (s_k_ch * s_chunk, 4; null when the spheres are
// swept flat) and the per-ray shutter time (n,).
extern "C" int rt_bounce_ordered_motion(
    const float* o, const float* d, const uint8_t* alive, const float* uni,
    float tmin, int n,
    const float* sph, const int* sph_mat, int n_sph,
    const float* rect, const int* rect_mat, int n_rect,
    const float* tri, const float* tri_nrm, const int* tri_mat, int n_tri,
    const float* mat,
    const float* s_prim, const int* s_orig, const float* s_cull,
    const float* s_scull, const float* s_box, int s_k_ch, int s_chunk,
    const float* t_prim, const int* t_orig, const float* t_cull,
    const float* t_scull, const float* t_box, int t_k_ch, int t_chunk,
    float* out_no, float* out_nd, float* out_att, float* out_emit,
    float* out_p, float* out_n, int* out_inter, int* stats,
    const float* sph_vel, const float* s_vel, const float* time,
    cudaStream_t stream) {
  if (n <= 0) return 0;
  const Stage osph{s_prim, s_orig, s_cull, s_scull, s_box, s_k_ch, s_chunk,
                   s_vel};
  const Stage otri{t_prim, t_orig, t_cull, t_scull, t_box, t_k_ch, t_chunk};
  return launch<true>(n, osph, otri, sph, rect, tri, sph_vel, stream, o, d,
                      alive, uni, tmin, n, sph, sph_mat, n_sph, rect,
                      rect_mat, n_rect, tri, tri_nrm, tri_mat, n_tri, mat,
                      osph, otri, out_no, out_nd, out_att, out_emit, out_p,
                      out_n, out_inter, stats, sph_vel, time);
}

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
