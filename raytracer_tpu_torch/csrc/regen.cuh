// The regeneration epilogue shared by regen.cu and regen_ordered.cu: after
// the sweep, the bounce's values (scatter.cuh::bounce_values), then the
// loop's bookkeeping for one lane: emission, throughput, Russian roulette,
// the depth cap, retire and quota counting, and the camera respawn of a
// retired lane. The counterpart of _regen_epilogue
// (raytracer_tpu/ops/pallas_intersect.py); its plain twin is
// ops/regen.py::regen_step_plain.
//
// Rounding: the bookkeeping follows ops/regen.py::regen_bookkeeping (which
// the eager loop's step, models/wavefront_soa.py::_step, also runs)
// operation for operation, with every product and sum rounded on its own
// (__fmul_rn, __fadd_rn: nvcc would contract them into FMAs) and the pixel
// coordinate divided as PyTorch's CUDA ops divide a tensor by a Python
// number (times the float32 reciprocal). So on the card the kernel's
// bookkeeping rounds as that loop does, and both take the same paths.
// Accurate sqrtf/cosf/sinf, no fast math (scatter.cuh says why).
//
// The lane state is updated in place: each thread reads only its own lane,
// and all of it before it writes any of it (o, d and alive before the
// sweep, the rest after it, to keep registers free during the sweep). The
// wrapper checks that no two lane tensors share memory.
//
// Motion blur (MOTION): the lane's shutter time rides beside the lanes
// (time (n,), in place); the sweep and bounce_values take it, and a lane
// that respawns draws its next sample's time from U row 8:
// time0 + U[8] (time1 - time0), rounded as ops/regen.py::regen_bookkeeping
// rounds it.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "scatter.cuh"
#include "sweep.cuh"

namespace {

// Rows of the loop's per-step draw U (8, n; 9 with motion): 0-2 the
// scatter's, 3 Russian roulette, 4-7 the respawn's jitter x, jitter y, lens
// radius, lens angle, 8 the respawn's shutter time.
constexpr int U_RR = 3, U_JX = 4, U_JY = 5, U_LR = 6, U_LPHI = 7, U_TIME = 8;
// The camera as ops/regen.py::pack_camera packs it, (32,) f32: origin 0-2,
// u 3-5, v 6-8, lower-left corner 9-11, horizontal 12-14, vertical 15-17,
// lens radius 18, shutter times 19-20.
constexpr int CAM_U = 3, CAM_V = 6, CAM_LLC = 9, CAM_HOR = 12, CAM_VER = 15,
              CAM_LENS = 18, CAM_T0 = 19, CAM_T1 = 20;

// The lane state of the regeneration loop (models/wavefront_soa.py::_Lanes):
// (3, n) rows, alive as bytes 0/1, depth and done int32; px, py, U and cam
// are read only.
struct Lanes {
  float* o;
  float* d;
  float* tput;
  float* samp;
  float* acc;
  uint8_t* alive;
  int* depth;
  int* done;
  const float* px;
  const float* py;
  const float* U;
  const float* cam;
};

struct RegenParams {
  float eps;  // the spawn offset
  int width, height, quota, max_depth, rr_on, rr_start;
};

// One lane's step after the sweep: ray (ox..dz), alive a, winner w. MOTION:
// sph_vel the velocities, tm the lane's shutter time (read before the
// sweep), time_out the lane's time row, written here.
template <bool MOTION = false>
__device__ __forceinline__ void regen_epilogue(
    int i, int n, float ox, float oy, float oz, float dx, float dy, float dz,
    bool a, const Winner& w, const float* __restrict__ sph,
    const int* __restrict__ sph_mat, const float* __restrict__ rect,
    const int* __restrict__ rect_mat, const float* __restrict__ tri_nrm,
    const int* __restrict__ tri_mat, const float* __restrict__ mat,
    const Lanes& L, const RegenParams& P,
    const float* __restrict__ sph_vel = nullptr, float tm = 0.f,
    float* __restrict__ time_out = nullptr) {
  const float* __restrict__ U = L.U;
  const Scatter v = bounce_values<MOTION>(
      ox, oy, oz, dx, dy, dz, w, sph, sph_mat, rect, rect_mat, tri_nrm,
      tri_mat, mat, U[i], U[n + i], U[2 * n + i], P.eps, sph_vel, tm);
  float tr = L.tput[i], tg = L.tput[n + i], tb = L.tput[2 * n + i];
  float sr = L.samp[i], sg = L.samp[n + i], sb = L.samp[2 * n + i];
  float cr = L.acc[i], cg = L.acc[n + i], cb = L.acc[2 * n + i];
  const int depth = L.depth[i], done = L.done[i];

  // emission (miss-masked in bounce_values)
  if (a) {
    sr = __fadd_rn(sr, __fmul_rn(tr, v.er));
    sg = __fadd_rn(sg, __fmul_rn(tg, v.eg));
    sb = __fadd_rn(sb, __fmul_rn(tb, v.eb));
  }
  bool cont = a && v.inter != INTER_ABSORB;
  if (cont) {
    tr = __fmul_rn(tr, v.ar);
    tg = __fmul_rn(tg, v.ag);
    tb = __fmul_rn(tb, v.ab);
  }
  if (P.rr_on) {
    const float p_surv = fminf(fmaxf(fmaxf(fmaxf(tr, tg), tb), 0.05f), 1.f);
    const bool do_rr = depth >= P.rr_start;
    const bool survive = !do_rr || U[U_RR * n + i] < p_surv;
    if (do_rr && cont && survive) {
      const float inv = 1.f / p_surv;
      tr = __fmul_rn(tr, inv);
      tg = __fmul_rn(tg, inv);
      tb = __fmul_rn(tb, inv);
    }
    cont = cont && survive;
  }
  const int depth2 = depth + 1;
  cont = cont && depth2 < P.max_depth;
  const bool retire = a && !cont;
  if (retire) {
    cr = __fadd_rn(cr, sr);
    cg = __fadd_rn(cg, sg);
    cb = __fadd_rn(cb, sb);
  }
  const int done2 = done + (retire ? 1 : 0);
  const bool regen = retire && done2 < P.quota;

  // the next ray: the camera's for a respawn (camera_rays_soa), the
  // scattered one for a lane that goes on, else the ray as it was
  float o3[3] = {ox, oy, oz}, d3[3] = {dx, dy, dz};
  if (regen) {
    const float* __restrict__ c = L.cam;
    const float cu = __fmul_rn(__fadd_rn(L.px[i], U[U_JX * n + i]),
                               1.f / (float)(P.width - 1));
    const float cv = __fmul_rn(__fadd_rn(L.py[i], U[U_JY * n + i]),
                               1.f / (float)(P.height - 1));
    const float ct = __fsub_rn(1.f, cv);  // y axis is reverted
    const float lr = __fmul_rn(sqrtf(U[U_LR * n + i]), c[CAM_LENS]);
    const float phi = __fmul_rn(TWO_PI, U[U_LPHI * n + i]);
    const float rdx = __fmul_rn(lr, cosf(phi));
    const float rdy = __fmul_rn(lr, sinf(phi));
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      o3[k] = __fadd_rn(__fadd_rn(c[k], __fmul_rn(c[CAM_U + k], rdx)),
                        __fmul_rn(c[CAM_V + k], rdy));
      d3[k] = __fsub_rn(
          __fadd_rn(__fadd_rn(c[CAM_LLC + k], __fmul_rn(cu, c[CAM_HOR + k])),
                    __fmul_rn(ct, c[CAM_VER + k])),
          o3[k]);
    }
  } else if (cont) {
    o3[0] = v.nox; o3[1] = v.noy; o3[2] = v.noz;
    d3[0] = v.ndx; d3[1] = v.ndy; d3[2] = v.ndz;
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    L.o[k * n + i] = o3[k];
    L.d[k * n + i] = d3[k];
  }
  L.tput[i] = regen ? 1.f : tr;
  L.tput[n + i] = regen ? 1.f : tg;
  L.tput[2 * n + i] = regen ? 1.f : tb;
  L.samp[i] = regen ? 0.f : sr;
  L.samp[n + i] = regen ? 0.f : sg;
  L.samp[2 * n + i] = regen ? 0.f : sb;
  L.acc[i] = cr;
  L.acc[n + i] = cg;
  L.acc[2 * n + i] = cb;
  L.alive[i] = (cont || regen) ? 1 : 0;
  L.depth[i] = regen ? 0 : depth2;
  L.done[i] = done2;
  if constexpr (MOTION) {
    const float* __restrict__ c = L.cam;
    const float t_new = __fadd_rn(
        c[CAM_T0], __fmul_rn(U[U_TIME * n + i], __fsub_rn(c[CAM_T1],
                                                          c[CAM_T0])));
    time_out[i] = regen ? t_new : tm;
  }
}

}  // namespace
