// The closest-hit sweep shared by the fused bounce (bounce.cu) and the
// closest-hit kernel (closest.cu): one thread per ray walks the sphere, rect
// and triangle tables, staged through a shared-memory tile, and keeps the
// winner in registers.
//
// The counterpart of the TPU kernels' _stage_sweep
// (raytracer_tpu/ops/pallas_intersect.py): a candidate counts when
// t_min <= t <= t_max, and the fold starts at best_t = min(t_max, BIG) and
// takes only t < best_t, so a hit must lie strictly below t_max. Stages run
// spheres, then rects, then triangles, each in table order, so the lowest
// index wins a tie and spheres win over rects over triangles. The sphere
// quadratic uses the direct oc = o - c form (no |o|^2 - 2 o.c expansion,
// which cancels catastrophically at large coordinates).
//
// Every thread of the block must call sweep(): it synchronises the block
// while staging. A block whose lanes are all dead skips the sweep; a dead
// lane inside a live block takes no part in it and keeps the miss winner.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr float BIG = 3.0e38f;                // the "no hit" t
constexpr int TILE_FLOATS = 4096;             // 16 KB staging tile
constexpr int SPH_W = 4, RECT_W = 8, TRI_W = 16;

struct Ray {
  float ox, oy, oz, dx, dy, dz, tmin, tmax;
};

// The winner: ty is -1 on a miss (t is then min(t_max, BIG)); b1, b2 are the
// barycentrics of a triangle winner and 0 otherwise.
struct Winner {
  float t;
  int ty, ix;
  float b1, b2;
};

// Copy rows [base, base + cnt) of a table with `width` floats per row into
// the shared tile (whole block, coalesced float loads).
template <int BLOCK>
__device__ __forceinline__ void stage(float* tile, const float* table,
                                      int base, int cnt, int width) {
  const float* src = table + (size_t)base * width;
  for (int k = threadIdx.x; k < cnt * width; k += BLOCK) tile[k] = src[k];
}

template <int BLOCK>
__device__ __forceinline__ Winner sweep(
    float* tile, bool live, const Ray& ray,
    const float* __restrict__ sph, int n_sph,
    const float* __restrict__ rect, int n_rect,
    const float* __restrict__ tri, int n_tri) {
  const float ox = ray.ox, oy = ray.oy, oz = ray.oz;
  const float dx = ray.dx, dy = ray.dy, dz = ray.dz;
  const float tmin = ray.tmin, tmax = fminf(ray.tmax, BIG);
  Winner w{tmax, -1, 0, 0.f, 0.f};
  if (!__syncthreads_or(live)) return w;

  // ---- spheres
  const float a = dx * dx + dy * dy + dz * dz;
  const float inv_a = 1.0f / a;
  const int sph_tile = TILE_FLOATS / SPH_W;
  for (int base = 0; base < n_sph; base += sph_tile) {
    const int cnt = min(sph_tile, n_sph - base);
    __syncthreads();
    stage<BLOCK>(tile, sph, base, cnt, SPH_W);
    __syncthreads();
    if (!live) continue;
    const float4* s4 = reinterpret_cast<const float4*>(tile);
    for (int j = 0; j < cnt; ++j) {
      const float4 s = s4[j];
      const float ocx = ox - s.x, ocy = oy - s.y, ocz = oz - s.z;
      const float half_b = dx * ocx + dy * ocy + dz * ocz;
      const float c = ocx * ocx + ocy * ocy + ocz * ocz - s.w;
      const float disc = half_b * half_b - a * c;
      if (disc >= 0.f) {
        const float sq = sqrtf(disc);
        const float r1 = (-half_b - sq) * inv_a;
        const float r2 = (-half_b + sq) * inv_a;
        const float t = (r1 >= tmin && r1 <= tmax) ? r1
                      : ((r2 >= tmin && r2 <= tmax) ? r2 : BIG);
        if (t < w.t) {
          w.t = t;
          w.ty = 0;
          w.ix = base + j;
        }
      }
    }
  }

  // ---- axis-aligned rects: plane solve, inclusive bounds
  const int rect_tile = TILE_FLOATS / RECT_W;
  for (int base = 0; base < n_rect; base += rect_tile) {
    const int cnt = min(rect_tile, n_rect - base);
    __syncthreads();
    stage<BLOCK>(tile, rect, base, cnt, RECT_W);
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < cnt; ++j) {
      const float* r = tile + j * RECT_W;
      const int axis = (int)r[0];
      const float d_n = axis == 0 ? dx : (axis == 1 ? dy : dz);
      const float o_n = axis == 0 ? ox : (axis == 1 ? oy : oz);
      const bool safe = fabsf(d_n) > 1e-12f;
      const float t = (r[1] - o_n) / (safe ? d_n : 1.0f);
      const float pa = (axis == 0 ? oy : ox) + t * (axis == 0 ? dy : dx);
      const float pb = (axis == 2 ? oy : oz) + t * (axis == 2 ? dy : dz);
      const bool ok = safe && pa >= r[2] && pa <= r[3] && pb >= r[4] &&
                      pb <= r[5] && t >= tmin && t <= tmax;
      if (ok && t < w.t) {
        w.t = t;
        w.ty = 1;
        w.ix = base + j;
      }
    }
  }

  // ---- triangles: scalar-triple-product Moller-Trumbore
  const float oxd_x = oy * dz - oz * dy;
  const float oxd_y = oz * dx - ox * dz;
  const float oxd_z = ox * dy - oy * dx;
  const int tri_tile = TILE_FLOATS / TRI_W;
  for (int base = 0; base < n_tri; base += tri_tile) {
    const int cnt = min(tri_tile, n_tri - base);
    __syncthreads();
    stage<BLOCK>(tile, tri, base, cnt, TRI_W);
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < cnt; ++j) {
      const float* q = tile + j * TRI_W;
      const float div = -(dx * q[0] + dy * q[1] + dz * q[2]);
      if (div == 0.f) continue;
      const float inv = 1.0f / div;
      const float b1 = ((oxd_x * q[6] + oxd_y * q[7] + oxd_z * q[8]) -
                        (dx * q[9] + dy * q[10] + dz * q[11])) * inv;
      const float b2 = (-(oxd_x * q[3] + oxd_y * q[4] + oxd_z * q[5]) +
                        (dx * q[12] + dy * q[13] + dz * q[14])) * inv;
      const float t = ((ox * q[0] + oy * q[1] + oz * q[2]) - q[15]) * inv;
      const bool ok = b1 >= 0.f && b1 <= 1.f && b2 >= 0.f &&
                      b1 + b2 <= 1.f && t >= tmin && t <= tmax;
      if (ok && t < w.t) {
        w.t = t;
        w.ty = 2;
        w.ix = base + j;
        w.b1 = b1;
        w.b2 = b2;
      }
    }
  }
  return w;
}

}  // namespace
