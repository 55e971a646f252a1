// The epilogue of the fused bounces (bounce.cu, bounce_ordered.cu) and of
// the regeneration steps (regen.cuh): the winner's attributes,
// constant/checker texture, material scatter and spawn offset of one ray,
// from the winner of a sweep. The winner's index is the scene's own: its
// records are read once from the scene-order tables. bounce_values returns
// them; bounce_epilogue writes them out. MOTION (motion blur): a sphere
// winner's normal is taken at its centre moved to c + v t (sweep.cuh::moved),
// with v from the velocity table sph_vel and t the ray's shutter time.
// Compiled without --use_fast_math: the checker texture takes sin() of
// world coordinates, far outside [-pi, pi], where __sinf is inaccurate.

#pragma once

#include <cuda_runtime.h>

#include "sweep.cuh"

namespace {

constexpr float TWO_PI = 6.283185307179586f;
constexpr float FRAC_1_PI = 0.3183098861837907f;
constexpr int MAT_W = 12;
constexpr int INTER_DIFFUSE = 0, INTER_SPECULAR = 1, INTER_ABSORB = 2,
              INTER_REFLECT = 3, INTER_REFRACT = 4;

__device__ __forceinline__ void unit3(float& x, float& y, float& z) {
  const float inv = rsqrtf(fmaxf(x * x + y * y + z * z, 1e-30f));
  x *= inv;
  y *= inv;
  z *= inv;
}

// The bounce's values for one ray (the counterpart of _bounce_values): the
// interaction code, the next ray (spawn-offset origin no, scattered
// direction nd), attenuation, emission, hit point and shading normal.
struct Scatter {
  int inter;
  float nox, noy, noz, ndx, ndy, ndz, ar, ag, ab, er, eg, eb;
  float px, py, pz, nx, ny, nz;
};

// u0, u1: the unit-sphere pair; u2: the dielectric's reflect choice; eps:
// the spawn offset; sph_vel, time: the velocities and the shutter time
// (MOTION).
template <bool MOTION = false>
__device__ __forceinline__ Scatter bounce_values(
    float ox, float oy, float oz, float dx, float dy, float dz,
    const Winner& w, const float* __restrict__ sph,
    const int* __restrict__ sph_mat, const float* __restrict__ rect,
    const int* __restrict__ rect_mat, const float* __restrict__ tri_nrm,
    const int* __restrict__ tri_mat, const float* __restrict__ mat,
    float u0, float u1, float u2, float eps,
    const float* __restrict__ sph_vel = nullptr, float time = 0.f) {
  const float best_t = w.t, best_b1 = w.b1, best_b2 = w.b2;
  const int best_ty = w.ty, best_ix = w.ix;
  // ---- epilogue: the winner's attributes; a miss acts as an all-zero
  // winner record (zero normal, zero material features), as on the TPU
  const bool valid = best_ty >= 0;
  const float t = valid ? best_t : 0.f;
  const float px = ox + t * dx, py = oy + t * dy, pz = oz + t * dz;
  float nox = 0.f, noy = 0.f, noz = 0.f;
  int mid = -1;
  if (best_ty == 0) {
    float4 s = reinterpret_cast<const float4*>(sph)[best_ix];
    if constexpr (MOTION)
      s = moved(s, reinterpret_cast<const float4*>(sph_vel)[best_ix], time);
    const float inv_r = 1.0f / sqrtf(fmaxf(s.w, 1e-20f));
    nox = (px - s.x) * inv_r;
    noy = (py - s.y) * inv_r;
    noz = (pz - s.z) * inv_r;
    mid = sph_mat[best_ix];
  } else if (best_ty == 1) {
    const int axis = (int)rect[(size_t)best_ix * RECT_W];
    nox = axis == 0 ? 1.f : 0.f;
    noy = axis == 1 ? 1.f : 0.f;
    noz = axis == 2 ? 1.f : 0.f;
    mid = rect_mat[best_ix];
  } else if (best_ty == 2) {
    const float* nn = tri_nrm + (size_t)best_ix * 9;
    const float tb0 = 1.f - best_b1 - best_b2;
    nox = tb0 * nn[0] + best_b1 * nn[3] + best_b2 * nn[6];
    noy = tb0 * nn[1] + best_b1 * nn[4] + best_b2 * nn[7];
    noz = tb0 * nn[2] + best_b1 * nn[5] + best_b2 * nn[8];
    unit3(nox, noy, noz);
    mid = tri_mat[best_ix];
  }
  const bool front = (dx * nox + dy * noy + dz * noz) < 0.f;
  const float sgn = front ? 1.f : -1.f;
  float nx = nox * sgn, ny = noy * sgn, nz = noz * sgn;
  unit3(nx, ny, nz);

  float f[MAT_W];
#pragma unroll
  for (int k = 0; k < MAT_W; ++k) f[k] = 0.f;
  if (mid >= 0) {
#pragma unroll
    for (int k = 0; k < 10; ++k) f[k] = mat[(size_t)mid * MAT_W + k];
  }
  const float kind = f[0], fuzz = f[1], ir = fmaxf(f[2], 1e-6f);
  const float sines = sinf(10.f * px) * sinf(10.f * py) * sinf(10.f * pz);
  const bool chk = fabsf(f[3] - 1.f) < 0.5f && sines >= 0.f;
  const float alr = chk ? f[7] : f[4];
  const float alg = chk ? f[8] : f[5];
  const float alb = chk ? f[9] : f[6];

  const float z = 1.f - 2.f * u0;
  const float phi = TWO_PI * u1;
  const float rs = sqrtf(fmaxf(0.f, 1.f - z * z));
  const float sx = rs * cosf(phi), sy = rs * sinf(phi);

  // Lambertian / diffuse light: n + unit sphere, near-zero guard
  float ldx = nx + sx, ldy = ny + sy, ldz = nz + z;
  if (ldx * ldx + ldy * ldy + ldz * ldz < 1e-16f) {
    ldx = nx; ldy = ny; ldz = nz;
  }
  // metal: reflect(unit d) + fuzz * unit sphere; absorb below the surface
  float ux = dx, uy = dy, uz = dz;
  unit3(ux, uy, uz);
  const float dn = ux * nx + uy * ny + uz * nz;
  const float rfx = ux - 2.f * dn * nx, rfy = uy - 2.f * dn * ny,
              rfz = uz - 2.f * dn * nz;
  const float mdx = rfx + fuzz * sx, mdy = rfy + fuzz * sy,
              mdz = rfz + fuzz * z;
  const bool metal_ok = (mdx * nx + mdy * ny + mdz * nz) > 0.f;
  // dielectric: Schlick + total internal reflection against u2
  const float ratio = front ? 1.f / ir : ir;
  const float cos_t = fminf(-dn, 1.f);
  const float sin_t = sqrtf(fmaxf(0.f, 1.f - cos_t * cos_t));
  const bool cannot = ratio * sin_t > 1.f;
  float r0 = (1.f - ratio) / (1.f + ratio);
  r0 = r0 * r0;
  const float x = 1.f - cos_t, x2 = x * x;
  const float refl = r0 + (1.f - r0) * (x2 * x2 * x);
  const bool do_refl = cannot || refl > u2;
  const float ppx = ratio * (ux + cos_t * nx), ppy = ratio * (uy + cos_t * ny),
              ppz = ratio * (uz + cos_t * nz);
  const float par = -sqrtf(fabsf(1.f - (ppx * ppx + ppy * ppy + ppz * ppz)));

  const bool is_lam = fabsf(kind - 0.f) < 0.5f;
  const bool is_met = fabsf(kind - 1.f) < 0.5f;
  const bool is_die = fabsf(kind - 2.f) < 0.5f;
  const bool is_lgt = fabsf(kind - 3.f) < 0.5f;
  const bool diffish = is_lam || is_lgt;
  float odx, ody, odz;
  int inter;
  if (diffish) {
    odx = ldx; ody = ldy; odz = ldz;
    inter = INTER_DIFFUSE;
  } else if (is_met) {
    odx = mdx; ody = mdy; odz = mdz;
    inter = metal_ok ? INTER_SPECULAR : INTER_ABSORB;
  } else if (do_refl) {
    odx = rfx; ody = rfy; odz = rfz;
    inter = is_die ? INTER_REFLECT : INTER_DIFFUSE;
  } else {
    odx = ppx + par * nx; ody = ppy + par * ny; odz = ppz + par * nz;
    inter = is_die ? INTER_REFRACT : INTER_DIFFUSE;
  }
  if (!valid) inter = INTER_ABSORB;
  const bool lit = is_lgt && valid;

  const float dot = odx * nx + ody * ny + odz * nz;
  const float side = (dot > 0.f ? 1.f : (dot < 0.f ? -1.f : 0.f)) * eps;
  return Scatter{inter,
                 px + nx * side, py + ny * side, pz + nz * side,
                 odx, ody, odz,
                 is_lgt ? FRAC_1_PI : alr, is_lgt ? FRAC_1_PI : alg,
                 is_lgt ? FRAC_1_PI : alb,
                 lit ? alr : 0.f, lit ? alg : 0.f, lit ? alb : 0.f,
                 px, py, pz, nx, ny, nz};
}

// bounce_values for ray i, its uniforms read from uni (4, n): rows 0-2
// u0-u2, row 3 the spawn offset; the values written to the (3, n) rows
// and inter (n,). sph_vel, time: as for bounce_values.
template <bool MOTION = false>
__device__ __forceinline__ void bounce_epilogue(
    int i, int n, float ox, float oy, float oz, float dx, float dy, float dz,
    const Winner& w, const float* __restrict__ sph,
    const int* __restrict__ sph_mat, const float* __restrict__ rect,
    const int* __restrict__ rect_mat, const float* __restrict__ tri_nrm,
    const int* __restrict__ tri_mat, const float* __restrict__ mat,
    const float* __restrict__ uni,
    float* __restrict__ out_no, float* __restrict__ out_nd,
    float* __restrict__ out_att, float* __restrict__ out_emit,
    float* __restrict__ out_p, float* __restrict__ out_n,
    int* __restrict__ out_inter, const float* __restrict__ sph_vel = nullptr,
    float time = 0.f) {
  const Scatter v = bounce_values<MOTION>(
      ox, oy, oz, dx, dy, dz, w, sph, sph_mat, rect, rect_mat, tri_nrm,
      tri_mat, mat, uni[i], uni[n + i], uni[2 * n + i], uni[3 * n + i],
      sph_vel, time);
  out_no[i] = v.nox;
  out_no[n + i] = v.noy;
  out_no[2 * n + i] = v.noz;
  out_nd[i] = v.ndx;
  out_nd[n + i] = v.ndy;
  out_nd[2 * n + i] = v.ndz;
  out_att[i] = v.ar;
  out_att[n + i] = v.ag;
  out_att[2 * n + i] = v.ab;
  out_emit[i] = v.er;
  out_emit[n + i] = v.eg;
  out_emit[2 * n + i] = v.eb;
  out_p[i] = v.px;
  out_p[n + i] = v.py;
  out_p[2 * n + i] = v.pz;
  out_n[i] = v.nx;
  out_n[n + i] = v.ny;
  out_n[2 * n + i] = v.nz;
  out_inter[i] = v.inter;
}

}  // namespace
