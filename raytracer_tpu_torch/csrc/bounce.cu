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
// Compiled without --use_fast_math: the checker texture takes sin() of
// world coordinates, far outside [-pi, pi], where __sinf is inaccurate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float BIG = 3.0e38f;
constexpr float TWO_PI = 6.283185307179586f;
constexpr float FRAC_1_PI = 0.3183098861837907f;
constexpr int BLOCK = 128;
constexpr int TILE_FLOATS = 4096;            // 16 KB staging tile
constexpr int SPH_W = 4, RECT_W = 8, TRI_W = 16, MAT_W = 12;
constexpr int INTER_DIFFUSE = 0, INTER_SPECULAR = 1, INTER_ABSORB = 2,
              INTER_REFLECT = 3, INTER_REFRACT = 4;

__device__ __forceinline__ void unit3(float& x, float& y, float& z) {
  const float inv = rsqrtf(fmaxf(x * x + y * y + z * z, 1e-30f));
  x *= inv;
  y *= inv;
  z *= inv;
}

// Copy rows [base, base + cnt) of a table with `width` floats per row into
// the shared tile (whole block, coalesced float loads).
__device__ __forceinline__ void stage(float* tile, const float* table,
                                      int base, int cnt, int width) {
  const float* src = table + (size_t)base * width;
  for (int k = threadIdx.x; k < cnt * width; k += BLOCK) tile[k] = src[k];
}

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
    int* __restrict__ out_inter) {
  __shared__ __align__(16) float tile[TILE_FLOATS];
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  const bool in = i < n;
  const bool live = in && alive[i] != 0;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  if (in) {
    ox = o[i]; oy = o[n + i]; oz = o[2 * n + i];
    dx = d[i]; dy = d[n + i]; dz = d[2 * n + i];
  }
  float best_t = BIG, best_b1 = 0.f, best_b2 = 0.f;
  int best_ty = -1, best_ix = 0;

  if (__syncthreads_or(live)) {
    // ---- spheres: direct oc = o - c quadratic (no |o|^2 - 2 o.c form,
    // which cancels catastrophically at large coordinates)
    const float a = dx * dx + dy * dy + dz * dz;
    const float inv_a = 1.0f / a;
    const int sph_tile = TILE_FLOATS / SPH_W;
    for (int base = 0; base < n_sph; base += sph_tile) {
      const int cnt = min(sph_tile, n_sph - base);
      __syncthreads();
      stage(tile, sph, base, cnt, SPH_W);
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
          const float t = (r1 >= tmin && r1 <= BIG) ? r1
                        : ((r2 >= tmin && r2 <= BIG) ? r2 : BIG);
          if (t < best_t) {
            best_t = t;
            best_ty = 0;
            best_ix = base + j;
          }
        }
      }
    }

    // ---- axis-aligned rects: plane solve, inclusive bounds
    const int rect_tile = TILE_FLOATS / RECT_W;
    for (int base = 0; base < n_rect; base += rect_tile) {
      const int cnt = min(rect_tile, n_rect - base);
      __syncthreads();
      stage(tile, rect, base, cnt, RECT_W);
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
                        pb <= r[5] && t >= tmin && t <= BIG;
        if (ok && t < best_t) {
          best_t = t;
          best_ty = 1;
          best_ix = base + j;
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
      stage(tile, tri, base, cnt, TRI_W);
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
                        b1 + b2 <= 1.f && t >= tmin && t <= BIG;
        if (ok && t < best_t) {
          best_t = t;
          best_ty = 2;
          best_ix = base + j;
          best_b1 = b1;
          best_b2 = b2;
        }
      }
    }
  }
  if (!in) return;

  // ---- epilogue: the winner's attributes; a miss acts as an all-zero
  // winner record (zero normal, zero material features), as on the TPU
  const bool valid = best_ty >= 0;
  const float t = valid ? best_t : 0.f;
  const float px = ox + t * dx, py = oy + t * dy, pz = oz + t * dz;
  float nox = 0.f, noy = 0.f, noz = 0.f;
  int mid = -1;
  if (best_ty == 0) {
    const float4 s = reinterpret_cast<const float4*>(sph)[best_ix];
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

  const float u0 = uni[i], u1 = uni[n + i], u2 = uni[2 * n + i];
  const float eps = uni[3 * n + i];
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
  out_no[i] = px + nx * side;
  out_no[n + i] = py + ny * side;
  out_no[2 * n + i] = pz + nz * side;
  out_nd[i] = odx;
  out_nd[n + i] = ody;
  out_nd[2 * n + i] = odz;
  out_att[i] = is_lgt ? FRAC_1_PI : alr;
  out_att[n + i] = is_lgt ? FRAC_1_PI : alg;
  out_att[2 * n + i] = is_lgt ? FRAC_1_PI : alb;
  out_emit[i] = lit ? alr : 0.f;
  out_emit[n + i] = lit ? alg : 0.f;
  out_emit[2 * n + i] = lit ? alb : 0.f;
  out_p[i] = px;
  out_p[n + i] = py;
  out_p[2 * n + i] = pz;
  out_n[i] = nx;
  out_n[n + i] = ny;
  out_n[2 * n + i] = nz;
  out_inter[i] = inter;
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
  bounce_kernel<<<grid, BLOCK, 0, stream>>>(
      o, d, alive, uni, tmin, n, sph, sph_mat, n_sph, rect, rect_mat, n_rect,
      tri, tri_nrm, tri_mat, n_tri, mat, out_no, out_nd, out_att, out_emit,
      out_p, out_n, out_inter);
  return (int)cudaGetLastError();
}

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
