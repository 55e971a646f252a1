// The closest-hit sweeps shared by the fused bounces (bounce.cu,
// bounce_ordered.cu), the closest-hit kernels (closest.cu,
// closest_ordered.cu), the regeneration steps (regen.cu, regen_ordered.cu)
// and the leaf kernel (leaf.cu), the winner in registers.
//
// What decides a winner (both designs below, every kernel): a candidate
// counts when t_min <= t <= t_max, and the fold starts at best_t =
// min(t_max, BIG) and takes only t < best_t, so a hit must lie strictly
// below t_max. Stages run spheres, then rects, then triangles, each in
// table order, so the lowest index wins a tie and spheres win over rects
// over triangles. The sphere quadratic uses the direct oc = o - c form (no
// |o|^2 - 2 o.c expansion, which cancels catastrophically at large
// coordinates). Each pair's arithmetic is the same code in every kernel
// (sphere_disc, sphere_root, rect_t, tri_t), so a lane's winner does not
// depend on which rays share its warp or block, nor on the visit order.
//
// sweep_rays(): the flat sweep, the counterpart of the TPU kernels'
// _stage_sweep (raytracer_tpu/ops/pallas_intersect.py). A block stages the
// tables through a 16 KB shared tile that all its threads read as a
// broadcast; each thread carries R rays. What bounds it on an H100 is
// instruction issue: at one ray per thread a missed pair took ~29
// instructions, 12 of them FP32, with a branch and its convergence
// barrier per pair. So each staged sphere is read once for all R rays,
// and the pair loop takes UNROLL spheres at a time: their loads
// first, then the R x UNROLL discriminants (independent chains), then one
// branch for the group: the square root and the root checks run only where
// some pair has disc >= 0 (sphere_root), and a miss folds nothing, as the
// fold of t = BIG changes nothing. The order of the folds for a ray stays
// table order. A dead ray rides along with t_min = +inf, which no test
// passes, so it keeps the miss winner; a warp whose rays k are all dead
// sweeps its other rays alone. The grouped pair test's roundings are
// written out (sphere_disc_rn), so both loops give the same bits. One block
// per 256-lane tile: a persistent grid that took tiles from a counter
// bought nothing (0.98-1.03x in tools/ab_bounce.py's A/B on an H100).
//
// sweep_ordered(): the same winner through the near-to-far superchunk walk
// (walk(), the counterpart of stage_ordered and _tile_chunk_order) for a
// sphere or triangle stage that ops/ordered.py sorted, one warp at a time:
// every decision is the warp's own. What bounded the walk when a block of
// 128 lanes decided together was the bodies it ran for lanes that could
// not reach them (8.44 bodies per block at a field64k secondary-ray step
// where each warp of its lanes needs 4.70), behind two block barriers per
// body. Per warp: shuffles reduce the alive origins to the warp's box;
// each superchunk's squared gap to it goes to the warp's shared keys,
// where its 32 lanes rank them; the walk visits superchunks in that order
// and stops once the gap exceeds every alive lane's reach min(best_t,
// t_cap) * |d| (a warp max; t_cap: the exit t from the stage box, leave *
// 1.001 + 1e-4; the stop compares against reach^2 * 1.001 + 1e-9). A
// superchunk, then each member chunk, runs when an alive lane's slab test
// passes (__any_sync), each test with the winner as it stands. So a warp
// computes only the bodies its own 32 rays can reach, never waits at a
// barrier for another warp, and runs exactly the chunks of
// ops/ordered.py::walk_plain with groups of 32, the plain version. The warp
// copies each body's sub-tiles into its own shared buffer (16 B a lane,
// __syncwarp around it); overlapping that copy with the fold through
// cp.async bought nothing (0.95-1.03x, same A/B). The fold compares (t, then
// type, then scene index), so the walk keeps the flat sweep's winner
// whatever the visit order and the group, but for one case: a float32
// false hit (the test hits a sphere that float64 misses, at a point outside
// its padded chunk box; |o - c|^2 - r^2 cancels) is kept only where some
// lane of the group runs its chunk. Such a lane's winner follows its group:
// a warp drops a false hit that its block of 128 kept (ops/ordered.py). The
// flat stages of an ordered kernel stream through the same buffer
// (flat_warp).
//
// Calls: every thread of a block calls sweep_rays() (it synchronises the
// block while staging; a block whose rays are all dead skips it). Every
// lane of a warp calls sweep_ordered() (warp collectives only; a warp whose
// lanes are all dead skips it, a dead lane takes no part and keeps the miss
// winner).
//
// Motion blur (MOTION = true, the TPU kernels' has_time): each ray carries
// a shutter time t, and sphere j is tested at its centre moved to
// c_j + v_j t (moved(): the product and the sum each rounded on its own, as
// the plain version computes them), with v_j from a velocity table beside
// the sphere table ((S, 4): vx, vy, vz, 0). The flat sweep stages the
// spheres and their velocities together, half a tile each; the warp's
// buffer holds a sub-tile of velocities after the sub-tile of spheres. The cull
// boxes of an ordered stage were dilated over the shutter when it was
// packed (ops/ordered.py), so the walk's culls need no time. MOTION = false
// compiles to the static code: every motion branch is `if constexpr`.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr float BIG = 3.0e38f;                // the "no hit" t
constexpr int TILE_FLOATS = 4096;             // 16 KB staging tile
constexpr int SPH_W = 4, RECT_W = 8, TRI_W = 16;
constexpr int SUPER = 8;                      // chunks per superchunk
constexpr int MAX_SUPERS = 1024;              // ops/ordered.py MAX_SUPERS
constexpr float INV_GUARD = 1e-30f;           // |d| <= this: parallel axis
constexpr float CAP_REL = 1.001f, CAP_ABS = 1e-4f;
constexpr float REACH_REL = 1.001f, REACH_ABS = 1e-9f;
constexpr int PRIM_SPHERE = 0, PRIM_RECT = 1, PRIM_TRIANGLE = 2;
constexpr unsigned FULL = 0xffffffffu;
constexpr int WARP = 32;
constexpr int UNROLL = 4;         // flat sweep: spheres per group of pairs
constexpr int BUF_FLOATS = 640;  // a warp's staging buffer (2,560 B)

// Primitives per sub-tile of a warp's buffer, records (+ velocities) + ids
// within BUF_FLOATS: spheres 128 x 20 B, moving spheres 64 x 36 B, rects
// 64 x 32 B, triangles 32 x 68 B.
template <int KIND, bool MOVES>
__host__ __device__ constexpr int buf_sub() {
  return KIND == PRIM_SPHERE ? (MOVES ? 64 : 128)
                             : (KIND == PRIM_RECT ? 64 : 32);
}

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

// One ordered stage as ops/ordered.py packs it; prim == nullptr means the
// stage is flat.
struct Stage {
  const float* prim;    // (k_ch * chunk, width) sorted records, pads miss
  const int* orig;      // (k_ch * chunk,) scene index, -1 on a pad
  const float* cull;    // (k_ch, 6) chunk boxes: lo xyz, hi xyz
  const float* scull;   // (k_ch / SUPER, 6) superchunk boxes
  const float* box;     // (6,) the stage box
  int k_ch, chunk;
  const float* vel;     // (k_ch * chunk, SPH_W) sorted velocities (MOTION)
};

// Copy rows [base, base + cnt) of a table with `width` floats per row into
// the shared tile (whole block, coalesced float loads).
template <int BLOCK>
__device__ __forceinline__ void stage(float* tile, const float* table,
                                      int base, int cnt, int width) {
  const float* src = table + (size_t)base * width;
  for (int k = threadIdx.x; k < cnt * width; k += BLOCK) tile[k] = src[k];
}

// ---- pair tests, shared by the flat sweep, the walk and the leaf kernel.
// Each returns BIG where the pair misses. r.tmax is already min(t_max, BIG).

// The sphere test's first half: half_b and the discriminant.
__device__ __forceinline__ float sphere_disc(const Ray& r, float a, float4 s,
                                             float& half_b) {
  const float ocx = r.ox - s.x, ocy = r.oy - s.y, ocz = r.oz - s.z;
  half_b = r.dx * ocx + r.dy * ocy + r.dz * ocz;
  const float c = ocx * ocx + ocy * ocy + ocz * ocz - s.w;
  return half_b * half_b - a * c;
}

// Its second half, for disc >= 0: the nearer root in [t_min, t_max], else
// the farther, else BIG.
__device__ __forceinline__ float sphere_root(const Ray& r, float inv_a,
                                             float half_b, float disc) {
  const float sq = sqrtf(disc);
  const float r1 = (-half_b - sq) * inv_a;
  const float r2 = (-half_b + sq) * inv_a;
  return (r1 >= r.tmin && r1 <= r.tmax) ? r1
       : ((r2 >= r.tmin && r2 <= r.tmax) ? r2 : BIG);
}

__device__ __forceinline__ float sphere_t(const Ray& r, float a, float inv_a,
                                          float4 s) {
  float half_b;
  const float disc = sphere_disc(r, a, s, half_b);
  if (!(disc >= 0.f)) return BIG;
  return sphere_root(r, inv_a, half_b, disc);
}

// axis-aligned rect: plane solve, inclusive bounds
__device__ __forceinline__ float rect_t(const Ray& r, const float* q) {
  const int axis = (int)q[0];
  const float d_n = axis == 0 ? r.dx : (axis == 1 ? r.dy : r.dz);
  const float o_n = axis == 0 ? r.ox : (axis == 1 ? r.oy : r.oz);
  const bool safe = fabsf(d_n) > 1e-12f;
  const float t = (q[1] - o_n) / (safe ? d_n : 1.0f);
  const float pa = (axis == 0 ? r.oy : r.ox) + t * (axis == 0 ? r.dy : r.dx);
  const float pb = (axis == 2 ? r.oy : r.oz) + t * (axis == 2 ? r.dy : r.dz);
  const bool ok = safe && pa >= q[2] && pa <= q[3] && pb >= q[4] &&
                  pb <= q[5] && t >= r.tmin && t <= r.tmax;
  return ok ? t : BIG;
}

// triangle: scalar-triple-product Moller-Trumbore; oxd = o x d
__device__ __forceinline__ float tri_t(const Ray& r, const float* oxd,
                                       const float* q, float& b1, float& b2) {
  const float div = -(r.dx * q[0] + r.dy * q[1] + r.dz * q[2]);
  if (div == 0.f) return BIG;
  const float inv = 1.0f / div;
  b1 = ((oxd[0] * q[6] + oxd[1] * q[7] + oxd[2] * q[8]) -
        (r.dx * q[9] + r.dy * q[10] + r.dz * q[11])) * inv;
  b2 = (-(oxd[0] * q[3] + oxd[1] * q[4] + oxd[2] * q[5]) +
        (r.dx * q[12] + r.dy * q[13] + r.dz * q[14])) * inv;
  const float t = ((r.ox * q[0] + r.oy * q[1] + r.oz * q[2]) - q[15]) * inv;
  const bool ok = b1 >= 0.f && b1 <= 1.f && b2 >= 0.f && b1 + b2 <= 1.f &&
                  t >= r.tmin && t <= r.tmax;
  return ok ? t : BIG;
}

// The sphere s (centre, r^2) with its centre moved to c + v t.
__device__ __forceinline__ float4 moved(float4 s, float4 v, float t) {
  return make_float4(__fadd_rn(s.x, __fmul_rn(v.x, t)),
                     __fadd_rn(s.y, __fmul_rn(v.y, t)),
                     __fadd_rn(s.z, __fmul_rn(v.z, t)), s.w);
}

__device__ __forceinline__ float ray_a(const Ray& r) {
  return r.dx * r.dx + r.dy * r.dy + r.dz * r.dz;
}

__device__ __forceinline__ void ray_oxd(const Ray& r, float* oxd) {
  oxd[0] = r.oy * r.dz - r.oz * r.dy;
  oxd[1] = r.oz * r.dx - r.ox * r.dz;
  oxd[2] = r.ox * r.dy - r.oy * r.dx;
}

// sphere_disc with every rounding written out, in the order nvcc gives
// sphere_disc in the flat sweep and the walk (FMUL first, then FFMAs; disc
// = fma(half_b, half_b, -(a c))): the same bits in every instantiation of
// the grouped loops below, whatever nvcc would contract there.
__device__ __forceinline__ float sphere_disc_rn(const Ray& r, float a,
                                                float4 s, float& half_b) {
  const float ocx = __fsub_rn(r.ox, s.x), ocy = __fsub_rn(r.oy, s.y),
              ocz = __fsub_rn(r.oz, s.z);
  half_b = __fmaf_rn(r.dz, ocz, __fmaf_rn(r.dx, ocx, __fmul_rn(r.dy, ocy)));
  const float c = __fsub_rn(
      __fmaf_rn(ocz, ocz, __fmaf_rn(ocx, ocx, __fmul_rn(ocy, ocy))), s.w);
  return __fmaf_rn(half_b, half_b, -__fmul_rn(a, c));
}

// U staged spheres s (velocities v, MOTION) against R rays: the R x U
// discriminants first, then one branch for the group; `fold(k, u, t)` gets
// each pair with disc >= 0, in u order for each ray k.
template <int U, int R, bool MOTION, class Fold>
__device__ __forceinline__ void sphere_group(
    const float4 (&s)[U], const float4 (&v)[U], const Ray (&r)[R],
    const float (&a)[R], const float (&inv_a)[R], const float (&time)[R],
    Fold fold) {
  float hb[U][R], disc[U][R];
  float top = -INFINITY;
#pragma unroll
  for (int u = 0; u < U; ++u) {
#pragma unroll
    for (int k = 0; k < R; ++k) {
      float4 c = s[u];
      if constexpr (MOTION) c = moved(s[u], v[u], time[k]);
      disc[u][k] = sphere_disc_rn(r[k], a[k], c, hb[u][k]);
      top = fmaxf(top, disc[u][k]);
    }
  }
  if (!(top >= 0.f)) return;
#pragma unroll
  for (int u = 0; u < U; ++u) {
#pragma unroll
    for (int k = 0; k < R; ++k) {
      if (disc[u][k] >= 0.f)
        fold(k, u, sphere_root(r[k], inv_a[k], hb[u][k], disc[u][k]));
    }
  }
}

// ---- the flat sweep: a block, R rays per thread

// The flat sweep's pair loop over cnt staged spheres (s4, velocities v4)
// for RR rays, in groups of UNROLL; winner indices base + j.
template <int RR, bool MOTION>
__device__ __forceinline__ void sphere_pairs(
    const float4* s4, const float4* v4, int base, int cnt, const Ray (&r)[RR],
    const float (&a)[RR], const float (&inv_a)[RR], const float (&time)[RR],
    Winner (&w)[RR]) {
  int j = 0;
  auto fold = [&](int k, int u, float t) {
    if (t < w[k].t) {
      w[k].t = t;
      w[k].ty = PRIM_SPHERE;
      w[k].ix = base + j + u;
    }
  };
  for (; j + UNROLL <= cnt; j += UNROLL) {
    float4 s[UNROLL], v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      s[u] = s4[j + u];
      v[u] = MOTION ? v4[j + u] : s[u];
    }
    sphere_group<UNROLL, RR, MOTION>(s, v, r, a, inv_a, time, fold);
  }
  for (; j < cnt; ++j) {
    const float4 s[1] = {s4[j]};
    const float4 v[1] = {MOTION ? v4[j] : s4[j]};
    sphere_group<1, RR, MOTION>(s, v, r, a, inv_a, time, fold);
  }
}

template <int BLOCK, int R, bool MOTION>
__device__ __forceinline__ void sweep_spheres(
    float* tile, bool any, const bool (&live)[R], const Ray (&r)[R],
    const float* __restrict__ sph, int n_sph, Winner (&w)[R],
    const float* __restrict__ vel, const float (&time)[R]) {
  float a[R], inv_a[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    a[k] = ray_a(r[k]);
    inv_a[k] = 1.0f / a[k];
  }
  // Two rays per thread: where every lane's ray k of a warp is dead (lanes
  // live and die in whole warps: sparse shadow rays, late regen steps), the
  // warp sweeps its other ray alone, with the same arithmetic.
  bool need0 = true, need1 = true;
  if constexpr (R == 2) {
    need0 = __any_sync(FULL, live[0]);
    need1 = __any_sync(FULL, live[1]);
  }
  // with MOTION the velocities take the tile's second half
  constexpr int sph_tile = TILE_FLOATS / (MOTION ? 2 * SPH_W : SPH_W);
  for (int base = 0; base < n_sph; base += sph_tile) {
    const int cnt = min(sph_tile, n_sph - base);
    __syncthreads();
    stage<BLOCK>(tile, sph, base, cnt, SPH_W);
    if constexpr (MOTION)
      stage<BLOCK>(tile + TILE_FLOATS / 2, vel, base, cnt, SPH_W);
    __syncthreads();
    if (!any) continue;
    const float4* s4 = reinterpret_cast<const float4*>(tile);
    const float4* v4 = reinterpret_cast<const float4*>(
        tile + (MOTION ? TILE_FLOATS / 2 : 0));
    if constexpr (R == 2) {
      if (need0 != need1) {
        const Ray r1[1] = {need0 ? r[0] : r[1]};
        const float a1[1] = {need0 ? a[0] : a[1]};
        const float i1[1] = {need0 ? inv_a[0] : inv_a[1]};
        const float t1[1] = {need0 ? time[0] : time[1]};
        Winner w1[1] = {need0 ? w[0] : w[1]};
        sphere_pairs<1, MOTION>(s4, v4, base, cnt, r1, a1, i1, t1, w1);
        if (need0) w[0] = w1[0];
        else w[1] = w1[0];
        continue;
      }
    }
    sphere_pairs<R, MOTION>(s4, v4, base, cnt, r, a, inv_a, time, w);
  }
}

template <int BLOCK, int R>
__device__ __forceinline__ void sweep_rects(float* tile, bool any,
                                            const Ray (&r)[R],
                                            const float* __restrict__ rect,
                                            int n_rect, Winner (&w)[R]) {
  const int rect_tile = TILE_FLOATS / RECT_W;
  for (int base = 0; base < n_rect; base += rect_tile) {
    const int cnt = min(rect_tile, n_rect - base);
    __syncthreads();
    stage<BLOCK>(tile, rect, base, cnt, RECT_W);
    __syncthreads();
    if (!any) continue;
    for (int j = 0; j < cnt; ++j) {
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const float t = rect_t(r[k], tile + j * RECT_W);
        if (t < w[k].t) {
          w[k].t = t;
          w[k].ty = PRIM_RECT;
          w[k].ix = base + j;
        }
      }
    }
  }
}

template <int BLOCK, int R>
__device__ __forceinline__ void sweep_tris(float* tile, bool any,
                                           const Ray (&r)[R],
                                           const float* __restrict__ tri,
                                           int n_tri, Winner (&w)[R]) {
  float oxd[R][3];
#pragma unroll
  for (int k = 0; k < R; ++k) ray_oxd(r[k], oxd[k]);
  const int tri_tile = TILE_FLOATS / TRI_W;
  for (int base = 0; base < n_tri; base += tri_tile) {
    const int cnt = min(tri_tile, n_tri - base);
    __syncthreads();
    stage<BLOCK>(tile, tri, base, cnt, TRI_W);
    __syncthreads();
    if (!any) continue;
    for (int j = 0; j < cnt; ++j) {
#pragma unroll
      for (int k = 0; k < R; ++k) {
        float b1 = 0.f, b2 = 0.f;
        const float t = tri_t(r[k], oxd[k], tile + j * TRI_W, b1, b2);
        if (t < w[k].t) {
          w[k].t = t;
          w[k].ty = PRIM_TRIANGLE;
          w[k].ix = base + j;
          w[k].b1 = b1;
          w[k].b2 = b2;
        }
      }
    }
  }
}

// The ray with t_max clamped to BIG (the tests' upper bound).
__device__ __forceinline__ Ray clamped(const Ray& ray) {
  Ray r = ray;
  r.tmax = fminf(ray.tmax, BIG);
  return r;
}

// The flat sweep of R rays per thread: w[k] is ray k's winner (the miss
// winner where live[k] is false). vel, time: the sphere velocities and each
// ray's shutter time (MOTION).
template <int BLOCK, int R, bool MOTION = false>
__device__ __forceinline__ void sweep_rays(
    float* tile, const bool (&live)[R], const Ray (&ray)[R],
    const float* __restrict__ sph, int n_sph,
    const float* __restrict__ rect, int n_rect,
    const float* __restrict__ tri, int n_tri, Winner (&w)[R],
    const float* __restrict__ vel, const float (&time)[R]) {
  Ray r[R];
  bool any = false;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    r[k] = clamped(ray[k]);
    w[k] = Winner{r[k].tmax, -1, 0, 0.f, 0.f};
    if (!live[k]) r[k].tmin = INFINITY;   // no test passes: the miss stays
    any = any || live[k];
  }
  if (!__syncthreads_or(any)) return;
  sweep_spheres<BLOCK, R, MOTION>(tile, any, live, r, sph, n_sph, w, vel,
                                  time);
  sweep_rects<BLOCK, R>(tile, any, r, rect, n_rect, w);
  sweep_tris<BLOCK, R>(tile, any, r, tri, n_tri, w);
}

// One ray per thread (leaf.cu's dense stages).
template <int BLOCK>
__device__ __forceinline__ Winner sweep(
    float* tile, bool live, const Ray& ray,
    const float* __restrict__ sph, int n_sph,
    const float* __restrict__ rect, int n_rect,
    const float* __restrict__ tri, int n_tri) {
  const bool l[1] = {live};
  const Ray rr[1] = {ray};
  const float tm[1] = {0.f};
  Winner w[1];
  sweep_rays<BLOCK, 1>(tile, l, rr, sph, n_sph, rect, n_rect, tri, n_tri, w,
                       nullptr, tm);
  return w[0];
}

// ---- box tests

// A ray's values for the box tests: 1/d with the 1e30 guard of the TPU
// kernels' ray_vals, and which axes the ray is parallel to (that guard).
struct CullRay {
  float ix, iy, iz;
  bool px, py, pz;
};

__device__ __forceinline__ CullRay cull_ray(const Ray& r) {
  CullRay c;
  c.px = fabsf(r.dx) <= INV_GUARD;
  c.py = fabsf(r.dy) <= INV_GUARD;
  c.pz = fabsf(r.dz) <= INV_GUARD;
  c.ix = c.px ? 1e30f : 1.0f / r.dx;
  c.iy = c.py ? 1e30f : 1.0f / r.dy;
  c.iz = c.pz ? 1e30f : 1.0f / r.dz;
  return c;
}

// One slab: narrows [tn, tf]; a parallel axis passes when the origin lies
// inside the slab (inclusive).
__device__ __forceinline__ bool axis_slab(float o, float inv, bool par,
                                          float lo, float hi, float& tn,
                                          float& tf) {
  if (par) return o >= lo && o <= hi;
  const float t0 = (lo - o) * inv, t1 = (hi - o) * inv;
  tn = fmaxf(tn, fminf(t0, t1));
  tf = fminf(tf, fmaxf(t0, t1));
  return true;
}

// Box b (lo xyz, hi xyz): enter t and leave t (without cap); false when the
// box is inverted or a parallel axis misses.
__device__ __forceinline__ bool box_span(const Ray& r, const CullRay& c,
                                         const float* b, float& tn,
                                         float& tf) {
  tn = r.tmin;
  tf = INFINITY;
  return b[0] <= b[3] && axis_slab(r.ox, c.ix, c.px, b[0], b[3], tn, tf) &&
         axis_slab(r.oy, c.iy, c.py, b[1], b[4], tn, tf) &&
         axis_slab(r.oz, c.iz, c.pz, b[2], b[5], tn, tf);
}

// Can the ray touch box b for t in [t_min, min(cap, t_max)]? (inclusive)
__device__ __forceinline__ bool slab(const Ray& r, const CullRay& c,
                                     const float* b, float cap) {
  float tn, tf;
  return box_span(r, c, b, tn, tf) && tn <= fminf(tf, fminf(cap, r.tmax));
}

// ---- warp collectives

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

// lo[k] = min, hi[k] = max over the warp's live lanes of the origin.
__device__ __forceinline__ void warp_box(const Ray& r, bool live, float* lo,
                                         float* hi) {
  float v[6] = {live ? r.ox : BIG,  live ? r.oy : BIG,  live ? r.oz : BIG,
                live ? r.ox : -BIG, live ? r.oy : -BIG, live ? r.oz : -BIG};
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      v[k] = fminf(v[k], __shfl_xor_sync(FULL, v[k], off));
      v[3 + k] = fmaxf(v[3 + k], __shfl_xor_sync(FULL, v[3 + k], off));
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    lo[k] = v[k];
    hi[k] = v[3 + k];
  }
}

// ---- a warp's staging buffer

// `floats` floats (a multiple of 4; both sides 16-B aligned), copied by the
// warp, 16 B a lane; the caller's __syncwarp() shows them to the warp.
__device__ __forceinline__ void warp_copy(float* dst, const void* src,
                                          int floats) {
  const float4* s = static_cast<const float4*>(src);
  float4* t = reinterpret_cast<float4*>(dst);
  for (int k = threadIdx.x & (WARP - 1); k < floats / 4; k += WARP)
    t[k] = __ldg(s + k);
}

// The shared memory of one warp in an ordered kernel: its buffer, then the
// walk's keys and order for k_sup superchunks, rounded up to 16 B so that
// the next warp's buffer stays aligned.
struct WarpShared {
  float* buf;
  float* key;
  int* order;
};

__host__ __device__ constexpr size_t warp_shared_bytes(int k_sup) {
  return ((size_t)BUF_FLOATS * sizeof(float) + (size_t)8 * k_sup + 15)
         / 16 * 16;
}

// A block of 4 warps stays within the 48 KB of dynamic shared memory that
// a launch gets without opting in, up to MAX_SUPERS superchunks.
static_assert(4 * warp_shared_bytes(MAX_SUPERS) <= 48 * 1024,
              "an ordered kernel's block outgrows 48 KB of shared memory");

__device__ __forceinline__ WarpShared warp_shared(float* smem, int k_sup) {
  const int warp = threadIdx.x / WARP;
  float* base = smem + warp * (warp_shared_bytes(k_sup) / sizeof(float));
  return WarpShared{base, base + BUF_FLOATS,
                    reinterpret_cast<int*>(base + BUF_FLOATS + k_sup)};
}

// ---- the flat stages of an ordered kernel, one warp: sub-tiles of the
// table go through the warp's buffer; the fold is the flat sweep's (strict
// <, table order).
template <int KIND, bool MOVES>
__device__ __forceinline__ void flat_warp(float* buf, bool live,
                                          const Ray& r,
                                          const float* __restrict__ table,
                                          int n, Winner& w,
                                          const float* __restrict__ vel,
                                          float time) {
  constexpr int W = KIND == PRIM_SPHERE ? SPH_W
                  : (KIND == PRIM_RECT ? RECT_W : TRI_W);
  constexpr int SUB = buf_sub<KIND, MOVES>();
  if (n <= 0) return;
  const float a = ray_a(r);
  const float inv_a = 1.0f / a;
  float oxd[3];
  if constexpr (KIND == PRIM_TRIANGLE) ray_oxd(r, oxd);
  for (int base = 0; base < n; base += SUB) {
    const int cnt = min(SUB, n - base);
    __syncwarp();   // every lane is done with the buffer before its refill
    warp_copy(buf, table + (size_t)base * W, cnt * W);
    if constexpr (MOVES)
      warp_copy(buf + SUB * W, vel + (size_t)base * SPH_W, cnt * SPH_W);
    __syncwarp();
    if (!live) continue;
    for (int j = 0; j < cnt; ++j) {
      float t, b1 = 0.f, b2 = 0.f;
      if constexpr (KIND == PRIM_SPHERE) {
        float4 s = reinterpret_cast<const float4*>(buf)[j];
        if constexpr (MOVES)
          s = moved(s, reinterpret_cast<const float4*>(buf + SUB * W)[j],
                    time);
        t = sphere_t(r, a, inv_a, s);
      } else if constexpr (KIND == PRIM_RECT) {
        t = rect_t(r, buf + j * RECT_W);
      } else {
        t = tri_t(r, oxd, buf + j * TRI_W, b1, b2);
      }
      if (t < w.t) {
        w.t = t;
        w.ty = KIND;
        w.ix = base + j;
        w.b1 = b1;
        w.b2 = b2;
      }
    }
  }
}

// ---- the walk of one ordered stage by one warp (KIND: PRIM_SPHERE or
// PRIM_TRIANGLE). Returns the chunk bodies the warp ran. MOTION: spheres at
// the ray's shutter time, their velocities from st.vel. The stage's chunk
// is a multiple of the sub-tile (checked by the entry points).
template <int KIND, bool MOTION>
__device__ __forceinline__ int walk(const WarpShared& sh, bool live, const Ray& r,
                    const CullRay& cu, const Stage& st, Winner& w,
                    float time) {
  constexpr bool MOVES = MOTION && KIND == PRIM_SPHERE;
  constexpr int W = KIND == PRIM_SPHERE ? SPH_W : TRI_W;
  constexpr int SUB = buf_sub<KIND, MOVES>();
  constexpr int IDS = SUB * W + (MOVES ? SUB * SPH_W : 0);
  const int lane = threadIdx.x & (WARP - 1);
  const int k_sup = st.k_ch / SUPER;

  // this lane's reach cap: its exit t from the stage box, with slack
  float tn, tf, t_cap = 0.f;
  if (box_span(r, cu, st.box, tn, tf) && tn <= tf)
    t_cap = tf * CAP_REL + CAP_ABS;
  const float a = ray_a(r);
  const float inv_a = 1.0f / a;
  const float dlen = sqrtf(a);
  float oxd[3];
  if constexpr (KIND == PRIM_TRIANGLE) ray_oxd(r, oxd);

  // the warp's alive-origin box; each superchunk's squared gap to it,
  // ranked by the warp (stable: equal gaps keep table order)
  float lo[3], hi[3];
  warp_box(r, live, lo, hi);
  __syncwarp();   // the keys' earlier readers (another stage) are done
  for (int s = lane; s < k_sup; s += WARP) {
    const float* b = st.scull + 6 * s;
    const float gx = fmaxf(fmaxf(b[0] - hi[0], lo[0] - b[3]), 0.f);
    const float gy = fmaxf(fmaxf(b[1] - hi[1], lo[1] - b[4]), 0.f);
    const float gz = fmaxf(fmaxf(b[2] - hi[2], lo[2] - b[5]), 0.f);
    sh.key[s] = gx * gx + gy * gy + gz * gz;
  }
  __syncwarp();
  for (int s = lane; s < k_sup; s += WARP) {
    const float k = sh.key[s];
    int rank = 0;
    for (int j = 0; j < k_sup; ++j) {
      const float kj = sh.key[j];
      rank += (kj < k) || (kj == k && j < s);
    }
    sh.order[rank] = s;
  }
  __syncwarp();

  auto stop = [&](int s) {
    const float reach = warp_max(live ? fminf(w.t, t_cap) * dlen : 0.f);
    return sh.key[s] > reach * reach * REACH_REL + REACH_ABS;
  };
  auto any_slab = [&](const float* box) {
    return __any_sync(FULL, live && slab(r, cu, box, fminf(w.t, t_cap)));
  };
  auto compute = [&](const float* tile) {
    const int* ids = reinterpret_cast<const int*>(tile + IDS);
    if constexpr (KIND == PRIM_SPHERE) {
      const float4* s4 = reinterpret_cast<const float4*>(tile);
      const float4* v4 = reinterpret_cast<const float4*>(
          tile + (MOVES ? SUB * W : 0));
      const Ray rr[1] = {r};
      const float aa[1] = {a}, ia[1] = {inv_a}, tt[1] = {time};
#pragma unroll 1
      for (int j = 0; j < SUB; j += UNROLL) {
        float4 s[UNROLL], v[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          s[u] = s4[j + u];
          v[u] = MOVES ? v4[j + u] : s[u];
        }
        sphere_group<UNROLL, 1, MOVES>(
            s, v, rr, aa, ia, tt, [&](int, int u, float t) {
              if (t <= w.t) {
                const int id = ids[j + u];
                if (t < w.t || (w.ty == KIND && id < w.ix)) {
                  w.t = t;
                  w.ty = KIND;
                  w.ix = id;
                  w.b1 = 0.f;
                  w.b2 = 0.f;
                }
              }
            });
      }
    } else {
#pragma unroll 4
      for (int j = 0; j < SUB; ++j) {
        float b1 = 0.f, b2 = 0.f;
        const float t = tri_t(r, oxd, tile + j * TRI_W, b1, b2);
        if (t <= w.t) {
          const int id = ids[j];
          if (t < w.t || (w.ty == KIND && id < w.ix)) {
            w.t = t;
            w.ty = KIND;
            w.ix = id;
            w.b1 = b1;
            w.b2 = b2;
          }
        }
      }
    }
  };

  // chunk c: its sub-tiles through the warp's buffer
  auto body = [&](int c) {
    for (int sub = 0; sub < st.chunk; sub += SUB) {
      const size_t row = (size_t)c * st.chunk + sub;
      __syncwarp();   // every lane is done with the buffer before its refill
      warp_copy(sh.buf, st.prim + row * W, SUB * W);
      if constexpr (MOVES)
        warp_copy(sh.buf + SUB * W, st.vel + row * SPH_W, SUB * SPH_W);
      warp_copy(sh.buf + IDS, st.orig + row, SUB);
      __syncwarp();
      if (live) compute(sh.buf);
    }
  };

  // each test with the winner as it stands (walk_plain's order)
  int bodies = 0;
  for (int pos = 0; pos < k_sup; ++pos) {
    const int s = sh.order[pos];
    if (stop(s)) break;
    if (!any_slab(st.scull + 6 * s)) continue;
    for (int c = s * SUPER; c < (s + 1) * SUPER; ++c) {
      if (!any_slab(st.cull + 6 * c)) continue;
      body(c);
      ++bodies;
    }
  }
  return bodies;
}

// The closest hit of one warp with the ordered stages walked and the others
// streamed flat. stats (optional): this warp's chunk bodies of the sphere
// walk and of the triangle walk. vel, time: as for sweep_rays() (MOTION; a
// sphere stage that walks reads osph.vel instead of vel).
template <bool MOTION = false>
__device__ __forceinline__ Winner sweep_ordered(
    const WarpShared& sh, bool live, const Ray& ray,
    const float* __restrict__ sph, int n_sph, const Stage& osph,
    const float* __restrict__ rect, int n_rect,
    const float* __restrict__ tri, int n_tri, const Stage& otri,
    int* __restrict__ stats, const float* __restrict__ vel = nullptr,
    float time = 0.f) {
  const Ray r = clamped(ray);
  Winner w{r.tmax, -1, 0, 0.f, 0.f};
  int nb_sph = 0, nb_tri = 0;
  if (__any_sync(FULL, live)) {
    const CullRay cu = cull_ray(r);
    if (osph.prim != nullptr)
      nb_sph = walk<PRIM_SPHERE, MOTION>(sh, live, r, cu, osph, w, time);
    else
      flat_warp<PRIM_SPHERE, MOTION>(sh.buf, live, r, sph, n_sph, w, vel,
                                     time);
    flat_warp<PRIM_RECT, false>(sh.buf, live, r, rect, n_rect, w, nullptr,
                                0.f);
    if (otri.prim != nullptr)
      nb_tri = walk<PRIM_TRIANGLE, MOTION>(sh, live, r, cu, otri, w, time);
    else
      flat_warp<PRIM_TRIANGLE, false>(sh.buf, live, r, tri, n_tri, w,
                                      nullptr, 0.f);
  }
  if (stats != nullptr && (threadIdx.x & (WARP - 1)) == 0) {
    stats[0] = nb_sph;
    stats[1] = nb_tri;
  }
  return w;
}

// ---- launch helpers (host)

// Is every pointer 16-B aligned (null counts as aligned)? The warps' buffers
// copy 16 B at a time.
__host__ inline bool aligned16(std::initializer_list<const void*> ps) {
  for (const void* p : ps)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

// The checks of an ordered entry point's stages: superchunk counts within
// MAX_SUPERS, chunks that the buffer's sub-tiles divide, aligned tables.
template <bool MOTION>
__host__ inline cudaError_t check_stages(const Stage& s, const Stage& t,
                                         const float* sph, const float* rect,
                                         const float* tri,
                                         const float* sph_vel) {
  if (s.k_ch / SUPER > MAX_SUPERS || t.k_ch / SUPER > MAX_SUPERS)
    return cudaErrorInvalidValue;
  if (s.prim != nullptr && s.chunk % buf_sub<PRIM_SPHERE, MOTION>() != 0)
    return cudaErrorInvalidValue;
  if (t.prim != nullptr && t.chunk % buf_sub<PRIM_TRIANGLE, false>() != 0)
    return cudaErrorInvalidValue;
  if (MOTION && s.prim != nullptr && s.vel == nullptr)
    return cudaErrorInvalidValue;
  if (!aligned16({s.prim, s.orig, s.vel, t.prim, t.orig, sph, rect, tri,
                  sph_vel}))
    return cudaErrorMisalignedAddress;
  return cudaSuccess;
}

// The superchunks a warp's keys and order hold: those of the larger
// ordered stage, at least 1.
__host__ inline int walk_supers(const Stage& s, const Stage& t) {
  const int k_ch = s.k_ch > t.k_ch ? s.k_ch : t.k_ch;
  return k_ch / SUPER > 1 ? k_ch / SUPER : 1;
}

}  // namespace
