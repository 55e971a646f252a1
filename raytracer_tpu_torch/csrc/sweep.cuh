// The closest-hit sweeps shared by the fused bounces (bounce.cu,
// bounce_ordered.cu), the closest-hit kernels (closest.cu,
// closest_ordered.cu) and the leaf kernel (leaf.cu): one thread per ray,
// tables staged through a shared-memory tile, the winner in registers.
//
// sweep(): the flat sweep, the counterpart of the TPU kernels' _stage_sweep
// (raytracer_tpu/ops/pallas_intersect.py): a candidate counts when
// t_min <= t <= t_max, and the fold starts at best_t = min(t_max, BIG) and
// takes only t < best_t, so a hit must lie strictly below t_max. Stages run
// spheres, then rects, then triangles, each in table order, so the lowest
// index wins a tie and spheres win over rects over triangles. The sphere
// quadratic uses the direct oc = o - c form (no |o|^2 - 2 o.c expansion,
// which cancels catastrophically at large coordinates).
//
// sweep_ordered(): the same winner through the near-to-far superchunk walk
// (walk(), the counterpart of stage_ordered and _tile_chunk_order) for a
// sphere or triangle stage that ops/ordered.py sorted. Per block: a block
// reduction of the alive origins gives the block's box; each superchunk's
// squared gap to it goes to shared memory, where a rank sort orders them;
// the walk visits superchunks in that order and stops once the gap exceeds
// every alive lane's reach min(best_t, t_cap) * |d| (t_cap: the exit t from
// the stage box, leave * 1.001 + 1e-4; the stop compares against
// reach^2 * 1.001 + 1e-9). A superchunk, then each member chunk, runs when
// an alive lane's slab test passes. Every decision before a barrier is the
// block's: the order and the gaps come from shared memory, the reach from a
// block max, "any lane reaches this box" from __syncthreads_or. The fold
// compares (t, then type, then scene index), so the walk keeps the flat
// sweep's winner whatever the visit order. ops/ordered.py::walk_plain is
// the plain version.
//
// Every thread of the block must call sweep() and sweep_ordered(): they
// synchronise the block while staging. A block whose lanes are all dead
// skips them; a dead lane inside a live block takes no part and keeps the
// miss winner.
//
// Motion blur (MOTION = true, the TPU kernels' has_time): each ray carries
// a shutter time t, and sphere j is tested at its centre moved to
// c_j + v_j t (moved(): the product and the sum each rounded on its own, as
// the plain version computes them), with v_j from a velocity table beside
// the sphere table ((S, 4): vx, vy, vz, 0). The flat sweep stages the
// spheres and their velocities together, half a tile each; the walk stages
// a sub-tile of velocities after the sub-tile of spheres. The cull boxes
// of an ordered stage were dilated over the shutter when it was packed
// (ops/ordered.py), so the walk's culls need no time. MOTION = false
// compiles to the static code: every motion branch is `if constexpr`.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float BIG = 3.0e38f;                // the "no hit" t
constexpr int TILE_FLOATS = 4096;             // 16 KB staging tile
constexpr int SPH_W = 4, RECT_W = 8, TRI_W = 16;
constexpr int SUPER = 8;                      // chunks per superchunk
constexpr int MAX_SUPERS = 1024;              // ops/ordered.py MAX_SUPERS
constexpr int WALK_SUB = 256;                 // prims per staged sub-tile
constexpr float INV_GUARD = 1e-30f;           // |d| <= this: parallel axis
constexpr float CAP_REL = 1.001f, CAP_ABS = 1e-4f;
constexpr float REACH_REL = 1.001f, REACH_ABS = 1e-9f;
constexpr int PRIM_SPHERE = 0, PRIM_RECT = 1, PRIM_TRIANGLE = 2;

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

// Shared memory of the walk (besides the staging tile).
struct WalkShared {
  float key[MAX_SUPERS];
  int order[MAX_SUPERS];
  int itile[WALK_SUB];
  float red[6 * 32];
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

__device__ __forceinline__ float sphere_t(const Ray& r, float a, float inv_a,
                                          float4 s) {
  const float ocx = r.ox - s.x, ocy = r.oy - s.y, ocz = r.oz - s.z;
  const float half_b = r.dx * ocx + r.dy * ocy + r.dz * ocz;
  const float c = ocx * ocx + ocy * ocy + ocz * ocz - s.w;
  const float disc = half_b * half_b - a * c;
  if (!(disc >= 0.f)) return BIG;
  const float sq = sqrtf(disc);
  const float r1 = (-half_b - sq) * inv_a;
  const float r2 = (-half_b + sq) * inv_a;
  return (r1 >= r.tmin && r1 <= r.tmax) ? r1
       : ((r2 >= r.tmin && r2 <= r.tmax) ? r2 : BIG);
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

// ---- the flat stages

template <int BLOCK, bool MOTION = false>
__device__ __forceinline__ void sweep_spheres(
    float* tile, bool live, const Ray& r, const float* __restrict__ sph,
    int n_sph, Winner& w, const float* __restrict__ vel = nullptr,
    float time = 0.f) {
  const float a = r.dx * r.dx + r.dy * r.dy + r.dz * r.dz;
  const float inv_a = 1.0f / a;
  // with MOTION the velocities take the tile's second half
  constexpr int sph_tile = TILE_FLOATS / (MOTION ? 2 * SPH_W : SPH_W);
  for (int base = 0; base < n_sph; base += sph_tile) {
    const int cnt = min(sph_tile, n_sph - base);
    __syncthreads();
    stage<BLOCK>(tile, sph, base, cnt, SPH_W);
    if constexpr (MOTION)
      stage<BLOCK>(tile + TILE_FLOATS / 2, vel, base, cnt, SPH_W);
    __syncthreads();
    if (!live) continue;
    const float4* s4 = reinterpret_cast<const float4*>(tile);
    [[maybe_unused]] const float4* v4 =
        reinterpret_cast<const float4*>(tile + TILE_FLOATS / 2);
    for (int j = 0; j < cnt; ++j) {
      float4 s = s4[j];
      if constexpr (MOTION) s = moved(s, v4[j], time);
      const float t = sphere_t(r, a, inv_a, s);
      if (t < w.t) {
        w.t = t;
        w.ty = PRIM_SPHERE;
        w.ix = base + j;
      }
    }
  }
}

template <int BLOCK>
__device__ __forceinline__ void sweep_rects(float* tile, bool live,
                                            const Ray& r,
                                            const float* __restrict__ rect,
                                            int n_rect, Winner& w) {
  const int rect_tile = TILE_FLOATS / RECT_W;
  for (int base = 0; base < n_rect; base += rect_tile) {
    const int cnt = min(rect_tile, n_rect - base);
    __syncthreads();
    stage<BLOCK>(tile, rect, base, cnt, RECT_W);
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < cnt; ++j) {
      const float t = rect_t(r, tile + j * RECT_W);
      if (t < w.t) {
        w.t = t;
        w.ty = PRIM_RECT;
        w.ix = base + j;
      }
    }
  }
}

template <int BLOCK>
__device__ __forceinline__ void sweep_tris(float* tile, bool live,
                                           const Ray& r,
                                           const float* __restrict__ tri,
                                           int n_tri, Winner& w) {
  const float oxd[3] = {r.oy * r.dz - r.oz * r.dy, r.oz * r.dx - r.ox * r.dz,
                        r.ox * r.dy - r.oy * r.dx};
  const int tri_tile = TILE_FLOATS / TRI_W;
  for (int base = 0; base < n_tri; base += tri_tile) {
    const int cnt = min(tri_tile, n_tri - base);
    __syncthreads();
    stage<BLOCK>(tile, tri, base, cnt, TRI_W);
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < cnt; ++j) {
      float b1 = 0.f, b2 = 0.f;
      const float t = tri_t(r, oxd, tile + j * TRI_W, b1, b2);
      if (t < w.t) {
        w.t = t;
        w.ty = PRIM_TRIANGLE;
        w.ix = base + j;
        w.b1 = b1;
        w.b2 = b2;
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

// vel, time: the sphere velocities and the ray's shutter time (MOTION).
template <int BLOCK, bool MOTION = false>
__device__ __forceinline__ Winner sweep(
    float* tile, bool live, const Ray& ray,
    const float* __restrict__ sph, int n_sph,
    const float* __restrict__ rect, int n_rect,
    const float* __restrict__ tri, int n_tri,
    const float* __restrict__ vel = nullptr, float time = 0.f) {
  const Ray r = clamped(ray);
  Winner w{r.tmax, -1, 0, 0.f, 0.f};
  if (!__syncthreads_or(live)) return w;
  sweep_spheres<BLOCK, MOTION>(tile, live, r, sph, n_sph, w, vel, time);
  sweep_rects<BLOCK>(tile, live, r, rect, n_rect, w);
  sweep_tris<BLOCK>(tile, live, r, tri, n_tri, w);
  return w;
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

// ---- block reductions (BLOCK a multiple of 32, at most 1024)

template <int BLOCK>
__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  float m = red[0];
#pragma unroll
  for (int k = 1; k < BLOCK / 32; ++k) m = fmaxf(m, red[k]);
  return m;
}

// lo[k] = min, hi[k] = max over the block's live lanes of the origin.
template <int BLOCK>
__device__ __forceinline__ void block_box(const Ray& r, bool live, float* red,
                                          float* lo, float* hi) {
  float v[6] = {live ? r.ox : BIG,  live ? r.oy : BIG,  live ? r.oz : BIG,
                live ? r.ox : -BIG, live ? r.oy : -BIG, live ? r.oz : -BIG};
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      v[k] = fminf(v[k], __shfl_xor_sync(0xffffffffu, v[k], off));
      v[3 + k] = fmaxf(v[3 + k], __shfl_xor_sync(0xffffffffu, v[3 + k], off));
    }
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int k = 0; k < 6; ++k) red[6 * warp + k] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    lo[k] = red[k];
    hi[k] = red[3 + k];
    for (int q = 1; q < BLOCK / 32; ++q) {
      lo[k] = fminf(lo[k], red[6 * q + k]);
      hi[k] = fmaxf(hi[k], red[6 * q + 3 + k]);
    }
  }
}

// ---- the walk of one ordered stage (KIND: PRIM_SPHERE or PRIM_TRIANGLE).
// Returns the chunk bodies the block ran. MOTION: spheres at the ray's
// shutter time, their velocities from st.vel.
template <int BLOCK, int KIND, bool MOTION = false>
__device__ int walk(float* tile, WalkShared& sh, bool live, const Ray& r,
                    const CullRay& cu, const Stage& st, Winner& w,
                    float time = 0.f) {
  constexpr bool MOVES = MOTION && KIND == PRIM_SPHERE;
  constexpr int W = KIND == PRIM_SPHERE ? SPH_W : TRI_W;
  const int tid = threadIdx.x;
  const int k_sup = st.k_ch / SUPER;
  __syncthreads();  // the shared arrays' earlier readers are done

  // this lane's reach cap: its exit t from the stage box, with slack
  float tn, tf, t_cap = 0.f;
  if (box_span(r, cu, st.box, tn, tf) && tn <= tf)
    t_cap = tf * CAP_REL + CAP_ABS;
  const float a = r.dx * r.dx + r.dy * r.dy + r.dz * r.dz;
  const float inv_a = 1.0f / a;
  const float dlen = sqrtf(a);
  const float oxd[3] = {r.oy * r.dz - r.oz * r.dy, r.oz * r.dx - r.ox * r.dz,
                        r.ox * r.dy - r.oy * r.dx};

  // the block's alive-origin box; each superchunk's squared gap to it
  float lo[3], hi[3];
  block_box<BLOCK>(r, live, sh.red, lo, hi);
  for (int s = tid; s < k_sup; s += BLOCK) {
    const float* b = st.scull + 6 * s;
    const float gx = fmaxf(fmaxf(b[0] - hi[0], lo[0] - b[3]), 0.f);
    const float gy = fmaxf(fmaxf(b[1] - hi[1], lo[1] - b[4]), 0.f);
    const float gz = fmaxf(fmaxf(b[2] - hi[2], lo[2] - b[5]), 0.f);
    sh.key[s] = gx * gx + gy * gy + gz * gz;
  }
  __syncthreads();
  // rank sort, stable: equal gaps keep table order
  for (int s = tid; s < k_sup; s += BLOCK) {
    const float k = sh.key[s];
    int rank = 0;
    for (int j = 0; j < k_sup; ++j) {
      const float kj = sh.key[j];
      rank += (kj < k) || (kj == k && j < s);
    }
    sh.order[rank] = s;
  }
  __syncthreads();

  int bodies = 0;
  for (int pos = 0; pos < k_sup; ++pos) {
    const int s = sh.order[pos];
    const float g2 = sh.key[s];
    const float reach =
        block_max<BLOCK>(live ? fminf(w.t, t_cap) * dlen : 0.f, sh.red);
    if (g2 > reach * reach * REACH_REL + REACH_ABS) break;
    if (!__syncthreads_or(live &&
                          slab(r, cu, st.scull + 6 * s, fminf(w.t, t_cap))))
      continue;
    for (int m = 0; m < SUPER; ++m) {
      const int c = s * SUPER + m;
      if (!__syncthreads_or(live &&
                            slab(r, cu, st.cull + 6 * c, fminf(w.t, t_cap))))
        continue;
      ++bodies;
      const float* src = st.prim + (size_t)c * st.chunk * W;
      const int* osrc = st.orig + (size_t)c * st.chunk;
      for (int sub = 0; sub < st.chunk; sub += WALK_SUB) {
        const int cnt = min(WALK_SUB, st.chunk - sub);
        __syncthreads();
        stage<BLOCK>(tile, src, sub, cnt, W);
        if constexpr (MOVES)
          stage<BLOCK>(tile + WALK_SUB * SPH_W,
                       st.vel + (size_t)c * st.chunk * SPH_W, sub, cnt,
                       SPH_W);
        for (int k = tid; k < cnt; k += BLOCK) sh.itile[k] = osrc[sub + k];
        __syncthreads();
        if (!live) continue;
        for (int j = 0; j < cnt; ++j) {
          float b1 = 0.f, b2 = 0.f, t;
          if (KIND == PRIM_SPHERE) {
            float4 s = reinterpret_cast<const float4*>(tile)[j];
            if constexpr (MOVES)
              s = moved(s, reinterpret_cast<const float4*>(
                               tile + WALK_SUB * SPH_W)[j], time);
            t = sphere_t(r, a, inv_a, s);
          } else {
            t = tri_t(r, oxd, tile + j * TRI_W, b1, b2);
          }
          const int id = sh.itile[j];
          if (t < w.t || (t == w.t && w.ty == KIND && id < w.ix)) {
            w.t = t;
            w.ty = KIND;
            w.ix = id;
            w.b1 = b1;
            w.b2 = b2;
          }
        }
      }
    }
  }
  return bodies;
}

// The closest hit with the ordered stages walked and the others swept
// flat. stats (optional): per block, the chunk bodies of the sphere walk
// and of the triangle walk. vel, time: as for sweep() (MOTION; a sphere
// stage that walks reads osph.vel instead of vel).
template <int BLOCK, bool MOTION = false>
__device__ __forceinline__ Winner sweep_ordered(
    float* tile, WalkShared& sh, bool live, const Ray& ray,
    const float* __restrict__ sph, int n_sph, const Stage& osph,
    const float* __restrict__ rect, int n_rect,
    const float* __restrict__ tri, int n_tri, const Stage& otri,
    int* __restrict__ stats, const float* __restrict__ vel = nullptr,
    float time = 0.f) {
  const Ray r = clamped(ray);
  Winner w{r.tmax, -1, 0, 0.f, 0.f};
  int nb_sph = 0, nb_tri = 0;
  if (__syncthreads_or(live)) {
    const CullRay cu = cull_ray(r);
    if (osph.prim != nullptr)
      nb_sph = walk<BLOCK, PRIM_SPHERE, MOTION>(tile, sh, live, r, cu, osph,
                                                 w, time);
    else
      sweep_spheres<BLOCK, MOTION>(tile, live, r, sph, n_sph, w, vel, time);
    sweep_rects<BLOCK>(tile, live, r, rect, n_rect, w);
    if (otri.prim != nullptr)
      nb_tri = walk<BLOCK, PRIM_TRIANGLE>(tile, sh, live, r, cu, otri, w);
    else
      sweep_tris<BLOCK>(tile, live, r, tri, n_tri, w);
  }
  if (stats != nullptr && threadIdx.x == 0) {
    stats[2 * blockIdx.x] = nb_sph;
    stats[2 * blockIdx.x + 1] = nb_tri;
  }
  return w;
}

}  // namespace
