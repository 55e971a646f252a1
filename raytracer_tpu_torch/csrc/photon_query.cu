// Dense dual-radius photon query for Hopper (sm_90a): for each point, the
// flux and count of the photons within r and within the cap radius, each
// photon weighted by s = 1 - |n . delta| / |delta|.
//
// Replaces raytracer_tpu/ops/pallas_photon.py::_query_kernel (reached
// through _call_query / query_photons), whose plain PyTorch twin is
// raytracer_tpu_torch/ops/photon_query.py::query_photons_plain; the item
// list and the group cull below have their own plain twins there
// (plan_items, query_items_plain).
//
// What bounds it: FP32 issue on the (point, photon) pairs that survive the
// culls: ~11 instructions for a pair out of reach, ~20 more for one in
// reach. Device memory traffic is small beside that.
//
// What held the first design back (one block per tile of 256 cell-sorted
// points walking all its live chunks; measured on an H100): tiles differ
// widely in their work. In the first iteration of a Cornell render at
// 800x800 / 500k photons a tile has 7 live chunks at the median and 187 at
// most (a tile whose sorted points straddle distant cells gets a box that
// passes most chunks), and the launch waited for that block. And each
// point tested every photon of a live 1024-photon chunk, three shared loads
// per photon for one point.
//
// Design:
//   * tiles of TILE = 32 x PTS cell-sorted points; a warp holds a tile's
//     points, PTS a lane (points base + lane + 32 p), so one photon read
//     from shared memory serves PTS pair tests. Two points a lane measured
//     fastest on an H100 (tools/ab_bounce.py): four took 113 registers,
//     four blocks a SM and coarser tile boxes (1.4x slower at the whole
//     global map), one 1.07x slower there;
//   * query_cull: per tile, the chunks (1024 photons, the packed cull
//     boxes) whose squared gap to the tile's box is within the tile's
//     largest reach: a bit mask and a count;
//   * query_plan (one block): the live pairs T of all tiles; a work item is
//     at most ic = max(ITEM, ceil(T / BUDGET)) live chunks of one tile, so
//     the heaviest tile runs on many SMs at once; the scan of the items per
//     tile (at least one, so every tile writes its points) and of the
//     partial-sum slots of the tiles with more than one. Nothing leaves
//     the device: the item kernel reads the item count there;
//   * query_items: one block of SPLIT warps per item. Each lane tests one
//     of a chunk's 32 photon groups (32 photons each, their boxes packed
//     beside the chunk boxes) against the tile's box and reach, so the
//     block runs only the groups some point of the tile can reach, and its
//     warps take those groups in turn: an item's longest chain of work is
//     a quarter of its groups (one warp holding a whole item of four dense
//     chunks took ~0.3 ms alone, and the launch waited for it). Each warp
//     copies a batch of its groups into its own shared buffer (position
//     float4 with two bf16 of the payload in w, the other four in a uint2)
//     and folds them, photons in chunk, group and photon order; the warps'
//     sums are added in warp order through shared memory;
//   * a tile with one item writes its sums; the items of a tile with more
//     write slots, and query_combine sums them in item order, so a render
//     is deterministic from run to run;
//   * n_live (one past the last valid photon) is read on the device, so
//     the caller needs no host sync; chunks past it are never read;
//   * the 8 sums stay in f32 registers. The TPU kernel rounds the weight
//     to bf16 for its MXU flux product; here weight and sum are f32;
//   * d^2 is rounded as the plain version rounds it, (dx*dx + dy*dy) +
//     dz*dz with __fmul_rn/__fadd_rn, and every cull's gap^2 the same way,
//     so a cull never drops a photon in reach and the counts are bit-equal
//     to the plain version's: for a photon in a box and a point in a box,
//     each rounded |difference| is at least the rounded gap.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARP = 32;
constexpr int PTS = 2;                   // points per lane
constexpr int TILE = WARP * PTS;         // points per tile (one warp)
constexpr int CHUNK = 1024;              // photons per chunk box
constexpr int GROUP = 32;                // photons per group box
constexpr int GROUPS = CHUNK / GROUP;    // groups per chunk: one per lane
constexpr int ITEM = 4;                  // live chunks per item, at least
constexpr int BUDGET = 16384;            // items beyond one per tile, at most
constexpr int SLOTS = 2 * BUDGET;        // partial sums: see query_plan
constexpr int BATCH = 4;                 // groups per copy into the buffer
constexpr int WARPS = 4;                 // warps per block (cull, combine)
constexpr int SPLIT = 4;                 // warps sharing one item
constexpr int PLAN = 1024;               // query_plan's threads
constexpr float BIG = 3.0e38f;
constexpr unsigned FULL = 0xffffffffu;
constexpr bool GROUP_CULL = true;        // cull photon groups per tile

static_assert(GROUPS == WARP, "one group box per lane");

__device__ __forceinline__ float sq3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

// Squared gap between the box b (lo xyz, hi xyz) and the box lo..hi of a
// tile, rounded as a pair's d^2.
__device__ __forceinline__ float gap2(const float (&b)[6], const float* lo,
                                      const float* hi) {
  const float gx = fmaxf(fmaxf(__fsub_rn(b[0], hi[0]),
                               __fsub_rn(lo[0], b[3])), 0.f);
  const float gy = fmaxf(fmaxf(__fsub_rn(b[1], hi[1]),
                               __fsub_rn(lo[1], b[4])), 0.f);
  const float gz = fmaxf(fmaxf(__fsub_rn(b[2], hi[2]),
                               __fsub_rn(lo[2], b[5])), 0.f);
  return sq3(gx, gy, gz);
}

// The box planes (6, k) at column c.
__device__ __forceinline__ void box_at(const float* __restrict__ planes,
                                       int k, int c, float (&b)[6]) {
#pragma unroll
  for (int j = 0; j < 6; ++j) b[j] = planes[(size_t)j * k + c];
}

// One tile's points in registers, with the tile's box and largest reach^2
// (warp reductions; a point past n has reach -1 and no part in the box).
struct Tile {
  float px[PTS], py[PTS], pz[PTS], r2[PTS], cap2[PTS];
  float lo[3], hi[3], reach2;
};

__device__ __forceinline__ void load_tile(Tile& T, int t, int n,
                                          const float* __restrict__ pts,
                                          const float* __restrict__ r2_in,
                                          const float* __restrict__ cap2_in) {
  const int lane = threadIdx.x & (WARP - 1);
  float v[7] = {BIG, BIG, BIG, -BIG, -BIG, -BIG, -BIG};
#pragma unroll
  for (int p = 0; p < PTS; ++p) {
    const int i = t * TILE + lane + WARP * p;
    const bool in = i < n;
    T.px[p] = in ? pts[3 * i] : 0.f;
    T.py[p] = in ? pts[3 * i + 1] : 0.f;
    T.pz[p] = in ? pts[3 * i + 2] : 0.f;
    T.r2[p] = in ? r2_in[i] : -1.f;
    T.cap2[p] = in ? cap2_in[i] : -1.f;
    if (in) {
      v[0] = fminf(v[0], T.px[p]); v[1] = fminf(v[1], T.py[p]);
      v[2] = fminf(v[2], T.pz[p]); v[3] = fmaxf(v[3], T.px[p]);
      v[4] = fmaxf(v[4], T.py[p]); v[5] = fmaxf(v[5], T.pz[p]);
      v[6] = fmaxf(v[6], fmaxf(T.r2[p], T.cap2[p]));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < 3; ++k)
      v[k] = fminf(v[k], __shfl_xor_sync(FULL, v[k], off));
#pragma unroll
    for (int k = 3; k < 7; ++k)
      v[k] = fmaxf(v[k], __shfl_xor_sync(FULL, v[k], off));
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    T.lo[k] = v[k];
    T.hi[k] = v[3 + k];
  }
  T.reach2 = v[6];
}

__device__ __forceinline__ int chunks_live(const int* __restrict__ n_live,
                                           int n_chunks) {
  const int live = min(max(*n_live, 0), n_chunks * CHUNK);
  return (live + CHUNK - 1) / CHUNK;
}

// The scratch of one query, in ints (query_work): per tile the live-chunk
// mask (k_words words), its count, its first item and first slot; one past
// the last tile's first item; the item count and ic.
struct Work {
  uint32_t* mask;
  int *count, *item0, *slot0, *meta;
};

__host__ __device__ inline int words_of(int n_chunks) {
  return (n_chunks + 31) / 32;
}

__host__ __device__ inline Work work_at(int* w, int n_tiles, int n_chunks) {
  const size_t m = (size_t)n_tiles * words_of(n_chunks);
  Work k;
  k.mask = reinterpret_cast<uint32_t*>(w);
  k.count = w + m;
  k.item0 = k.count + n_tiles;          // n_tiles + 1 entries
  k.slot0 = k.item0 + n_tiles + 1;
  k.meta = k.slot0 + n_tiles;           // item count, ic
  return k;
}

// ---- query_cull: a warp per tile, 32 chunks per ballot

__global__ void __launch_bounds__(WARP * WARPS) query_cull(
    const float* __restrict__ pts, const float* __restrict__ r2_in,
    const float* __restrict__ cap2_in, int n, int n_tiles,
    const float* __restrict__ cull, int n_chunks,
    const int* __restrict__ n_live, Work wk) {
  const int t = blockIdx.x * WARPS + threadIdx.x / WARP;
  if (t >= n_tiles) return;
  const int lane = threadIdx.x & (WARP - 1);
  Tile T;
  load_tile(T, t, n, pts, r2_in, cap2_in);
  const int k_end = chunks_live(n_live, n_chunks);
  const int k_words = words_of(n_chunks);
  int cnt = 0;
  for (int w = 0; w < k_words; ++w) {
    const int c = w * 32 + lane;
    bool near = false;
    if (c < k_end) {
      float b[6];
      box_at(cull, n_chunks, c, b);
      near = gap2(b, T.lo, T.hi) <= T.reach2;
    }
    const unsigned m = __ballot_sync(FULL, near);
    if (lane == 0) wk.mask[(size_t)t * k_words + w] = m;
    cnt += __popc(m);
  }
  if (lane == 0) wk.count[t] = cnt;
}

// ---- query_plan: one block of PLAN threads

// Inclusive block scan of (a, b) over PLAN threads; returns the block
// totals in ta, tb.
__device__ __forceinline__ int2 block_scan(int a, int b, int2* red,
                                           int& ta, int& tb) {
  const int lane = threadIdx.x & (WARP - 1), warp = threadIdx.x / WARP;
#pragma unroll
  for (int off = 1; off < WARP; off <<= 1) {
    const int xa = __shfl_up_sync(FULL, a, off);
    const int xb = __shfl_up_sync(FULL, b, off);
    if (lane >= off) { a += xa; b += xb; }
  }
  if (lane == WARP - 1) red[warp] = make_int2(a, b);
  __syncthreads();
  int pa = 0, pb = 0;
  ta = tb = 0;
  for (int w = 0; w < PLAN / WARP; ++w) {
    if (w < warp) { pa += red[w].x; pb += red[w].y; }
    ta += red[w].x;
    tb += red[w].y;
  }
  __syncthreads();   // red is free for the next call
  return make_int2(a + pa, b + pb);
}

// T = the live (tile, chunk) pairs; ic = max(ITEM, ceil(T / BUDGET)). A
// tile with c live chunks has max(1, ceil(c / ic)) items, so there are at
// most n_tiles + T / ic <= n_tiles + BUDGET; a tile with more than one
// (c > ic) has fewer than 2 c / ic, so the slots number fewer than 2 T / ic
// <= SLOTS.
__global__ void __launch_bounds__(PLAN) query_plan(int n_tiles, Work wk) {
  __shared__ int2 red[PLAN / WARP];
  __shared__ int s_total;
  int part = 0;
  for (int t = threadIdx.x; t < n_tiles; t += PLAN) part += wk.count[t];
  int ta, tb;
  block_scan(part, 0, red, ta, tb);
  if (threadIdx.x == 0) s_total = ta;
  __syncthreads();
  const int ic = max(ITEM, (s_total + BUDGET - 1) / BUDGET);
  int items = 0, slots = 0;
  for (int base = 0; base < n_tiles; base += PLAN) {
    const int t = base + threadIdx.x;
    const int c = t < n_tiles ? wk.count[t] : 0;
    const int it = t < n_tiles ? max(1, (c + ic - 1) / ic) : 0;
    const int sl = it > 1 ? it : 0;
    const int2 inc = block_scan(it, sl, red, ta, tb);
    if (t < n_tiles) {
      wk.item0[t] = items + inc.x - it;
      wk.slot0[t] = slots + inc.y - sl;
    }
    items += ta;
    slots += tb;
  }
  if (threadIdx.x == 0) {
    wk.item0[n_tiles] = items;
    wk.meta[0] = items;
    wk.meta[1] = ic;
  }
}

// ---- query_items: a warp per item

struct Sums {
  float v[PTS][8];   // flux_r rgb, count_r, flux_cap rgb, count_cap
};

__device__ __forceinline__ float bf_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// Copy photon `lane` of group g into slot q of the buffer: position and
// normal x, y in a float4; normal z and power rgb in a uint2 (bf16 pairs).
__device__ __forceinline__ void copy_photon(
    float4* bpos, uint2* bpay, int q, int g, int p_total,
    const float* __restrict__ posf, const uint16_t* __restrict__ pay) {
  const int lane = threadIdx.x & (WARP - 1);
  const size_t p = (size_t)g * GROUP + lane;
  const uint32_t nx = pay[3 * (size_t)p_total + p];
  const uint32_t ny = pay[4 * (size_t)p_total + p];
  const uint32_t nz = pay[5 * (size_t)p_total + p];
  const uint32_t pr = pay[p], pg = pay[(size_t)p_total + p],
                 pb = pay[2 * (size_t)p_total + p];
  bpos[q * GROUP + lane] =
      make_float4(posf[p], posf[(size_t)p_total + p],
                  posf[2 * (size_t)p_total + p],
                  __uint_as_float(nx | (ny << 16)));
  bpay[q * GROUP + lane] = make_uint2(nz | (pr << 16), pg | (pb << 16));
}

// Fold `cnt` buffered photons into the lane's PTS points.
__device__ __forceinline__ void fold(const float4* bpos, const uint2* bpay,
                                     int cnt, const Tile& T, Sums& S) {
#pragma unroll 2
  for (int q = 0; q < cnt; ++q) {
    const float4 a = bpos[q];
    float d2[PTS];
    bool any = false;
#pragma unroll
    for (int p = 0; p < PTS; ++p) {
      d2[p] = sq3(__fsub_rn(a.x, T.px[p]), __fsub_rn(a.y, T.py[p]),
                  __fsub_rn(a.z, T.pz[p]));
      any |= d2[p] <= T.r2[p] || d2[p] <= T.cap2[p];
    }
    if (!any) continue;
    const uint2 b = bpay[q];
    const uint32_t w = __float_as_uint(a.w);
    const float nx = bf_lo(w), ny = bf_hi(w), nz = bf_lo(b.x);
    const float pr = bf_hi(b.x), pg = bf_lo(b.y), pb = bf_hi(b.y);
#pragma unroll
    for (int p = 0; p < PTS; ++p) {
      const bool in_r = d2[p] <= T.r2[p];
      const bool in_c = d2[p] <= T.cap2[p];
      if (in_r || in_c) {
        const float dx = __fsub_rn(a.x, T.px[p]);
        const float dy = __fsub_rn(a.y, T.py[p]);
        const float dz = __fsub_rn(a.z, T.pz[p]);
        const float nd = nx * dx + ny * dy + nz * dz;
        const float s = 1.f - fabsf(nd) * rsqrtf(fmaxf(d2[p], 1e-20f));
        const float wr = s * pr, wg = s * pg, wb = s * pb;
        if (in_r) {
          S.v[p][0] += wr; S.v[p][1] += wg; S.v[p][2] += wb;
          S.v[p][3] += 1.f;
        }
        if (in_c) {
          S.v[p][4] += wr; S.v[p][5] += wg; S.v[p][6] += wb;
          S.v[p][7] += 1.f;
        }
      }
    }
  }
}

__global__ void __launch_bounds__(WARP * SPLIT) query_items(
    const float* __restrict__ pts, const float* __restrict__ r2_in,
    const float* __restrict__ cap2_in, int n, int n_tiles,
    const float* __restrict__ posf, const uint16_t* __restrict__ pay,
    const float* __restrict__ gcull, int n_chunks, Work wk,
    float* __restrict__ out, float* __restrict__ slots) {
  __shared__ float4 s_pos[SPLIT][BATCH * GROUP];
  __shared__ uint2 s_pay[SPLIT][BATCH * GROUP];
  __shared__ float4 s_sum[SPLIT][TILE][2];
  const int warp = threadIdx.x / WARP, lane = threadIdx.x & (WARP - 1);
  const int item = blockIdx.x;
  if (item >= wk.meta[0]) return;
  const int ic = wk.meta[1];
  // the tile: the last one whose first item is <= item
  int t = 0, hi = n_tiles - 1;
  while (t < hi) {
    const int mid = (t + hi + 1) >> 1;
    if (wk.item0[mid] <= item) t = mid;
    else hi = mid - 1;
  }
  const int k = item - wk.item0[t];
  const int n_items = wk.item0[t + 1] - wk.item0[t];
  const int rank0 = k * ic, rank1 = min(rank0 + ic, wk.count[t]);

  Tile T;
  load_tile(T, t, n, pts, r2_in, cap2_in);
  Sums S;
#pragma unroll
  for (int p = 0; p < PTS; ++p)
#pragma unroll
    for (int j = 0; j < 8; ++j) S.v[p][j] = 0.f;

  const int p_total = n_chunks * CHUNK;
  const int n_groups = n_chunks * GROUPS;
  const int k_words = words_of(n_chunks);
  float4* bpos = s_pos[warp];
  uint2* bpay = s_pay[warp];
  int rank = 0, seen = 0;   // live chunks and live groups passed so far
  for (int w = 0; w < k_words && rank < rank1; ++w) {
    uint32_t m = wk.mask[(size_t)t * k_words + w];
    const int pc = __popc(m);
    if (rank + pc <= rank0) {
      rank += pc;
      continue;
    }
    for (; m != 0 && rank < rank1; m &= m - 1, ++rank) {
      if (rank < rank0) continue;
      const int c = w * 32 + __ffs(m) - 1;
      // the groups of chunk c that some point of the tile can reach; the
      // item's warps take them in turn
      uint32_t live = FULL;
      if (GROUP_CULL) {
        float b[6];
        box_at(gcull, n_groups, c * GROUPS + lane, b);
        live = __ballot_sync(FULL, gap2(b, T.lo, T.hi) <= T.reach2);
      }
      uint32_t gm = 0;
      for (uint32_t x = live; x != 0; x &= x - 1, ++seen)
        if (seen % SPLIT == warp) gm |= x & (0u - x);
      while (gm != 0) {
        __syncwarp();   // every lane is done with the buffer
        int q = 0;
        for (; q < BATCH && gm != 0; ++q, gm &= gm - 1)
          copy_photon(bpos, bpay, q, c * GROUPS + __ffs(gm) - 1, p_total,
                      posf, pay);
        __syncwarp();
        fold(bpos, bpay, q * GROUP, T, S);
      }
    }
  }
  // the warps' sums, added in warp order
#pragma unroll
  for (int p = 0; p < PTS; ++p) {
    const int j = lane + WARP * p;
    s_sum[warp][j][0] = make_float4(S.v[p][0], S.v[p][1], S.v[p][2],
                                    S.v[p][3]);
    s_sum[warp][j][1] = make_float4(S.v[p][4], S.v[p][5], S.v[p][6],
                                    S.v[p][7]);
  }
  __syncthreads();
  float* dst = n_items == 1 ? nullptr
             : slots + (size_t)(wk.slot0[t] + k) * TILE * 8;
  for (int j = threadIdx.x; j < TILE; j += WARP * SPLIT) {
    const int i = t * TILE + j;
    if (i >= n) continue;
    float4 a = s_sum[0][j][0], b = s_sum[0][j][1];
    for (int v = 1; v < SPLIT; ++v) {
      const float4 x = s_sum[v][j][0], y = s_sum[v][j][1];
      a.x += x.x; a.y += x.y; a.z += x.z; a.w += x.w;
      b.x += y.x; b.y += y.y; b.z += y.z; b.w += y.w;
    }
    float4* o = reinterpret_cast<float4*>(dst != nullptr ? dst + 8 * j
                                                         : out + 8 * (size_t)i);
    o[0] = a;
    o[1] = b;
  }
}

// ---- query_combine: the slots of a tile with several items, in item order

__global__ void __launch_bounds__(WARP * WARPS) query_combine(
    int n, int n_tiles, Work wk, const float* __restrict__ slots,
    float* __restrict__ out) {
  const int t = blockIdx.x * WARPS + threadIdx.x / WARP;
  if (t >= n_tiles) return;
  const int items = wk.item0[t + 1] - wk.item0[t];
  if (items == 1) return;
  const int lane = threadIdx.x & (WARP - 1);
  const float4* src = reinterpret_cast<const float4*>(
      slots + (size_t)wk.slot0[t] * TILE * 8);
  for (int p = 0; p < PTS; ++p) {
    const int j = lane + WARP * p;
    const int i = t * TILE + j;
    if (i >= n) continue;
    float4 a = src[2 * j], b = src[2 * j + 1];
    for (int k = 1; k < items; ++k) {
      const float4 x = src[(size_t)k * TILE * 2 + 2 * j];
      const float4 y = src[(size_t)k * TILE * 2 + 2 * j + 1];
      a.x += x.x; a.y += x.y; a.z += x.z; a.w += x.w;
      b.x += y.x; b.y += y.y; b.z += y.z; b.w += y.w;
    }
    float4* o = reinterpret_cast<float4*>(out + 8 * (size_t)i);
    o[0] = a;
    o[1] = b;
  }
}

}  // namespace

// Ints of scratch a query of n points over n_chunks chunks needs (work).
extern "C" int rt_photon_query_work(int n, int n_chunks) {
  const int n_tiles = (n + TILE - 1) / TILE;
  return n_tiles * (words_of(n_chunks) + 3) + 3;
}

// The kernel's shapes: points per tile, slots of partial sums, photons per
// group box, photons per chunk box, live chunks per item at least, items
// beyond one per tile at most.
extern "C" int rt_photon_query_dims(int* dims) {
  dims[0] = TILE;
  dims[1] = SLOTS;
  dims[2] = GROUP;
  dims[3] = CHUNK;
  dims[4] = ITEM;
  dims[5] = BUDGET;
  return 0;
}

// Plain C entry point (loaded with ctypes). Launches on `stream`, does not
// synchronise, allocates nothing; returns cudaGetLastError() of the
// launches. points (n, 3) f32; r2, cap2 (n,) f32; posf (3, n_chunks*CHUNK)
// f32; payload (6, n_chunks*CHUNK) bf16; cull (6, n_chunks) and gcull (6,
// n_chunks*GROUPS) f32 boxes; n_live one int in device memory; out (n, 8)
// f32; work rt_photon_query_work ints; slots (SLOTS, TILE, 8) f32.
extern "C" int rt_photon_query(
    const float* pts, const float* r2, const float* cap2, int n,
    const float* posf, const __nv_bfloat16* payload, const float* cull,
    const float* gcull, int n_chunks, const int* n_live, float* out,
    int* work, float* slots, cudaStream_t stream) {
  if (n <= 0) return 0;
  const int n_tiles = (n + TILE - 1) / TILE;
  const Work wk = work_at(work, n_tiles, n_chunks);
  const int per = WARPS;
  query_cull<<<(n_tiles + per - 1) / per, WARP * WARPS, 0, stream>>>(
      pts, r2, cap2, n, n_tiles, cull, n_chunks, n_live, wk);
  query_plan<<<1, PLAN, 0, stream>>>(n_tiles, wk);
  query_items<<<n_tiles + BUDGET, WARP * SPLIT, 0, stream>>>(
      pts, r2, cap2, n, n_tiles, posf,
      reinterpret_cast<const uint16_t*>(payload), gcull, n_chunks, wk, out,
      slots);
  query_combine<<<(n_tiles + per - 1) / per, WARP * WARPS, 0, stream>>>(
      n, n_tiles, wk, slots, out);
  return (int)cudaGetLastError();
}

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
