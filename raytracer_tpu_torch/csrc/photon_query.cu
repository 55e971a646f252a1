// Dense dual-radius photon query for Hopper (sm_90a): for each point, the
// flux and count of the photons within r and within the cap radius, each
// photon weighted by s = 1 - |n . delta| / |delta|.
//
// Replaces raytracer_tpu/ops/pallas_photon.py::_query_kernel (reached
// through _call_query / query_photons), whose plain PyTorch twin is
// raytracer_tpu_torch/ops/photon_query.py::query_photons_plain.
//
// What bounds it: FP32 arithmetic on the (point, photon) pairs that survive the
// chunk cull: ~20 flops and one rsqrt per pair in reach, ~10 flops for a
// pair out of reach. Photons are read once per live (tile, chunk) pair
// into shared memory, so device memory traffic is small beside that.
// Live (tile, chunk) pairs in the first iteration of a Cornell render at
// 800x800 points / 500k photons (measured on an H100 by chip_smoke.py):
// global map 18,161 of 2,500 tiles x 742 chunks (7.3 chunks per tile,
// ~4.8e9 pairs tested, 10.3 ms); caustic map 4,661 of 2,500 x 16 (1.9 per
// tile, 0.87 ms).
//
// Design, simple first:
//   * one thread per point; a block is one tile of TILE cell-sorted
//     points. The block reduces its tile's AABB and largest squared reach
//     max(r^2, cap^2) once;
//   * the cull runs in the kernel: for each window of TILE chunks, thread
//     t tests chunk window + t against the tile and writes one flag to
//     shared memory; the block then walks the window's live chunks in
//     order, a branch that is uniform across the block;
//   * n_live (one past the last valid photon) is read from device memory,
//     so the caller needs no host sync; chunks past it are never read;
//   * a live chunk of CHUNK photons is staged in shared memory: positions
//     f32, power and normal bf16, 24 KB; every thread reads the same
//     photon at once (a broadcast);
//   * the 8 sums stay in f32 registers and are written once. The TPU kernel
//     rounds the weight to bf16 for its MXU flux product; here weight and
//     sum are f32, which is more exact;
//   * d^2 is rounded as the plain version rounds it, (dx*dx + dy*dy) +
//     dz*dz with __fmul_rn/__fadd_rn (nvcc would contract to FMAs
//     otherwise), and the cull's gap^2 the same way, so the in-radius
//     tests, and the counts, are bit-equal to the plain version's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 256;
constexpr int CHUNK = 1024;
constexpr float BIG = 3.0e38f;

__device__ __forceinline__ float sq3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

// Block-wide reduction of 7 values (tile lo xyz as min, hi xyz and reach^2
// as max) through warp shuffles and one shared row per warp.
__device__ __forceinline__ void tile_bounds(float v[7], float (*red)[7]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) {
    for (int k = 0; k < 3; ++k)
      v[k] = fminf(v[k], __shfl_xor_sync(0xffffffffu, v[k], off));
    for (int k = 3; k < 7; ++k)
      v[k] = fmaxf(v[k], __shfl_xor_sync(0xffffffffu, v[k], off));
  }
  if (lane == 0)
    for (int k = 0; k < 7; ++k) red[warp][k] = v[k];
  __syncthreads();
  for (int w = 0; w < TILE / 32; ++w) {
    for (int k = 0; k < 3; ++k) v[k] = fminf(v[k], red[w][k]);
    for (int k = 3; k < 7; ++k) v[k] = fmaxf(v[k], red[w][k]);
  }
}

__global__ void __launch_bounds__(TILE) photon_query_kernel(
    const float* __restrict__ pts, const float* __restrict__ r2_in,
    const float* __restrict__ cap2_in, int n,
    const float* __restrict__ posf, const __nv_bfloat16* __restrict__ payload,
    const float* __restrict__ cull, int n_chunks,
    const int* __restrict__ n_live, float* __restrict__ out) {
  __shared__ float s_pos[3][CHUNK];
  __shared__ __nv_bfloat16 s_pay[6][CHUNK];
  __shared__ float s_red[TILE / 32][7];
  __shared__ uint8_t s_live[TILE];

  const int i = blockIdx.x * TILE + threadIdx.x;
  const bool in = i < n;
  float px = 0.f, py = 0.f, pz = 0.f, r2 = 0.f, cap2 = 0.f;
  if (in) {
    px = pts[3 * i]; py = pts[3 * i + 1]; pz = pts[3 * i + 2];
    r2 = r2_in[i]; cap2 = cap2_in[i];
  }
  float b[7] = {in ? px : BIG, in ? py : BIG, in ? pz : BIG,
                in ? px : -BIG, in ? py : -BIG, in ? pz : -BIG,
                in ? fmaxf(r2, cap2) : -BIG};
  tile_bounds(b, s_red);
  const float reach2 = b[6];

  const int p_total = n_chunks * CHUNK;
  const int live_photons = min(max(*n_live, 0), p_total);
  const int k_end = (live_photons + CHUNK - 1) / CHUNK;

  float fr0 = 0.f, fr1 = 0.f, fr2 = 0.f, cr = 0.f;
  float fc0 = 0.f, fc1 = 0.f, fc2 = 0.f, cc = 0.f;

  for (int w0 = 0; w0 < k_end; w0 += TILE) {
    // ---- cull one window of chunks, one chunk per thread
    const int c = w0 + threadIdx.x;
    bool near = false;
    if (c < k_end) {
      const float gx = fmaxf(fmaxf(__fsub_rn(cull[c], b[3]),
                                   __fsub_rn(b[0], cull[3 * n_chunks + c])),
                             0.f);
      const float gy = fmaxf(fmaxf(__fsub_rn(cull[n_chunks + c], b[4]),
                                   __fsub_rn(b[1], cull[4 * n_chunks + c])),
                             0.f);
      const float gz = fmaxf(
          fmaxf(__fsub_rn(cull[2 * n_chunks + c], b[5]),
                __fsub_rn(b[2], cull[5 * n_chunks + c])),
          0.f);
      near = sq3(gx, gy, gz) <= reach2;
    }
    __syncthreads();  // the previous window's flags are no longer read
    s_live[threadIdx.x] = near;
    __syncthreads();

    const int w_end = min(TILE, k_end - w0);
    for (int k = 0; k < w_end; ++k) {
      if (!s_live[k]) continue;  // uniform across the block
      const int base = (w0 + k) * CHUNK;
      __syncthreads();  // the previous chunk is no longer read
      for (int j = threadIdx.x; j < CHUNK; j += TILE) {
        s_pos[0][j] = posf[base + j];
        s_pos[1][j] = posf[p_total + base + j];
        s_pos[2][j] = posf[2 * p_total + base + j];
      }
      for (int j = threadIdx.x; j < CHUNK; j += TILE)
        for (int r = 0; r < 6; ++r)
          s_pay[r][j] = payload[(size_t)r * p_total + base + j];
      __syncthreads();
      if (!in) continue;
      for (int j = 0; j < CHUNK; ++j) {
        const float dx = __fsub_rn(s_pos[0][j], px);
        const float dy = __fsub_rn(s_pos[1][j], py);
        const float dz = __fsub_rn(s_pos[2][j], pz);
        const float d2 = sq3(dx, dy, dz);
        const bool in_r = d2 <= r2;
        const bool in_c = d2 <= cap2;
        if (in_r || in_c) {
          const float nd = __bfloat162float(s_pay[3][j]) * dx
                         + __bfloat162float(s_pay[4][j]) * dy
                         + __bfloat162float(s_pay[5][j]) * dz;
          const float s = 1.f - fabsf(nd) * rsqrtf(fmaxf(d2, 1e-20f));
          const float wr = s * __bfloat162float(s_pay[0][j]);
          const float wg = s * __bfloat162float(s_pay[1][j]);
          const float wb = s * __bfloat162float(s_pay[2][j]);
          if (in_r) { fr0 += wr; fr1 += wg; fr2 += wb; cr += 1.f; }
          if (in_c) { fc0 += wr; fc1 += wg; fc2 += wb; cc += 1.f; }
        }
      }
    }
  }
  if (in) {
    float* o = out + 8 * (size_t)i;
    o[0] = fr0; o[1] = fr1; o[2] = fr2; o[3] = cr;
    o[4] = fc0; o[5] = fc1; o[6] = fc2; o[7] = cc;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream`, does not
// synchronise, allocates nothing; returns cudaGetLastError() of the launch.
// points (n, 3) f32; r2, cap2 (n,) f32; posf (3, n_chunks*CHUNK) f32;
// payload (6, n_chunks*CHUNK) bf16; cull (6, n_chunks) f32; n_live one int
// in device memory; out (n, 8) f32.
extern "C" int rt_photon_query(
    const float* pts, const float* r2, const float* cap2, int n,
    const float* posf, const __nv_bfloat16* payload, const float* cull,
    int n_chunks, const int* n_live, float* out, cudaStream_t stream) {
  if (n <= 0) return 0;
  const int grid = (n + TILE - 1) / TILE;
  photon_query_kernel<<<grid, TILE, 0, stream>>>(
      pts, r2, cap2, n, posf, payload, cull, n_chunks, n_live, out);
  return (int)cudaGetLastError();
}

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
