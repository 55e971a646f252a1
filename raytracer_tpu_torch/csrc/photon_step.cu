// One step of the regenerating photon pass after the bounce, for Hopper
// (sm_90a), one thread per lane: Russian roulette, the deposit and its
// flags, the continuing photon's next ray and renormalised power, and,
// inside the spawn window, the lane's rank among the retiring lanes, the
// budget test and the emission of the next photon into the lanes that
// spawn. The lane state, the deposit slot of this step and the spawn
// counter are updated in place.
//
// Replaces no Pallas kernel: the JAX package's step
// (raytracer_tpu/models/wavefront_soa.py, the photon pass's body) is
// elementwise code that XLA fuses; the eager port spread it over ~70
// small launches a step. Its plain twin is
// raytracer_tpu_torch/models/wavefront_soa.py::PhotonPass._step_plain.
//
// What bounds it: bytes. A lane reads the bounce's rows (inter, next
// origin and direction, attenuation, point, normal: 64 B), its state (o,
// d, w, alive, the two flags, depth: 43 B) and the roulette draw (4 B);
// it writes the deposit (36 B), its two flags (2 B) and its state (43 B);
// a lane that spawns reads its seven emission draws (28 B) and a light
// row. ~220 B a lane a step, ~55 MB a step at 250,880 lanes: ~16 us at
// 3.35 TB/s. The design meets it by reading and writing each byte once,
// coalesced (SoA rows, lane i at thread i), keeping the step's values in
// registers, and ranking the retiring lanes in the same pass: a warp
// ballot and popcount in the block, then a single-pass decoupled
// look-back over the blocks (each block publishes its count, then its
// inclusive prefix, in one word; the blocks take their order from a
// ticket, so every block a block waits on is already running). The last
// block to finish adds the spawned photons to the counter and zeroes the
// tickets and the look-back words for the next launch, so a step is one
// launch and the pass replays under a CUDA graph.
//
// Rounding: the arithmetic follows _step_plain and emit_photons_soa
// operation for operation, every product and sum rounded on its own
// (__fmul_rn, __fadd_rn, __fsub_rn: nvcc would contract them into FMAs),
// the division IEEE (__fdiv_rn), accurate sqrtf/cosf/sinf (no fast
// math), clamps and maxima as PyTorch's CUDA kernels take them (NaN
// kept), and the hemisphere's dot product summed as PyTorch's reduction
// over three rows sums it, left to right. So on the card the kernel's
// deposits, flags, lanes and counter equal the plain twin's bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;
constexpr int WARPS = BLOCK / 32;
constexpr int INTER_DIFFUSE = 0, INTER_ABSORB = 2;
constexpr float TWO_PI = 6.283185307179586f;
// A light row of ops/photon_step.py::emission_table: p0 0-2, p1 3-5, r0
// 6, power (flux * scale) 7-9, 1 for a sphere light 10, the pick's
// cumulative probability 11.
constexpr int LIGHT_W = 12;
constexpr int L_P1 = 3, L_R0 = 6, L_POW = 7, L_SPH = 10, L_CDF = 11;
// A look-back word: the state in the top two bits, a count below.
constexpr uint32_t AGGREGATE = 1u << 30, INCLUSIVE = 2u << 30;
constexpr uint32_t COUNT = (1u << 30) - 1;

// The step's tensors (ops/photon_step.py::step_args): the bounce's
// outputs and the draws are read; the lanes, the deposits, the counter and
// the scratch words are written.
struct Step {
  const int* inter;
  const float* no;
  const float* nd;
  const float* att;
  const float* p;
  const float* nrm;
  const float* U;       // (4, L): row 3 Russian roulette
  const float* E;       // (7, L) emission draws, null outside the window
  float* o;
  float* d;
  float* w;
  uint8_t* alive;
  uint8_t* has_spec;
  uint8_t* has_diff;
  int* depth;
  float* dep;           // (9, S, L): point, power, normal
  uint8_t* flags;       // (2, S, L): valid, caustic
  long long* counter;   // photons spawned
  uint32_t* scratch;    // two tickets, then one look-back word a block
  const float* lights;  // (n_lights, LIGHT_W)
  int n_lights, L, S, step, max_bounces;
  long long B;
};

// PyTorch's clamp(x, min=lo) on the card: NaN stays, else max(x, lo)
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

// PyTorch's max reduction step (max_propagate_nan)
__device__ __forceinline__ float max_nan(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}

__device__ __forceinline__ uint32_t load_word(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int k = 16; k > 0; k >>= 1) v += __shfl_xor_sync(0xffffffffu, v, k);
  return v;
}

// ops/sampling.py::uniform_sphere_from: z = 1 - 2 u1, phi = 2 pi u2
__device__ __forceinline__ void sphere_from(float u1, float u2, float& x,
                                            float& y, float& z) {
  z = __fsub_rn(1.f, __fmul_rn(2.f, u1));
  const float phi = __fmul_rn(TWO_PI, u2);
  const float r = sqrtf(clamp_min(__fsub_rn(1.f, __fmul_rn(z, z)), 0.f));
  x = __fmul_rn(r, cosf(phi));
  y = __fmul_rn(r, sinf(phi));
}

// wavefront_soa.py::emit_photons_soa for lane i from its seven draws:
// origin o3, direction d3, power w3.
__device__ __forceinline__ void emit(const Step& s, int i, float o3[3],
                                     float d3[3], float w3[3]) {
  const int L = s.L;
  const float* __restrict__ E = s.E;
  const float u0 = E[i];
  int idx = 0;  // searchsorted(cdf, u0, right=True) over the sorted cdf
  for (int j = 0; j < s.n_lights; ++j)
    idx += s.lights[j * LIGHT_W + L_CDF] <= u0 ? 1 : 0;
  idx = min(idx, s.n_lights - 1);
  const float* __restrict__ l = s.lights + idx * LIGHT_W;
  const bool is_sph = l[L_SPH] != 0.f;
  float sx, sy, sz;
  sphere_from(E[L + i], E[2 * L + i], sx, sy, sz);
  float nx = 0.f, ny = -1.f, nz = 0.f;
  if (is_sph) {
    const float rr = __fadd_rn(l[L_R0], 1e-4f);
    o3[0] = __fadd_rn(l[0], __fmul_rn(sx, rr));
    o3[1] = __fadd_rn(l[1], __fmul_rn(sy, rr));
    o3[2] = __fadd_rn(l[2], __fmul_rn(sz, rr));
    nx = sx; ny = sy; nz = sz;
  } else {
    o3[0] = __fadd_rn(l[0], __fmul_rn(__fsub_rn(l[L_P1], l[0]),
                                      E[5 * L + i]));
    o3[1] = l[1];
    o3[2] = __fadd_rn(l[2], __fmul_rn(__fsub_rn(l[L_P1 + 2], l[2]),
                                      E[6 * L + i]));
  }
  float hx, hy, hz;
  sphere_from(E[3 * L + i], E[4 * L + i], hx, hy, hz);
  const float dot = __fadd_rn(__fadd_rn(__fmul_rn(hx, nx), __fmul_rn(hy, ny)),
                              __fmul_rn(hz, nz));
  const float flip = dot > 0.f ? 1.f : -1.f;
  d3[0] = __fmul_rn(hx, flip);
  d3[1] = __fmul_rn(hy, flip);
  d3[2] = __fmul_rn(hz, flip);
  const float ws = is_sph ? 1.f : clamp_min(-d3[1], 0.f);
#pragma unroll
  for (int k = 0; k < 3; ++k) w3[k] = __fmul_rn(l[L_POW + k], ws);
}

template <bool SPAWN>
__global__ void __launch_bounds__(BLOCK) photon_step_kernel(const Step s) {
  __shared__ int warp_off[WARPS];
  __shared__ int block_off;
  __shared__ uint32_t vblock;
  __shared__ long long c0;
  __shared__ bool last;
  const int L = s.L, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  uint32_t* const words = s.scratch + 2;

  // the block's place in lane order: from a ticket when blocks rank
  uint32_t b = blockIdx.x;
  if constexpr (SPAWN) {
    if (tid == 0) {
      vblock = atomicAdd(&s.scratch[0], 1u);
      c0 = *s.counter;
    }
    __syncthreads();
    b = vblock;
  }
  const int i = (int)b * BLOCK + tid;
  const bool in = i < L;

  // ---- the lane's step, in _step_plain's order
  bool a = false, cont = false, spec = false, diff = false;
  int depth2 = 0;
  float o3[3], d3[3], w3[3];
  if (in) {
    a = s.alive[i] != 0;
    spec = s.has_spec[i] != 0;
    diff = s.has_diff[i] != 0;
    float at[3], wv[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      at[k] = s.att[k * L + i];
      wv[k] = s.w[k * L + i];
    }
    const float hmax = max_nan(max_nan(at[0], at[1]), at[2]);
    const bool survive = s.U[3 * L + i] <= hmax;
    const int inter = survive ? s.inter[i] : INTER_ABSORB;
    const bool diffuse_now = a && inter == INTER_DIFFUSE;
    const size_t slot = (size_t)s.step * L + i;
    const size_t plane = (size_t)s.S * L;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      s.dep[k * plane + slot] = s.p[k * L + i];
      s.dep[(3 + k) * plane + slot] = wv[k];
      s.dep[(6 + k) * plane + slot] = s.nrm[k * L + i];
    }
    s.flags[slot] = diffuse_now ? 1 : 0;
    s.flags[plane + slot] = (diffuse_now && spec && !diff) ? 1 : 0;

    depth2 = s.depth[i] + 1;
    cont = a && inter != INTER_ABSORB && depth2 < s.max_bounces;
    const float m = clamp_min(hmax, 1e-12f);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float renorm = survive ? __fdiv_rn(at[k], m) : 1.f;
      o3[k] = cont ? s.no[k * L + i] : s.o[k * L + i];
      d3[k] = cont ? s.nd[k * L + i] : s.d[k * L + i];
      w3[k] = cont ? __fmul_rn(wv[k], renorm) : wv[k];
    }
    spec = spec || (cont && !diffuse_now);
    diff = diff || diffuse_now;
  }
  bool alive_next = a && cont;

  if constexpr (SPAWN) {
    // ---- the rank among retiring lanes (torch.cumsum of the retire mask)
    const bool retire = a && !cont;
    const uint32_t ballot = __ballot_sync(0xffffffffu, retire);
    if (lane == 0) warp_off[warp] = __popc(ballot);
    __syncthreads();
    if (warp == 0) {
      const int n = lane < WARPS ? warp_off[lane] : 0;
      int incl = n;  // inclusive scan of the warps' counts
#pragma unroll
      for (int k = 1; k < 32; k <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, incl, k);
        if (lane >= k) incl += up;
      }
      const int agg = __shfl_sync(0xffffffffu, incl, 31);
      if (lane < WARPS) warp_off[lane] = incl - n;
      // the blocks before this one: decoupled look-back
      int excl = 0;
      if (b == 0) {
        if (lane == 0) atomicExch(&words[0], INCLUSIVE | (uint32_t)agg);
      } else {
        if (lane == 0) atomicExch(&words[b], AGGREGATE | (uint32_t)agg);
        int base = (int)b - 1;
        while (true) {
          const int j = base - lane;
          const uint32_t v = j >= 0 ? load_word(&words[j]) : INCLUSIVE;
          if (__any_sync(0xffffffffu, (v & ~COUNT) == 0)) continue;
          const uint32_t inc =
              __ballot_sync(0xffffffffu, (v & ~COUNT) == INCLUSIVE);
          if (inc) {
            const int first = __ffs(inc) - 1;  // the nearest inclusive
            excl += warp_sum(lane <= first ? (int)(v & COUNT) : 0);
            break;
          }
          excl += warp_sum((int)(v & COUNT));
          base -= 32;
        }
        if (lane == 0)
          atomicExch(&words[b], INCLUSIVE | (uint32_t)(excl + agg));
      }
      if (lane == 0) block_off = excl;
    }
    __syncthreads();
    if (retire) {
      const long long rank =
          (long long)block_off + warp_off[warp] +
          __popc(ballot & (0xffffffffu >> (31 - lane)));
      if (c0 + rank <= s.B) {  // spawn
        emit(s, i, o3, d3, w3);
        spec = diff = false;
        depth2 = 0;
        alive_next = true;
      }
    }
  }

  if (in) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      s.o[k * L + i] = o3[k];
      s.d[k * L + i] = d3[k];
      s.w[k * L + i] = w3[k];
    }
    s.alive[i] = alive_next ? 1 : 0;
    s.has_spec[i] = spec ? 1 : 0;
    s.has_diff[i] = diff ? 1 : 0;
    s.depth[i] = depth2;
  }

  if constexpr (SPAWN) {
    // the last block to finish: the counter, then a clean slate
    __syncthreads();
    if (tid == 0) {
      __threadfence();
      last = atomicAdd(&s.scratch[1], 1u) == gridDim.x - 1;
    }
    __syncthreads();
    if (last) {
      __threadfence();
      if (tid == 0) {
        const long long total = load_word(&words[gridDim.x - 1]) & COUNT;
        const long long room = s.B - c0;
        *s.counter = c0 + (total < room ? total : room);
        s.scratch[0] = 0;
        s.scratch[1] = 0;
      }
      for (uint32_t j = tid; j < gridDim.x; j += BLOCK) words[j] = 0;
    }
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream`, does not
// synchronise, allocates nothing; returns cudaGetLastError() of the launch.
// Read: the bounce's inter (L,) int32 and no, nd, att, p, nrm (3, L) f32;
// U (4, L) f32; E (7, L) f32, or null after the spawn window; lights
// (n_lights, 12) f32. In place: o, d, w (3, L) f32; alive, has_spec,
// has_diff (L,) bytes; depth (L,) int32; slot `step` of dep (9, S, L) f32
// and flags (2, S, L) bytes; counter, one int64; scratch (2 + ceil(L /
// 256),) uint32, zero before the launch and left zero after it.
extern "C" int rt_photon_step(
    const int* inter, const float* no, const float* nd, const float* att,
    const float* p, const float* nrm, const float* U, const float* E,
    float* o, float* d, float* w, uint8_t* alive, uint8_t* has_spec,
    uint8_t* has_diff, int* depth, float* dep, uint8_t* flags,
    long long* counter, uint32_t* scratch, const float* lights,
    int n_lights, int L, int S, int step, int max_bounces, long long B,
    cudaStream_t stream) {
  if (L <= 0) return 0;
  const Step s{inter, no, nd, att, p, nrm, U, E, o, d, w, alive, has_spec,
               has_diff, depth, dep, flags, counter, scratch, lights,
               n_lights, L, S, step, max_bounces, B};
  const int blocks = (L + BLOCK - 1) / BLOCK;
  if (E != nullptr)
    photon_step_kernel<true><<<blocks, BLOCK, 0, stream>>>(s);
  else
    photon_step_kernel<false><<<blocks, BLOCK, 0, stream>>>(s);
  return (int)cudaGetLastError();
}

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
