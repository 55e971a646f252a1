// The FMA-rate probe for Hopper (sm_90a): `passes` fused multiply-adds per
// element on four accumulators, a_k = a_k * w + x, out (a0 + a1) + (a2 +
// a3), in float32 (FFMA) or in packed bfloat16 pairs (HFMA2: the bf16 rate
// of the CUDA cores, not of the tensor cores).
//
// Replaces experiments/bf16_rate_bench.py::_kernel (reached through run),
// which measured the TPU's elementwise (VPU) rate in f32 against bf16; its
// plain PyTorch twin is
// raytracer_tpu_torch/experiments/bf16_rate_bench.py::fma_chain_plain.
//
// What bounds it: 12 bytes per float32 element (x, w in, out) against
// 2 * passes flops, so below ~20 flops per byte (passes < ~128 in f32)
// device memory, above it the FMA pipes. Each thread takes 16 bytes of x
// and w (4 floats or 4 bf16 pairs), so it runs 16 independent chains: the
// pipes stay full past the FMA latency. The accumulators' starting values
// are rounded as PyTorch rounds x * s in the tensor's type (the product in
// float32, one rounding), and the sums as PyTorch's adds, so only the FMA
// itself (one rounding where the plain version rounds twice) differs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;
constexpr float S1 = 1.0009765625f, S2 = 1.001953125f, S3 = 1.0029296875f;

template <typename T>
struct Ops;

template <>
struct Ops<float> {
  static __device__ __forceinline__ float fma(float a, float w, float x) {
    return fmaf(a, w, x);
  }
  static __device__ __forceinline__ float add(float a, float b) {
    return __fadd_rn(a, b);
  }
  static __device__ __forceinline__ float scale(float x, float s) {
    return __fmul_rn(x, s);
  }
};

template <>
struct Ops<__nv_bfloat162> {
  using T = __nv_bfloat162;
  static __device__ __forceinline__ T fma(T a, T w, T x) {
    return __hfma2(a, w, x);
  }
  static __device__ __forceinline__ T add(T a, T b) { return __hadd2(a, b); }
  static __device__ __forceinline__ T scale(T x, float s) {
    const float2 f = __bfloat1622float2(x);
    return __floats2bfloat162_rn(f.x * s, f.y * s);
  }
};

// One thread per 16 bytes of x, w and out; n16: their count.
template <typename T>
__global__ void __launch_bounds__(BLOCK) fma_kernel(
    const uint4* __restrict__ x, const uint4* __restrict__ w,
    uint4* __restrict__ out, long long n16, int passes) {
  constexpr int K = sizeof(uint4) / sizeof(T);
  using O = Ops<T>;
  const long long stride = (long long)gridDim.x * BLOCK;
  for (long long i = (long long)blockIdx.x * BLOCK + threadIdx.x; i < n16;
       i += stride) {
    uint4 xv = x[i], wv = w[i], ov;
    const T* xs = reinterpret_cast<const T*>(&xv);
    const T* ws = reinterpret_cast<const T*>(&wv);
    T* os = reinterpret_cast<T*>(&ov);
    T a0[K], a1[K], a2[K], a3[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      a0[k] = xs[k];
      a1[k] = O::scale(xs[k], S1);
      a2[k] = O::scale(xs[k], S2);
      a3[k] = O::scale(xs[k], S3);
    }
#pragma unroll 4
    for (int p = 0; p < passes / 4; ++p) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        a0[k] = O::fma(a0[k], ws[k], xs[k]);
        a1[k] = O::fma(a1[k], ws[k], xs[k]);
        a2[k] = O::fma(a2[k], ws[k], xs[k]);
        a3[k] = O::fma(a3[k], ws[k], xs[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k)
      os[k] = O::add(O::add(a0[k], a1[k]), O::add(a2[k], a3[k]));
    out[i] = ov;
  }
}

template <typename T>
int launch(const void* x, const void* w, void* out, long long n16,
           int passes, cudaStream_t stream) {
  if (n16 <= 0) return 0;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long want = (n16 + BLOCK - 1) / BLOCK;
  const int grid = (int)(want < 32LL * sms ? want : 32LL * sms);
  fma_kernel<T><<<grid, BLOCK, 0, stream>>>(
      static_cast<const uint4*>(x), static_cast<const uint4*>(w),
      static_cast<uint4*>(out), n16, passes);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream`, does not
// synchronise, allocates nothing; returns cudaGetLastError() of the launch.
// x, w, out: n elements of float32 (bf16 = 0) or bfloat16 (bf16 = 1), n a
// multiple of 8, 16-byte aligned; passes a multiple of 4.
extern "C" int rt_fma_rate(const void* x, const void* w, void* out,
                           long long n, int passes, int bf16,
                           cudaStream_t stream) {
  const long long bytes = n * (bf16 ? 2 : 4);
  if (bytes % 16 != 0 || passes % 4 != 0) return (int)cudaErrorInvalidValue;
  return bf16 ? launch<__nv_bfloat162>(x, w, out, bytes / 16, passes, stream)
              : launch<float>(x, w, out, bytes / 16, passes, stream);
}

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
