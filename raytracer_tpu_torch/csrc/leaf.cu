// Leaf-culled closest hit for Hopper (sm_90a): one thread per ray.
//
// Replaces raytracer_tpu/ops/pallas_bvh.py::_leaf_kernel (reached through
// _call_leaf_kernel / _run / intersect_leaf(_full)), whose plain PyTorch
// twin is raytracer_tpu_torch/ops/leaf.py::leaf_closest_plain.
//
// Per ray: the dense stages first, through sweep.cuh's flat sweep: the big
// spheres (radius > 20 x the median, e.g. scene_500's ground), then the
// rects, then the triangles; their hits bound t. Then every leaf box in
// table order, slab-tested against the running best t (a leaf is culled
// when its entry t exceeds it), and an exact float32 test of the spheres of
// each leaf that passes, with the direct oc = o - c quadratic. The fold
// keeps the flat sweep's winner: (t, then type, then scene index).
//
// The TPU kernel gathers each lane's next K leaves with one-hot bf16
// matmuls, re-derives the winner in f32 and rescues rejected candidates;
// none of that is needed here. The leaves are read per ray from global
// memory (through L1), not staged per block: after the dense stages the
// rays of a block diverge, each on its own leaves. No barrier follows the
// dense sweep, so each thread walks on its own.
//
// What bounds it: FP32 work, but only ~17 flops per sphere of a visited
// leaf plus ~20 per leaf box; at scene_500 (1 big sphere, 32 leaves of 32)
// a camera ray tests its few leaves instead of all 1005 spheres. The
// divergence of the per-ray leaf loop is the cost the flat sweep does not
// pay. visits (optional, null = off): the leaves each ray tested.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sweep.cuh"

namespace {

constexpr int BLOCK = 128;

__global__ void __launch_bounds__(BLOCK) leaf_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ tmin, const float* __restrict__ tmax,
    const uint8_t* __restrict__ alive, int n,
    const float* __restrict__ big, const int* __restrict__ big_orig,
    int n_big, const float* __restrict__ rect, int n_rect,
    const float* __restrict__ tri, int n_tri,
    const float* __restrict__ box, const float* __restrict__ lsph,
    const int* __restrict__ lorig, int n_leaf, int leaf,
    float* __restrict__ out_t, int* __restrict__ out_ty,
    int* __restrict__ out_ix, float* __restrict__ out_b1,
    float* __restrict__ out_b2, int* __restrict__ visits) {
  __shared__ __align__(16) float tile[TILE_FLOATS];
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  const bool in = i < n;
  const bool live = in && alive[i] != 0;
  Ray ray{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, BIG};
  if (in) {
    ray = Ray{o[i], o[n + i], o[2 * n + i], d[i], d[n + i], d[2 * n + i],
              tmin[i], tmax[i]};
  }
  Winner w = sweep<BLOCK>(tile, live, ray, big, n_big, rect, n_rect, tri,
                          n_tri);
  if (!in) return;
  if (w.ty == PRIM_SPHERE) w.ix = big_orig[w.ix];
  int nv = 0;
  if (live) {
    const Ray r = clamped(ray);
    const CullRay cu = cull_ray(r);
    const float a = r.dx * r.dx + r.dy * r.dy + r.dz * r.dz;
    const float inv_a = 1.0f / a;
    const float4* s4 = reinterpret_cast<const float4*>(lsph);
    for (int l = 0; l < n_leaf; ++l) {
      if (!slab(r, cu, box + 6 * l, w.t)) continue;
      ++nv;
      for (int j = l * leaf; j < (l + 1) * leaf; ++j) {
        const float t = sphere_t(r, a, inv_a, __ldg(s4 + j));
        if (t < w.t || (t == w.t && w.ty != PRIM_SPHERE && w.ty >= 0)) {
          w = Winner{t, PRIM_SPHERE, __ldg(lorig + j), 0.f, 0.f};
        } else if (t == w.t && w.ty == PRIM_SPHERE) {
          const int id = __ldg(lorig + j);
          if (id < w.ix) w.ix = id;
        }
      }
    }
  }
  const bool hit = w.ty >= 0;
  out_t[i] = hit ? w.t : INFINITY;
  out_ty[i] = w.ty;
  out_ix[i] = hit ? w.ix : -1;
  out_b1[i] = w.b1;
  out_b2[i] = w.b2;
  if (visits != nullptr) visits[i] = nv;
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream`, does not
// synchronise, allocates nothing; returns cudaGetLastError() of the launch.
// o, d (3, n) f32; tmin, tmax (n,) f32; alive (n,) bool; big (n_big, 4),
// big_orig (n_big,); rect (n_rect, 8); tri (n_tri, 16); box (n_leaf, 6);
// lsph (n_leaf * leaf, 4), lorig (n_leaf * leaf,).
extern "C" int rt_leaf(
    const float* o, const float* d, const float* tmin, const float* tmax,
    const uint8_t* alive, int n,
    const float* big, const int* big_orig, int n_big,
    const float* rect, int n_rect, const float* tri, int n_tri,
    const float* box, const float* lsph, const int* lorig, int n_leaf,
    int leaf,
    float* out_t, int* out_ty, int* out_ix, float* out_b1, float* out_b2,
    int* visits, cudaStream_t stream) {
  if (n <= 0) return 0;
  const int grid = (n + BLOCK - 1) / BLOCK;
  leaf_kernel<<<grid, BLOCK, 0, stream>>>(
      o, d, tmin, tmax, alive, n, big, big_orig, n_big, rect, n_rect, tri,
      n_tri, box, lsph, lorig, n_leaf, leaf, out_t, out_ty, out_ix, out_b1,
      out_b2, visits);
  return (int)cudaGetLastError();
}

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
