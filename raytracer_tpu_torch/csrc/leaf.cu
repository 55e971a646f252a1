// Leaf-culled closest hit for Hopper (sm_90a): a warp of 32 rays walks a
// box hierarchy over the leaves together.
//
// Replaces raytracer_tpu/ops/pallas_bvh.py::_leaf_kernel (reached through
// _call_leaf_kernel / _run / intersect_leaf(_full)), whose plain PyTorch
// twins are raytracer_tpu_torch/ops/leaf.py::leaf_closest_plain (leaves in
// table order) and leaf_walk_plain (this kernel's walk).
//
// Per ray: the dense stages first, through sweep.cuh's flat sweep: the big
// spheres (radius > 20 x the median, e.g. scene_500's ground), then the
// rects, then the triangles; their hits bound t. Then the leaves whose
// box the ray's slab test passes against its running best t, and an exact
// float32 test of their spheres with the direct oc = o - c quadratic. The
// fold keeps the flat sweep's winner: (t, then type, then scene index),
// whatever the order the leaves are visited in.
//
// What bounds it: FP32 work, ~17 flops per sphere of a visited leaf and
// ~12 per box test. What held the first design (one thread per ray, every
// leaf box in table order from global memory, each leaf's spheres through
// __ldg) back on an H100 was latency: each lane made n_leaf dependent box
// loads and slab tests, and its warp then ran the union of its lanes'
// leaves one lane-divergent loop after another.
//
// Design:
//   * the hierarchy (ops/leaf.py::leaf_tree): median splits of the leaf
//     boxes, inner boxes the exact union of their children's, so a ray
//     that passes a leaf's box passes every box above it; nodes in
//     breadth-first order. A block stages the first NODE_STAGE nodes'
//     boxes (the top of the tree, all of scene_500's 63) in shared memory,
//     in the tile the dense sweep used; deeper ones are read through L1;
//   * a warp walks it together: at an inner node every alive lane tests
//     both children with its own best t; the warp descends into the
//     children some lane passes, the one most lanes enter first (by entry
//     t, else by count) first, the other on a stack. A ray tests ~2 log2 L
//     boxes instead of L;
//   * at a leaf, the lanes whose own slab test of the leaf's box passes
//     (the test of the first design, with the best t as it stands) fold
//     its spheres; the warp copies them into its own shared buffer (one
//     sphere and its id per lane) and every lane reads them as a
//     broadcast, four spheres per branch (sweep.cuh::sphere_group);
//   * visits (optional, null = off): the leaves each ray folded.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sweep.cuh"

namespace {

constexpr int BLOCK = 128;
constexpr int WARPS_PER_BLOCK = BLOCK / WARP;
constexpr int NODE_STAGE = 256;          // node boxes staged per block
constexpr int LEAF_SUB = 32;             // leaf spheres per buffer fill
constexpr int STACK = 32;                // ops/leaf.py::STACK
constexpr int WARP_FLOATS = LEAF_SUB * SPH_W + LEAF_SUB;
static_assert(NODE_STAGE * 6 + WARPS_PER_BLOCK * WARP_FLOATS <= TILE_FLOATS,
              "the leaf walk's shared memory outgrows the sweep's tile");
constexpr bool NEAR_FIRST = true;        // order two live children

__global__ void __launch_bounds__(BLOCK) leaf_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ tmin, const float* __restrict__ tmax,
    const uint8_t* __restrict__ alive, int n,
    const float* __restrict__ big, const int* __restrict__ big_orig,
    int n_big, const float* __restrict__ rect, int n_rect,
    const float* __restrict__ tri, int n_tri,
    const float* __restrict__ nbox, const int4* __restrict__ node,
    int n_node, const float* __restrict__ lsph,
    const int* __restrict__ lorig, int leaf,
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
  if (in && w.ty == PRIM_SPHERE) w.ix = big_orig[w.ix];

  // the top of the hierarchy into the tile, which the sweep is done with
  const int n_stage = min(n_node, NODE_STAGE);
  __syncthreads();
  for (int k = threadIdx.x; k < n_stage * 6; k += BLOCK) tile[k] = nbox[k];
  __syncthreads();
  const int lane = threadIdx.x & (WARP - 1);
  float* wbuf = tile + NODE_STAGE * 6 + (threadIdx.x / WARP) * WARP_FLOATS;
  float4* s4 = reinterpret_cast<float4*>(wbuf);
  int* ids = reinterpret_cast<int*>(wbuf + LEAF_SUB * SPH_W);
  auto box = [&](int k) -> const float* {
    return k < NODE_STAGE ? tile + 6 * k : nbox + 6 * k;
  };

  int nv = 0;
  if (n_node > 0 && __any_sync(FULL, live)) {
    const Ray r = clamped(ray);
    const CullRay cu = cull_ray(r);
    const float a = ray_a(r);
    const float inv_a = 1.0f / a;
    const Ray rr[1] = {r};
    const float aa[1] = {a}, ia[1] = {inv_a}, tt[1] = {0.f};
    // this lane's slab test of box k with its best t; tn: its entry t
    auto passes = [&](int k, float& tn) {
      float tf;
      return live && box_span(r, cu, box(k), tn, tf) &&
             tn <= fminf(tf, fminf(w.t, r.tmax));
    };
    auto fold = [&](bool on, float t, int id) {
      if (!on) return;
      if (t < w.t || (t == w.t && w.ty != PRIM_SPHERE && w.ty >= 0)) {
        w = Winner{t, PRIM_SPHERE, id, 0.f, 0.f};
      } else if (t == w.t && w.ty == PRIM_SPHERE && id < w.ix) {
        w.ix = id;
      }
    };
    // leaf l's spheres, in sub-tiles of LEAF_SUB through the warp's buffer
    auto run_leaf = [&](int l, bool on) {
      const float4* src = reinterpret_cast<const float4*>(lsph);
      for (int s = 0; s < leaf; s += LEAF_SUB) {
        const int cnt = min(LEAF_SUB, leaf - s);
        const int base = l * leaf + s;
        __syncwarp();   // every lane is done with the buffer
        if (lane < cnt) {
          s4[lane] = __ldg(src + base + lane);
          ids[lane] = __ldg(lorig + base + lane);
        }
        __syncwarp();
        int j = 0;
        auto f = [&](int, int u, float t) { fold(on, t, ids[j + u]); };
        for (; j + UNROLL <= cnt; j += UNROLL) {
          float4 sv[UNROLL];
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) sv[u] = s4[j + u];
          sphere_group<UNROLL, 1, false>(sv, sv, rr, aa, ia, tt, f);
        }
        for (; j < cnt; ++j) {
          const float4 sv[1] = {s4[j]};
          sphere_group<1, 1, false>(sv, sv, rr, aa, ia, tt, f);
        }
      }
    };

    int stack[STACK];
    int sp = 0, k = 0;
    while (true) {
      const int4 rec = __ldg(node + k);
      bool down = false;
      if (rec.z >= 0) {
        float tn;
        const bool on = passes(k, tn);
        if (__any_sync(FULL, on)) {
          run_leaf(rec.z, on);
          nv += on;
        }
      } else {
        float tn0, tn1;
        const bool h0 = passes(rec.x, tn0), h1 = passes(rec.y, tn1);
        const unsigned b0 = __ballot_sync(FULL, h0);
        const unsigned b1 = __ballot_sync(FULL, h1);
        if (b0 != 0 && b1 != 0) {
          const unsigned both = b0 & b1;
          const bool first1 =
              NEAR_FIRST &&
              (both != 0 ? 2 * __popc(__ballot_sync(FULL, h0 && h1 &&
                                                     tn1 < tn0))
                               > __popc(both)
                         : __popc(b1) > __popc(b0));
          stack[sp++] = first1 ? rec.x : rec.y;
          k = first1 ? rec.y : rec.x;
          down = true;
        } else if ((b0 | b1) != 0) {
          k = b0 != 0 ? rec.x : rec.y;
          down = true;
        }
      }
      if (down) continue;
      if (sp == 0) break;
      k = stack[--sp];
    }
  }
  if (!in) return;
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
// big_orig (n_big,); rect (n_rect, 8); tri (n_tri, 16); nbox (n_node, 6),
// node (n_node, 4) int32 (ops/leaf.py::leaf_tree, at most STACK deep);
// lsph (n_leaf * leaf, 4), lorig (n_leaf * leaf,).
extern "C" int rt_leaf(
    const float* o, const float* d, const float* tmin, const float* tmax,
    const uint8_t* alive, int n,
    const float* big, const int* big_orig, int n_big,
    const float* rect, int n_rect, const float* tri, int n_tri,
    const float* nbox, const int* node, int n_node, const float* lsph,
    const int* lorig, int leaf,
    float* out_t, int* out_ty, int* out_ix, float* out_b1, float* out_b2,
    int* visits, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (!aligned16({node, lsph})) return (int)cudaErrorMisalignedAddress;
  const int grid = (n + BLOCK - 1) / BLOCK;
  leaf_kernel<<<grid, BLOCK, 0, stream>>>(
      o, d, tmin, tmax, alive, n, big, big_orig, n_big, rect, n_rect, tri,
      n_tri, nbox, reinterpret_cast<const int4*>(node), n_node, lsph, lorig,
      leaf, out_t, out_ty, out_ix, out_b1, out_b2, visits);
  return (int)cudaGetLastError();
}

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
