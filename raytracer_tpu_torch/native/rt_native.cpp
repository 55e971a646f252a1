// Host-side BVH build of raytracer_tpu_torch (``ops/bvh.py``): median
// split on the largest-extent axis of the primitive centroids, into the
// flat layout of ``ops/bvh.py::_build_flat_python``. A copy of the
// ``rt_bvh_build`` entry point of the JAX package's native runtime, so
// that the port builds and loads its own library (``native/runtime.py``).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 rt_native.cpp -o librt_native.so

#include <algorithm>
#include <cstring>
#include <vector>

extern "C" {

// ------------------------------------------------------------------ BVH

// Flat-layout contract (shared with the Python fallback):
//   interior: left/right = child node ids, is_leaf = 0
//   leaf:     left = first index into `order`, right = prim count, is_leaf = 1
// Returns the number of nodes written, or -1 on error.
int rt_bvh_build(const float* pmin, const float* pmax, int n,
                 float* node_min, float* node_max,
                 int* left, int* right, int* is_leaf,
                 int* order, int leaf_size) {
  if (n <= 0 || leaf_size < 1) return -1;
  const int max_nodes = 2 * n;  // binary tree with >=1 prim per leaf
  std::vector<float> cx(n), cy(n), cz(n);
  for (int i = 0; i < n; i++) {
    cx[i] = 0.5f * (pmin[3 * i + 0] + pmax[3 * i + 0]);
    cy[i] = 0.5f * (pmin[3 * i + 1] + pmax[3 * i + 1]);
    cz[i] = 0.5f * (pmin[3 * i + 2] + pmax[3 * i + 2]);
  }
  for (int i = 0; i < n; i++) order[i] = i;

  struct Task { int nid, s, e; };
  std::vector<Task> stack;
  stack.reserve(64);
  int n_nodes = 1;
  stack.push_back({0, 0, n});

  while (!stack.empty()) {
    Task t = stack.back();
    stack.pop_back();
    float bmin[3] = {1e30f, 1e30f, 1e30f};
    float bmax[3] = {-1e30f, -1e30f, -1e30f};
    float cmin[3] = {1e30f, 1e30f, 1e30f};
    float cmax[3] = {-1e30f, -1e30f, -1e30f};
    for (int i = t.s; i < t.e; i++) {
      const int p = order[i];
      const float c[3] = {cx[p], cy[p], cz[p]};
      for (int a = 0; a < 3; a++) {
        bmin[a] = std::min(bmin[a], pmin[3 * p + a]);
        bmax[a] = std::max(bmax[a], pmax[3 * p + a]);
        cmin[a] = std::min(cmin[a], c[a]);
        cmax[a] = std::max(cmax[a], c[a]);
      }
    }
    std::memcpy(node_min + 3 * t.nid, bmin, sizeof bmin);
    std::memcpy(node_max + 3 * t.nid, bmax, sizeof bmax);

    const int count = t.e - t.s;
    if (count <= leaf_size) {
      left[t.nid] = t.s;
      right[t.nid] = count;
      is_leaf[t.nid] = 1;
      continue;
    }
    int axis = 0;
    float best_ext = -1.0f;
    for (int a = 0; a < 3; a++) {
      const float ext = cmax[a] - cmin[a];
      if (ext > best_ext) { best_ext = ext; axis = a; }
    }
    const float* cc = axis == 0 ? cx.data() : (axis == 1 ? cy.data() : cz.data());
    int* beg = order + t.s;
    int* mid = beg + count / 2;
    int* end = order + t.e;
    std::nth_element(beg, mid, end,
                     [cc](int a, int b) { return cc[a] < cc[b]; });

    if (n_nodes + 2 > max_nodes) return -1;
    const int l_id = n_nodes++;
    const int r_id = n_nodes++;
    left[t.nid] = l_id;
    right[t.nid] = r_id;
    is_leaf[t.nid] = 0;
    stack.push_back({r_id, t.s + count / 2, t.e});
    stack.push_back({l_id, t.s, t.s + count / 2});
  }
  return n_nodes;
}

}  // extern "C"
