// Host C++ of mapmerge_torch: the merge-graph solve and the LZF decoder.
//
// The port's own copy of mapmerge_tpu/native/mapmerge_native.cpp, the JAX
// package's g++ library, with the same two C functions and the same
// arithmetic, so that both packages give the same bits on one host:
//
//  - merge_graph_solve (replaces mapmerge_tpu/native/mapmerge_native.cpp:
//    136-254): union-find components over the edges at or above the
//    confidence threshold, a Kruskal maximum spanning tree of the largest
//    component (float32 confidences, std::stable_sort on descending
//    confidence), the tree centre by leaf-BFS eccentricity, and the global
//    transforms chained over the tree in double (mat4_mul) with
//    Gauss-Jordan inverses in double (invert4: partial pivoting, a pivot
//    below 1e-12 leaves the map beyond that edge unregistered). The
//    contract is the reference's graph machinery (map_merge_3d/src/
//    graph.cpp, map_merging.cpp:137-186); graph/merge_graph.py's
//    compute_global_transforms_plain is its plain Python version.
//  - lzf_decompress (replaces mapmerge_native.cpp:101-127): liblzf's format,
//    the payload of PCD binary_compressed files; io/pcd.py's
//    _lzf_decompress is its plain Python version.
//
// Host code, not a kernel: built by kernels/build.py at first use with
// g++ -O3 -shared -fPIC -std=c++17, the JAX package's flags (no fast-math,
// no -march), so the two libraries built on one host give the same bits;
// bound with ctypes by native/__init__.py.

#include <cmath>
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <queue>
#include <vector>

namespace {

struct DisjointSets {
  std::vector<int> parent, rank_, size;
  explicit DisjointSets(int n) : parent(n), rank_(n, 0), size(n, 1) {
    for (int i = 0; i < n; ++i) parent[i] = i;
  }
  int find(int e) {
    int root = e;
    while (root != parent[root]) root = parent[root];
    while (e != parent[e]) {
      int next = parent[e];
      parent[e] = root;
      e = next;
    }
    return root;
  }
  int merge(int a, int b) {
    if (rank_[a] < rank_[b]) {
      parent[a] = b;
      size[b] += size[a];
      return b;
    }
    if (rank_[b] < rank_[a]) {
      parent[b] = a;
      size[a] += size[b];
      return a;
    }
    parent[a] = b;
    rank_[b]++;
    size[b] += size[a];
    return b;
  }
};

// General 4x4 inverse by Gauss-Jordan with partial pivoting (the reference
// uses Eigen's general inverse on possibly non-rigid estimates).
bool invert4(const float* m, float* out) {
  double a[4][8];
  for (int r = 0; r < 4; ++r) {
    for (int c = 0; c < 4; ++c) a[r][c] = m[r * 4 + c];
    for (int c = 0; c < 4; ++c) a[r][4 + c] = (r == c) ? 1.0 : 0.0;
  }
  for (int col = 0; col < 4; ++col) {
    int piv = col;
    for (int r = col + 1; r < 4; ++r)
      if (std::abs(a[r][col]) > std::abs(a[piv][col])) piv = r;
    if (std::abs(a[piv][col]) < 1e-12) return false;
    if (piv != col)
      for (int c = 0; c < 8; ++c) std::swap(a[piv][c], a[col][c]);
    double d = a[col][col];
    for (int c = 0; c < 8; ++c) a[col][c] /= d;
    for (int r = 0; r < 4; ++r) {
      if (r == col) continue;
      double f = a[r][col];
      for (int c = 0; c < 8; ++c) a[r][c] -= f * a[col][c];
    }
  }
  for (int r = 0; r < 4; ++r)
    for (int c = 0; c < 4; ++c) out[r * 4 + c] = float(a[r][4 + c]);
  return true;
}

void mat4_mul(const float* a, const float* b, float* out) {
  for (int r = 0; r < 4; ++r)
    for (int c = 0; c < 4; ++c) {
      double acc = 0.0;
      for (int k = 0; k < 4; ++k) acc += double(a[r * 4 + k]) * b[k * 4 + c];
      out[r * 4 + c] = float(acc);
    }
}

}  // namespace

extern "C" {

// liblzf decompression (PCL binary_compressed payload format).
// Returns decompressed size, or -1 on malformed input / overflow.
int lzf_decompress(const uint8_t* in, int in_len, uint8_t* out, int out_cap) {
  int i = 0, o = 0;
  while (i < in_len) {
    unsigned ctrl = in[i++];
    if (ctrl < 32) {
      int len = int(ctrl) + 1;
      if (i + len > in_len || o + len > out_cap) return -1;
      std::memcpy(out + o, in + i, size_t(len));
      i += len;
      o += len;
    } else {
      int len = int(ctrl >> 5);
      if (len == 7) {
        if (i >= in_len) return -1;
        len += in[i++];
      }
      if (i >= in_len) return -1;
      int ref = o - int((ctrl & 0x1f) << 8) - int(in[i++]) - 1;
      len += 2;
      if (ref < 0 || o + len > out_cap) return -1;
      for (int k = 0; k < len; ++k) {
        out[o] = out[ref];
        ++o;
        ++ref;
      }
    }
  }
  return o;
}

// Global-consistency solve. Inputs: n_edges pairwise estimates
// (src[i], tgt[i], conf[i], transforms[i*16..] row-major, T: src->tgt
// frame). Output: out[n_nodes*16] global map->reference transforms (zeros
// = unregistered). Returns n_nodes (0 if no edges), or -1 if out_cap_nodes
// is too small.
int merge_graph_solve(const int32_t* src, const int32_t* tgt,
                      const float* conf, const float* transforms,
                      int n_edges, float conf_threshold, float* out,
                      int out_cap_nodes) {
  int n_nodes = 0;
  for (int e = 0; e < n_edges; ++e)
    n_nodes = std::max({n_nodes, src[e] + 1, tgt[e] + 1});
  if (n_nodes == 0) return 0;
  if (n_nodes > out_cap_nodes) return -1;
  std::memset(out, 0, size_t(n_nodes) * 16 * sizeof(float));

  // largest connected component over confidence-thresholded edges
  DisjointSets comps(n_nodes);
  for (int e = 0; e < n_edges; ++e) {
    if (conf[e] < conf_threshold) continue;
    int a = comps.find(src[e]), b = comps.find(tgt[e]);
    if (a != b) comps.merge(a, b);
  }
  int max_comp = 0, best_size = -1;
  for (int i = 0; i < n_nodes; ++i) {
    if (comps.find(i) == i && comps.size[i] > best_size) {
      best_size = comps.size[i];
      max_comp = i;
    }
  }
  std::vector<int> component;  // edge indices whose source is in component
  for (int e = 0; e < n_edges; ++e)
    if (comps.find(src[e]) == max_comp) component.push_back(e);
  if (component.empty()) return n_nodes;
  // the spanning-tree/center universe is bounded by the component edges
  // (mirrors number_of_nodes(component) in graph/merge_graph.py — nodes
  // outside it must not become center candidates)
  int comp_n = 0;
  for (int e : component)
    comp_n = std::max({comp_n, src[e] + 1, tgt[e] + 1});

  // Kruskal maximum spanning tree (descending confidence, stable order)
  std::vector<int> order(component);
  std::stable_sort(order.begin(), order.end(),
                   [&](int a, int b) { return conf[a] > conf[b]; });
  DisjointSets mst(n_nodes);
  std::vector<std::vector<int>> adj(n_nodes);  // neighbor node ids
  std::vector<int> degree(n_nodes, 0);
  for (int e : order) {
    int a = mst.find(src[e]), b = mst.find(tgt[e]);
    if (a != b) {
      mst.merge(a, b);
      adj[src[e]].push_back(tgt[e]);
      adj[tgt[e]].push_back(src[e]);
      degree[src[e]]++;
      degree[tgt[e]]++;
    }
  }

  // tree centers: min over nodes of (max BFS distance from any leaf)
  std::vector<int> max_dist(n_nodes, 0);
  for (int leaf = 0; leaf < comp_n; ++leaf) {
    if (degree[leaf] != 1) continue;
    std::vector<int> dist(n_nodes, 0);
    std::vector<char> seen(n_nodes, 0);
    std::queue<int> q;
    q.push(leaf);
    seen[leaf] = 1;
    while (!q.empty()) {
      int u = q.front();
      q.pop();
      for (int v : adj[u])
        if (!seen[v]) {
          seen[v] = 1;
          dist[v] = dist[u] + 1;
          q.push(v);
        }
    }
    for (int i = 0; i < n_nodes; ++i)
      max_dist[i] = std::max(max_dist[i], dist[i]);
  }
  int reference = 0, best = INT32_MAX;
  for (int i = 0; i < comp_n; ++i)
    if (max_dist[i] < best) {
      best = max_dist[i];
      reference = i;
    }

  // BFS chaining: global[to] = global[from] * T(from->to)
  auto edge_transform = [&](int from, int to, float* t) -> bool {
    for (int e : component) {
      if (src[e] == from && tgt[e] == to)
        return invert4(transforms + size_t(e) * 16, t);
      if (src[e] == to && tgt[e] == from) {
        std::memcpy(t, transforms + size_t(e) * 16, 16 * sizeof(float));
        return true;
      }
    }
    return false;
  };

  for (int c = 0; c < 4; ++c) out[size_t(reference) * 16 + c * 4 + c] = 1.0f;
  std::vector<char> seen(n_nodes, 0);
  seen[reference] = 1;
  std::queue<int> q;
  q.push(reference);
  while (!q.empty()) {
    int u = q.front();
    q.pop();
    for (int v : adj[u]) {
      if (seen[v]) continue;
      seen[v] = 1;
      float t[16], g[16];
      if (edge_transform(u, v, t)) {
        mat4_mul(out + size_t(u) * 16, t, g);
        std::memcpy(out + size_t(v) * 16, g, sizeof(g));
      }
      q.push(v);
    }
  }
  return n_nodes;
}

}  // extern "C"
