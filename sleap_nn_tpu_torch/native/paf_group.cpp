// Native host-side PAF grouping: per-edge Hungarian assignment + greedy
// instance assembly, one call per sample.
//
// A copy of sleap_nn_tpu/native/paf_group.cpp (the JAX package's default
// bottom-up grouping); only this comment differs. The same math as the
// scipy path of sleap_nn_tpu_torch/inference/paf_grouping.py
// (match_candidates_dense + assign_connections_to_instances); the two can
// emit instances in a different order, and where scores tie they can
// partition the peaks differently. This file is the default path.
//
// Pure C ABI, loaded with ctypes by sleap_nn_tpu_torch/native/__init__.py,
// which builds it at first use with:
//   g++ -O3 -shared -fPIC -std=c++17 paf_group.cpp -o paf_group-<hash>.so

#include <array>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

constexpr double BIG = 1e9;

// Jonker-Volgonant style O(n^3) rectangular assignment on an n x m cost
// matrix (n <= m), minimizing cost. Returns col index per row in `match`.
// The classic potentials formulation (same optimum scipy returns).
void solve_assignment(const std::vector<double>& a, int n, int m,
                      std::vector<int>& match_out) {
  // 1-indexed potentials algorithm; a is (n x m) row-major.
  std::vector<double> u(n + 1, 0.0), v(m + 1, 0.0);
  std::vector<int> p(m + 1, 0), way(m + 1, 0);
  for (int i = 1; i <= n; ++i) {
    p[0] = i;
    int j0 = 0;
    std::vector<double> minv(m + 1, DBL_MAX);
    std::vector<char> used(m + 1, 0);
    do {
      used[j0] = 1;
      int i0 = p[j0], j1 = -1;
      double delta = DBL_MAX;
      for (int j = 1; j <= m; ++j) {
        if (used[j]) continue;
        double cur = a[(i0 - 1) * m + (j - 1)] - u[i0] - v[j];
        if (cur < minv[j]) { minv[j] = cur; way[j] = j0; }
        if (minv[j] < delta) { delta = minv[j]; j1 = j; }
      }
      for (int j = 0; j <= m; ++j) {
        if (used[j]) { u[p[j]] += delta; v[j] -= delta; }
        else { minv[j] -= delta; }
      }
      j0 = j1;
    } while (p[j0] != 0);
    do { int j1 = way[j0]; p[j0] = p[j1]; j0 = j1; } while (j0);
  }
  match_out.assign(n, -1);
  for (int j = 1; j <= m; ++j)
    if (p[j] > 0) match_out[p[j] - 1] = j - 1;
}

}  // namespace

extern "C" {

// Dense per-sample grouping.
//
//   scores:            (n_edges * k * k) row-major float32; -inf = invalid
//   edge_src/edge_dst: (n_edges) node index per edge
//   sorted_edge_order: (n_edges) processing order (toposorted)
//   out_assign:        (n_nodes * k) int32, instance id per (node, slot);
//                      -1 = unassigned. Ids are compacted [0, n_instances).
//   out_conn_*:        capacity >= n_edges * k each; matched connections.
//   out_n_conns:       number of connections written.
//
// Returns the number of instances (after the min_instance_peaks filter).
int paf_group_sample(const float* scores, int n_edges, int k,
                     const int* edge_src, const int* edge_dst, int n_nodes,
                     const int* sorted_edge_order, float min_line_scores,
                     int min_instance_peaks,
                     int32_t* out_assign, int32_t* out_conn_edge,
                     int32_t* out_conn_src, int32_t* out_conn_dst,
                     float* out_conn_score, int32_t* out_n_conns) {
  // ---- per-edge Hungarian over the valid sub-matrix --------------------
  // connections[e] holds (src_slot, dst_slot, score) triples.
  std::vector<std::vector<std::array<double, 3>>> connections(n_edges);
  std::vector<int> vsrc, vdst;
  std::vector<double> cost;
  std::vector<int> match;
  for (int e = 0; e < n_edges; ++e) {
    const float* s = scores + (size_t)e * k * k;
    vsrc.clear();
    vdst.clear();
    for (int r = 0; r < k; ++r) {
      bool any = false;
      for (int c = 0; c < k; ++c)
        if (std::isfinite(s[r * k + c])) { any = true; break; }
      if (any) vsrc.push_back(r);
    }
    for (int c = 0; c < k; ++c) {
      bool any = false;
      for (int r = 0; r < k; ++r)
        if (std::isfinite(s[r * k + c])) { any = true; break; }
      if (any) vdst.push_back(c);
    }
    if (vsrc.empty() || vdst.empty()) continue;

    // Hungarian needs rows <= cols; transpose when needed.
    const bool flip = vsrc.size() > vdst.size();
    const auto& rows = flip ? vdst : vsrc;
    const auto& cols = flip ? vsrc : vdst;
    const int n = (int)rows.size(), m = (int)cols.size();
    cost.assign((size_t)n * m, BIG);
    for (int r = 0; r < n; ++r)
      for (int c = 0; c < m; ++c) {
        float val = flip ? s[vsrc[c] * k + vdst[r]] : s[vsrc[r] * k + vdst[c]];
        if (std::isfinite(val)) cost[(size_t)r * m + c] = -(double)val;
      }
    solve_assignment(cost, n, m, match);
    for (int r = 0; r < n; ++r) {
      int c = match[r];
      if (c < 0) continue;
      double sc = -cost[(size_t)r * m + c];
      if (sc <= -1e8) continue;  // matched into an invalid (BIG) cell
      if (sc >= (double)min_line_scores) {
        int src_slot = flip ? vsrc[c] : vsrc[r];
        int dst_slot = flip ? vdst[r] : vdst[c];
        connections[e].push_back({(double)src_slot, (double)dst_slot, sc});
      }
    }
  }

  // ---- greedy union into instances (identical case analysis to the
  //      Python assign_connections_to_instances) -------------------------
  std::vector<int32_t> assign((size_t)n_nodes * k, -1);
  int next_inst = 0;
  for (int oi = 0; oi < n_edges; ++oi) {
    int e = sorted_edge_order[oi];
    int src_node = edge_src[e], dst_node = edge_dst[e];
    for (const auto& conn : connections[e]) {
      int src_slot = (int)conn[0], dst_slot = (int)conn[1];
      int32_t& src_a = assign[(size_t)src_node * k + src_slot];
      int32_t& dst_a = assign[(size_t)dst_node * k + dst_slot];
      if (src_a < 0 && dst_a < 0) {
        src_a = dst_a = next_inst++;
      } else if (src_a >= 0 && dst_a < 0) {
        dst_a = src_a;
      } else if (src_a < 0 && dst_a >= 0) {
        src_a = dst_a;
      } else if (src_a != dst_a) {
        int src_inst = src_a, dst_inst = dst_a;
        dst_a = src_inst;  // the contested peak joins src's instance
        // Full merge only when the two instances occupy disjoint node sets.
        std::vector<char> src_nodes(n_nodes, 0), dst_nodes(n_nodes, 0);
        for (int nd = 0; nd < n_nodes; ++nd)
          for (int sl = 0; sl < k; ++sl) {
            int32_t a2 = assign[(size_t)nd * k + sl];
            if (a2 == src_inst) src_nodes[nd] = 1;
            if (a2 == dst_inst) dst_nodes[nd] = 1;
          }
        bool overlap = false;
        for (int nd = 0; nd < n_nodes; ++nd)
          if (src_nodes[nd] && dst_nodes[nd]) { overlap = true; break; }
        if (!overlap) {
          for (auto& a2 : assign)
            if (a2 == dst_inst) a2 = src_inst;
        }
      }
    }
  }

  // ---- min_instance_peaks filter + id compaction -----------------------
  std::vector<int> counts(next_inst, 0);
  for (auto a2 : assign)
    if (a2 >= 0) counts[a2]++;
  std::vector<int> remap(next_inst, -1);
  int n_out = 0;
  for (int i = 0; i < next_inst; ++i)
    if (counts[i] > 0 && counts[i] >= min_instance_peaks) remap[i] = n_out++;
  for (auto& a2 : assign)
    if (a2 >= 0) a2 = remap[a2];

  for (size_t i = 0; i < assign.size(); ++i) out_assign[i] = assign[i];
  int32_t nc = 0;
  for (int e = 0; e < n_edges; ++e)
    for (const auto& conn : connections[e]) {
      out_conn_edge[nc] = e;
      out_conn_src[nc] = (int32_t)conn[0];
      out_conn_dst[nc] = (int32_t)conn[1];
      out_conn_score[nc] = (float)conn[2];
      ++nc;
    }
  *out_n_conns = nc;
  return n_out;
}

}  // extern "C"
