// Host-side graph construction: exact k-NN (brute force and a uniform-grid
// best-first search) and Guillard's node-nested coarsening sweep.
//
// These run in the data pipeline on the CPU, behind a plain C interface
// loaded with ctypes (graphs4cfd_tpu_torch/native/__init__.py builds this
// file with g++ at first use).  They compute what the numpy plain versions
// compute (graphs4cfd_tpu_torch/ops/knn.py:knn_neighbors_plain,
// ops/coarsen.py:guillard_coarsening_plain) to the bit: the squared
// distance is summed one dimension at a time in float64, d += t * t, with
// no fused multiply-add (the build passes -ffp-contract=off and no
// -march), and neighbours come in ascending (distance, index) order.
//
// Build: g++ -O3 -ffp-contract=off -shared -fPIC graph_ops.cpp -o libgraph_ops.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>
#include <vector>

extern "C" {

// Exact k-NN: for each query row, the k nearest rows of x (L2), ordered by
// ascending distance with ties broken by index.  exclude_self assumes
// queries == x and skips the identical index.
void knn_neighbors(const double* x, int64_t n, const double* q, int64_t m,
                   int64_t dim, int64_t k, int32_t exclude_self,
                   int32_t* out /* [m*k] */) {
  std::vector<std::pair<double, int64_t>> heap;  // max-heap of size k
  for (int64_t i = 0; i < m; ++i) {
    heap.clear();
    const double* qi = q + i * dim;
    for (int64_t j = 0; j < n; ++j) {
      if (exclude_self && j == i) continue;
      const double* xj = x + j * dim;
      double d = 0.0;
      for (int64_t d_ = 0; d_ < dim; ++d_) {
        double t = qi[d_] - xj[d_];
        d += t * t;
      }
      if ((int64_t)heap.size() < k) {
        heap.emplace_back(d, j);
        std::push_heap(heap.begin(), heap.end());
      } else if (d < heap.front().first ||
                 (d == heap.front().first && j < heap.front().second)) {
        std::pop_heap(heap.begin(), heap.end());
        heap.back() = {d, j};
        std::push_heap(heap.begin(), heap.end());
      }
    }
    std::sort_heap(heap.begin(), heap.end());
    for (int64_t t = 0; t < k; ++t) out[i * k + t] = (int32_t)heap[t].second;
  }
}

// Exact grid-accelerated k-NN via best-first cell search.
// Points are bucketed into a uniform grid (counting sort); per query, cells
// are visited in order of increasing lower-bound distance (query point to
// cell AABB) using a small binary heap, scanning points until the k-th
// nearest distance is below the next cell's bound.  Exact for any point
// distribution (clustered, collinear, degenerate extents) and O(N·k)
// expected for quasi-uniform sets — replaces the reference pipeline's
// per-epoch brute-force knn_graph cost (SURVEY §3.5).  Supports up to 4-D
// coordinates (periodic axes lift to (cos,sin) pairs upstream).
void knn_neighbors_grid(const double* x, int64_t n, const double* q,
                        int64_t m, int64_t dim, int64_t k,
                        int32_t exclude_self, int32_t* out /* [m*k] */) {
  // ---- bounding box + cell size ------------------------------------------
  double lo[4], hi[4];
  for (int64_t d = 0; d < dim; ++d) { lo[d] = x[d]; hi[d] = x[d]; }
  for (int64_t i = 1; i < n; ++i)
    for (int64_t d = 0; d < dim; ++d) {
      double v = x[i * dim + d];
      if (v < lo[d]) lo[d] = v;
      if (v > hi[d]) hi[d] = v;
    }
  double vol = 1.0;
  for (int64_t d = 0; d < dim; ++d) vol *= (hi[d] - lo[d]) + 1e-12;
  double h = std::pow(vol * 2.0 / (double)n, 1.0 / (double)dim);
  if (!(h > 0)) h = 1.0;
  int64_t nc[4], stride[4], total = 1;
  for (int64_t d = 0; d < dim; ++d) {
    nc[d] = std::max<int64_t>(1, (int64_t)((hi[d] - lo[d]) / h) + 1);
    nc[d] = std::min<int64_t>(nc[d], 1 << 10);
  }
  for (int64_t d = 0; d < dim; ++d) { stride[d] = total; total *= nc[d]; }
  double cw[4];
  for (int64_t d = 0; d < dim; ++d) cw[d] = (hi[d] - lo[d] + 1e-12) / nc[d];
  auto cell_of = [&](const double* p, int64_t* c) {
    for (int64_t d = 0; d < dim; ++d) {
      int64_t v = (int64_t)((p[d] - lo[d]) / cw[d]);
      c[d] = std::min(std::max<int64_t>(v, 0), nc[d] - 1);
    }
  };
  // ---- counting-sort points into cells -----------------------------------
  std::vector<int64_t> cell_id(n), count(total + 1, 0);
  for (int64_t i = 0; i < n; ++i) {
    int64_t c[4], id = 0;
    cell_of(x + i * dim, c);
    for (int64_t d = 0; d < dim; ++d) id += c[d] * stride[d];
    cell_id[i] = id;
    count[id + 1]++;
  }
  for (int64_t i = 0; i < total; ++i) count[i + 1] += count[i];
  std::vector<int32_t> order(n);
  {
    std::vector<int64_t> cursor(count.begin(), count.end() - 1);
    for (int64_t i = 0; i < n; ++i) order[cursor[cell_id[i]]++] = (int32_t)i;
  }
  // ---- per-query best-first search ---------------------------------------
  std::vector<int64_t> stamp(total, -1);
  std::vector<std::pair<double, int64_t>> knn_heap;   // max-heap of (d2, j)
  std::vector<std::pair<double, int64_t>> cell_heap;  // min-heap of (lb, id)
  auto cell_lb = [&](const double* qp, int64_t id) {
    double lb = 0.0;
    for (int64_t d = 0; d < dim; ++d) {
      int64_t c = (id / stride[d]) % nc[d];
      double clo = lo[d] + c * cw[d], chi = clo + cw[d];
      double t = (qp[d] < clo) ? clo - qp[d] : (qp[d] > chi ? qp[d] - chi : 0.0);
      lb += t * t;
    }
    return lb;
  };
  auto cmp = [](const std::pair<double, int64_t>& a,
                const std::pair<double, int64_t>& b) { return a.first > b.first; };
  for (int64_t qi = 0; qi < m; ++qi) {
    const double* qp = q + qi * dim;
    int64_t qc[4];
    cell_of(qp, qc);
    int64_t qid = 0;
    for (int64_t d = 0; d < dim; ++d) qid += qc[d] * stride[d];
    knn_heap.clear();
    cell_heap.clear();
    cell_heap.emplace_back(0.0, qid);
    stamp[qid] = qi;
    while (!cell_heap.empty()) {
      std::pop_heap(cell_heap.begin(), cell_heap.end(), cmp);
      auto [lb, id] = cell_heap.back();
      cell_heap.pop_back();
      if ((int64_t)knn_heap.size() == k && lb > knn_heap.front().first) break;
      // scan points in this cell
      for (int64_t s = count[id]; s < count[id + 1]; ++s) {
        int64_t j = order[s];
        if (exclude_self && j == qi) continue;
        double d2 = 0.0;
        for (int64_t d = 0; d < dim; ++d) {
          double t = qp[d] - x[j * dim + d];
          d2 += t * t;
        }
        if ((int64_t)knn_heap.size() < k) {
          knn_heap.emplace_back(d2, j);
          std::push_heap(knn_heap.begin(), knn_heap.end());
        } else if (d2 < knn_heap.front().first ||
                   (d2 == knn_heap.front().first && j < knn_heap.front().second)) {
          std::pop_heap(knn_heap.begin(), knn_heap.end());
          knn_heap.back() = {d2, j};
          std::push_heap(knn_heap.begin(), knn_heap.end());
        }
      }
      // push face-neighbour cells
      for (int64_t d = 0; d < dim; ++d) {
        int64_t c = (id / stride[d]) % nc[d];
        for (int64_t s2 = -1; s2 <= 1; s2 += 2) {
          int64_t c2 = c + s2;
          if (c2 < 0 || c2 >= nc[d]) continue;
          int64_t id2 = id + s2 * stride[d];
          if (stamp[id2] == qi) continue;
          stamp[id2] = qi;
          cell_heap.emplace_back(cell_lb(qp, id2), id2);
          std::push_heap(cell_heap.begin(), cell_heap.end(), cmp);
        }
      }
    }
    std::sort_heap(knn_heap.begin(), knn_heap.end());
    for (int64_t t = 0; t < k; ++t) out[qi * k + t] = (int32_t)knn_heap[t].second;
  }
}

// Guillard node-nested coarsening: greedy sweep in node order; every node
// still marked coarse removes its k senders from the coarse set.
void guillard_coarsening(const int32_t* senders /* [num_nodes*k] */,
                         int64_t num_nodes, int64_t k,
                         uint8_t* coarse /* [num_nodes] */) {
  for (int64_t v = 0; v < num_nodes; ++v) coarse[v] = 1;
  for (int64_t v = 0; v < num_nodes; ++v) {
    if (coarse[v]) {
      for (int64_t j = 0; j < k; ++j) coarse[senders[v * k + j]] = 0;
    }
  }
}

}  // extern "C"
