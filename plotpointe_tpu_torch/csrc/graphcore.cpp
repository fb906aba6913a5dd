// graphcore — the host-side graph and data runtime of plotpointe_tpu_torch.
//
// Counterpart of native/graphcore.cpp of the JAX package, with the same C ABI
// (ppt_abi_version() == 1): O(E) counting-sort CSR construction,
// chronological leave-last-2 split assignment and the padded positive table,
// the preprocessing between the interaction tables and the device tensors.
// Plain C entry points for ctypes. Host code: g++ builds it at first use
// (plotpointe_tpu_torch/native.py) into build/plotpointe_tpu_torch/.
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

extern "C" {

// Sort E directed edges by (dst, src) with a two-pass counting sort, write
// int32 outputs padded to e_pad with sentinel n_nodes, and fill the CSR
// row_ptr over destinations (length n_nodes + 2; last row = padding segment).
// out_src/out_dst: length e_pad; out_w: length e_pad; out_row_ptr: n_nodes+2.
void ppt_build_csr(const int64_t* src, const int64_t* dst, const float* w,
                   int64_t e, int64_t n_nodes, int64_t e_pad,
                   int32_t* out_src, int32_t* out_dst, float* out_w,
                   int32_t* out_row_ptr) {
  // pass 1: stable counting sort by src (secondary key)
  std::vector<int64_t> count(static_cast<size_t>(n_nodes) + 2, 0);
  for (int64_t i = 0; i < e; ++i) count[src[i] + 1]++;
  for (int64_t v = 0; v <= n_nodes; ++v) count[v + 1] += count[v];
  std::vector<int64_t> order1(e);
  {
    std::vector<int64_t> cursor(count.begin(), count.end() - 1);
    for (int64_t i = 0; i < e; ++i) order1[cursor[src[i]]++] = i;
  }
  // pass 2: stable counting sort by dst (primary key) over pass-1 order
  std::fill(count.begin(), count.end(), 0);
  for (int64_t i = 0; i < e; ++i) count[dst[i] + 1]++;
  for (int64_t v = 0; v <= n_nodes; ++v) count[v + 1] += count[v];
  std::vector<int64_t> cursor(count.begin(), count.end() - 1);
  for (int64_t k = 0; k < e; ++k) {
    const int64_t i = order1[k];
    const int64_t pos = cursor[dst[i]]++;
    out_src[pos] = static_cast<int32_t>(src[i]);
    out_dst[pos] = static_cast<int32_t>(dst[i]);
    out_w[pos] = w ? w[i] : 1.0f;
  }
  for (int64_t p = e; p < e_pad; ++p) {
    out_src[p] = static_cast<int32_t>(n_nodes);
    out_dst[p] = static_cast<int32_t>(n_nodes);
    out_w[p] = 0.0f;
  }
  // row_ptr over dst (real edges), sentinel row ends at e_pad
  out_row_ptr[0] = 0;
  for (int64_t v = 0; v <= n_nodes; ++v)
    out_row_ptr[v + 1] = static_cast<int32_t>(count[v + 1]);
  out_row_ptr[n_nodes + 1] = static_cast<int32_t>(e_pad);
}

// Chronological leave-last-2 split roles per interaction row.
// Inputs: user index u[i] in [0, n_users), timestamp ts[i]. Output role[i]:
// 0 = train, 1 = val, 2 = test, 3 = dropped (user has < 2 interactions).
// Per-user order is by (ts, original position) — the stable-sort semantics of
// the reference's sort_values+groupby (train_gat_custom.py:141-163).
void ppt_leave_last2(const int32_t* u, const int64_t* ts, int64_t n,
                     int32_t n_users, int8_t* role) {
  std::vector<int64_t> count(static_cast<size_t>(n_users) + 1, 0);
  for (int64_t i = 0; i < n; ++i) count[u[i] + 1]++;
  for (int32_t v = 0; v < n_users; ++v) count[v + 1] += count[v];
  // bucket rows per user (stable), then sort each bucket by (ts, pos)
  std::vector<int64_t> rows(n);
  {
    std::vector<int64_t> cursor(count.begin(), count.end() - 1);
    for (int64_t i = 0; i < n; ++i) rows[cursor[u[i]]++] = i;
  }
  for (int32_t v = 0; v < n_users; ++v) {
    int64_t lo = count[v], hi = count[v + 1];
    const int64_t cnt = hi - lo;
    std::stable_sort(rows.begin() + lo, rows.begin() + hi,
                     [&](int64_t a, int64_t b) { return ts[a] < ts[b]; });
    if (cnt < 2) {
      for (int64_t k = lo; k < hi; ++k) role[rows[k]] = 3;
    } else if (cnt == 2) {
      role[rows[lo]] = 0;
      role[rows[lo + 1]] = 2;
    } else {
      for (int64_t k = lo; k < hi - 2; ++k) role[rows[k]] = 0;
      role[rows[hi - 2]] = 1;
      role[rows[hi - 1]] = 2;
    }
  }
}

// Sorted, deduplicated per-user positive table [n_users, p], pad = n_items.
// Inputs must be the TRAIN rows only. Returns unique-degree per user.
void ppt_padded_positives(const int32_t* u, const int32_t* it, int64_t n,
                          int32_t n_users, int32_t n_items, int32_t p,
                          int32_t* out_table, int32_t* out_deg) {
  std::vector<std::vector<int32_t>> buckets(n_users);
  for (int64_t i = 0; i < n; ++i) buckets[u[i]].push_back(it[i]);
  for (int32_t v = 0; v < n_users; ++v) {
    auto& b = buckets[v];
    std::sort(b.begin(), b.end());
    b.erase(std::unique(b.begin(), b.end()), b.end());
    const int32_t deg = static_cast<int32_t>(std::min<size_t>(b.size(), p));
    out_deg[v] = deg;
    int32_t* row = out_table + static_cast<int64_t>(v) * p;
    for (int32_t k = 0; k < deg; ++k) row[k] = b[k];
    for (int32_t k = deg; k < p; ++k) row[k] = n_items;
  }
}

int ppt_abi_version() { return 1; }

}  // extern "C"
