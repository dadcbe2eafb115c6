// Native host-side mesh/graph kernels for the PDE framework.
//
// The reference implements its entire host pipeline in C++ (ExodusIO.hpp's
// adjacency construction :317-386, dual-graph partitioning input :880-918,
// ghost resolution :1121-1384).  Here the equivalent hot paths are native
// too, exposed through a C ABI consumed via ctypes (no pybind11 in the
// image); the Python layer falls back to vectorized NumPy when the shared
// library is unavailable.
//
// All kernels are deterministic and single-threaded-stable: results are
// sorted CSR structures independent of thread count (parallel sections only
// partition work by row).
//
// Build: g++ -O3 -march=native -shared -fPIC -o libddps_native.so ddps_native.cpp
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

// ---------------------------------------------------------------------------
// Index-type-templated cores for the hottest kernels.  At 10M DOF the host
// pipeline is memory-traffic-bound (this VM's first-touch fault rate swings
// 0.15-2 GB/s): int32 connectivity/indices halve every stream and every
// freshly-faulted output page, so the wrappers below export both an int64
// and an int32 ABI and the Python layer dispatches on the array dtypes.
// ---------------------------------------------------------------------------
namespace {

template <typename TIdx>
void build_node_elem_csr_t(const TIdx* conn, int64_t num_elem, int64_t npe,
                           int64_t n, std::vector<int64_t>& ne_ptr,
                           std::vector<TIdx>& ne_elems) {
  ne_ptr.assign(n + 1, 0);
  const int64_t total = num_elem * npe;
  for (int64_t i = 0; i < total; ++i) ne_ptr[conn[i] + 1]++;
  for (int64_t i = 0; i < n; ++i) ne_ptr[i + 1] += ne_ptr[i];
  ne_elems.resize(total);
  std::vector<int64_t> cursor(ne_ptr.begin(), ne_ptr.end() - 1);
  for (int64_t e = 0; e < num_elem; ++e)
    for (int64_t k = 0; k < npe; ++k)
      ne_elems[cursor[conn[e * npe + k]]++] = static_cast<TIdx>(e);
}

// Capacity-bounded single-pass adjacency.  Dedup is an insertion into a
// small sorted stack buffer (rows are ~15-26 wide for linear elements;
// binary search + memmove beats the former sort/unique of the ~60-entry
// duplicated candidate list).  Rows wider than the buffer fall back to
// sort/unique per row; result is byte-identical either way.
template <typename TIdx>
int64_t node_adjacency_cap_t(const TIdx* conn, int64_t num_elem, int64_t npe,
                             int64_t n, int64_t cap, int64_t* indptr,
                             TIdx* indices) {
  std::vector<int64_t> ne_ptr;
  std::vector<TIdx> ne_elems;
  build_node_elem_csr_t(conn, num_elem, npe, n, ne_ptr, ne_elems);

  constexpr int kBuf = 128;
  TIdx row[kBuf];
  std::vector<TIdx> widebuf;
  int64_t nnz = 0;
  indptr[0] = 0;
  for (int64_t v = 0; v < n; ++v) {
    const TIdx vt = static_cast<TIdx>(v);
    int m = 0;
    bool wide = false;
    for (int64_t p = ne_ptr[v]; p < ne_ptr[v + 1] && !wide; ++p) {
      const TIdx* elem = conn + static_cast<int64_t>(ne_elems[p]) * npe;
      for (int64_t k = 0; k < npe; ++k) {
        const TIdx u = elem[k];
        if (u == vt) continue;
        int lo = 0, hi = m;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (row[mid] < u) lo = mid + 1; else hi = mid;
        }
        if (lo < m && row[lo] == u) continue;
        if (m == kBuf) { wide = true; break; }
        std::memmove(row + lo + 1, row + lo, (m - lo) * sizeof(TIdx));
        row[lo] = u;
        ++m;
      }
    }
    if (wide) {
      widebuf.clear();
      for (int64_t p = ne_ptr[v]; p < ne_ptr[v + 1]; ++p) {
        const TIdx* elem = conn + static_cast<int64_t>(ne_elems[p]) * npe;
        for (int64_t k = 0; k < npe; ++k)
          if (elem[k] != vt) widebuf.push_back(elem[k]);
      }
      std::sort(widebuf.begin(), widebuf.end());
      widebuf.erase(std::unique(widebuf.begin(), widebuf.end()),
                    widebuf.end());
      if (nnz + static_cast<int64_t>(widebuf.size()) > cap) return -1;
      std::memcpy(indices + nnz, widebuf.data(),
                  widebuf.size() * sizeof(TIdx));
      nnz += static_cast<int64_t>(widebuf.size());
    } else {
      if (nnz + m > cap) return -1;
      std::memcpy(indices + nnz, row, m * sizeof(TIdx));
      nnz += m;
    }
    indptr[v + 1] = nnz;
  }
  return nnz;
}

template <typename TIdx>
int64_t assemble_reduced_t(const int64_t* adj_ptr, const TIdx* adj_idx,
                           int64_t n, const uint8_t* free_mask,
                           const TIdx* node_to_free, const double* bval,
                           int64_t* indptr, TIdx* indices, double* data,
                           double* b, TIdx* bdry_rows, TIdx* bdry_cols) {
  if (indices == nullptr) {
    int64_t nnz = 0, r = 0;
    indptr[0] = 0;
    for (int64_t u = 0; u < n; ++u) {
      if (!free_mask[u]) continue;
      int64_t row_nnz = 1;  // diagonal
      for (int64_t p = adj_ptr[u]; p < adj_ptr[u + 1]; ++p)
        row_nnz += free_mask[adj_idx[p]] ? 1 : 0;
      nnz += row_nnz;
      indptr[++r] = nnz;
    }
    return nnz;
  }
  int64_t pos = 0, r = 0, bpos = 0;
  for (int64_t u = 0; u < n; ++u) {
    if (!free_mask[u]) continue;
    const int64_t lo = adj_ptr[u], hi = adj_ptr[u + 1];
    double brhs = 0.0;
    bool diag_done = false;
    for (int64_t p = lo; p < hi; ++p) {
      const TIdx v = adj_idx[p];
      if (v > static_cast<TIdx>(u) && !diag_done) {
        indices[pos] = static_cast<TIdx>(r);
        data[pos] = static_cast<double>(hi - lo);  // degree: ALL neighbors
        ++pos;
        diag_done = true;
      }
      if (free_mask[v]) {
        indices[pos] = node_to_free[v];
        data[pos] = -1.0;
        ++pos;
      } else {
        brhs += bval[v];
        if (bdry_rows) {
          bdry_rows[bpos] = static_cast<TIdx>(r);
          bdry_cols[bpos] = v;
          ++bpos;
        }
      }
    }
    if (!diag_done) {
      indices[pos] = static_cast<TIdx>(r);
      data[pos] = static_cast<double>(hi - lo);
      ++pos;
    }
    b[r] = brhs;
    ++r;
  }
  return pos;
}

template <typename TIdx>
int64_t pack_dia_t(const int64_t* indptr, const TIdx* indices,
                   const double* data, int64_t n, int64_t n_pad,
                   int64_t max_diags, int64_t* offsets_out, float* data_out) {
  std::vector<int32_t> lut(2 * n - 1, -1);
  if (data_out == nullptr) {
    int64_t ndiags = 0;
    for (int64_t i = 0; i < n; ++i)
      for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
        const int64_t key = static_cast<int64_t>(indices[p]) - i + (n - 1);
        if (lut[key] < 0) {
          lut[key] = 1;
          if (++ndiags > max_diags) return -1;
        }
      }
    int64_t k = 0;
    for (int64_t key = 0; key < 2 * n - 1; ++key)
      if (lut[key] >= 0) offsets_out[k++] = key - (n - 1);
    return ndiags;
  }
  const int64_t ndiags = max_diags;
  for (int64_t d = 0; d < ndiags; ++d) lut[offsets_out[d] + (n - 1)] = d;
  std::memset(data_out, 0, sizeof(float) * ndiags * n_pad);
  for (int64_t i = 0; i < n; ++i)
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      const int64_t d = lut[static_cast<int64_t>(indices[p]) - i + (n - 1)];
      data_out[d * n_pad + i] = static_cast<float>(data[p]);
    }
  return ndiags;
}

// Single-pass Galerkin RAP (C = P^T A P) with results stashed in
// thread-local buffers: the two-call count+fill protocol above re-walks the
// whole triple product; at 10M-DOF fine levels the numeric pass is ~6 s, so
// computing once and copying out nearly halves the RAP phase of AMG setup.
template <typename TIdx>
struct RapStash {
  std::vector<int64_t> Cp;
  std::vector<TIdx> Ci;
  std::vector<double> Cx;
};

template <typename TIdx>
RapStash<TIdx>& rap_stash() {
  static thread_local RapStash<TIdx> s;
  return s;
}

template <typename TIdx>
int64_t rap_run_t(const int64_t* Ap, const TIdx* Ai, const double* Ax,
                  const int64_t* Pp, const TIdx* Pi, const double* Px,
                  int64_t n_f, int64_t n_c) {
  RapStash<TIdx>& st = rap_stash<TIdx>();
  // R = P^T in CSR (n_c rows).
  std::vector<int64_t> Rp(n_c + 1, 0);
  std::vector<TIdx> Ri(Pp[n_f]);
  std::vector<double> Rx(Pp[n_f]);
  for (int64_t p = 0; p < Pp[n_f]; ++p) Rp[Pi[p] + 1]++;
  for (int64_t c = 0; c < n_c; ++c) Rp[c + 1] += Rp[c];
  {
    std::vector<int64_t> cur(Rp.begin(), Rp.end() - 1);
    for (int64_t i = 0; i < n_f; ++i)
      for (int64_t p = Pp[i]; p < Pp[i + 1]; ++p) {
        const int64_t q = cur[Pi[p]]++;
        Ri[q] = static_cast<TIdx>(i);
        Rx[q] = Px[p];
      }
  }
  std::vector<double> acc(n_c, 0.0);
  std::vector<char> mark(n_c, 0);
  std::vector<TIdx> touched;
  st.Cp.assign(n_c + 1, 0);
  st.Ci.clear();
  st.Cx.clear();
  int64_t nnz = 0;
  for (int64_t c = 0; c < n_c; ++c) {
    touched.clear();
    for (int64_t rp = Rp[c]; rp < Rp[c + 1]; ++rp) {
      const int64_t k = Ri[rp];
      const double rv = Rx[rp];
      for (int64_t ap = Ap[k]; ap < Ap[k + 1]; ++ap) {
        const int64_t j = Ai[ap];
        const double av = rv * Ax[ap];
        for (int64_t pp = Pp[j]; pp < Pp[j + 1]; ++pp) {
          const TIdx cc = Pi[pp];
          if (!mark[cc]) {
            mark[cc] = 1;
            touched.push_back(cc);
          }
          acc[cc] += av * Px[pp];
        }
      }
    }
    std::sort(touched.begin(), touched.end());
    for (TIdx cc : touched) {
      st.Ci.push_back(cc);
      st.Cx.push_back(acc[cc]);
      ++nnz;
      mark[cc] = 0;
      acc[cc] = 0.0;
    }
    st.Cp[c + 1] = nnz;
  }
  return nnz;
}

template <typename TIdx>
void rap_fetch_t(int64_t* Cp, TIdx* Ci, double* Cx) {
  RapStash<TIdx>& st = rap_stash<TIdx>();
  std::memcpy(Cp, st.Cp.data(), st.Cp.size() * sizeof(int64_t));
  std::memcpy(Ci, st.Ci.data(), st.Ci.size() * sizeof(TIdx));
  std::memcpy(Cx, st.Cx.data(), st.Cx.size() * sizeof(double));
  st.Cp.clear(); st.Cp.shrink_to_fit();
  st.Ci.clear(); st.Ci.shrink_to_fit();
  st.Cx.clear(); st.Cx.shrink_to_fit();
}

// Gershgorin bound of lambda_max(D^-1 A): max_i sum_j |a_ij| / |d_i|.
// One streaming pass over (indices, data); a guaranteed containment bound
// for the Chebyshev interval, replacing the 20-matvec host power method on
// >4M-row fine levels (~13 s -> ~0.7 s at 10M DOF).
template <typename TIdx>
double gersh_dinv_t(const int64_t* indptr, const TIdx* indices,
                    const double* data, int64_t n) {
  double best = 0.0;
  for (int64_t i = 0; i < n; ++i) {
    double s = 0.0, d = 0.0;
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      s += std::fabs(data[p]);
      if (static_cast<int64_t>(indices[p]) == i) d = data[p];
    }
    if (d == 0.0) d = 1.0;
    const double v = s / std::fabs(d);
    if (v > best) best = v;
  }
  return best;
}

template <typename TIdx>
int64_t sa_prolongator_t(const int64_t* Ap, const TIdx* Ai, const double* Ax,
                         const TIdx* agg, const double* tval,
                         const double* s_over_d, int64_t n_f, int64_t n_c,
                         int64_t* Pp /* n_f+1 */, TIdx* Pi /* nullable */,
                         double* Px /* nullable */) {
  std::vector<double> acc(n_c, 0.0);
  std::vector<char> mark(n_c, 0);
  std::vector<int64_t> touched;
  int64_t nnz = 0;
  Pp[0] = 0;
  for (int64_t i = 0; i < n_f; ++i) {
    touched.clear();
    const double s = s_over_d[i];
    for (int64_t p = Ap[i]; p < Ap[i + 1]; ++p) {
      const int64_t c = agg[Ai[p]];
      if (c < 0) continue;  // unaggregated neighbor (shouldn't happen)
      if (!mark[c]) {
        mark[c] = 1;
        touched.push_back(c);
      }
      acc[c] -= s * Ax[p];
    }
    const int64_t ci = agg[i];
    if (ci >= 0) {
      if (!mark[ci]) {
        mark[ci] = 1;
        touched.push_back(ci);
      }
      acc[ci] += 1.0;
    }
    std::sort(touched.begin(), touched.end());
    if (Pi) {
      for (int64_t c : touched) {
        Pi[nnz] = static_cast<TIdx>(c);
        Px[nnz] = tval[c] * acc[c];
        ++nnz;
      }
    } else {
      nnz += static_cast<int64_t>(touched.size());
    }
    for (int64_t c : touched) {
      mark[c] = 0;
      acc[c] = 0.0;
    }
    Pp[i + 1] = nnz;
  }
  return nnz;
}

// Fused adjacency + reduced-Laplacian assembly: the two-kernel pipeline
// (node_adjacency_cap -> assemble_reduced) materializes the full node
// adjacency CSR only to re-read it immediately — ~1.15 GB of write+read
// traffic at 10M DOF on a host whose fresh pages fault at 0.15-2 GB/s.
// This kernel dedups each free node's neighbor row in the same stack
// buffer and emits the reduced row directly; boundary-node adjacency rows
// (skipped by the assembler anyway) are never computed.  Output is
// byte-identical to the two-kernel path (golden-tested).  Capacity-bounded
// single pass: returns -1 when cap_nnz/cap_b would overflow (caller falls
// back to the two-kernel form).
template <typename TIdx>
int64_t assemble_from_conn_t(const TIdx* conn, int64_t num_elem, int64_t npe,
                             int64_t n, const uint8_t* free_mask,
                             const TIdx* node_to_free, const double* bval,
                             int64_t cap_nnz, int64_t cap_b,
                             int64_t* indptr /* n_free+1 */, TIdx* indices,
                             double* data, double* b, TIdx* bdry_rows,
                             TIdx* bdry_cols, int64_t* nb_out) {
  std::vector<int64_t> ne_ptr;
  std::vector<TIdx> ne_elems;
  build_node_elem_csr_t(conn, num_elem, npe, n, ne_ptr, ne_elems);

  constexpr int kBuf = 128;
  TIdx row[kBuf];
  std::vector<TIdx> widebuf;
  int64_t pos = 0, r = 0, bpos = 0;
  indptr[0] = 0;
  for (int64_t u = 0; u < n; ++u) {
    if (!free_mask[u]) continue;
    const TIdx ut = static_cast<TIdx>(u);
    int m = 0;
    bool wide = false;
    for (int64_t p = ne_ptr[u]; p < ne_ptr[u + 1] && !wide; ++p) {
      const TIdx* elem = conn + static_cast<int64_t>(ne_elems[p]) * npe;
      for (int64_t k = 0; k < npe; ++k) {
        const TIdx v = elem[k];
        if (v == ut) continue;
        int lo = 0, hi = m;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (row[mid] < v) lo = mid + 1; else hi = mid;
        }
        if (lo < m && row[lo] == v) continue;
        if (m == kBuf) { wide = true; break; }
        std::memmove(row + lo + 1, row + lo, (m - lo) * sizeof(TIdx));
        row[lo] = v;
        ++m;
      }
    }
    const TIdx* nbr = row;
    int64_t deg = m;
    if (wide) {
      widebuf.clear();
      for (int64_t p = ne_ptr[u]; p < ne_ptr[u + 1]; ++p) {
        const TIdx* elem = conn + static_cast<int64_t>(ne_elems[p]) * npe;
        for (int64_t k = 0; k < npe; ++k)
          if (elem[k] != ut) widebuf.push_back(elem[k]);
      }
      std::sort(widebuf.begin(), widebuf.end());
      widebuf.erase(std::unique(widebuf.begin(), widebuf.end()),
                    widebuf.end());
      nbr = widebuf.data();
      deg = static_cast<int64_t>(widebuf.size());
    }
    if (pos + deg + 1 > cap_nnz || bpos + deg > cap_b) return -1;
    double brhs = 0.0;
    bool diag_done = false;
    for (int64_t q = 0; q < deg; ++q) {
      const TIdx v = nbr[q];
      if (v > ut && !diag_done) {
        indices[pos] = static_cast<TIdx>(r);
        data[pos] = static_cast<double>(deg);  // degree: ALL neighbors
        ++pos;
        diag_done = true;
      }
      if (free_mask[v]) {
        indices[pos] = node_to_free[v];
        data[pos] = -1.0;
        ++pos;
      } else {
        brhs += bval[v];
        bdry_rows[bpos] = static_cast<TIdx>(r);
        bdry_cols[bpos] = v;
        ++bpos;
      }
    }
    if (!diag_done) {
      indices[pos] = static_cast<TIdx>(r);
      data[pos] = static_cast<double>(deg);
      ++pos;
    }
    b[r] = brhs;
    ++r;
    indptr[r] = pos;
  }
  *nb_out = bpos;
  return pos;
}

}  // namespace

extern "C" {

int64_t rap_run(const int64_t* Ap, const int64_t* Ai, const double* Ax,
                const int64_t* Pp, const int64_t* Pi, const double* Px,
                int64_t n_f, int64_t n_c) {
  return rap_run_t<int64_t>(Ap, Ai, Ax, Pp, Pi, Px, n_f, n_c);
}
void rap_fetch(int64_t* Cp, int64_t* Ci, double* Cx) {
  rap_fetch_t<int64_t>(Cp, Ci, Cx);
}
int64_t rap_run_i32(const int64_t* Ap, const int32_t* Ai, const double* Ax,
                    const int64_t* Pp, const int32_t* Pi, const double* Px,
                    int64_t n_f, int64_t n_c) {
  return rap_run_t<int32_t>(Ap, Ai, Ax, Pp, Pi, Px, n_f, n_c);
}
void rap_fetch_i32(int64_t* Cp, int32_t* Ci, double* Cx) {
  rap_fetch_t<int32_t>(Cp, Ci, Cx);
}
double gersh_dinv(const int64_t* indptr, const int64_t* indices,
                  const double* data, int64_t n) {
  return gersh_dinv_t<int64_t>(indptr, indices, data, n);
}
double gersh_dinv_i32(const int64_t* indptr, const int32_t* indices,
                      const double* data, int64_t n) {
  return gersh_dinv_t<int32_t>(indptr, indices, data, n);
}

// ---------------------------------------------------------------------------
// Node adjacency from element connectivity (deduplicated directed edges).
//
// Equivalent computation to ExodusIO.hpp:342-378's per-element double loop
// inserting into std::map<idx_t, std::set<idx_t>> — but via a two-pass
// node->element incidence CSR and per-node small-array dedup: O(n * d log d)
// time, O(nnz) memory, no hash tables.
//
// conn: (num_elem, nodes_per_elem) int64 (0-based), possibly several blocks
//       concatenated by the caller with uniform npe per call.
// Returns the edge count; fills indptr (n+1) and, on the second call with
// the same inputs plus an `indices` buffer of size indptr[n], the column
// indices (sorted within each row).
// ---------------------------------------------------------------------------
static void build_node_elem_csr(const int64_t* conn, int64_t num_elem,
                                int64_t npe, int64_t n,
                                std::vector<int64_t>& ne_ptr,
                                std::vector<int64_t>& ne_elems) {
  ne_ptr.assign(n + 1, 0);
  const int64_t total = num_elem * npe;
  for (int64_t i = 0; i < total; ++i) ne_ptr[conn[i] + 1]++;
  for (int64_t i = 0; i < n; ++i) ne_ptr[i + 1] += ne_ptr[i];
  ne_elems.resize(total);
  std::vector<int64_t> cursor(ne_ptr.begin(), ne_ptr.end() - 1);
  for (int64_t e = 0; e < num_elem; ++e)
    for (int64_t k = 0; k < npe; ++k)
      ne_elems[cursor[conn[e * npe + k]]++] = e;
}

int64_t node_adjacency(const int64_t* conn, int64_t num_elem, int64_t npe,
                       int64_t n, int64_t* indptr /* n+1, out */,
                       int64_t* indices /* nullable; out */) {
  std::vector<int64_t> ne_ptr, ne_elems;
  build_node_elem_csr(conn, num_elem, npe, n, ne_ptr, ne_elems);

  std::vector<int64_t> scratch;
  int64_t nnz = 0;
  indptr[0] = 0;
  for (int64_t v = 0; v < n; ++v) {
    scratch.clear();
    for (int64_t p = ne_ptr[v]; p < ne_ptr[v + 1]; ++p) {
      const int64_t* elem = conn + ne_elems[p] * npe;
      for (int64_t k = 0; k < npe; ++k)
        if (elem[k] != v) scratch.push_back(elem[k]);
    }
    std::sort(scratch.begin(), scratch.end());
    scratch.erase(std::unique(scratch.begin(), scratch.end()), scratch.end());
    if (indices)
      std::memcpy(indices + nnz, scratch.data(),
                  scratch.size() * sizeof(int64_t));
    nnz += static_cast<int64_t>(scratch.size());
    indptr[v + 1] = nnz;
  }
  return nnz;
}

// Single-pass variant: writes indices up to ``cap`` entries and returns the
// nnz, or -1 once it would overflow (caller falls back to the two-pass
// form).  Halves the adjacency cost — the incidence CSR build plus the
// per-node sort/unique dominate, and the two-call convention repeats both.
int64_t node_adjacency_cap(const int64_t* conn, int64_t num_elem, int64_t npe,
                           int64_t n, int64_t cap,
                           int64_t* indptr /* n+1, out */,
                           int64_t* indices /* cap, out */) {
  return node_adjacency_cap_t<int64_t>(conn, num_elem, npe, n, cap, indptr,
                                       indices);
}

int64_t node_adjacency_cap_i32(const int32_t* conn, int64_t num_elem,
                               int64_t npe, int64_t n, int64_t cap,
                               int64_t* indptr /* n+1, out */,
                               int32_t* indices /* cap, out */) {
  return node_adjacency_cap_t<int32_t>(conn, num_elem, npe, n, cap, indptr,
                                       indices);
}

// ---------------------------------------------------------------------------
// Element dual graph: elements adjacent iff sharing >= ncommon nodes
// (the METIS_PartMeshDual / ParMETIS_V3_PartMeshKway input rule,
// ExodusIO.hpp:909-918).  Same incidence-CSR scheme, counting element-pair
// multiplicities per row with a sort.
// ---------------------------------------------------------------------------
int64_t dual_graph(const int64_t* conn, int64_t num_elem, int64_t npe,
                   int64_t n, int64_t ncommon, int64_t* indptr /* ne+1 */,
                   int64_t* indices /* nullable */) {
  std::vector<int64_t> ne_ptr, ne_elems;
  build_node_elem_csr(conn, num_elem, npe, n, ne_ptr, ne_elems);

  std::vector<int64_t> cand;
  int64_t nnz = 0;
  indptr[0] = 0;
  for (int64_t e = 0; e < num_elem; ++e) {
    cand.clear();
    const int64_t* elem = conn + e * npe;
    for (int64_t k = 0; k < npe; ++k) {
      const int64_t v = elem[k];
      for (int64_t p = ne_ptr[v]; p < ne_ptr[v + 1]; ++p)
        if (ne_elems[p] != e) cand.push_back(ne_elems[p]);
    }
    std::sort(cand.begin(), cand.end());
    // Count multiplicity runs; keep those >= ncommon.
    int64_t row_nnz = 0;
    for (size_t i = 0; i < cand.size();) {
      size_t j = i;
      while (j < cand.size() && cand[j] == cand[i]) ++j;
      if (static_cast<int64_t>(j - i) >= ncommon) {
        if (indices) indices[nnz + row_nnz] = cand[i];
        ++row_nnz;
      }
      i = j;
    }
    nnz += row_nnz;
    indptr[e + 1] = nnz;
  }
  return nnz;
}

// ---------------------------------------------------------------------------
// Greedy aggregation for smoothed-aggregation AMG (Vanek passes 1-3) —
// the setup hot loop (solvers/precond/amg.py:aggregate_greedy), native.
// strength filtering is applied by the caller (indices = strong neighbors).
// ---------------------------------------------------------------------------
int64_t aggregate_greedy(const int64_t* indptr, const int64_t* indices,
                         int64_t n, int64_t* agg /* out, n */) {
  std::fill(agg, agg + n, int64_t(-1));
  int64_t next = 0;
  // Pass 1: roots whose whole neighborhood is unaggregated.
  for (int64_t i = 0; i < n; ++i) {
    if (agg[i] != -1) continue;
    bool free_nbhd = true;
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p)
      if (agg[indices[p]] != -1) { free_nbhd = false; break; }
    if (free_nbhd) {
      agg[i] = next;
      for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p)
        agg[indices[p]] = next;
      ++next;
    }
  }
  // Pass 2: attach stragglers to the first aggregated neighbor.
  for (int64_t i = 0; i < n; ++i) {
    if (agg[i] != -1) continue;
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p)
      if (agg[indices[p]] != -1) { agg[i] = agg[indices[p]]; break; }
  }
  // Pass 3: isolated nodes become singletons.
  for (int64_t i = 0; i < n; ++i)
    if (agg[i] == -1) agg[i] = next++;
  return next;  // number of aggregates
}

// ---------------------------------------------------------------------------
// Reverse Cuthill-McKee ordering — bandwidth reduction for SpMV locality
// (improves ELL gather locality; no analogue in the reference, which
// relies on ParMETIS for locality).
// perm[out]: new position -> old index.
// ---------------------------------------------------------------------------
void rcm_order(const int64_t* indptr, const int64_t* indices, int64_t n,
               int64_t* perm) {
  std::vector<int64_t> degree(n);
  for (int64_t i = 0; i < n; ++i) degree[i] = indptr[i + 1] - indptr[i];
  std::vector<char> visited(n, 0);
  std::vector<int64_t> order;
  order.reserve(n);
  std::vector<int64_t> frontier, next, nbrs;
  for (int64_t seed_scan = 0; seed_scan < n;) {
    // Next unvisited min-degree seed.
    int64_t seed = -1, best = INT64_MAX;
    for (int64_t i = 0; i < n; ++i)
      if (!visited[i] && degree[i] < best) { best = degree[i]; seed = i; }
    if (seed < 0) break;
    visited[seed] = 1;
    order.push_back(seed);
    frontier.assign(1, seed);
    while (!frontier.empty()) {
      next.clear();
      for (int64_t v : frontier) {
        nbrs.clear();
        for (int64_t p = indptr[v]; p < indptr[v + 1]; ++p)
          if (!visited[indices[p]]) nbrs.push_back(indices[p]);
        std::sort(nbrs.begin(), nbrs.end(), [&](int64_t a, int64_t b) {
          return degree[a] != degree[b] ? degree[a] < degree[b] : a < b;
        });
        for (int64_t u : nbrs)
          if (!visited[u]) {
            visited[u] = 1;
            order.push_back(u);
            next.push_back(u);
          }
      }
      frontier.swap(next);
    }
    seed_scan = static_cast<int64_t>(order.size());
  }
  // Reverse for RCM.
  for (int64_t i = 0; i < n; ++i) perm[i] = order[n - 1 - i];
}

// ---------------------------------------------------------------------------
// ELL packing: scatter CSR rows into a padded (n_pad, K) layout in one pass
// (ops/ell.py:ell_from_csr inner loop, native).
// cols_out int32 (n_pad*K), vals_out float32/float64 selected by f64 flag.
// ---------------------------------------------------------------------------
void pack_ell_f32(const int64_t* indptr, const int64_t* indices,
                  const double* data, int64_t n, int64_t n_pad, int64_t K,
                  int32_t* cols_out, float* vals_out) {
  std::memset(cols_out, 0, sizeof(int32_t) * n_pad * K);
  std::memset(vals_out, 0, sizeof(float) * n_pad * K);
  for (int64_t i = 0; i < n; ++i) {
    int64_t w = 0;
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p, ++w) {
      cols_out[i * K + w] = static_cast<int32_t>(indices[p]);
      vals_out[i * K + w] = static_cast<float>(data[p]);
    }
  }
}

void pack_ell_f64(const int64_t* indptr, const int64_t* indices,
                  const double* data, int64_t n, int64_t n_pad, int64_t K,
                  int32_t* cols_out, double* vals_out) {
  std::memset(cols_out, 0, sizeof(int32_t) * n_pad * K);
  std::memset(vals_out, 0, sizeof(double) * n_pad * K);
  for (int64_t i = 0; i < n; ++i) {
    int64_t w = 0;
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p, ++w) {
      cols_out[i * K + w] = static_cast<int32_t>(indices[p]);
      vals_out[i * K + w] = data[p];
    }
  }
}

// ---------------------------------------------------------------------------
// ILU(0): incomplete LU factorization with zero fill-in, in place on the CSR
// value array (columns must be sorted within rows; pattern unchanged).
//
// The host analogue of the Ifpack2 ILUT setup the reference uses as
// its production preconditioner (BelosMueLuSolver.cpp:92-97) — level 0
// instead of thresholded fill, which is the standard parity baseline.
// IKJ ordering with a per-row position map: O(sum_i deg_i^2 / 2).
// diag_pos[out]: value-array position of each row's diagonal.
// Returns 0 on success, (i+1) if row i has a zero/missing pivot.
// ---------------------------------------------------------------------------
int64_t ilu0(const int64_t* indptr, const int64_t* indices, double* data,
             int64_t n, int64_t* diag_pos /* out, n */) {
  std::vector<int64_t> pos(n, -1);
  for (int64_t i = 0; i < n; ++i) {
    diag_pos[i] = -1;
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      pos[indices[p]] = p;
      if (indices[p] == i) diag_pos[i] = p;
    }
    if (diag_pos[i] < 0) return i + 1;  // structurally missing pivot
    for (int64_t p = indptr[i]; p < indptr[i + 1] && indices[p] < i; ++p) {
      const int64_t k = indices[p];
      const double pivot = data[diag_pos[k]];
      if (pivot == 0.0) return k + 1;
      const double lik = data[p] / pivot;
      data[p] = lik;
      for (int64_t q = diag_pos[k] + 1; q < indptr[k + 1]; ++q) {
        const int64_t pp = pos[indices[q]];
        if (pp >= 0) data[pp] -= lik * data[q];
      }
    }
    if (data[diag_pos[i]] == 0.0) return i + 1;  // numerically zero pivot
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) pos[indices[p]] = -1;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// ILUT (Saad's threshold incomplete LU) — the literal analogue of Ifpack2's
// ILUT, the reference's production preconditioner
// (BelosMueLuSolver.cpp:92-97; defaults level-of-fill 1.0, drop tol 0).
// Row-wise IKJ with a dense working row; per-row fill cap
// p_i = max(1, ceil(fill_factor * nnz(A_i))) largest-magnitude entries kept
// per factor; entries below droptol * ||A_i||_2 dropped during elimination.
// Caller allocates Li/Lx and Ui/Ux with capacity sum_i p_i.
// Returns 0, or (i+1) on a zero pivot at row i.
// ---------------------------------------------------------------------------
int64_t ilut(const int64_t* Ap, const int64_t* Ai, const double* Ax,
             int64_t n, double fill_factor, double droptol,
             int64_t* Lp, int64_t* Li, double* Lx,
             int64_t* Up, int64_t* Ui, double* Ux, double* diag) {
  std::vector<double> w(n, 0.0);
  std::vector<char> occ(n, 0);
  std::vector<int64_t> occl;
  std::vector<int64_t> cand;
  Lp[0] = 0;
  Up[0] = 0;
  for (int64_t i = 0; i < n; ++i) {
    occl.clear();
    double nrm2 = 0.0;
    for (int64_t p = Ap[i]; p < Ap[i + 1]; ++p) {
      w[Ai[p]] = Ax[p];
      if (!occ[Ai[p]]) {
        occ[Ai[p]] = 1;
        occl.push_back(Ai[p]);
      }
      nrm2 += Ax[p] * Ax[p];
    }
    const double tau = droptol * std::sqrt(nrm2);
    const int64_t cap = std::max<int64_t>(
        1, static_cast<int64_t>(
               std::ceil(fill_factor * double(Ap[i + 1] - Ap[i]))));
    // Eliminate lower entries in ascending column order (new fill-in can
    // add more lower columns, so re-scan with a sorted working list).
    std::sort(occl.begin(), occl.end());
    for (size_t idx = 0; idx < occl.size(); ++idx) {
      const int64_t k = occl[idx];
      if (k >= i) break;
      if (w[k] == 0.0) continue;
      w[k] /= diag[k];
      if (std::abs(w[k]) < tau) {
        w[k] = 0.0;
        continue;
      }
      bool added = false;
      for (int64_t q = Up[k]; q < Up[k + 1]; ++q) {
        const int64_t c = Ui[q];
        if (!occ[c]) {
          occ[c] = 1;
          occl.push_back(c);
          added = true;
        }
        w[c] -= w[k] * Ux[q];
      }
      if (added) {  // keep ascending order for the remaining elimination
        std::sort(occl.begin() + idx + 1, occl.end());
      }
    }
    if (w[i] == 0.0) {
      for (int64_t c : occl) {
        occ[c] = 0;
        w[c] = 0.0;
      }
      return i + 1;
    }
    diag[i] = w[i];
    // Keep the cap largest-magnitude entries per factor, columns sorted.
    auto emit = [&](bool lower_part, int64_t* Pp, int64_t* Pi, double* Px) {
      cand.clear();
      for (int64_t c : occl) {
        const bool is_low = c < i;
        if (is_low == lower_part && c != i && w[c] != 0.0) cand.push_back(c);
      }
      if (static_cast<int64_t>(cand.size()) > cap) {
        std::nth_element(
            cand.begin(), cand.begin() + cap, cand.end(),
            [&](int64_t a, int64_t b) {
              return std::abs(w[a]) > std::abs(w[b]);
            });
        cand.resize(cap);
      }
      std::sort(cand.begin(), cand.end());
      int64_t out = Pp[i];
      for (int64_t c : cand) {
        Pi[out] = c;
        Px[out] = w[c];
        ++out;
      }
      Pp[i + 1] = out;
    };
    emit(true, Lp, Li, Lx);
    emit(false, Up, Ui, Ux);
    for (int64_t c : occl) {
      occ[c] = 0;
      w[c] = 0.0;
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Level schedule for a sparse triangular solve: level[i] = 1 + max level of
// the dependencies of row i (strictly-lower neighbors for a lower solve,
// strictly-upper for an upper solve).  Rows within one level are mutually
// independent, so the device sweep can process a whole level in parallel.
// Returns the number of levels.
// ---------------------------------------------------------------------------
int64_t tri_levels(const int64_t* indptr, const int64_t* indices, int64_t n,
                   int64_t lower, int64_t* level /* out, n */) {
  int64_t nlev = 0;
  if (lower) {
    for (int64_t i = 0; i < n; ++i) {
      int64_t lv = 0;
      for (int64_t p = indptr[i]; p < indptr[i + 1] && indices[p] < i; ++p)
        lv = std::max(lv, level[indices[p]] + 1);
      level[i] = lv;
      nlev = std::max(nlev, lv + 1);
    }
  } else {
    for (int64_t i = n - 1; i >= 0; --i) {
      int64_t lv = 0;
      for (int64_t p = indptr[i + 1] - 1; p >= indptr[i] && indices[p] > i; --p)
        lv = std::max(lv, level[indices[p]] + 1);
      level[i] = lv;
      nlev = std::max(nlev, lv + 1);
    }
  }
  return nlev;
}

// ---------------------------------------------------------------------------
// DIA packing: detect the distinct diagonals of a CSR matrix and scatter the
// values into (ndiags, n_pad) float32 storage (ops/dia.py::dia_from_csr hot
// path — NumPy needed three 19M-element temporaries + a sort at 1M DOF).
// Two-call protocol: with data_out == nullptr, fills offsets_out (ascending)
// and returns ndiags, or -1 as soon as the count exceeds max_diags (early
// exit — unstructured matrices bail in one partial pass).  Second call
// scatters values.
// ---------------------------------------------------------------------------
int64_t pack_dia_f32(const int64_t* indptr, const int64_t* indices,
                     const double* data, int64_t n, int64_t n_pad,
                     int64_t max_diags, int64_t* offsets_out,
                     float* data_out /* nullable, (ndiags, n_pad) */) {
  // Offset lookup over [-(n-1), n-1], stored shifted by (n-1).  Fill pass
  // (data_out != nullptr): offsets_out holds the ascending diagonal list
  // and the caller passes the actual diagonal count via max_diags.
  return pack_dia_t<int64_t>(indptr, indices, data, n, n_pad, max_diags,
                             offsets_out, data_out);
}

int64_t pack_dia_f32_i32(const int64_t* indptr, const int32_t* indices,
                         const double* data, int64_t n, int64_t n_pad,
                         int64_t max_diags, int64_t* offsets_out,
                         float* data_out /* nullable, (ndiags, n_pad) */) {
  return pack_dia_t<int32_t>(indptr, indices, data, n, n_pad, max_diags,
                             offsets_out, data_out);
}

// ---------------------------------------------------------------------------
// Smoothed-aggregation prolongator P = (I - s D^-1 A) T, built directly from
// the aggregate assignment (amg.py's scipy chain A@T -> Dinv@ -> T-):
//   P[i, c] = tval[c] * ( [agg[i] == c]  -  s_over_d[i] * sum_{j in c} A[i,j] )
// Row i touches exactly the aggregates of its neighbors (plus its own), so
// one pass with a small per-row dedup map suffices.  Two-call protocol.
// ---------------------------------------------------------------------------

int64_t sa_prolongator(const int64_t* Ap, const int64_t* Ai, const double* Ax,
                       const int64_t* agg, const double* tval,
                       const double* s_over_d, int64_t n_f, int64_t n_c,
                       int64_t* Pp /* n_f+1 */, int64_t* Pi /* nullable */,
                       double* Px /* nullable */) {
  return sa_prolongator_t<int64_t>(Ap, Ai, Ax, agg, tval, s_over_d, n_f, n_c,
                                   Pp, Pi, Px);
}

// int32 ABI: at 10M DOF the assembled CSR carries int32 indices; converting
// them to int64 for this one call allocated ~1 GB of fresh pages (this VM
// faults fresh pages at 0.15-2 GB/s) and dominated the AMG "prolongator"
// phase (~24 s of a 32 s setup).
int64_t sa_prolongator_i32(const int64_t* Ap, const int32_t* Ai,
                           const double* Ax, const int32_t* agg,
                           const double* tval, const double* s_over_d,
                           int64_t n_f, int64_t n_c, int64_t* Pp,
                           int32_t* Pi /* nullable */,
                           double* Px /* nullable */) {
  return sa_prolongator_t<int32_t>(Ap, Ai, Ax, agg, tval, s_over_d, n_f, n_c,
                                   Pp, Pi, Px);
}

// ---------------------------------------------------------------------------
// bfloat16 exactness check: 1 iff every f64 value round-trips f64 -> f32 ->
// (f32 with low 16 mantissa bits zero).  One pass, no temporaries (the NumPy
// form allocated two nnz-sized arrays: ~1 s at 19M nnz).
// ---------------------------------------------------------------------------
int64_t bf16_exact(const double* data, int64_t nnz) {
  for (int64_t i = 0; i < nnz; ++i) {
    const float f = static_cast<float>(data[i]);
    if (static_cast<double>(f) != data[i]) return 0;
    uint32_t bits;
    std::memcpy(&bits, &f, 4);
    if (bits & 0xFFFFu) return 0;
  }
  return 1;
}

// ---------------------------------------------------------------------------
// Galerkin triple product C = P^T A P (the SA-AMG coarse-operator build,
// solvers/precond/amg.py) — native Gustavson with a dense coarse-row
// accumulator.  scipy's two-pass spgemm dominated AMG setup time
// (~2 s at 1M DOF); this single fused pass with the transpose built once is
// ~an order cheaper in allocations.
// A: (n_f x n_f) CSR; P: (n_f x n_c) CSR.  Two-call protocol like
// node_adjacency: first call with Ci == nullptr fills Cp and returns nnz;
// second call fills Ci/Cx (columns sorted).
// ---------------------------------------------------------------------------
int64_t rap_galerkin(const int64_t* Ap, const int64_t* Ai, const double* Ax,
                     const int64_t* Pp, const int64_t* Pi, const double* Px,
                     int64_t n_f, int64_t n_c, int64_t* Cp /* n_c+1 */,
                     int64_t* Ci /* nullable */, double* Cx /* nullable */) {
  // R = P^T in CSR (n_c rows).
  std::vector<int64_t> Rp(n_c + 1, 0), Ri(Pp[n_f]);
  std::vector<double> Rx(Pp[n_f]);
  for (int64_t p = 0; p < Pp[n_f]; ++p) Rp[Pi[p] + 1]++;
  for (int64_t c = 0; c < n_c; ++c) Rp[c + 1] += Rp[c];
  {
    std::vector<int64_t> cur(Rp.begin(), Rp.end() - 1);
    for (int64_t i = 0; i < n_f; ++i)
      for (int64_t p = Pp[i]; p < Pp[i + 1]; ++p) {
        const int64_t q = cur[Pi[p]]++;
        Ri[q] = i;
        Rx[q] = Px[p];
      }
  }
  std::vector<double> acc(n_c, 0.0);
  std::vector<char> mark(n_c, 0);
  std::vector<int64_t> touched;
  int64_t nnz = 0;
  Cp[0] = 0;
  const bool numeric = Ci != nullptr;
  for (int64_t c = 0; c < n_c; ++c) {
    touched.clear();
    for (int64_t rp = Rp[c]; rp < Rp[c + 1]; ++rp) {
      const int64_t k = Ri[rp];
      const double rv = Rx[rp];
      for (int64_t ap = Ap[k]; ap < Ap[k + 1]; ++ap) {
        const int64_t j = Ai[ap];
        const double av = rv * Ax[ap];
        for (int64_t pp = Pp[j]; pp < Pp[j + 1]; ++pp) {
          const int64_t cc = Pi[pp];
          if (!mark[cc]) {
            mark[cc] = 1;
            touched.push_back(cc);
          }
          if (numeric) acc[cc] += av * Px[pp];
        }
      }
    }
    if (numeric) {
      std::sort(touched.begin(), touched.end());
      for (int64_t cc : touched) {
        Ci[nnz] = cc;
        Cx[nnz] = acc[cc];
        ++nnz;
        mark[cc] = 0;
        acc[cc] = 0.0;
      }
    } else {  // symbolic count pass: skip the accumulate and the sort
      nnz += static_cast<int64_t>(touched.size());
      for (int64_t cc : touched) mark[cc] = 0;
    }
    Cp[c + 1] = nnz;
  }
  return nnz;
}

// ---------------------------------------------------------------------------
// Lattice-stencil verification + correction extraction on the packed DIA
// array: checks data[d][i] == pats[cls(i)][d] * in_range(i, tap d) exactly
// (off-diagonals), fills corr[i] = data[diag][i] - pats[cls(i)][diag], and
// returns 1 on success / 0 on the first mismatch.  One contiguous pass per
// diagonal — the NumPy form allocated ~3 n-sized temporaries per tap
// (~6 s at 10M DOF).
// ---------------------------------------------------------------------------
int64_t stencil_verify_corr(const float* data, int64_t stride, int64_t nd,
                            int64_t mx, int64_t my, int64_t mz, int64_t p,
                            const int64_t* taps /* nd x 3: dx,dy,dz */,
                            int64_t diag_idx,
                            const float* pats /* (p*p*p) x nd */,
                            float* corr /* n out */) {
  const int64_t n = mx * my * mz;
  for (int64_t d = 0; d < nd; ++d) {
    const float* row = data + d * stride;
    const int64_t dx = taps[d * 3], dy = taps[d * 3 + 1],
                  dz = taps[d * 3 + 2];
    const bool is_diag = (d == diag_idx);
    int64_t i = 0;
    for (int64_t iz = 0; iz < mz; ++iz) {
      const bool okz = (iz + dz >= 0) && (iz + dz < mz);
      for (int64_t iy = 0; iy < my; ++iy) {
        const bool oky = okz && (iy + dy >= 0) && (iy + dy < my);
        const int64_t cls_base = ((iz % p) * p + (iy % p)) * p;
        for (int64_t ix = 0; ix < mx; ++ix, ++i) {
          const float pat = pats[(cls_base + ix % p) * nd + d];
          if (is_diag) {
            corr[i] = row[i] - pat;
          } else {
            const bool in_range =
                oky && (ix + dx >= 0) && (ix + dx < mx);
            const float expected = in_range ? pat : 0.0f;
            if (row[i] != expected) return 0;
          }
        }
      }
    }
    (void)n;
  }
  return 1;
}

// ---------------------------------------------------------------------------
// Reduced-Laplacian assembly from the node adjacency: for every FREE node u
// emit row r = node_to_free[u] with -1 per free neighbor, the total neighbor
// count (free + boundary) on the diagonal at its sorted column position, and
// b[r] = sum of bval over boundary neighbors (ExodusIO.hpp:597-687
// semantics).  Adjacency columns are sorted by node id, and node_to_free is
// monotone over free nodes, so output columns come out sorted (canonical
// CSR) with no sort.  Two-call convention like node_adjacency: first call
// with indices == nullptr fills indptr and returns nnz; second call fills
// indices/data/b.  Replaces ~15 nnz-sized NumPy passes (~90 s of the 10M
// assembly on this 1-core host).
// ---------------------------------------------------------------------------
int64_t assemble_reduced(const int64_t* adj_ptr, const int64_t* adj_idx,
                         int64_t n, const uint8_t* free_mask,
                         const int64_t* node_to_free, const double* bval,
                         int64_t* indptr /* n_free+1, out */,
                         int64_t* indices /* nullable; out */,
                         double* data /* nullable; out */,
                         double* b /* nullable; n_free, out */,
                         int64_t* bdry_rows /* nullable; out */,
                         int64_t* bdry_cols /* nullable; out */) {
  // Count pass (indices == nullptr): fills indptr, returns nnz.  The
  // boundary-pair count is sum(row degrees) - (nnz - n_free), derivable by
  // the caller.
  return assemble_reduced_t<int64_t>(adj_ptr, adj_idx, n, free_mask,
                                     node_to_free, bval, indptr, indices,
                                     data, b, bdry_rows, bdry_cols);
}

int64_t assemble_reduced_i32(const int64_t* adj_ptr, const int32_t* adj_idx,
                             int64_t n, const uint8_t* free_mask,
                             const int32_t* node_to_free, const double* bval,
                             int64_t* indptr /* n_free+1, out */,
                             int32_t* indices /* nullable; out */,
                             double* data /* nullable; out */,
                             double* b /* nullable; n_free, out */,
                             int32_t* bdry_rows /* nullable; out */,
                             int32_t* bdry_cols /* nullable; out */) {
  return assemble_reduced_t<int32_t>(adj_ptr, adj_idx, n, free_mask,
                                     node_to_free, bval, indptr, indices,
                                     data, b, bdry_rows, bdry_cols);
}

int64_t assemble_from_conn(const int64_t* conn, int64_t num_elem, int64_t npe,
                           int64_t n, const uint8_t* free_mask,
                           const int64_t* node_to_free, const double* bval,
                           int64_t cap_nnz, int64_t cap_b, int64_t* indptr,
                           int64_t* indices, double* data, double* b,
                           int64_t* bdry_rows, int64_t* bdry_cols,
                           int64_t* nb_out) {
  return assemble_from_conn_t<int64_t>(conn, num_elem, npe, n, free_mask,
                                       node_to_free, bval, cap_nnz, cap_b,
                                       indptr, indices, data, b, bdry_rows,
                                       bdry_cols, nb_out);
}

int64_t assemble_from_conn_i32(const int32_t* conn, int64_t num_elem,
                               int64_t npe, int64_t n,
                               const uint8_t* free_mask,
                               const int32_t* node_to_free, const double* bval,
                               int64_t cap_nnz, int64_t cap_b, int64_t* indptr,
                               int32_t* indices, double* data, double* b,
                               int32_t* bdry_rows, int32_t* bdry_cols,
                               int64_t* nb_out) {
  return assemble_from_conn_t<int32_t>(conn, num_elem, npe, n, free_mask,
                                       node_to_free, bval, cap_nnz, cap_b,
                                       indptr, indices, data, b, bdry_rows,
                                       bdry_cols, nb_out);
}

// ---------------------------------------------------------------------------
// Structured (box-mesh) reduced-system assembly (models/structured.py):
// writes the canonical CSR + RHS + degree of the reduced heat Laplacian of
// ``box_mesh(nx, ny, nz)`` directly from the lattice tables — no mesh, no
// element scan, no dedup (replaces the O(elems x 16) single-scan kernel for
// generated boxes; reference semantics per ExodusIO.hpp:591-687).
//
// Free grid (mx, my, mz), row id ix + mx*(iy + my*iz); free node (ix,iy,iz)
// is mesh node (ix+1, iy, iz) of the (mx+2, my, mz) node grid.  Class
// c = ((iz%p)*p + iy%p)*p + ix%p (free-grid parity, p = stencil period).
// - taps: nd reduced-grid offsets (dx,dy,dz), ascending by (dz,dy,dx), so
//   emitted columns are sorted (canonical CSR).
// - pats[d*C + c]: the verified off-diagonal pattern value of tap d for
//   class c; the diagonal value is the node DEGREE (free + boundary
//   neighbors, ExodusIO.hpp:123-125), counted from the node-adjacency
//   offsets `opar` (x neighbors always exist inside the node grid; only
//   y/z faces truncate).
// - b[r] = bc_lo * #boundary-neighbors on the x=0 face (rows with ix==0)
//   + bc_hi * ... (ix==mx-1), i.e. sum of nodeset ids over adjacent
//   boundary nodes (ExodusIO.hpp:671-687).
// indptr/indices/data/b/degree must be preallocated (nnz is closed-form:
// sum_d prod_axis (m - |d|)).
// ---------------------------------------------------------------------------
void assemble_structured(int64_t mx, int64_t my, int64_t mz, int64_t p,
                         const int64_t* taps, int64_t nd, int64_t diag_idx,
                         const double* pats, const int64_t* opar_ptr,
                         const int64_t* opar, double bc_lo, double bc_hi,
                         int64_t* indptr, int32_t* indices, double* data,
                         double* b, double* degree) {
  const int64_t C = p * p * p;
  std::vector<int64_t> col_off(nd);
  for (int64_t d = 0; d < nd; ++d)
    col_off[d] = taps[d * 3] + taps[d * 3 + 1] * mx + taps[d * 3 + 2] * mx * my;
  std::vector<double> deg_c(p), blo_c(p), bhi_c(p);
  std::vector<char> okyz(nd);
  int64_t nnz = 0;
  indptr[0] = 0;
  for (int64_t iz = 0; iz < mz; ++iz) {
    for (int64_t iy = 0; iy < my; ++iy) {
      // Per-(iz, iy): y/z tap validity and per-x-class degree/b counts.
      for (int64_t d = 0; d < nd; ++d) {
        const int64_t dy = taps[d * 3 + 1], dz = taps[d * 3 + 2];
        okyz[d] = (iy + dy >= 0) && (iy + dy < my) && (iz + dz >= 0) &&
                  (iz + dz < mz);
      }
      const int64_t cyz = ((iz % p) * p + iy % p) * p;
      for (int64_t xc = 0; xc < p; ++xc) {
        const int64_t c = cyz + xc;
        int64_t deg = 0, lo = 0, hi = 0;
        for (int64_t k = opar_ptr[c]; k < opar_ptr[c + 1]; ++k) {
          const int64_t dx = opar[k * 3], dy = opar[k * 3 + 1],
                        dz = opar[k * 3 + 2];
          const bool ok = (iy + dy >= 0) && (iy + dy < my) &&
                          (iz + dz >= 0) && (iz + dz < mz);
          if (!ok) continue;
          ++deg;
          if (dx == -1) ++lo;
          if (dx == 1) ++hi;
        }
        deg_c[xc] = static_cast<double>(deg);
        blo_c[xc] = static_cast<double>(lo);
        bhi_c[xc] = static_cast<double>(hi);
      }
      const int64_t row0 = mx * (iy + my * iz);
      for (int64_t ix = 0; ix < mx; ++ix) {
        const int64_t u = row0 + ix;
        const int64_t xc = ix % p;
        const double deg = deg_c[xc];
        for (int64_t d = 0; d < nd; ++d) {
          const int64_t dx = taps[d * 3];
          if (!okyz[d] || ix + dx < 0 || ix + dx >= mx) continue;
          // A zero pattern value means this class has no adjacency on
          // this tap (off-diagonals of the graph Laplacian are always
          // -1): the element-scan CSR has no entry there, so neither do
          // we (bit-identical sparsity).
          const double v = pats[d * C + cyz + xc];
          if (d != diag_idx && v == 0.0) continue;
          indices[nnz] = static_cast<int32_t>(u + col_off[d]);
          data[nnz] = (d == diag_idx) ? deg : v;
          ++nnz;
        }
        indptr[u + 1] = nnz;
        degree[u] = deg;
        double bv = 0.0;
        if (ix == 0) bv += bc_lo * blo_c[xc];
        if (ix == mx - 1) bv += bc_hi * bhi_c[xc];
        b[u] = bv;
      }
    }
  }
}

}  // extern "C"  (templates cannot carry C linkage)

// ---------------------------------------------------------------------------
// Strength-filtered greedy aggregation straight off the raw CSR
// (solvers/precond/amg.py::aggregate_greedy).  The numpy preamble that
// materialized the filtered graph (repeat/mask/bincount/fancy-gather over
// nnz) dominated aggregation at 3.2M rows / 47M nnz; here the filter is a
// branch in the three Vanek passes.  strong(i, j) == (j != i) &&
// (|a_ij| >= theta * sqrt(|d_i d_j| + 1e-300)) — the exact expression the
// NumPy fallback evaluates, same operation order, so the two paths agree
// bit-for-bit on boundary ties.
// ---------------------------------------------------------------------------
template <typename I>
static int64_t aggregate_greedy_filtered_t(const int64_t* indptr,
                                           const I* indices,
                                           const double* data,
                                           const double* diag, double theta,
                                           int64_t n, int64_t* agg) {
  std::fill(agg, agg + n, int64_t(-1));
  const bool filt = theta > 0.0;
  auto strong = [&](int64_t i, int64_t p) -> bool {
    const int64_t j = static_cast<int64_t>(indices[p]);
    if (j == i) return false;
    if (!filt) return true;
    return std::fabs(data[p]) >=
           theta * std::sqrt(std::fabs(diag[i] * diag[j]) + 1e-300);
  };
  int64_t next = 0;
  // Pass 1: roots whose whole strong neighborhood is unaggregated.
  for (int64_t i = 0; i < n; ++i) {
    if (agg[i] != -1) continue;
    bool free_nbhd = true;
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p)
      if (strong(i, p) && agg[indices[p]] != -1) {
        free_nbhd = false;
        break;
      }
    if (free_nbhd) {
      agg[i] = next;
      for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p)
        if (strong(i, p)) agg[indices[p]] = next;
      ++next;
    }
  }
  // Pass 2: attach stragglers to the first aggregated strong neighbor.
  for (int64_t i = 0; i < n; ++i) {
    if (agg[i] != -1) continue;
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p)
      if (strong(i, p) && agg[indices[p]] != -1) {
        agg[i] = agg[indices[p]];
        break;
      }
  }
  // Pass 3: isolated nodes become singletons.
  for (int64_t i = 0; i < n; ++i)
    if (agg[i] == -1) agg[i] = next++;
  return next;
}

extern "C" {

int64_t aggregate_greedy_filtered(const int64_t* indptr,
                                  const int64_t* indices, const double* data,
                                  const double* diag, double theta, int64_t n,
                                  int64_t* agg) {
  return aggregate_greedy_filtered_t<int64_t>(indptr, indices, data, diag,
                                              theta, n, agg);
}

int64_t aggregate_greedy_filtered_i32(const int64_t* indptr,
                                      const int32_t* indices,
                                      const double* data, const double* diag,
                                      double theta, int64_t n, int64_t* agg) {
  return aggregate_greedy_filtered_t<int32_t>(indptr, indices, data, diag,
                                              theta, n, agg);
}

}  // extern "C"
