// sparse_host — native host-side runtime for spmv_research_tpu.
//
// Plays the role of the reference's C core library (SURVEY.md §2.5 "lib/"):
// the preprocessing paths that dominate conversion time are native, not
// Python. Exposed via a C ABI consumed through ctypes
// (spmv_research_tpu/io/native.py):
//
//   * mtx_parse        — MatrixMarket coordinate parser
//                        (role of lib/storage_formats/matrix_market/matrix_market.c:258)
//   * coo_to_csr       — counting-sort conversion (lib/storage_formats/csr/csr_gen.c:182)
//   * rcm              — reverse Cuthill–McKee (lib/rcm/rcm_gen.c:127)
//   * row_neighbours / cross_row_similarity — feature extraction
//                        (lib/storage_formats/csr_util/csr_util_gen.c:597,640)
//   * waksman_route    — exact Beneš routing (the BFLY format compiler's hot
//                        path; no reference analog)
//
// Build: make -C native   (g++ -O3 -march=native -shared -fPIC)

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <algorithm>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- mtx parse

// Parses the body of a MatrixMarket coordinate file (after header+size line).
// fields: 2 (pattern), 3 (real/integer), 4 (complex: real part kept).
// Returns number of entries parsed, or -1 on error.
int64_t mtx_parse_body(const char* buf, int64_t len, int64_t nnz_decl,
                       int32_t fields, int32_t* rows, int32_t* cols,
                       double* vals) {
  const char* p = buf;
  const char* end = buf + len;
  int64_t k = 0;
  while (p < end && k < nnz_decl) {
    while (p < end && (*p == ' ' || *p == '\n' || *p == '\r' || *p == '\t'))
      ++p;
    if (p >= end) break;
    char* q;
    long r = strtol(p, &q, 10);
    if (q == p) return -1;
    p = q;
    long c = strtol(p, &q, 10);
    if (q == p) return -1;
    p = q;
    double v = 1.0;
    if (fields >= 3) {
      v = strtod(p, &q);
      if (q == p) return -1;
      p = q;
      if (fields == 4) {  // complex: skip imaginary part
        strtod(p, &q);
        p = q;
      }
    }
    rows[k] = (int32_t)(r - 1);
    cols[k] = (int32_t)(c - 1);
    vals[k] = v;
    ++k;
  }
  return k;
}

// ---------------------------------------------------------------- coo → csr

// Counting-sort by row, then per-row sort by column. Output arrays
// preallocated by caller: ia (m+1), ja (nnz), a (nnz).
void coo_to_csr(const int32_t* rows, const int32_t* cols, const double* vals,
                int64_t nnz, int64_t m, int32_t* ia, int32_t* ja, double* a) {
  std::vector<int64_t> count(m + 1, 0);
  for (int64_t k = 0; k < nnz; ++k) count[rows[k] + 1]++;
  for (int64_t i = 0; i < m; ++i) count[i + 1] += count[i];
  for (int64_t i = 0; i <= m; ++i) ia[i] = (int32_t)count[i];
  std::vector<int64_t> pos(count.begin(), count.end() - 1);
  for (int64_t k = 0; k < nnz; ++k) {
    int64_t dst = pos[rows[k]]++;
    ja[dst] = cols[k];
    a[dst] = vals[k];
  }
  // sort columns within each row (indices + values together)
  std::vector<std::pair<int32_t, double>> tmp;
  for (int64_t i = 0; i < m; ++i) {
    int64_t s = ia[i], e = ia[i + 1];
    if (e - s < 2) continue;
    tmp.resize(e - s);
    for (int64_t k = s; k < e; ++k) tmp[k - s] = {ja[k], a[k]};
    std::sort(tmp.begin(), tmp.end());
    for (int64_t k = s; k < e; ++k) {
      ja[k] = tmp[k - s].first;
      a[k] = tmp[k - s].second;
    }
  }
}

// ---------------------------------------------------------------- RCM

// BFS-based reverse Cuthill–McKee; perm[i] = old index of new row i.
void rcm(const int32_t* ia, const int32_t* ja, int64_t m, int32_t* perm) {
  std::vector<int32_t> degree(m);
  for (int64_t i = 0; i < m; ++i) degree[i] = ia[i + 1] - ia[i];
  std::vector<int32_t> order_by_deg(m);
  for (int64_t i = 0; i < m; ++i) order_by_deg[i] = (int32_t)i;
  std::stable_sort(order_by_deg.begin(), order_by_deg.end(),
                   [&](int32_t x, int32_t y) { return degree[x] < degree[y]; });
  std::vector<char> visited(m, 0);
  std::vector<int32_t> queue;
  queue.reserve(m);
  int64_t out = 0;
  std::vector<int32_t> nbrs;
  for (int64_t s = 0; s < m; ++s) {
    int32_t start = order_by_deg[s];
    if (visited[start]) continue;
    visited[start] = 1;
    size_t head = queue.size();
    queue.push_back(start);
    while (head < queue.size()) {
      int32_t u = queue[head++];
      perm[out++] = u;
      nbrs.clear();
      for (int32_t k = ia[u]; k < ia[u + 1]; ++k) {
        int32_t v = ja[k];
        if (v >= 0 && v < m && !visited[v]) {
          visited[v] = 1;
          nbrs.push_back(v);
        }
      }
      std::sort(nbrs.begin(), nbrs.end(), [&](int32_t x, int32_t y) {
        return degree[x] < degree[y];
      });
      for (int32_t v : nbrs) queue.push_back(v);
    }
  }
  std::reverse(perm, perm + m);
}

// ---------------------------------------------------------------- features

// Mean per-nnz count of same-row neighbours within `window` columns
// (csr_util_gen.c:597 semantics).
double row_neighbours_avg(const int32_t* ia, const int32_t* ja, int64_t m,
                          int64_t nnz, int64_t window) {
  if (nnz == 0) return 0.0;
  int64_t total = 0;
  for (int64_t i = 0; i < m; ++i) {
    int64_t s = ia[i], e = ia[i + 1];
    for (int64_t j = s; j < e; ++j) {
      for (int64_t k = j + 1; k < e; ++k) {
        if ((int64_t)ja[k] - ja[j] > window) break;
        total += 2;
      }
    }
  }
  return (double)total / (double)nnz;
}

// Cross-row similarity (csr_util_gen.c:640 semantics).
double cross_row_similarity_avg(const int32_t* ia, const int32_t* ja,
                                int64_t m, int64_t window) {
  double total = 0.0;
  int64_t nonempty = 0;
  int64_t prev = -1;
  // iterate pairs (row i, next non-empty row l)
  for (int64_t i = 0; i < m; ++i) {
    if (ia[i + 1] - ia[i] <= 0) continue;
    if (prev >= 0) {
      // similarity of row `prev` against row `i`
      int64_t s1 = ia[prev], e1 = ia[prev + 1];
      int64_t s2 = ia[i], e2 = ia[i + 1];
      int64_t k = s2, matches = 0;
      for (int64_t j = s1; j < e1; ++j) {
        while (k < e2) {
          int64_t diff = (int64_t)ja[k] - ja[j];
          if (diff >= -window && diff <= window) {
            matches++;
            break;
          }
          if (diff <= 0)
            k++;
          else
            break;
        }
      }
      total += (double)matches / (double)(e1 - s1);
    }
    nonempty++;
    prev = i;
  }
  if (nonempty == 0) return 0.0;
  return total / (double)nonempty;
}

// ---------------------------------------------------------------- waksman

// Exact Beneš routing with min-swap cycle coloring. See
// spmv_research_tpu/ops/waksman.py for the algorithm description; this is a
// cycle-walking implementation (O(N) per level instead of numpy's sorts).
//
// Inputs: full permutation arrays s[N], t[N] (caller pads), real[N] (0/1).
// Outputs: A_words, B_words (n_words × N packed planes), stage_ks
// (≤ 2L−1 entries, -1 terminated), n_stages. Caller allocates:
//   A_words, B_words: ((2L-1+31)/32) * N uint32, zeroed
//   stage_ks: 2L int32
// Returns number of emitted stages.
int32_t waksman_route(const int64_t* s_in, const int64_t* t_in,
                      const uint8_t* real, int64_t N, int32_t L,
                      uint32_t* A_words, uint32_t* B_words,
                      int32_t* stage_ks) {
  std::vector<int64_t> s(s_in, s_in + N), t(t_in, t_in + N);
  std::vector<int64_t> colors(N, 0);
  std::vector<int8_t> cbit((size_t)std::max(L - 1, 0) * N);

  std::vector<int64_t> pin(N), pout(N), slot_of(N);

  for (int32_t lvl = 0; lvl < L - 1; ++lvl) {
    const int64_t low_mask = (1LL << lvl) - 1;
    // pair by (sub, high bits of src): use slot table keyed by position
    // key space: subproblem id has lvl bits; (src >> (lvl+1)) has L-lvl-1 bits
    // → combined key < N/2. Two elements per key.
    std::vector<int64_t> first_of(N / 2, -1);
    for (int64_t e = 0; e < N; ++e) {
      int64_t key = ((s[e] >> (lvl + 1)) << lvl) | colors[e];
      if (first_of[key] < 0)
        first_of[key] = e;
      else {
        pin[e] = first_of[key];
        pin[first_of[key]] = e;
      }
    }
    std::fill(first_of.begin(), first_of.end(), -1);
    for (int64_t e = 0; e < N; ++e) {
      int64_t key = ((t[e] >> (lvl + 1)) << lvl) | colors[e];
      if (first_of[key] < 0)
        first_of[key] = e;
      else {
        pout[e] = first_of[key];
        pout[first_of[key]] = e;
      }
    }
    // walk constraint cycles; color alternately; choose parity minimizing
    // swaps over real elements
    std::vector<char> seen(N, 0);
    std::vector<int64_t> cyc;
    for (int64_t e0 = 0; e0 < N; ++e0) {
      if (seen[e0]) continue;
      cyc.clear();
      int64_t e = e0;
      // traverse: e -in-> pin(e) -out-> pout(pin(e)) ...
      while (!seen[e]) {
        seen[e] = 1;
        cyc.push_back(e);      // gets color parity 0
        int64_t f = pin[e];
        seen[f] = 1;
        cyc.push_back(f);      // parity 1
        e = pout[f];
      }
      // cost for parity assignment: parity0 → c=0 for even slots
      int64_t cost0 = 0, cost1 = 0;
      for (size_t idx = 0; idx < cyc.size(); ++idx) {
        int64_t el = cyc[idx];
        if (!real[el]) continue;
        int64_t c = (int64_t)(idx & 1);
        int64_t sb = (s[el] >> lvl) & 1, tb = (t[el] >> lvl) & 1;
        cost0 += (sb ^ c) + (c ^ tb);
        cost1 += (sb ^ c ^ 1) + (c ^ 1 ^ tb);
      }
      int64_t flip = cost1 < cost0 ? 1 : 0;
      for (size_t idx = 0; idx < cyc.size(); ++idx) {
        int64_t el = cyc[idx];
        int64_t c = ((int64_t)(idx & 1)) ^ flip;
        cbit[(size_t)lvl * N + el] = (int8_t)c;
        colors[el] |= c << lvl;
      }
    }
  }

  // emit stages
  int32_t n_stages = 0;
  auto emit = [&](int32_t k, auto&& pos_fn, auto&& swap_fn) {
    // check any real swap
    bool any = false;
    for (int64_t e = 0; e < N && !any; ++e)
      if (real[e] && swap_fn(e)) any = true;
    if (!any) return;
    int32_t w = n_stages / 32, b = n_stages % 32;
    uint32_t bit = 1u << b;
    // default-keep stage semantics: only take-partner (B) bits are consumed
    // (see ops/waksman.py emit); A_words stays zeroed for ABI compatibility
    uint32_t* B = B_words + (size_t)w * N;
    for (int64_t e = 0; e < N; ++e) {
      if (!real[e]) continue;
      if (swap_fn(e)) B[pos_fn(e)] |= bit;
    }
    stage_ks[n_stages++] = k;
  };

  const auto lowbits = [&](int64_t e, int32_t lvl) {
    return colors[e] & ((1LL << lvl) - 1);
  };

  for (int32_t lvl = 0; lvl < L - 1; ++lvl) {
    emit(lvl,
         [&](int64_t e) {
           int64_t c = cbit[(size_t)lvl * N + e];
           return (((s[e] >> (lvl + 1)) << (lvl + 1)) | (c << lvl)
                   | lowbits(e, lvl));
         },
         [&](int64_t e) {
           return ((s[e] >> lvl) & 1) != cbit[(size_t)lvl * N + e];
         });
  }
  {
    int32_t lvl = L - 1;
    emit(lvl,
         [&](int64_t e) {
           return (((t[e] >> lvl) & 1) << lvl) | lowbits(e, lvl);
         },
         [&](int64_t e) { return ((s[e] >> lvl) & 1) != ((t[e] >> lvl) & 1); });
  }
  for (int32_t lvl = L - 2; lvl >= 0; --lvl) {
    emit(lvl,
         [&](int64_t e) { return ((t[e] >> lvl) << lvl) | lowbits(e, lvl); },
         [&](int64_t e) {
           return cbit[(size_t)lvl * N + e] != ((t[e] >> lvl) & 1);
         });
  }
  return n_stages;
}

// ------------------------------------------------------ euler edge coloring

// Proper 2^levels-edge-coloring of a bipartite multigraph where every vertex
// on both sides has degree exactly 2^levels (the Clos routing primitive —
// see spmv_research_tpu/ops/clos_route.py:euler_edge_color, whose numpy
// tier this replaces: cycle walking is O(E) per level vs argsort+pointer-
// doubling O(E log E), and dominates CLOSG program build time).
//
// Euler-split recursion over a MAINTAINED edge layout: the edge table is
// kept physically sorted by (color-class, left vertex) across levels (class
// boundaries live in a segment table, not a per-edge color array). That
// buys, per level:
//   * L-side pairing for free — equal-left runs are contiguous and start
//     at even offsets (degrees are powers of two), so the L-partner of the
//     edge at position j is position j^1;
//   * class-contiguous cycle walks — both pairings stay inside one class
//     segment, so the walk's working set shrinks 2x per level and drops
//     into cache at depth (the walk was ~6 random accesses/edge/level in
//     the previous formulation and dominated CLOSG build time);
//   * the class split is a stable two-cursor partition (sequential passes),
//     which also preserves the left-vertex sort for the next level.
// Only the R-side counting sort still makes global random accesses.
// Returns 0, or -1 when the key space exceeds the allocator guard (caller
// falls back to numpy).
int32_t euler_edge_color(const int64_t* left, const int64_t* right,
                         int64_t E, int32_t levels, int32_t* color) {
  if (E <= 0) return 0;
  int64_t nl = 0, nr = 0;
  for (int64_t i = 0; i < E; ++i) {
    nl = std::max(nl, left[i] + 1);
    nr = std::max(nr, right[i] + 1);
  }
  const int64_t kmax = (1LL << (levels > 0 ? levels - 1 : 0))
                       * std::max(nl, nr);
  // int32 internals keep the latency-bound random-access passes in half
  // the memory traffic; the guards force the numpy fallback outside range.
  // kmax bounds the counting-sort key space: 2^26 caps the transient cnt
  // vector at 256 MB of int32 (2^28 risked a silent ~1 GB host alloc
  // before the numpy fallback could engage)
  if (kmax > (1LL << 26) || E > (1LL << 30)) return -1;
  const int32_t n = (int32_t)E;
  if (levels <= 0) {
    std::fill(color, color + n, 0);
    return 0;
  }

  // double-buffered edge table (left vertex, right vertex, original id)
  std::vector<int32_t> lvA(n), rvA(n), idA(n), lvB(n), rvB(n), idB(n);
  std::vector<int32_t> orderR(n), pr2(n), cnt;
  std::vector<uint8_t> bit(n);

  // initial counting sort by left vertex (single class)
  cnt.assign((size_t)nl + 1, 0);
  for (int32_t i = 0; i < n; ++i) cnt[left[i] + 1]++;
  for (int64_t k = 0; k < nl; ++k) cnt[k + 1] += cnt[k];
  for (int32_t i = 0; i < n; ++i) {
    const int32_t p = cnt[left[i]]++;
    lvA[p] = (int32_t)left[i];
    rvA[p] = (int32_t)right[i];
    idA[p] = i;
  }

  int32_t *lv = lvA.data(), *rv = rvA.data(), *id = idA.data();
  int32_t *lvn = lvB.data(), *rvn = rvB.data(), *idn = idB.data();
  std::vector<int32_t> segs, segs2;
  segs.push_back(0);
  segs.push_back(n);

  for (int32_t lvl = 0; lvl < levels; ++lvl) {
    const int32_t ncls = (int32_t)segs.size() - 1;
    // R-side pairing: counting sort keyed (class, right vertex); every
    // (class, vertex) bucket has even size and an even start offset, so
    // consecutive orderR entries pair without straddling buckets
    const int64_t K = (int64_t)ncls * nr;
    cnt.assign((size_t)K + 1, 0);
    for (int32_t c = 0; c < ncls; ++c) {
      const int64_t base = (int64_t)c * nr;
      for (int32_t j = segs[c]; j < segs[c + 1]; ++j)
        cnt[base + rv[j] + 1]++;
    }
    for (int64_t k = 0; k < K; ++k) cnt[k + 1] += cnt[k];
    for (int32_t c = 0; c < ncls; ++c) {
      const int64_t base = (int64_t)c * nr;
      for (int32_t j = segs[c]; j < segs[c + 1]; ++j)
        orderR[cnt[base + rv[j]]++] = j;
    }
    for (int32_t t = 0; t + 1 < n; t += 2) {
      const int32_t a = orderR[t], b = orderR[t + 1];
      pr2[a] = b;
      pr2[b] = a;
    }
    // alternating-cycle walk: L-partner of j is j^1, R-partner is pr2[j];
    // both stay inside the class segment (bit 2 marks "unvisited")
    std::fill(bit.begin(), bit.end(), 2);
    for (int32_t s = 0; s < n; ++s) {
      if (bit[s] != 2) continue;
      int32_t e = s;
      do {
        bit[e] = 0;
        const int32_t f = e ^ 1;
        bit[f] = 1;
        e = pr2[f];
      } while (e != s);
    }
    // stable partition of every class by the new bit (keeps the left-
    // vertex sort inside both halves; class order stays numeric)
    segs2.clear();
    segs2.push_back(0);
    for (int32_t c = 0; c < ncls; ++c) {
      const int32_t a = segs[c], b = segs[c + 1];
      int32_t z = 0;
      for (int32_t j = a; j < b; ++j) z += (bit[j] == 0);
      int32_t c0 = a, c1 = a + z;
      for (int32_t j = a; j < b; ++j) {
        const int32_t d = bit[j] ? c1++ : c0++;
        lvn[d] = lv[j];
        rvn[d] = rv[j];
        idn[d] = id[j];
      }
      segs2.push_back(a + z);
      segs2.push_back(b);
    }
    std::swap(lv, lvn);
    std::swap(rv, rvn);
    std::swap(id, idn);
    segs.swap(segs2);
  }
  for (int32_t c = 0; c < (int32_t)segs.size() - 1; ++c)
    for (int32_t j = segs[c]; j < segs[c + 1]; ++j) color[id[j]] = c;
  return 0;
}

// --------------------------------------------------------------- SELLW pack
//
// Native tier of the SELLW format compiler (ops/sellw.py build_sellw):
// block-pair chunks, per-sublane x2d-row binding, first-fit part packing
// with lane-conflict avoidance. Mirrors the Python packer exactly so the
// two tiers produce identical programs (tests compare numerically).
//
// count_only != 0: dry run — only counts chunks and max_part (so the
// caller can allocate exact output buffers), all output pointers may be
// null. Returns nchunks, or -1 when cap is exceeded (count_only=0 only).

static const int kSub = 8, kLanes = 128;

int64_t sellw_pack2(const int64_t* ia, const int32_t* ja, const float* av,
                    int64_t m, int64_t cap, int32_t count_only,
                    int32_t part_cap,
                    int32_t* word, float* vals, int32_t* wrow,
                    int32_t* pair_out, uint8_t* bids_out,
                    int32_t* max_part_out, int32_t* idx_out) {
  const int64_t nblocks = (m + kLanes - 1) / kLanes;
  const int64_t npairs = (nblocks + 1) / 2;
  int64_t nchunks = 0;
  int32_t max_part = 1;
  std::vector<int64_t> pstart, plen, prow, pbin, order, queue, defer;
  for (int64_t pb = 0; pb < npairs; ++pb) {
    const int64_t r0 = pb * 2 * kLanes;
    const int64_t r1 = std::min(r0 + 2 * kLanes, m);
    const int64_t e0 = ia[r0], e1 = ia[r1];
    if (e0 == e1) continue;
    // parts: maximal runs of equal (row, col/128) in CSR order
    pstart.clear(); plen.clear(); prow.clear(); pbin.clear();
    for (int64_t r = r0; r < r1; ++r) {
      int64_t e = ia[r];
      while (e < ia[r + 1]) {
        const int32_t bin = ja[e] / kLanes;
        int64_t f = e + 1;
        while (f < ia[r + 1] && ja[f] / kLanes == bin) ++f;
        // part_cap: split long parts into sub-parts, each with its own
        // extraction cell (the masked sublane-sum adds sub-totals) --
        // bounds the scan depth at log2(part_cap) with zero extra slots
        for (int64_t ps = e; ps < f; ps += part_cap) {
          const int64_t pe = std::min(ps + (int64_t)part_cap, f);
          pstart.push_back(ps);
          plen.push_back(pe - ps);
          prow.push_back(r - r0);
          pbin.push_back(bin);
          if (pe - ps > max_part) max_part = (int32_t)(pe - ps);
        }
        e = f;
      }
    }
    order.resize(pstart.size());
    for (size_t i = 0; i < order.size(); ++i) order[i] = (int64_t)i;
    std::stable_sort(order.begin(), order.end(),
                     [&](int64_t a, int64_t b) {
                       if (pbin[a] != pbin[b]) return pbin[a] < pbin[b];
                       return plen[a] > plen[b];
                     });
    queue = order;
    while (!queue.empty()) {
      if (!count_only && nchunks >= cap) return -1;
      int32_t* wd = count_only ? nullptr
                               : word + nchunks * kSub * kLanes;
      float* vv = count_only ? nullptr : vals + nchunks * kSub * kLanes;
      int32_t* ix = (count_only || !idx_out)
                        ? nullptr : idx_out + nchunks * kSub * kLanes;
      if (ix) memset(ix, 0xFF, sizeof(int32_t) * kSub * kLanes);  // -1
      uint32_t ex[kSub][kLanes];
      memset(ex, 0, sizeof(ex));
      if (!count_only) {
        memset(wd, 0, sizeof(int32_t) * kSub * kLanes);
        memset(vv, 0, sizeof(float) * kSub * kLanes);
      }
      int pos[kSub] = {0};
      int32_t wr[kSub] = {0};
      int64_t cur_bin = -1;
      int open_s[kSub];               // open sublanes for cur_bin
      int n_open = 0;
      int next_s = 0;
      uint8_t bids = 0;
      defer.clear();
      for (int64_t t : queue) {
        const int64_t p = pstart[t];
        const int k = (int)plen[t];
        const int64_t bin = pbin[t];
        const int l = (int)prow[t];
        const int lane = l & (kLanes - 1), bid = l >> 7;
        if (bin != cur_bin) { cur_bin = bin; n_open = 0; }
        int s = -1;
        for (int oi = 0; oi < n_open; ++oi) {  // first fit, conflict-free
          const int so = open_s[oi];
          if (pos[so] + k <= kLanes && !ex[so][lane]) { s = so; break; }
        }
        if (s < 0) {
          if (next_s >= kSub) { defer.push_back(t); continue; }
          s = next_s++;
          open_s[n_open++] = s;
          wr[s] = (int32_t)bin;
        }
        if (!count_only) {
          for (int d = 0; d < k; ++d) {
            uint32_t g = 0;
            for (int kk = 0; kk < 7; ++kk)
              if (d >= (1 << kk)) g |= 1u << kk;
            wd[s * kLanes + pos[s] + d] =
                (int32_t)((uint32_t)(ja[p + d] & (kLanes - 1)) | (g << 7));
            vv[s * kLanes + pos[s] + d] = av[p + d];
            if (ix) ix[s * kLanes + pos[s] + d] = (int32_t)(p + d);
          }
        }
        ex[s][lane] = ((uint32_t)(pos[s] + k - 1) << 14) | (1u << 21)
                      | ((uint32_t)bid << 22);
        pos[s] += k;
        bids |= (uint8_t)(1 << bid);
      }
      if (!count_only) {
        for (int s = 0; s < kSub; ++s)
          for (int l2 = 0; l2 < kLanes; ++l2)
            wd[s * kLanes + l2] |= (int32_t)ex[s][l2];
        for (int s = 0; s < kSub; ++s) wrow[nchunks * kSub + s] = wr[s];
        pair_out[nchunks] = (int32_t)pb;
        bids_out[nchunks] = bids;
      }
      ++nchunks;
      queue.swap(defer);
    }
  }
  *max_part_out = max_part;
  return nchunks;
}

int64_t sellw_pack(const int64_t* ia, const int32_t* ja, const float* av,
                   int64_t m, int64_t cap, int32_t count_only,
                   int32_t* word, float* vals, int32_t* wrow,
                   int32_t* pair_out, uint8_t* bids_out,
                   int32_t* max_part_out) {
  return sellw_pack2(ia, ja, av, m, cap, count_only, kLanes, word, vals,
                     wrow, pair_out, bids_out, max_part_out, nullptr);
}

}  // extern "C"
