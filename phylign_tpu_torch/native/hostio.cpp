// Native host-side kernels of the PyTorch/CUDA port: the port's own copy of
// phylign_tpu/native/hostio.cpp (all of it but the scalar xxh64 and
// encode_seq entry points, which the port does not call).
//   * canonical 31-mer XXH64 Bloom-row hashing (cobs-compatible: XXH64 of
//     the ASCII canonical k-mer, seed = hash index, mod signature size),
//   * the 03_match text parser, the dedup's unique+inverse and the filter's
//     top-k core (match stage),
//   * minimizer sketching (minimap2-sr style: packed canonical k-mer,
//     hash64 finalizer, w-window minima with ties), seed-anchor collection
//     and gapless SAM line assembly (align stage).
// Exposed with a plain C ABI for ctypes (phylign_tpu_torch/native/__init__.py,
// which builds it with g++ at first use); numpy implementations remain as the
// portable fallback.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <unordered_map>
#include <utility>
#include <vector>

// Run fn(begin, end) over [0, n) split into contiguous ranges, one per
// worker thread. ctypes releases the GIL around every call into this
// library, so threading here is real parallelism on many-core hosts. Thread count:
// PHYLIGN_TPU_NATIVE_THREADS env override, else hardware_concurrency,
// capped at 16; small inputs run inline (thread spawn ~50 us each).
template <typename F>
static void parallel_ranges(int64_t n, int64_t min_per_thread, F fn) {
  unsigned hw = std::thread::hardware_concurrency();
  if (const char* env = std::getenv("PHYLIGN_TPU_NATIVE_THREADS")) {
    long v = std::atol(env);
    if (v > 0) hw = (unsigned)v;
  }
  int64_t t = std::min<int64_t>(hw ? hw : 1, 16);
  t = std::min(t, n / std::max<int64_t>(1, min_per_thread));
  if (t <= 1) {
    fn((int64_t)0, n);
    return;
  }
  std::vector<std::thread> workers;
  workers.reserve((size_t)t);
  int64_t chunk = (n + t - 1) / t;
  for (int64_t i = 0; i < t; i++) {
    int64_t b = i * chunk, e = std::min(n, b + chunk);
    if (b >= e) break;
    workers.emplace_back([=] { fn(b, e); });
  }
  for (auto& w : workers) w.join();
}

extern "C" {

// ---------------------------------------------------------------- xxhash64
// XXH64 (Yann Collet's xxHash, public domain algorithm), transliterated from
// the specification.

static const uint64_t P1 = 0x9E3779B185EBCA87ULL;
static const uint64_t P2 = 0xC2B2AE3D27D4EB4FULL;
static const uint64_t P3 = 0x165667B19E3779F9ULL;
static const uint64_t P4 = 0x85EBCA77C2B2AE63ULL;
static const uint64_t P5 = 0x27D4EB2F165667C5ULL;

static inline uint64_t rotl64(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}

static inline uint64_t xxh_round(uint64_t acc, uint64_t lane) {
  acc += lane * P2;
  acc = rotl64(acc, 31);
  return acc * P1;
}

static inline uint64_t xxh_merge(uint64_t acc, uint64_t v) {
  acc ^= xxh_round(0, v);
  return acc * P1 + P4;
}

static inline uint64_t read_u64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;  // little-endian hosts only (x86_64 / aarch64)
}

static inline uint32_t read_u32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

static uint64_t xxh64(const uint8_t* data, uint64_t len, uint64_t seed) {
  const uint8_t* p = data;
  const uint8_t* end = data + len;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    const uint8_t* limit = end - 32;
    do {
      v1 = xxh_round(v1, read_u64(p)); p += 8;
      v2 = xxh_round(v2, read_u64(p)); p += 8;
      v3 = xxh_round(v3, read_u64(p)); p += 8;
      v4 = xxh_round(v4, read_u64(p)); p += 8;
    } while (p <= limit);
    h = rotl64(v1, 1) + rotl64(v2, 7) + rotl64(v3, 12) + rotl64(v4, 18);
    h = xxh_merge(h, v1); h = xxh_merge(h, v2);
    h = xxh_merge(h, v3); h = xxh_merge(h, v4);
  } else {
    h = seed + P5;
  }
  h += len;
  while (p + 8 <= end) {
    h ^= xxh_round(0, read_u64(p));
    h = rotl64(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= (uint64_t)read_u32(p) * P1;
    h = rotl64(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= (uint64_t)(*p) * P5;
    h = rotl64(h, 11) * P1;
    p++;
  }
  h ^= h >> 33; h *= P2;
  h ^= h >> 29; h *= P3;
  h ^= h >> 32;
  return h;
}

// ------------------------------------------- COBS canonical k-mer row hashes

// For every k-mer position: canonicalize (lexicographically smaller of the
// ASCII k-mer vs its reverse complement), hash with XXH64(seed=h) for each
// hash function, mod signature_size. out is [n_pos * num_hashes] int64.
// Returns n_pos.
int64_t cobs_row_indices(const uint8_t* codes, int64_t len, int32_t k,
                         uint64_t signature_size, int32_t num_hashes,
                         int64_t* out) {
  static const char ASCII[4] = {'A', 'C', 'G', 'T'};
  int64_t n_pos = len - k + 1;
  if (n_pos <= 0) return 0;
  std::vector<uint8_t> fwd(k), rc(k);
  for (int64_t p = 0; p < n_pos; p++) {
    for (int32_t j = 0; j < k; j++) {
      fwd[j] = ASCII[codes[p + j]];
      rc[j] = ASCII[3 - codes[p + k - 1 - j]];
    }
    const uint8_t* canon = fwd.data();
    if (std::memcmp(rc.data(), fwd.data(), k) < 0) canon = rc.data();
    for (int32_t h = 0; h < num_hashes; h++) {
      uint64_t hv = xxh64(canon, (uint64_t)k, (uint64_t)h);
      // signature_size == 0: emit the RAW 64-bit hash (bit-cast; the
      // caller reinterprets as uint64) so one hashing pass can serve many
      // batches — each batch only re-mods by its own signature size.
      out[p * num_hashes + h] =
          (int64_t)(signature_size ? hv % signature_size : hv);
    }
  }
  return n_pos;
}

// Batched cobs_row_indices over CONCATENATED sequences: sequence i occupies
// codes[off[i], off[i+1]); its rows land at out[out_off[i] * num_hashes]
// (out_off = caller's exclusive scan of per-seq n_pos). Threaded over
// sequences — the per-call ctypes overhead of hashing tens of thousands of
// reads one at a time (~15 us each) dominated the match stage's host side.
void cobs_row_indices_batch(const uint8_t* codes, const int64_t* off,
                            const int64_t* out_off, int64_t n_seqs,
                            int32_t k, uint64_t signature_size,
                            int32_t num_hashes, int64_t* out) {
  parallel_ranges(n_seqs, 256, [&](int64_t b, int64_t e) {
    for (int64_t i = b; i < e; i++) {
      cobs_row_indices(codes + off[i], off[i + 1] - off[i], k,
                       signature_size, num_hashes,
                       out + out_off[i] * num_hashes);
    }
  });
}

// ------------------------------------------------------- match-file parsing

// The 03_match text contract (match/postprocess.py): header lines
// "*{qname}\t{n_total}" followed by hit lines "_{acc}\t{score}". At full
// scale (305 batches x thousands of queries x 100 hits) this is tens of
// millions of lines; a python per-line parse costs minutes, this parser
// streams the decompressed buffer once and interns accession strings so
// the hit arrays stay numeric (ref workload: filter_queries.py:27-66).

// Pass 1: sizes. Returns 0 on success, -1 on malformed input.
int32_t match_text_stats(const uint8_t* buf, int64_t n, int64_t* n_queries,
                         int64_t* n_hits) {
  int64_t nq = 0, nh = 0;
  int64_t i = 0;
  while (i < n) {
    int64_t j = i;
    while (j < n && buf[j] != '\n') j++;
    int64_t e = j;
    if (e > i && buf[e - 1] == '\r') e--;  // CRLF tolerance
    if (e > i) {  // skip empty lines
      if (buf[i] == '*') nq++;
      else nh++;
    }
    i = j + 1;
  }
  *n_queries = nq;
  *n_hits = nh;
  return 0;
}

// Pass 2: fill arrays. qname/acc strings are returned as (offset, len)
// into buf; accessions are interned (acc_table holds first-occurrence
// offsets; hits carry uint32 ids). Hit counts are cumulative per query
// (q_hit_end[i] = hits in queries 0..i). Returns the number of distinct
// accessions, or -1 on malformed input (hit line before any header, no
// tab, or non-numeric score).
int64_t parse_match_text(const uint8_t* buf, int64_t n,
                         int64_t* q_name_off, int32_t* q_name_len,
                         int64_t* q_total, int64_t* q_hit_end,
                         uint32_t* hit_acc_id, int32_t* hit_score,
                         int64_t* acc_off, int32_t* acc_len) {
  std::unordered_map<std::string, uint32_t> intern;
  int64_t qi = -1, hi = 0, nacc = 0;
  int64_t i = 0;
  while (i < n) {
    int64_t j = i;
    while (j < n && buf[j] != '\n') j++;
    int64_t e = j;
    if (e > i && buf[e - 1] == '\r') e--;  // CRLF tolerance
    int64_t len = e - i;
    if (len > 0) {
      // find the tab
      int64_t t = i;
      while (t < e && buf[t] != '\t') t++;
      if (t >= e) return -1;
      // parse the integer after the tab; bound the digit count so corrupt
      // or hostile input fails cleanly (-1 -> numpy fallback) instead of
      // overflowing signed int64 (UB) or silently truncating to int32
      int64_t v = 0;
      int digits = 0;
      for (int64_t p = t + 1; p < e; p++) {
        if (buf[p] < '0' || buf[p] > '9') return -1;
        if (++digits > 18) return -1;
        v = v * 10 + (buf[p] - '0');
      }
      if (digits == 0) return -1;
      if (buf[i] == '*') {
        // header: "*qname\tN" — qname drops any FASTA comment after ' '
        qi++;
        int64_t name_end = t;
        for (int64_t p = i + 1; p < t; p++) {
          if (buf[p] == ' ') { name_end = p; break; }
        }
        q_name_off[qi] = i + 1;
        q_name_len[qi] = (int32_t)(name_end - (i + 1));
        q_total[qi] = v;
        q_hit_end[qi] = hi;
      } else {
        if (qi < 0) return -1;
        // hit: "_acc\tscore" — the '_' is the stripped-rid residue
        // acc = everything after the FIRST '_' (str.partition semantics of
        // read_match_file: empty when there is no '_')
        int64_t a0 = i;
        while (a0 < t && buf[a0] != '_') a0++;
        a0 = (a0 < t) ? a0 + 1 : t;
        std::string key(reinterpret_cast<const char*>(buf + a0),
                        (size_t)(t - a0));
        auto it = intern.find(key);
        uint32_t id;
        if (it == intern.end()) {
          id = (uint32_t)nacc;
          intern.emplace(std::move(key), id);
          acc_off[nacc] = a0;
          acc_len[nacc] = (int32_t)(t - a0);
          nacc++;
        } else {
          id = it->second;
        }
        if (v > INT32_MAX) return -1;  // score must fit its int32 column
        hit_acc_id[hi] = id;
        hit_score[hi] = (int32_t)v;
        hi++;
        q_hit_end[qi] = hi;
      }
    }
    i = j + 1;
  }
  return nacc;
}

// ----------------------------------------------- match-dedup unique+inverse

// Sorted-unique + inverse indices over an int32 array (the host half of the
// match kernel's two-stage dedup gather, ops/match.py dedup_rows): LSD radix
// sort on (value << 32 | position) packed u64 keys — ~5x faster than
// numpy's np.unique(return_inverse=True) argsort path on this host. Values
// must be non-negative. Writes ascending uniques to uniq_out (capacity n)
// and the value's unique-rank to inv_out[pos]; returns the unique count.
int64_t unique_inverse_i32(const int32_t* x, int64_t n,
                           int32_t* uniq_out, int32_t* inv_out) {
  if (n == 0) return 0;
  std::vector<uint64_t> keys((size_t)n), tmp((size_t)n);
  for (int64_t i = 0; i < n; i++)
    keys[(size_t)i] = ((uint64_t)(uint32_t)x[i] << 32) | (uint32_t)i;
  // 16-bit-digit LSD radix; skip digits that are constant across the array
  uint64_t ormask = 0, andmask = ~0ull;
  for (int64_t i = 0; i < n; i++) {
    ormask |= keys[(size_t)i];
    andmask &= keys[(size_t)i];
  }
  uint64_t varying = ormask ^ andmask;
  size_t count[1 << 16];
  for (int shift = 0; shift < 64; shift += 16) {
    if (((varying >> shift) & 0xFFFF) == 0) continue;
    std::memset(count, 0, sizeof(count));
    for (int64_t i = 0; i < n; i++)
      count[(keys[(size_t)i] >> shift) & 0xFFFF]++;
    size_t pos = 0;
    for (size_t d = 0; d < (1 << 16); d++) {
      size_t c = count[d];
      count[d] = pos;
      pos += c;
    }
    for (int64_t i = 0; i < n; i++)
      tmp[count[(keys[(size_t)i] >> shift) & 0xFFFF]++] = keys[(size_t)i];
    std::swap(keys, tmp);
  }
  int64_t nu = -1;
  int32_t prev = -1;
  for (int64_t i = 0; i < n; i++) {
    int32_t v = (int32_t)(keys[(size_t)i] >> 32);
    int32_t p = (int32_t)(keys[(size_t)i] & 0xFFFFFFFFu);
    if (nu < 0 || v != prev) {
      uniq_out[++nu] = v;
      prev = v;
    }
    inv_out[p] = (int32_t)nu;
  }
  return nu + 1;
}

// ------------------------------------------------- global top-k filter core

// The filter stage's hot core (ref: filter_queries.py:123-150): sort all
// (query, score, batch, accession) candidate rows by
// (query, -score, batch, accession) and keep, per query, the first `keep`
// rows plus every following row tying the rank-`keep` score.
//
// Key packing (caller guarantees the ranges): q < 2^22, score <= smax
// < 2^14, brank < 2^10, arank < 2^18. Writes kept ORIGINAL row indices in
// kept order to kept_out (size >= n); returns the kept count, or -1 if a
// range is violated.
int64_t filter_topk_rows(const int64_t* q, const int32_t* score,
                         const int32_t* brank, const int32_t* arank,
                         int64_t n, int64_t smax, int64_t keep,
                         int64_t* kept_out) {
  if (smax >= (1 << 14)) return -1;
  std::vector<std::pair<uint64_t, int64_t>> rows((size_t)n);
  for (int64_t i = 0; i < n; i++) {
    if (q[i] >= (1 << 22) || score[i] > smax || score[i] < 0 ||
        brank[i] >= (1 << 10) || arank[i] >= (1 << 18))
      return -1;
    uint64_t key = ((uint64_t)q[i] << 42) |
                   ((uint64_t)(smax - score[i]) << 28) |
                   ((uint64_t)brank[i] << 18) | (uint64_t)arank[i];
    rows[(size_t)i] = {key, i};
  }
  std::sort(rows.begin(), rows.end());
  int64_t out = 0;
  int64_t i = 0;
  while (i < n) {
    uint64_t qcur = rows[(size_t)i].first >> 42;
    int64_t start = i;
    while (i < n && (rows[(size_t)i].first >> 42) == qcur) i++;
    int64_t len = i - start;
    int64_t take = len <= keep ? len : keep;
    for (int64_t j = start; j < start + take; j++)
      kept_out[out++] = rows[(size_t)j].second;
    if (len > keep) {
      uint64_t cut_sbits = (rows[(size_t)(start + keep - 1)].first >> 28) &
                           ((1 << 14) - 1);
      for (int64_t j = start + keep; j < i; j++) {
        if (((rows[(size_t)j].first >> 28) & ((1 << 14) - 1)) != cut_sbits)
          break;
        kept_out[out++] = rows[(size_t)j].second;
      }
    }
  }
  return out;
}


int64_t minimizers(const uint8_t* codes, int64_t len, int32_t k, int32_t w,
                   uint64_t* out_hash, int32_t* out_pos, uint8_t* out_strand);

// Batched minimizer sketching over CONCATENATED sequences (one threaded
// call per read set; the per-read ctypes overhead dominated align-stage
// sketching). Sequence i's minimizers land at out_*[out_off[i]] (out_off =
// exclusive scan of the per-seq n_pos bound); counts[i] receives the real
// minimizer count.
void minimizers_batch(const uint8_t* codes, const int64_t* off,
                      int64_t n_seqs, int32_t k, int32_t w,
                      uint64_t* out_hash, int32_t* out_pos,
                      uint8_t* out_strand, const int64_t* out_off,
                      int64_t* counts) {
  parallel_ranges(n_seqs, 64, [&](int64_t b, int64_t e) {
    for (int64_t i = b; i < e; i++) {
      counts[i] = minimizers(codes + off[i], off[i + 1] - off[i], k, w,
                             out_hash + out_off[i], out_pos + out_off[i],
                             out_strand + out_off[i]);
    }
  });
}

// --------------------------------------------------------------- minimizers

static inline uint64_t mm_hash64(uint64_t x, uint64_t mask) {
  x = (~x + (x << 21)) & mask;
  x ^= x >> 24;
  x = (x + (x << 3) + (x << 8)) & mask;
  x ^= x >> 14;
  x = (x + (x << 2) + (x << 4)) & mask;
  x ^= x >> 28;
  x = (x + (x << 31)) & mask;
  return x;
}

// Minimizer sketch matching ops/minimizer.py: position i is selected iff its
// scrambled canonical-packing hash is the min of >= 1 w-window covering it
// (ties kept; strand-symmetric k-mers skipped). Writes up to n_pos entries;
// returns the count.
int64_t minimizers(const uint8_t* codes, int64_t len, int32_t k, int32_t w,
                   uint64_t* out_hash, int32_t* out_pos, uint8_t* out_strand) {
  int64_t n = len - k + 1;
  if (n <= 0) return 0;
  if (n < w) w = (int32_t)n;
  const uint64_t mask = (k < 32) ? ((1ULL << (2 * k)) - 1) : ~0ULL;
  const uint64_t INF = ~0ULL;

  std::vector<uint64_t> h((size_t)n);
  std::vector<uint8_t> strand((size_t)n);
  uint64_t f = 0, r = 0;
  const int shift = 2 * (k - 1);
  for (int64_t i = 0; i < len; i++) {
    uint64_t c = codes[i];
    f = ((f << 2) | c) & mask;
    r = (r >> 2) | ((3ULL - c) << shift);
    if (i >= k - 1) {
      int64_t p = i - k + 1;
      if (f == r) {
        h[p] = INF;  // strand-symmetric: never selected
        strand[p] = 0;
      } else if (r < f) {
        h[p] = mm_hash64(r, mask);
        strand[p] = 1;
      } else {
        h[p] = mm_hash64(f, mask);
        strand[p] = 0;
      }
    }
  }

  // sliding-window minima (monotone deque), then mark ties per window
  std::vector<uint8_t> sel((size_t)n, 0);
  std::vector<int64_t> deque((size_t)n);
  int64_t qh = 0, qt = 0;  // deque [qh, qt)
  for (int64_t i = 0; i < n; i++) {
    while (qt > qh && h[deque[qt - 1]] > h[i]) qt--;
    deque[qt++] = i;
    int64_t win_start = i - w + 1;
    if (deque[qh] < win_start) qh++;
    if (win_start >= 0) {
      uint64_t m = h[deque[qh]];
      if (m != INF) {
        // mark every position in the window achieving the min
        for (int64_t j = qh; j < qt; j++) {
          if (h[deque[j]] == m) sel[deque[j]] = 1;
          else break;  // deque is increasing: later entries are larger
        }
      }
    }
  }

  int64_t cnt = 0;
  for (int64_t p = 0; p < n; p++) {
    if (sel[p]) {
      out_hash[cnt] = h[p];
      out_pos[cnt] = (int32_t)p;
      out_strand[cnt] = strand[p];
      cnt++;
    }
  }
  return cnt;
}

// ----------------------------------------------------------- seed anchoring

// Anchor collection (minimap2 seeding, ops/minimizer.py collect_anchors_batch
// semantics): look up each query minimizer in the ref's unique sorted hash
// table, expand its occurrences (dropped when count == 0 or > max_occ),
// split by relative strand, group rows by (query, strand) and sort each
// group by (rpos, qpos). Two calls share the expensive binary-search pass:
//
//   anchors_count2: per-minimizer (lo, n_plus, n_minus) into scratch arrays
//                   + per-group counts + per-query rep_len (query bases
//                   covered by over-max_occ seeds, merged spans — minimap2's
//                   repeat length feeding the rl:i tag); returns the total
//                   anchor count.
//   anchors_fill:   consumes the scratch, writes flat (rpos, qpos) arrays
//                   with bounds[2q+s] group offsets, sorted within groups.

int64_t anchors_count2(const uint64_t* uh, const int64_t* us,
                       const int64_t* ucnt, int64_t n_uniq,
                       const uint8_t* sort_strand,
                       const uint64_t* qh, const int64_t* qpos,
                       const uint8_t* qstrand,
                       const int64_t* qoff, int64_t n_queries,
                       int64_t max_occ, int32_t k,
                       int64_t* m_lo, int32_t* m_np, int32_t* m_nm,
                       int64_t* gcount /* [2*n_queries], zeroed by caller */,
                       int64_t* rep_len /* [n_queries], zeroed by caller */) {
  // queries are independent (all per-q outputs are disjoint); parallelize
  // across query ranges with per-thread totals
  std::vector<int64_t> partial(16, 0);
  std::atomic<int> tix{0};
  parallel_ranges(n_queries, 256, [&](int64_t qb, int64_t qe) {
    int64_t total = 0;
    for (int64_t q = qb; q < qe; q++) {
      int64_t rep_st = -1, rep_en = -1;  // current merged repeat span
      for (int64_t m = qoff[q]; m < qoff[q + 1]; m++) {
        uint64_t h = qh[m];
        const uint64_t* it = std::lower_bound(uh, uh + n_uniq, h);
        int64_t np = 0, nm = 0, lo = 0;
        if (it != uh + n_uniq && *it == h) {
          int64_t u = it - uh;
          int64_t cnt = ucnt[u];
          if (cnt > max_occ) {
            // high-frequency seed: drop, but count its query span toward the
            // repeat length (spans arrive position-sorted; merge overlaps)
            int64_t st = qpos[m], en = st + k;
            if (st > rep_en) {
              if (rep_st >= 0) rep_len[q] += rep_en - rep_st;
              rep_st = st;
              rep_en = en;
            } else if (en > rep_en) {
              rep_en = en;
            }
          } else if (cnt > 0) {
            lo = us[u];
            uint8_t qs = qstrand[m];
            for (int64_t o = lo; o < lo + cnt; o++) {
              if (sort_strand[o] != qs) nm++;
              else np++;
            }
          }
        }
        m_lo[m] = lo;
        m_np[m] = np;
        m_nm[m] = nm;
        gcount[2 * q] += np;
        gcount[2 * q + 1] += nm;
        total += np + nm;
      }
      if (rep_st >= 0) rep_len[q] += rep_en - rep_st;
    }
    partial[(size_t)(tix++ & 15)] += total;
  });
  int64_t total = 0;
  for (int64_t p : partial) total += p;
  return total;
}

// Segmented anchors_count2: MANY (ref table, query set) groups in ONE call
// (the per-genome python/ctypes call overhead dominates align seeding at
// 10k-read scale — thousands of candidate genomes per run). Per query q:
// its ref's unique table is uh/us/ucnt[useg_off[q] .. +useg_n[q]) and its
// sort arrays start at sseg_off[q]; m_lo receives GLOBAL sort offsets, so
// the existing anchors_fill consumes the scratch unchanged. max_occ is
// per-query (presets can derive it per ref index).
int64_t anchors_count2_seg(const uint64_t* uh, const int64_t* us,
                           const int64_t* ucnt,
                           const int64_t* useg_off, const int64_t* useg_n,
                           const uint8_t* sort_strand,
                           const int64_t* sseg_off,
                           const uint64_t* qh, const int64_t* qpos,
                           const uint8_t* qstrand,
                           const int64_t* qoff, int64_t n_queries,
                           const int64_t* max_occ, int32_t k,
                           int64_t* m_lo, int32_t* m_np, int32_t* m_nm,
                           int64_t* gcount /* [2*n_queries], zeroed */,
                           int64_t* rep_len /* [n_queries], zeroed */) {
  std::vector<int64_t> partial(16, 0);
  std::atomic<int> tix{0};
  parallel_ranges(n_queries, 256, [&](int64_t qb, int64_t qe) {
    int64_t total = 0;
    for (int64_t q = qb; q < qe; q++) {
      const uint64_t* uhq = uh + useg_off[q];
      const int64_t* usq = us + useg_off[q];
      const int64_t* ucq = ucnt + useg_off[q];
      int64_t nu = useg_n[q];
      int64_t sbase = sseg_off[q];
      int64_t occ_cap = max_occ[q];
      int64_t rep_st = -1, rep_en = -1;
      for (int64_t m = qoff[q]; m < qoff[q + 1]; m++) {
        uint64_t h = qh[m];
        const uint64_t* it = std::lower_bound(uhq, uhq + nu, h);
        int64_t np = 0, nm = 0, lo = 0;
        if (it != uhq + nu && *it == h) {
          int64_t u = it - uhq;
          int64_t cnt = ucq[u];
          if (cnt > occ_cap) {
            int64_t st = qpos[m], en = st + k;
            if (st > rep_en) {
              if (rep_st >= 0) rep_len[q] += rep_en - rep_st;
              rep_st = st;
              rep_en = en;
            } else if (en > rep_en) {
              rep_en = en;
            }
          } else if (cnt > 0) {
            lo = usq[u] + sbase;  // GLOBAL sort offset for anchors_fill
            uint8_t qs = qstrand[m];
            for (int64_t o = lo; o < lo + cnt; o++) {
              if (sort_strand[o] != qs) nm++;
              else np++;
            }
          }
        }
        m_lo[m] = lo;
        m_np[m] = np;
        m_nm[m] = nm;
        gcount[2 * q] += np;
        gcount[2 * q + 1] += nm;
        total += np + nm;
      }
      if (rep_st >= 0) rep_len[q] += rep_en - rep_st;
    }
    partial[(size_t)(tix++ & 15)] += total;
  });
  int64_t total = 0;
  for (int64_t p : partial) total += p;
  return total;
}

void anchors_fill(const int32_t* sort_pos, const uint8_t* sort_strand,
                  const int64_t* qpos, const uint8_t* qstrand,
                  const int64_t* qoff, const int64_t* qlen, int64_t n_queries,
                  int32_t k,
                  const int64_t* m_lo, const int32_t* m_np,
                  const int32_t* m_nm,
                  const int64_t* bounds /* [2*n_queries+1] prefix of gcount */,
                  int32_t* out_rpos, int32_t* out_qpos) {
  std::vector<int64_t> cur(2 * (size_t)n_queries);
  for (int64_t g = 0; g < 2 * n_queries; g++) cur[g] = bounds[g];
  // both passes are query-independent (group g = 2q+strand is owned by
  // exactly one query, so cur[g] and the [bounds[g], bounds[g+1]) output
  // ranges are thread-disjoint); parallelize across query ranges
  parallel_ranges(n_queries, 256, [&](int64_t qb, int64_t qe) {
    for (int64_t q = qb; q < qe; q++) {
      for (int64_t m = qoff[q]; m < qoff[q + 1]; m++) {
        int64_t cnt = m_np[m] + m_nm[m];
        if (cnt == 0) continue;
        uint8_t qs = qstrand[m];
        int64_t qp_fwd = qpos[m];
        int64_t qp_rev = qlen[q] - k - qpos[m];
        for (int64_t o = m_lo[m]; o < m_lo[m] + cnt; o++) {
          bool rel = sort_strand[o] != qs;
          int64_t g = 2 * q + (rel ? 1 : 0);
          int64_t at = cur[g]++;
          out_rpos[at] = sort_pos[o];
          out_qpos[at] = (int32_t)(rel ? qp_rev : qp_fwd);
        }
      }
    }
    // per-group (rpos, qpos) sort: pack into one u64 (both are non-negative
    // int32s) so the sort is single-key
    std::vector<uint64_t> keys;
    for (int64_t g = 2 * qb; g < 2 * qe; g++) {
      int64_t a = bounds[g], b = bounds[g + 1];
      int64_t len = b - a;
      if (len <= 1) continue;
      keys.resize((size_t)len);
      for (int64_t i = 0; i < len; i++)
        keys[(size_t)i] = ((uint64_t)(uint32_t)out_rpos[a + i] << 32) |
                          (uint64_t)(uint32_t)out_qpos[a + i];
      std::sort(keys.begin(), keys.end());
      for (int64_t i = 0; i < len; i++) {
        out_rpos[a + i] = (int32_t)(keys[(size_t)i] >> 32);
        out_qpos[a + i] = (int32_t)(keys[(size_t)i] & 0xFFFFFFFFu);
      }
    }
  });
}


// ------------------------------------------------------- SAM line assembly
//
// Full headerless-SAM line bytes for GAPLESS (=/X-only) fast-path records —
// the align stage's host hot loop (engine._fused_finish; replaces the
// per-record python f-string/join work, the reference's equivalent being
// minimap2's own sam.c writer, called by the reference's
// scripts/batch_align.py:264).
// CIGAR is built from each record's sorted mismatch columns; SEQ from the
// forward 2-bit codes (reverse-complemented here when flag has 0x10, so the
// python side never needs the rc string). Tag block layout is fixed:
//   NM ms AS nn tp cm s1 s2 de rl  (de arrives preformatted: python's float
// repr rules are not worth reimplementing; its cardinality is tiny and the
// caller caches the strings).
//
// Two-phase parallel: workers format their record ranges into private
// buffers, then copy into `out` at exact offsets after a prefix scan.
// Returns total bytes written, or -1 if out_cap is too small.

static inline char* sam_put_i64(char* p, int64_t v) {
  if (v < 0) {
    *p++ = '-';
    v = -v;
  }
  char tmp[20];
  int n = 0;
  do {
    tmp[n++] = (char)('0' + (v % 10));
    v /= 10;
  } while (v);
  while (n) *p++ = tmp[--n];
  return p;
}

int64_t assemble_sam_lines(
    int64_t n, const uint8_t* qname_buf, const int64_t* qname_off,
    const int32_t* flag, const uint8_t* rname_buf, const int64_t* rname_off,
    const int32_t* cid, const int32_t* pos, const int32_t* mapq,
    const int32_t* mis_cols, const int64_t* mis_off, const int32_t* qlen,
    const uint8_t* seq_codes, const int64_t* seq_off, const int32_t* dp,
    const int32_t* cm, const int64_t* s1, const int64_t* s2,
    const int32_t* rl, const uint8_t* de_buf, const int64_t* de_off,
    uint8_t* out, int64_t out_cap, int64_t* line_off) {
  static const char FWD[4] = {'A', 'C', 'G', 'T'};
  static const char REV[4] = {'T', 'G', 'C', 'A'};
  unsigned hw = std::thread::hardware_concurrency();
  if (const char* env = std::getenv("PHYLIGN_TPU_NATIVE_THREADS")) {
    long v = std::atol(env);
    if (v > 0) hw = (unsigned)v;
  }
  int64_t t = std::min<int64_t>(hw ? hw : 1, 16);
  t = std::max<int64_t>(1, std::min(t, n / 2048));
  int64_t chunk = (n + t - 1) / t;
  std::vector<std::string> bufs((size_t)t);
  std::vector<std::thread> workers;
  for (int64_t w = 0; w < t; w++) {
    int64_t b = w * chunk, e = std::min(n, b + chunk);
    if (b >= e) break;
    std::string* buf = &bufs[(size_t)w];
    workers.emplace_back([=] {
      // conservative bound per record: fields + 20-digit ints + cigar runs
      int64_t bound = 0;
      for (int64_t i = b; i < e; i++)
        bound += 220 + (qname_off[i + 1] - qname_off[i]) +
                 (rname_off[cid[i] + 1] - rname_off[cid[i]]) + qlen[i] +
                 12 * (mis_off[i + 1] - mis_off[i]) +
                 (de_off[i + 1] - de_off[i]);
      buf->resize((size_t)bound);
      char* p = &(*buf)[0];
      const char* base = p;
      for (int64_t i = b; i < e; i++) {
        line_off[i + 1] = -(int64_t)(p - base);  // length marker, fixed below
        int64_t qn = qname_off[i + 1] - qname_off[i];
        std::memcpy(p, qname_buf + qname_off[i], (size_t)qn);
        p += qn;
        *p++ = '\t';
        p = sam_put_i64(p, flag[i]);
        *p++ = '\t';
        int64_t rn = rname_off[cid[i] + 1] - rname_off[cid[i]];
        std::memcpy(p, rname_buf + rname_off[cid[i]], (size_t)rn);
        p += rn;
        *p++ = '\t';
        p = sam_put_i64(p, pos[i]);
        *p++ = '\t';
        p = sam_put_i64(p, mapq[i]);
        *p++ = '\t';
        // cigar from sorted mismatch columns (coalescing adjacent X)
        int32_t prev = 0, L = qlen[i];
        for (int64_t m = mis_off[i]; m < mis_off[i + 1];) {
          int32_t c = mis_cols[m];
          if (c > prev) {
            p = sam_put_i64(p, c - prev);
            *p++ = '=';
          }
          int64_t m2 = m + 1;
          while (m2 < mis_off[i + 1] && mis_cols[m2] == mis_cols[m2 - 1] + 1)
            m2++;
          p = sam_put_i64(p, m2 - m);
          *p++ = 'X';
          prev = mis_cols[m2 - 1] + 1;
          m = m2;
        }
        if (L > prev) {
          p = sam_put_i64(p, L - prev);
          *p++ = '=';
        }
        std::memcpy(p, "\t*\t0\t0\t", 7);
        p += 7;
        const uint8_t* sc = seq_codes + seq_off[i];
        if (flag[i] & 0x10)
          for (int32_t j = L - 1; j >= 0; j--) *p++ = REV[sc[j] & 3];
        else
          for (int32_t j = 0; j < L; j++) *p++ = FWD[sc[j] & 3];
        std::memcpy(p, "\t*\tNM:i:", 8);
        p += 8;
        p = sam_put_i64(p, mis_off[i + 1] - mis_off[i]);
        std::memcpy(p, "\tms:i:", 6);
        p += 6;
        p = sam_put_i64(p, dp[i]);
        std::memcpy(p, "\tAS:i:", 6);
        p += 6;
        p = sam_put_i64(p, dp[i]);
        std::memcpy(p, "\tnn:i:0\ttp:A:P\tcm:i:", 20);
        p += 20;
        p = sam_put_i64(p, cm[i]);
        std::memcpy(p, "\ts1:i:", 6);
        p += 6;
        p = sam_put_i64(p, s1[i]);
        std::memcpy(p, "\ts2:i:", 6);
        p += 6;
        p = sam_put_i64(p, s2[i]);
        std::memcpy(p, "\tde:f:", 6);
        p += 6;
        int64_t dn = de_off[i + 1] - de_off[i];
        std::memcpy(p, de_buf + de_off[i], (size_t)dn);
        p += dn;
        std::memcpy(p, "\trl:i:", 6);
        p += 6;
        p = sam_put_i64(p, rl[i]);
        line_off[i + 1] += (int64_t)(p - base);  // now the record's length
      }
      buf->resize((size_t)(p - base));
    });
  }
  for (auto& w : workers) w.join();
  line_off[0] = 0;
  for (int64_t i = 0; i < n; i++) line_off[i + 1] += line_off[i];
  if (line_off[n] > out_cap) return -1;
  // copy per-worker buffers to their exact output spans
  int64_t copied = 0;
  for (int64_t w = 0; w < t; w++) {
    const std::string& s = bufs[(size_t)w];
    if (s.empty()) continue;
    std::memcpy(out + copied, s.data(), s.size());
    copied += (int64_t)s.size();
  }
  return line_off[n];
}

}  // extern "C"
