// Native host-side kernels of the PyTorch/CUDA port: the port's own copy of
// the match path's part of phylign_tpu/native/hostio.cpp (minimizers,
// anchoring and SAM assembly belong to the align stage, not ported yet).
//   * canonical 31-mer XXH64 Bloom-row hashing (cobs-compatible: XXH64 of
//     the ASCII canonical k-mer, seed = hash index, mod signature size),
//   * the 03_match text parser, the dedup's unique+inverse and the filter's
//     top-k core.
// Exposed with a plain C ABI for ctypes (phylign_tpu_torch/native/__init__.py,
// which builds it with g++ at first use); numpy implementations remain as the
// portable fallback.

#include <algorithm>
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

}  // extern "C"
