// Match epilogue: kernel B5 of the match stage for Hopper (sm_90a), with a
// plain C interface loaded through ctypes (phylign_tpu_torch/ops/
// _kernels.py).
//
// Replaces the jitted program around the gather + popcount in
// phylign_tpu/models/matcher.py:_hash_topk_flat (jax.jit, :119-165): the
// Bloom rows of _rows_from_hashes_dev with the padding-row mask (:70-92,
// :140-142), the threshold + top-k of _topk_scores (:44-66) and the flat hit
// packing (:144-165). Three kernels, each equal bit for bit to its plain
// PyTorch version in phylign_tpu_torch/models/matcher.py:
//   B5a hash_rows       _hash_rows_ref. A block per query, a thread per
//                       (slot, hash): row = (hi * 2**32 + lo) mod s in 64-bit
//                       unsigned arithmetic (exact for every hash, those
//                       >= 2**63 included), the padding row at or past the
//                       query's k-mer count (whose hashes are not read).
//   B5b threshold_topk  _topk_scores_ref. A warp per score row, 8 rows a
//                       block. One pass over the row's first d scores in
//                       16-byte loads counts s >= cut (n_keep) and compacts
//                       the qualifying (score, doc) pairs in doc order into
//                       the warp's stash (lane counts, a shuffle prefix).
//                       When n_keep > kk, a radix select over 8-bit digits
//                       from the top of the largest qualifying score (a
//                       256-bin histogram a warp, the row re-read from L2
//                       once a digit) finds the kk-th largest score t*, and
//                       one more pass stashes every doc above t* and the
//                       first kk - #{> t*} docs at t*, in doc order. The
//                       stash is then sorted by score, descending, with a
//                       stable LSD radix sort over the score's significant
//                       bytes (one pass below 256), so equal scores keep
//                       doc order: jax.lax.top_k's order, (score desc, doc
//                       asc). Zeros fill the window past min(n_keep, kk).
//                       Up to kSmemKK entries the stash lives in shared
//                       memory; above, in a device workspace of one stash
//                       a warp, each warp looping over rows.
//   B5c pack_hits       _pack_hits_ref. A tile is 32 16-byte chunks of
//                       n_keep's aligned granules, 128 queries (32 << shift
//                       chunks past kPackMaxTiles tiles). Every block reads
//                       all of n_keep in one round of 16-byte loads (up to
//                       16,384 queries) and folds each warp's 32 chunks
//                       into its tile's take sum (min(n_keep, kk)) in
//                       shared memory, waiting on no other block; after one
//                       barrier each warp sums the tiles before its own and
//                       all of them. A warp a tile (a tile a block where the
//                       grid allows) writes its queries' hit words (score
//                       << 16 | doc), consecutive lanes on consecutive
//                       words, word w's query by a search of the lanes'
//                       first words in shuffles. The loads of its first 128
//                       words go out before the fold (they need the tile's
//                       own takes only) and stay in flight, score and doc
//                       apart, until the words are stored. The copy of
//                       n_keep at [cap, cap + Q) goes out before the fold
//                       too; the zeros [min(total, cap), cap) and the total
//                       follow it. Both in 16-byte stores from the first
//                       16-byte boundary on, scalar stores for the head and
//                       tail (out need only be 4-byte aligned). The grid: a
//                       block a tile, or enough blocks for kPackFillStores
//                       16-byte stores a thread, at most a block an SM.
//   B5d merge_topk      _merge_topk_ref. Replaces the second jax.lax.top_k
//                       of phylign_tpu/parallel/dist.py:dist_topk (:107-133)
//                       over the windows gathered from nd doc shards: each
//                       shard's window is sorted (score desc, local doc asc)
//                       with its qualifying count, shard e's docs are
//                       columns [e w_loc, (e + 1) w_loc). The merged window
//                       is a stable descending sort of the takes in shard
//                       order: (score desc, global doc asc), jax.lax.top_k's
//                       order over the gather. A warp a query row, each on
//                       its own (no block barrier); blocks of 8 rows,
//                       halved while the blocks would not give every SM
//                       one. Lane e loads shard e's count; n_keep is their
//                       sum (the psum of dist.py:155), written once. A row
//                       uses min(n_keep, lim, kk) entries of each shard. At
//                       2 shards the first kMergeHeads entries of both
//                       windows load with the counts; a row that uses no
//                       more of either ranks them in registers (an entry's
//                       place plus the other shard's entries ahead of it,
//                       by shuffles), any other by merge path over the
//                       windows in device memory: lane l finds the split
//                       of its diagonal and merges a run of ceil(n / 32)
//                       output ranks in order, shard 0 first on ties. At
//                       more, an entry's rank is its place plus, in every
//                       other window, the entries ahead of it by a binary
//                       search in device memory (a shard before its own:
//                       scores >= its score; after: >). The ranked entries
//                       (docs plus e w_loc) go to the warp's slice of
//                       shared memory, then the row goes out in 16-byte
//                       stores, scalar stores for the head and tail, -1
//                       and doc -1 from registers past the entries (in
//                       chunks of kMergeChunk ranks past it). An empty row
//                       ranks nothing and stores fillers only.
//
// What bounds it on an H100: bytes. B5b reads the [Q, 32 Wp] int32 score
// matrix B1/B2 wrote (80 MB at Q = 9,216, Wp = 68) and writes the [Q, kk]
// window; B5a reads the int64 hash halves (16 bytes a slot) and writes the
// int32 rows; B5c reads n_keep and the taken entries and writes the flat
// buffer; B5d writes the [Q, kk] windows whole, fillers included (most of
// a sparse merge's bytes), and reads about the entries that reach them. The
// design reads every score once in the usual case (n_keep <= kk), keeps
// one row's work inside one warp (no atomics to device memory; B5c's
// block barriers only share a tile's counts), and
// launches each kernel once a call: 4 kernels a _hash_topk_flat call with
// B1/B2, against about 59 torch kernels.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBins = 256;
// B5b: rows (warps) a block, the largest kk whose stash lives in shared
// memory, and the most device workspace the larger ones take
constexpr int kTopkWarps = 8;
constexpr int kSmemKK = 512;
constexpr int64_t kWsBudget = (int64_t)256 << 20;
// B5c: threads a block; 16-byte loads of n_keep in flight a thread; the
// most tiles (their sums in shared memory, 32 KB); rounds of 32 hit words
// a warp loads before it stores them; the zeros' 16-byte stores a thread
// the grid is sized for; the most blocks, one an SM of an H100
constexpr int kPackThreads = 256;
constexpr int kPackWarps = kPackThreads / 32;
constexpr int kPackLoads = 16;
constexpr int kPackMaxTiles = 8192;
constexpr int kPackRounds = 4;
constexpr int kPackFillStores = 4;
constexpr int kPackMaxBlocks = 132;

// the warp's exclusive prefix of x in lane order; total gets the sum
__device__ __forceinline__ int warp_excl(int x, int lane, int& total) {
  int inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += y;
  }
  total = __shfl_sync(kFull, inc, 31);
  return inc - x;
}

// ---------------------------------------------------------------------------
// B5a: Bloom rows
// ---------------------------------------------------------------------------

__global__ void hash_rows_kernel(const int64_t* __restrict__ hi,
                                 const int64_t* __restrict__ lo,
                                 const int32_t* __restrict__ nk, int kh, int h,
                                 uint64_t s, int32_t pad_row,
                                 int32_t* __restrict__ rows) {
  const int64_t base = (int64_t)blockIdx.x * kh;
  const int n = nk[blockIdx.x];
  for (int e = threadIdx.x; e < kh; e += blockDim.x) {
    int32_t r = pad_row;
    if (e / h < n) {
      const uint64_t x = ((uint64_t)hi[base + e] << 32) | (uint64_t)(uint32_t)lo[base + e];
      r = (int32_t)(x % s);
    }
    rows[base + e] = r;
  }
}

// ---------------------------------------------------------------------------
// B5b: threshold + top-k
// ---------------------------------------------------------------------------

// blocks of a launch: one row a warp, or with a workspace as many as the
// workspace budget allows (each warp then loops over rows)
__host__ __device__ inline int64_t topk_blocks(int q, int kk) {
  const int64_t need = ((int64_t)q + kTopkWarps - 1) / kTopkWarps;
  if (kk <= kSmemKK) return need;
  const int64_t fit = kWsBudget / ((int64_t)kTopkWarps * 16 * kk);
  return need < fit ? need : (fit > 1 ? fit : 1);
}

// the 16-byte load holding docs j .. j + 3 of a row, -1 (never qualifies)
// where j >= d
__device__ __forceinline__ int4 load4(const int32_t* row, int j, int d) {
  return j < d ? __ldg(reinterpret_cast<const int4*>(row + j)) : make_int4(-1, -1, -1, -1);
}

// the lane's 4 docs of chunk `j0` (doc j0 + t), -1 past d
struct Four {
  int32_t x[4];
  __device__ __forceinline__ void set(int4 v, int j0, int d) {
    x[0] = v.x;
    x[1] = j0 + 1 < d ? v.y : -1;
    x[2] = j0 + 2 < d ? v.z : -1;
    x[3] = j0 + 3 < d ? v.w : -1;
  }
};

constexpr int kUnroll = 4;  // 16-byte loads in flight a lane

// stash the flagged docs of every lane's Four in doc order at n .. n + count
// (entries at or past kk dropped); returns the warp's count
__device__ __forceinline__ int stash_flagged(const Four& f, const bool (&fl)[4], int j0, int lane,
                                             int n, int kk, int32_t* sv, int32_t* sd) {
  const int cnt = fl[0] + fl[1] + fl[2] + fl[3];
  if (!__any_sync(kFull, cnt)) return 0;
  int total;
  int pos = n + warp_excl(cnt, lane, total);
#pragma unroll
  for (int t = 0; t < 4; t++) {
    if (fl[t]) {
      if (pos < kk) {
        sv[pos] = f.x[t];
        sd[pos] = j0 + t;
      }
      pos++;
    }
  }
  return total;
}

// the 8-bit digit bin (from the top) that holds the rem-th largest entry of
// the warp's histogram: returns the bin, sets `above` to the entries in the
// bins above it. Lane l owns bins 255 - 8l down to 248 - 8l.
__device__ __forceinline__ int select_bin(const int* hist, int lane, int rem, int& above) {
  int own = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) own += hist[255 - 8 * lane - i];
  int total;
  int cum = warp_excl(own, lane, total);
  int found = -1, fab = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    const int b = 255 - 8 * lane - i;
    const int hb = hist[b];
    if (found < 0 && cum < rem && rem <= cum + hb) {
      found = b;
      fab = cum;
    }
    cum += hb;
  }
  const int src = __ffs(__ballot_sync(kFull, found >= 0)) - 1;
  above = __shfl_sync(kFull, fab, src);
  return __shfl_sync(kFull, found, src);
}

// Output: vals, idx int32 [Q, kk], n_keep int32 [Q]. Shared memory: a
// 256-bin histogram a warp, then (no workspace) the warp's two stash
// buffers of kk (score, doc) pairs; with a workspace the buffers are its
// 4 * kk words a warp.
__global__ void __launch_bounds__(kTopkWarps * 32)
    threshold_topk_kernel(const int32_t* __restrict__ scores, int64_t stride,
                          const int32_t* __restrict__ cut, int q, int d, int kk,
                          int32_t* __restrict__ ws, int32_t* __restrict__ vals,
                          int32_t* __restrict__ idx, int32_t* __restrict__ n_keep) {
  extern __shared__ __align__(16) int32_t smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gw = blockIdx.x * kTopkWarps + warp;
  int* hist = smem + warp * kBins;
  int32_t* buf = ws ? ws + (int64_t)gw * 4 * kk : smem + kTopkWarps * kBins + warp * 4 * kk;
  const int64_t n_warps = (int64_t)gridDim.x * kTopkWarps;

  for (int64_t row = gw; row < q; row += n_warps) {
    const int32_t* srow = scores + row * stride;
    const int32_t c = cut[row];
    int32_t *sv = buf, *sd = buf + kk, *tv = buf + 2 * kk, *td = buf + 3 * kk;

    // pass 1: n_keep, the largest qualifying score, and the qualifying docs
    // in doc order while they fit the window
    int n = 0;
    int32_t mx = 0;
    for (int base = 0; base < d; base += 128 * kUnroll) {
      int4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; u++) v[u] = load4(srow, base + 128 * u + 4 * lane, d);
#pragma unroll
      for (int u = 0; u < kUnroll; u++) {
        const int j0 = base + 128 * u + 4 * lane;
        Four f;
        f.set(v[u], j0, d);
        bool fl[4];
#pragma unroll
        for (int t = 0; t < 4; t++) {
          fl[t] = f.x[t] >= 0 && f.x[t] >= c;
          if (fl[t]) mx = max(mx, f.x[t]);
        }
        n += stash_flagged(f, fl, j0, lane, n, kk, sv, sd);
      }
    }
    mx = (int32_t)__reduce_max_sync(kFull, (unsigned)mx);
    __syncwarp();

    if (n > kk && kk > 0) {
      // radix select of the kk-th largest qualifying score t*
      int rem = kk;
      uint32_t prefix = 0;
      const int top = mx > 0 ? 31 - __clz(mx) : 0;
      for (int shift = (top / 8) * 8; shift >= 0; shift -= 8) {
        for (int b = lane; b < kBins; b += 32) hist[b] = 0;
        __syncwarp();
        const uint32_t hmask = shift + 8 >= 32 ? 0u : ~0u << (shift + 8);
        for (int base = 0; base < d; base += 128 * kUnroll) {
          int4 v[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; u++) v[u] = load4(srow, base + 128 * u + 4 * lane, d);
#pragma unroll
          for (int u = 0; u < kUnroll; u++) {
            Four f;
            f.set(v[u], base + 128 * u + 4 * lane, d);
#pragma unroll
            for (int t = 0; t < 4; t++) {
              const int32_t x = f.x[t];
              if (x >= 0 && x >= c && ((uint32_t)x & hmask) == prefix)
                atomicAdd(&hist[((uint32_t)x >> shift) & 255], 1);
            }
          }
        }
        __syncwarp();
        int above;
        const int b = select_bin(hist, lane, rem, above);
        rem -= above;
        prefix |= (uint32_t)b << shift;
        __syncwarp();
      }
      const int32_t tstar = (int32_t)prefix;
      const int need_eq = rem;  // docs at t* the window takes, the first in doc order
      // the window's docs in doc order: every doc above t*, the first
      // need_eq at t*
      int m = 0, eq_seen = 0;
      for (int base = 0; base < d; base += 128 * kUnroll) {
        int4 v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; u++) v[u] = load4(srow, base + 128 * u + 4 * lane, d);
#pragma unroll
        for (int u = 0; u < kUnroll; u++) {
          const int j0 = base + 128 * u + 4 * lane;
          Four f;
          f.set(v[u], j0, d);
          const int ce = (f.x[0] == tstar) + (f.x[1] == tstar) + (f.x[2] == tstar) + (f.x[3] == tstar);
          int te;
          int e = eq_seen + warp_excl(ce, lane, te);
          bool fl[4];
#pragma unroll
          for (int t = 0; t < 4; t++) {
            const bool eq = f.x[t] == tstar;
            fl[t] = f.x[t] > tstar || (eq && e < need_eq);
            e += eq;
          }
          eq_seen += te;
          m += stash_flagged(f, fl, j0, lane, m, kk, sv, sd);
        }
      }
      __syncwarp();
    }

    // stable LSD radix sort of the stash by score, descending: one pass a
    // significant byte of the largest score (stashed: it is in the window)
    const int m = n < kk ? n : kk;
    const int passes = (m > 1 && mx > 0) ? (31 - __clz(mx)) / 8 + 1 : 0;
    for (int p = 0; p < passes; p++) {
      const int shift = 8 * p;
      for (int b = lane; b < kBins; b += 32) hist[b] = 0;
      __syncwarp();
      for (int i = lane; i < m; i += 32) atomicAdd(&hist[((uint32_t)sv[i] >> shift) & 255], 1);
      __syncwarp();
      {  // each bin's first position: the entries in the bins above it
        int own = 0;
#pragma unroll
        for (int i = 0; i < 8; i++) own += hist[255 - 8 * lane - i];
        int total;
        int cum = warp_excl(own, lane, total);
#pragma unroll
        for (int i = 0; i < 8; i++) {
          const int b = 255 - 8 * lane - i;
          const int hb = hist[b];
          hist[b] = cum;
          cum += hb;
        }
      }
      __syncwarp();
      for (int i0 = 0; i0 < m; i0 += 32) {
        const int i = i0 + lane;
        const bool act = i < m;
        const int dg = act ? (int)(((uint32_t)sv[i] >> shift) & 255) : kBins + lane;
        const unsigned peers = __match_any_sync(kFull, dg);
        const unsigned before = peers & ((1u << lane) - 1u);
        const int pos = act ? hist[dg] + __popc(before) : 0;
        __syncwarp();
        if (act) {
          if (before == 0) hist[dg] += __popc(peers);
          tv[pos] = sv[i];
          td[pos] = sd[i];
        }
        __syncwarp();
      }
      int32_t* x = sv;
      sv = tv;
      tv = x;
      x = sd;
      sd = td;
      td = x;
    }

    int32_t* vrow = vals + row * kk;
    int32_t* irow = idx + row * kk;
    for (int r = lane; r < kk; r += 32) {
      const bool in = r < m;
      vrow[r] = in ? sv[r] : 0;
      irow[r] = in ? sd[r] : 0;
    }
    if (lane == 0) n_keep[row] = n;
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// B5c: flat hit packing
// ---------------------------------------------------------------------------

// the hit word (score << 16 | doc) of a window entry's score and doc
__device__ __forceinline__ int32_t hit_word(int32_t score, int32_t doc) {
  return (int32_t)(((uint32_t)score << 16) | (uint32_t)doc);
}

// the takes min(n_keep, kk) of chunk c's 4 queries 4c - a .. 4c - a + 3
// (0 for a word of the granule outside [0, q))
__device__ __forceinline__ void chunk_takes(int4 v, int c, int a, int q, int kk, int (&tk)[4]) {
  const int e = 4 * c - a;
  tk[0] = e >= 0 && e < q ? min(v.x, kk) : 0;
  tk[1] = e + 1 >= 0 && e + 1 < q ? min(v.y, kk) : 0;
  tk[2] = e + 2 >= 0 && e + 2 < q ? min(v.z, kk) : 0;
  tk[3] = e + 3 < q ? min(v.w, kk) : 0;
}

// The 16-byte granules of out's words [lo, hi): the first word of the
// first whole granule at or past lo (a word is 16-byte aligned where mis +
// its index is a multiple of 4, mis: out's first word in its granule), the
// count of whole granules, and the first word past them.
struct Granules {
  int64_t p0, n, pb;
  __device__ __forceinline__ Granules(int64_t lo, int64_t hi, int mis) {
    p0 = lo + ((4 - ((mis + lo) & 3)) & 3);
    n = p0 < hi ? (hi - p0) >> 2 : 0;
    pb = p0 + 4 * n;
  }
  // the head [lo, p0) and tail [pb, hi), at most 3 words each: word i of
  // the 6 (-1 past them)
  __device__ __forceinline__ int64_t edge(int64_t lo, int64_t hi, int i) const {
    const int64_t w = i < 3 ? lo + i : pb + i - 3;
    return w < (i < 3 ? min(p0, hi) : hi) ? w : -1;
  }
};

// One pass of a warp: 32 chunks (128 queries) from chunk c0, a chunk a
// lane: the lane's 4 takes, its first word in the pass, the pass's words.
// Word w of the pass goes to lane w % 32, kPackRounds rounds of 32 words a
// batch: its chunk's lane is the last lane whose first word is <= w (a
// search of the lanes' first words in shuffles), its query and column by
// that lane's takes.
struct PackPass {
  int c0, tk[4], first, n;

  __device__ __forceinline__ void load(const int4* nk4, int c0_, int nchunks, int a, int q, int kk,
                                       int lane) {
    c0 = c0_;
    const int c = c0 + lane;
    chunk_takes(c < nchunks ? __ldg(nk4 + c) : make_int4(0, 0, 0, 0), c, a, q, kk, tk);
    first = warp_excl(tk[0] + tk[1] + tk[2] + tk[3], lane, n);
  }

  // the scores and docs of the words w0 + 32 r + lane below lim of a
  // batch, loaded (0 past lim): packed only when stored, so that the loads
  // stay in flight until then
  __device__ __forceinline__ void words(const int32_t* vals, const int32_t* idx, int a, int kk, int w0,
                                        int lim, int lane, int32_t (&sv)[kPackRounds],
                                        int32_t (&sd)[kPackRounds]) const {
#pragma unroll
    for (int r = 0; r < kPackRounds; r++) {
      const int w = w0 + 32 * r + lane;
      sv[r] = sd[r] = 0;
      if (w0 + 32 * r < lim) {
        int l = 0;
#pragma unroll
        for (int step = 16; step; step >>= 1)
          if (__shfl_sync(kFull, first, l + step) <= w) l += step;
        int col = w - __shfl_sync(kFull, first, l), k = 0;
#pragma unroll
        for (int y = 0; y < 3; y++) {
          const int ty = __shfl_sync(kFull, tk[y], l);
          if (k == y && col >= ty) {
            col -= ty;
            k++;
          }
        }
        if (w < lim) {
          const int64_t at = (int64_t)(4 * (c0 + l) - a + k) * kk + col;
          sv[r] = __ldg(vals + at);
          sd[r] = __ldg(idx + at);
        }
      }
    }
  }
};

// chunks b + u kPackThreads + t of n_keep's granules (0 past nchunks)
__device__ __forceinline__ void load_round(const int4* nk4, int b, int nchunks, int t,
                                           int4 (&v)[kPackLoads]) {
#pragma unroll
  for (int u = 0; u < kPackLoads; u++) {
    const int c = b + u * kPackThreads + t;
    v[u] = c < nchunks ? __ldg(nk4 + c) : make_int4(0, 0, 0, 0);
  }
}

// the sum of s_tile[0 .. j) and of all nt entries, to every lane of the warp
__device__ __forceinline__ void tile_sums(const int* s_tile, int nt, int j, int lane, int& before,
                                          int& all) {
  int b = 0, t = 0;
  for (int i = lane; i < nt; i += 32) {
    const int x = s_tile[i];
    b += i < j ? x : 0;
    t += x;
  }
  before = (int)__reduce_add_sync(kFull, (unsigned)b);
  all = (int)__reduce_add_sync(kFull, (unsigned)t);
}

// Output: int32 [cap + Q + 1] = [cap hit words | Q n_keep | total]. Tile j
// is chunks j << (5 + shift) .. of n_keep's granules; nt tiles. out need
// only be 4-byte aligned.
__global__ void __launch_bounds__(kPackThreads)
    pack_hits_kernel(const int32_t* __restrict__ vals, const int32_t* __restrict__ idx,
                     const int32_t* __restrict__ n_keep, int q, int kk, int cap, int shift, int nt,
                     int32_t* __restrict__ out) {
  extern __shared__ int s_tile[];  // each tile's takes
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int a = (int)(((uintptr_t)n_keep >> 2) & 3);  // n_keep's first word in its granule
  const int4* nk4 = reinterpret_cast<const int4*>(n_keep - a);
  const int nchunks = (q + a + 3) >> 2;
  // tiles a warp at a time, consecutive tiles on consecutive blocks
  const int j0 = warp * gridDim.x + blockIdx.x, tile_step = gridDim.x * kPackWarps;

  // 1. every tile's takes: n_keep in rounds of kPackLoads 16-byte loads a
  // thread (one round up to 16,384 queries), folded a warp's 32 chunks at
  // a time. The first round's loads go out first, then the loads of the
  // warp's first batch of hit words (they need its tile's takes, not where
  // the tile starts), then the copy of n_keep, then the fold.
  int4 v[kPackLoads];
  load_round(nk4, 0, nchunks, t, v);
  PackPass pass;
  int32_t sv[kPackRounds], sd[kPackRounds];
  if (j0 < nt) {
    pass.load(nk4, j0 << (5 + shift), nchunks, a, q, kk, lane);
    pass.words(vals, idx, a, kk, 0, pass.n, lane, sv, sd);
  }
  // the copy of n_keep at [cap, cap + q) needs no take (16-byte loads
  // where its words and n_keep's share their place in the granule)
  const int mis = (int)(((uintptr_t)out >> 2) & 3);  // out's first word in its granule
  const int64_t gt = (int64_t)blockIdx.x * kPackThreads + t, gstride = (int64_t)gridDim.x * kPackThreads;
  {
    const Granules g(cap, (int64_t)cap + q, mis);
    const bool same = ((mis + cap - a) & 3) == 0;
    for (int64_t k = gt; k < g.n; k += gstride) {
      const int64_t p = g.p0 + 4 * k;
      const int32_t* src = n_keep + (p - cap);
      *reinterpret_cast<int4*>(out + p) =
          same ? __ldg(reinterpret_cast<const int4*>(src)) : make_int4(src[0], src[1], src[2], src[3]);
    }
    if (blockIdx.x == 0 && t < 6) {
      const int64_t w = g.edge(cap, (int64_t)cap + q, t);
      if (w >= 0) out[w] = n_keep[w - cap];
    }
  }
  if (shift) {  // several warps' chunks add to a tile
    for (int j = t; j < nt; j += kPackThreads) s_tile[j] = 0;
    __syncthreads();
  }
  for (int b = 0;;) {
    int sum[kPackLoads];
#pragma unroll
    for (int u = 0; u < kPackLoads; u++) {
      int tk[4];
      chunk_takes(v[u], b + u * kPackThreads + t, a, q, kk, tk);
      sum[u] = (int)__reduce_add_sync(kFull, (unsigned)(tk[0] + tk[1] + tk[2] + tk[3]));
    }
    if (lane == 0) {
#pragma unroll
      for (int u = 0; u < kPackLoads; u++) {
        const int c0 = b + u * kPackThreads + warp * 32;
        if (c0 < nchunks) {
          if (shift) atomicAdd(&s_tile[c0 >> (5 + shift)], sum[u]);
          else s_tile[c0 >> 5] = sum[u];
        }
      }
    }
    b += kPackThreads * kPackLoads;
    if (b >= nchunks) break;
    load_round(nk4, b, nchunks, t, v);
  }
  __syncthreads();
  // 2. the total, and where the warp's first tile starts
  int base, total;
  tile_sums(s_tile, nt, j0, lane, base, total);

  // 3. the zeros [min(total, cap), cap) in 16-byte stores (head and tail by
  // the last block), and the total
  {
    const int used = min(total, cap);
    const Granules g(used, cap, mis);
    for (int64_t k = gt; k < g.n; k += gstride)
      *reinterpret_cast<int4*>(out + g.p0 + 4 * k) = make_int4(0, 0, 0, 0);
    if (blockIdx.x == gridDim.x - 1 && t < 7) {
      const int64_t w = t < 6 ? g.edge(used, cap, t) : (int64_t)cap + q;
      if (w >= 0) out[w] = t < 6 ? 0 : total;
    }
  }

  // 4. the hit words, the first batch from the loads of step 1
  for (int j = j0; j < nt; j += tile_step) {
    if (j != j0) tile_sums(s_tile, nt, j, lane, base, total);
    const int c_end = min(nchunks, (j + 1) << (5 + shift));
    for (int c0 = j << (5 + shift); c0 < c_end && base < cap; c0 += 32) {
      const bool loaded = j == j0 && c0 == j0 << (5 + shift);
      if (!loaded) pass.load(nk4, c0, nchunks, a, q, kk, lane);
      const int lim = min(pass.n, cap - base);  // the pass's words below cap
      for (int w0 = 0; w0 < lim; w0 += 32 * kPackRounds) {
        if (!(loaded && w0 == 0)) pass.words(vals, idx, a, kk, w0, lim, lane, sv, sd);
#pragma unroll
        for (int r = 0; r < kPackRounds; r++) {
          const int w = w0 + 32 * r + lane;
          if (w < lim) out[base + w] = hit_word(sv[r], sd[r]);
        }
      }
      base += pass.n;
    }
  }
}

// ---------------------------------------------------------------------------
// B5d: the merge of per-shard windows
// ---------------------------------------------------------------------------

constexpr int kMaxShards = 16;
// rows a block at most (a warp a row, no block barrier)
constexpr int kMergeRows = 8;
// output ranks a warp builds in shared memory at once; a row of kk above
// it goes out in chunks of it (its slice: 2 KB for each of values and doc
// ids)
constexpr int kMergeChunk = 508;
// entries of each of 2 shards a row loads with its counts, and ranks in
// registers when it uses no more of either
constexpr int kMergeHeads = 4;
// blocks of 8 rows an SM holds at once (at most 48 registers a thread):
// 660 on an H100, so a sparse merge's 541 blocks run in one wave
constexpr int kMergeMinBlocks = 5;

// Shard e's window: vals, idx int32 rows of stride[e] words, the first
// lim[e] entries of a row usable, sorted (score desc, doc asc); n_keep int32
// [Q] (null: no doc qualifies, an empty window).
struct Windows {
  const int32_t* vals[kMaxShards];
  const int32_t* idx[kMaxShards];
  const int32_t* n_keep[kMaxShards];
  int stride[kMaxShards];
  int lim[kMaxShards];
};

// Words of a warp's slice for each of values and doc ids: a chunk of
// output ranks from any word of 16 bytes on, rounded to 16 bytes
__host__ __device__ __forceinline__ int merge_slot(int chunk) { return (chunk + 6) & ~3; }

// entries of a descending run v[0 .. n) above x (or at least x, when ge)
__device__ __forceinline__ int count_ahead(const int32_t* v, int n, int32_t x, bool ge) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const int32_t y = __ldg(v + mid);
    if (y > x || (ge && y == x)) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// Output ranks [lo, hi) of the merge of two runs in device memory (a before
// b on ties) into rv, ri (rank c at c - c0; doc ids plus add_a, add_b), by
// merge path: lane l takes a run of ceil((hi - lo) / 32) ranks from its
// diagonal's split and merges it in order, each head's score and doc
// loaded together
__device__ __forceinline__ void merge_two(const int32_t* __restrict__ av, const int32_t* __restrict__ ai,
                                          int a, int add_a, const int32_t* __restrict__ bv,
                                          const int32_t* __restrict__ bi, int b, int add_b, int lo, int hi,
                                          int c0, int32_t* rv, int32_t* ri, int lane) {
  const int per = (hi - lo + 31) >> 5;
  int d = lo + lane * per;
  const int d1 = min(d + per, hi);
  if (d >= d1) return;
  // a's entries among the first d outputs: a[i] is one iff a[i] >= b[d - 1 - i]
  int i = max(0, d - b), i1 = min(d, a);
  while (i < i1) {
    const int mid = (i + i1) >> 1;
    if (__ldg(av + mid) >= __ldg(bv + d - 1 - mid)) i = mid + 1;
    else i1 = mid;
  }
  int j = d - i;
  int32_t x = 0, xi = 0, y = 0, yi = 0;
  if (i < a) {
    x = __ldg(av + i);
    xi = __ldg(ai + i);
  }
  if (j < b) {
    y = __ldg(bv + j);
    yi = __ldg(bi + j);
  }
  for (; d < d1; d++) {
    if (j >= b || (i < a && x >= y)) {
      rv[d - c0] = x;
      ri[d - c0] = xi + add_a;
      if (++i < a) {
        x = __ldg(av + i);
        xi = __ldg(ai + i);
      }
    } else {
      rv[d - c0] = y;
      ri[d - c0] = yi + add_b;
      if (++j < b) {
        y = __ldg(bv + j);
        yi = __ldg(bi + j);
      }
    }
  }
}

// n output words of a row to device memory at dst, which sits at word m of
// its 16 bytes: word k is s[m + k] (s 16-byte aligned) for k < nv, else -1
// (a filler, from registers); 16-byte stores from dst's first 16-byte
// boundary on, scalar stores for the head and tail; by one warp
__device__ __forceinline__ void store_row(int32_t* __restrict__ dst, const int32_t* s, int n, int nv, int m,
                                          int lane) {
  const int head = min(n, (4 - m) & 3);
  const int nb = (n - head) >> 2;
  int4* d4 = reinterpret_cast<int4*>(dst + head);
  const int4* s4 = reinterpret_cast<const int4*>(s + m + head);
  for (int g = lane; g < nb; g += 32) {
    const int k = head + 4 * g;
    int4 x = make_int4(-1, -1, -1, -1);
    if (k < nv) {
      x = s4[g];
      if (k + 1 >= nv) x.y = -1;
      if (k + 2 >= nv) x.z = -1;
      if (k + 3 >= nv) x.w = -1;
    }
    d4[g] = x;
  }
  const int tail = head + 4 * nb;
  const int k = lane < head ? lane : (lane >= 4 && lane < 4 + n - tail ? tail + lane - 4 : -1);
  if (k >= 0) dst[k] = k < nv ? s[m + k] : -1;
}

// Output: vals, idx int32 [Q, kk] (16-byte aligned), n_keep int32 [Q]. A
// block of `rows` warps, a warp a query row, each warp on its own (no
// block barrier); output ranks in chunks of `chunk`.
__global__ void __launch_bounds__(kMergeRows * 32, kMergeMinBlocks)
    merge_topk_kernel(Windows w, int nd, int w_loc, int q, int kk, int rows, int chunk,
                      int32_t* __restrict__ vals, int32_t* __restrict__ idx, int32_t* __restrict__ n_keep) {
  extern __shared__ int4 merge_smem[];
  __shared__ int cnt_s[kMergeRows][kMaxShards];
  const int wp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * rows + wp;
  if (row >= q) return;
  const int slot = merge_slot(chunk);
  int32_t* rv = reinterpret_cast<int32_t*>(merge_smem) + 2 * wp * slot;
  int32_t* ri = rv + slot;

  // 1. the row's counts, lane e shard e's; n_keep, their sum. At 2 shards
  // the heads load with them: lane l < 2 kMergeHeads holds entry l %
  // kMergeHeads of shard l / kMergeHeads
  const int32_t nk = lane < nd && w.n_keep[lane] ? __ldg(w.n_keep[lane] + row) : 0;
  const int he = lane / kMergeHeads, hk = lane % kMergeHeads;
  int32_t hv = 0, hid = 0;
  if (nd == 2 && he < 2 && hk < w.lim[he]) {
    hv = __ldg(w.vals[he] + row * w.stride[he] + hk);
    hid = __ldg(w.idx[he] + row * w.stride[he] + hk);
  }
  const int c = lane < nd ? min(max(nk, 0), min(w.lim[lane], kk)) : 0;  // entries used
  const int total = __reduce_add_sync(kFull, c);
  const int sum = __reduce_add_sync(kFull, nk);
  if (lane == 0) n_keep[row] = sum;
  if (lane < nd) cnt_s[wp][lane] = c;
  __syncwarp();

  // 2. a row of 2 shards that uses at most kMergeHeads of each ranks its
  // entries from the heads: its place in its run plus the other run's
  // entries ahead of it (for shard 0: scores > its score; for shard 1: >=)
  const int n0 = __shfl_sync(kFull, c, 0), n1 = __shfl_sync(kFull, c, 1);
  const bool from_heads = nd == 2 && n0 <= kMergeHeads && n1 <= kMergeHeads;
  int hrank = -1;
  if (from_heads && total > 0) {  // the same for the whole warp
    const int other = he ? n0 : n1;
    int rank = hk;
#pragma unroll
    for (int m = 0; m < kMergeHeads; m++) {
      const int32_t y = __shfl_sync(kFull, hv, (1 - he) * kMergeHeads + m);
      rank += m < other && (he ? y >= hv : y > hv);
    }
    if (he < 2 && hk < (he ? n1 : n0)) hrank = rank;
  }

  // 3. each chunk of output ranks: the row's entries placed in the warp's
  // slice (doc + e w_loc) at the row's word of 16 bytes, then the chunk
  // written in 16-byte stores, fillers from registers past the entries. An
  // empty row places nothing.
  const int valid = min(total, kk);
  for (int c0 = 0; c0 < kk; c0 += chunk) {
    const int c1 = min(c0 + chunk, kk), hi = min(c1, valid);
    const int64_t o = row * kk + c0;
    const int m = (int)(o & 3);
    if (hi > c0) {
      if (from_heads) {
        if (hrank >= c0 && hrank < hi) {
          rv[m + hrank - c0] = hv;
          ri[m + hrank - c0] = hid + he * w_loc;
        }
      } else if (nd == 2) {
        merge_two(w.vals[0] + row * w.stride[0], w.idx[0] + row * w.stride[0], n0, 0,
                  w.vals[1] + row * w.stride[1], w.idx[1] + row * w.stride[1], n1, w_loc, c0, hi, c0 - m, rv,
                  ri, lane);
      } else {
        // an entry's rank: its place in its own run plus, in every other
        // run, the entries ahead of it by a binary search (a shard before
        // its own: scores >= its score; after: scores > it)
        for (int e = 0; e < nd; e++) {
          const int n = min(cnt_s[wp][e], hi);
          const int32_t* ve = w.vals[e] + row * w.stride[e];
          const int32_t* ie = w.idx[e] + row * w.stride[e];
          for (int j = lane; j < n; j += 32) {
            const int32_t x = __ldg(ve + j);
            int rank = j;
            for (int f = 0; f < nd && rank < hi; f++)
              if (f != e) rank += count_ahead(w.vals[f] + row * w.stride[f], cnt_s[wp][f], x, f < e);
            if (rank >= c0 && rank < hi) {
              rv[m + rank - c0] = x;
              ri[m + rank - c0] = __ldg(ie + j) + e * w_loc;
            }
          }
        }
      }
      __syncwarp();
    }
    store_row(vals + o, rv, c1 - c0, hi - c0, m, lane);
    store_row(idx + o, ri, c1 - c0, hi - c0, m, lane);
    if (c1 < kk) __syncwarp();
  }
}

}  // namespace

extern "C" {

// B5a. hi, lo: int64 [Q, K, H] hash halves below 2**32; nk int32 [Q];
// rows int32 [Q, K, H]. 0 < s < 2**31. Returns a cudaError_t (0 on success).
int phylign_hash_rows(const void* hi, const void* lo, const void* nk, int q,
                      int k, int h, int64_t s, int pad_row, void* rows,
                      void* stream) {
  if (q <= 0 || k <= 0 || h <= 0) return 0;
  if (s <= 0 || s >= ((int64_t)1 << 31) || (int64_t)k * h >= ((int64_t)1 << 31))
    return (int)cudaErrorInvalidValue;
  const int kh = k * h;
  const int threads = kh >= 256 ? 256 : ((kh + 31) / 32) * 32;
  hash_rows_kernel<<<q, threads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)hi, (const int64_t*)lo, (const int32_t*)nk, kh, h,
      (uint64_t)s, (int32_t)pad_row, (int32_t*)rows);
  return (int)cudaGetLastError();
}

// B5b's device workspace in bytes for q rows and a window of kk: 0 when
// the stash fits shared memory (kk <= kSmemKK).
int64_t phylign_threshold_topk_workspace(int q, int kk) {
  if (kk <= kSmemKK || q <= 0) return 0;
  return topk_blocks(q, kk) * kTopkWarps * 16 * (int64_t)kk;
}

// B5b. scores: int32 rows of `stride` words (stride % 4 == 0, 16-byte
// aligned, stride >= d rounded up to 4), every score >= 0; cut int32 [Q];
// vals, idx int32 [Q, kk]; n_keep int32 [Q]. 0 <= kk <= d. ws:
// phylign_threshold_topk_workspace(q, kk) bytes (null when that is 0).
int phylign_threshold_topk(const void* scores, int64_t stride, const void* cut,
                           int q, int d, int kk, void* ws, void* vals,
                           void* idx, void* n_keep, void* stream) {
  if (q <= 0) return 0;
  if (d < 0 || kk < 0 || kk > d || stride < ((d + 3) / 4) * 4 || stride % 4 != 0 ||
      ((uintptr_t)scores & 15) || ((kk > kSmemKK) != (ws != nullptr)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kTopkWarps * 4 * (kBins + (ws ? 0 : 4 * kk));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        threshold_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  threshold_topk_kernel<<<(unsigned)topk_blocks(q, kk), kTopkWarps * 32, smem, (cudaStream_t)stream>>>(
      (const int32_t*)scores, stride, (const int32_t*)cut, q, d, kk, (int32_t*)ws,
      (int32_t*)vals, (int32_t*)idx, (int32_t*)n_keep);
  return (int)cudaGetLastError();
}

// B5c. vals, idx int32 [Q, kk]; n_keep int32 [Q]; out int32 [cap + Q + 1]
// (4-byte aligned: any word offset).
int phylign_pack_hits(const void* vals, const void* idx, const void* n_keep,
                      int q, int kk, int cap, void* out, void* stream) {
  if (q < 0 || kk < 0 || cap < 0) return (int)cudaErrorInvalidValue;
  // tiles of 32 << shift chunks, at most kPackMaxTiles; a block a tile, or
  // kPackFillStores 16-byte stores a thread of the words past the hits
  // (at most cap + q + 1), at most kPackMaxBlocks
  const int64_t nchunks = ((int64_t)q + (((uintptr_t)n_keep >> 2) & 3) + 3) / 4;
  int shift = 0;
  while (((nchunks + (32 << shift) - 1) >> (5 + shift)) > kPackMaxTiles) shift++;
  const int nt = (int)((nchunks + (32 << shift) - 1) >> (5 + shift));
  const int64_t stores = ((int64_t)cap + q + 4) / 4;
  const int64_t by_stores = (stores + kPackThreads * kPackFillStores - 1) / (kPackThreads * kPackFillStores);
  int64_t grid = nt > by_stores ? nt : by_stores;
  grid = grid < 1 ? 1 : (grid > kPackMaxBlocks ? kPackMaxBlocks : grid);
  pack_hits_kernel<<<(unsigned)grid, kPackThreads, nt * sizeof(int), (cudaStream_t)stream>>>(
      (const int32_t*)vals, (const int32_t*)idx, (const int32_t*)n_keep, q, kk, cap, shift, nt,
      (int32_t*)out);
  return (int)cudaGetLastError();
}

// B5d. nd windows (vals[e], idx[e], n_keep[e], stride[e], lim[e]: see
// Windows; nd <= kMaxShards); out_vals, out_idx int32 [Q, kk], 16-byte
// aligned; out_n int32 [Q]. The host arrays are read at the call. Rows a
// block: 8, halved while the blocks would not give every SM of the card
// one; output ranks a chunk: kk, at most kMergeChunk.
int phylign_merge_topk(int nd, const void* const* vals, const void* const* idx,
                       const void* const* n_keep, const int* stride, const int* lim, int w_loc,
                       int q, int kk, void* out_vals, void* out_idx, void* out_n, void* stream) {
  if (q <= 0) return 0;
  if (nd < 1 || nd > kMaxShards || kk < 0 || w_loc < 0 || (((uintptr_t)out_vals | (uintptr_t)out_idx) & 15))
    return (int)cudaErrorInvalidValue;
  Windows w{};
  for (int e = 0; e < nd; e++) {
    if (stride[e] < lim[e] || lim[e] < 0 || (lim[e] > 0 && (!vals[e] || !idx[e])))
      return (int)cudaErrorInvalidValue;
    w.vals[e] = (const int32_t*)vals[e];
    w.idx[e] = (const int32_t*)idx[e];
    w.n_keep[e] = (const int32_t*)n_keep[e];
    w.stride[e] = stride[e];
    w.lim[e] = lim[e];
  }
  int dev = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  int rows = kMergeRows;
  while (rows > 1 && ((int64_t)q + rows - 1) / rows < n_sm) rows >>= 1;
  const int chunk = kk < 1 ? 1 : (kk < kMergeChunk ? kk : kMergeChunk);
  const int smem = rows * 2 * merge_slot(chunk) * 4;
  const unsigned grid = (unsigned)(((int64_t)q + rows - 1) / rows);
  merge_topk_kernel<<<grid, rows * 32, smem, (cudaStream_t)stream>>>(
      w, nd, w_loc, q, kk, rows, chunk, (int32_t*)out_vals, (int32_t*)out_idx, (int32_t*)out_n);
  return (int)cudaGetLastError();
}

const char* phylign_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
