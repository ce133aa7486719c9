// A candidate genome's minimizer table on the card: the sketch of its
// contigs (ref_sketch) and the table's order by hash (ref_sort), with a
// plain C interface loaded through ctypes (phylign_tpu_torch/ops/_kernels.py).
//
// Replaces no TPU kernel: the JAX package and the port's CPU path build the
// table on the host (ops/minimizer.build_ref_index: the native sketch of
// native/hostio.cpp, then np.argsort(h, kind="stable")), which left the align
// stage's producer threads 0.24-0.35 s a genome of host work. Contract
// (phylign_tpu_torch/ops/minimizer.py: ref_sketch_ref, ref_sort_ref):
//   codes        uint8 [T]   the genome's concatenated codes (0-3), guards
//                            included
//   c_start/len  int64 [C]   each contig's [start, start + len) in codes
//   tile_first   int32 [C+1] the first sketch tile of each contig (a tile is
//                            kSketchTile k-mer positions of one contig)
// ref_sketch selects, in each contig, position p (a k-mer start) where the
// masked mm_hash64 of its canonical 2-bit packing is the minimum of at least
// one window of w positions of the contig (ties kept; w = the contig's
// positions where it has fewer than w; strand-symmetric k-mers never), and
// writes (hash, contig start + p, strand) in position order. ref_sort orders
// them by hash, ties by position: np.argsort(h, kind="stable") over the
// position-ordered sketch.
//
// The design:
//   * ref_sketch, two passes over tiles of kSketchTile positions, a block a
//     tile: the block hashes its positions and the w - 1 on each side from
//     the codes staged in shared memory, takes each window's minimum and
//     tests each position against the windows covering it; a thread rolls
//     the k-mers of a run of consecutive positions. The count pass writes
//     each tile's count and ref_scan_kernel their exclusive sum (the total
//     at [n_tiles]: the wrapper reads it to size the table); the write pass
//     computes the tile again and writes its selected positions in order
//     (a ballot a warp, the warps' counts summed in shared memory).
//   * ref_sort, a stable LSD radix sort of 8-bit digits over the hash's
//     2k bits (6 passes at k = 21), a pass three launches: a histogram of
//     each block's kSortTile items (digit-major), ref_scan_kernel (a block a
//     digit: the blocks' offsets within the digit, and its total), and a
//     stable scatter (each block adds the digits' totals' exclusive sum;
//     __match_any_sync ranks each item among the warp's items of its digit,
//     the warps' counts a digit summed in shared memory, a running offset a
//     digit carried over the block's rounds). Position and
//     strand travel as one 32-bit value (pos << 1 | strand); the first pass
//     packs them, the last unpacks. No bucket can overflow: the sort has no
//     buckets, so a repetitive genome's many equal hashes cost what any
//     table of their count costs.
// What bounds them: the codes read once and the table written once (the
// least bytes, 13.5 MB for a 4.25 Mb genome: 4 us at 3.35 TB/s); the sort's
// passes read and write the table 6 times more, and a genome this size is
// too small to fill the card, so launch gaps and the scans' single blocks
// weigh as much as the bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSketchTile = 1024;  // k-mer positions a block
constexpr int kKMax = 31;          // 2k bits fit a u64 below its top bit
constexpr int kWMax = 255;         // minimap2's largest window
constexpr int kSpan = kSketchTile + 2 * (kWMax - 1);  // positions a tile hashes
constexpr int kSortTile = 2048;    // items a block a sort pass
constexpr int kBins = 256;         // 8-bit digits
constexpr unsigned kFull = 0xffffffffu;
constexpr uint64_t kInf = ~0ull;   // a strand-symmetric k-mer's hash
static_assert(kThreads == kBins, "a thread a digit in the sort's blocks");

__device__ __forceinline__ uint64_t mm_hash64(uint64_t x, uint64_t mask) {
  x = (~x + (x << 21)) & mask;
  x ^= x >> 24;
  x = (x + (x << 3) + (x << 8)) & mask;
  x ^= x >> 14;
  x = (x + (x << 2) + (x << 4)) & mask;
  x ^= x >> 28;
  x = (x + (x << 31)) & mask;
  return x;
}

// The contig of tile b: the last c with tile_first[c] <= b (contigs without
// positions have no tile and share their successor's first).
__device__ int tile_contig(const int32_t* tile_first, int n_contigs, int b) {
  int lo = 0, hi = n_contigs - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (tile_first[mid] <= b) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// The exclusive sum of v over the block's kThreads threads; *total their
// sum. Every thread calls it; s_warp holds kWarps entries.
__device__ __forceinline__ int32_t block_exclusive(int32_t v, int32_t* s_warp, int32_t* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int32_t x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  int32_t pre = 0, tot = 0;
  for (int i = 0; i < kWarps; i++) {
    pre += i < warp ? s_warp[i] : 0;
    tot += s_warp[i];
  }
  __syncthreads();  // s_warp is the next call's
  *total = tot;
  return pre + x - v;
}

// Row blockIdx.x of data (rows of len entries) replaced by its exclusive
// sum, in place; totals[blockIdx.x] = the row's sum. A block a row, in
// coalesced chunks of kThreads entries.
__global__ void __launch_bounds__(kThreads) ref_scan_kernel(int32_t* data, int len, int32_t* totals) {
  __shared__ int32_t s_warp[kWarps];
  int32_t* row = data + (int64_t)blockIdx.x * len;
  int32_t carry = 0;
  for (int base = 0; base < len; base += kThreads) {
    const int i = base + threadIdx.x;
    const int32_t v = i < len ? row[i] : 0;
    int32_t tot;
    const int32_t ex = block_exclusive(v, s_warp, &tot);
    if (i < len) row[i] = carry + ex;
    carry += tot;
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

// kWrite false: tile_cnt[b] = the tile's selected positions. kWrite true:
// tile_cnt holds their exclusive sum; the tile's positions are written there.
template <bool kWrite>
__global__ void __launch_bounds__(kThreads) ref_sketch_kernel(
    const uint8_t* __restrict__ codes, const int64_t* __restrict__ c_start,
    const int64_t* __restrict__ c_len, const int32_t* __restrict__ tile_first,
    int n_contigs, int k, int w, int32_t* __restrict__ tile_cnt,
    uint64_t* __restrict__ out_hash, int32_t* __restrict__ out_pos,
    uint8_t* __restrict__ out_strand) {
  __shared__ uint8_t s_codes[kSpan + kKMax];
  __shared__ uint8_t s_strand[kSpan];
  __shared__ uint64_t s_h[kSpan];
  __shared__ uint64_t s_wmin[kSketchTile + kWMax];
  __shared__ int32_t s_warp[kWarps];

  const int b = blockIdx.x, t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int c = tile_contig(tile_first, n_contigs, b);
  const int64_t gs = c_start[c];
  const int n = (int)(c_len[c] - k + 1);  // > 0: the contig has a tile
  const int wc = n < w ? n : w;
  const int nw = n - wc + 1;               // windows
  const int p0 = (b - tile_first[c]) * kSketchTile;
  const int p1 = min(p0 + kSketchTile, n);
  const int a = max(0, p0 - wc + 1);       // the first position hashed, and window
  const int e = min(n, p1 + wc - 1);       // one past the last position hashed
  const int s_hi = min(nw - 1, p1 - 1);    // the last window
  const int hn = e - a;

  for (int i = t; i < hn + k - 1; i += kThreads) s_codes[i] = codes[gs + a + i];
  __syncthreads();
  // a thread a run of consecutive positions, the k-mers rolled as
  // hostio.cpp's minimizers rolls them (k - 1 codes read ahead of the run)
  const uint64_t mask = (1ull << (2 * k)) - 1;
  const int shift = 2 * (k - 1), run = (hn + kThreads - 1) / kThreads;
  const int i0 = min(hn, t * run), i1 = min(hn, i0 + run);
  uint64_t f = 0, r = 0;
  for (int j = 0; j < k - 1 && i0 < i1; j++) {
    const uint64_t cj = s_codes[i0 + j];
    f = ((f << 2) | cj) & mask;
    r = (r >> 2) | ((3ull - cj) << shift);
  }
  for (int i = i0; i < i1; i++) {
    const uint64_t cj = s_codes[i + k - 1];
    f = ((f << 2) | cj) & mask;
    r = (r >> 2) | ((3ull - cj) << shift);
    uint64_t h;
    uint8_t st = 0;
    if (f == r) {
      h = kInf;
    } else if (r < f) {
      h = mm_hash64(r, mask);
      st = 1;
    } else {
      h = mm_hash64(f, mask);
    }
    s_h[i] = h;
    s_strand[i] = st;
  }
  __syncthreads();
  for (int s = a + t; s <= s_hi; s += kThreads) {
    uint64_t m = s_h[s - a];
    for (int j = 1; j < wc; j++) {
      const uint64_t v = s_h[s - a + j];
      m = v < m ? v : m;
    }
    s_wmin[s - a] = m;
  }
  __syncthreads();

  // p is selected iff a window covering it has its hash as minimum
  auto selected = [&](int p) -> bool {
    const uint64_t hp = s_h[p - a];
    if (hp == kInf) return false;
    const int hi = min(p, nw - 1);
    for (int s = max(0, p - wc + 1); s <= hi; s++)
      if (s_wmin[s - a] == hp) return true;
    return false;
  };

  if (!kWrite) {
    int cnt = 0;
    for (int p = p0 + t; p < p1; p += kThreads) cnt += selected(p);
    for (int o = 16; o > 0; o >>= 1) cnt += __shfl_xor_sync(kFull, cnt, o);
    if (lane == 0) s_warp[warp] = cnt;
    __syncthreads();
    if (t == 0) {
      int tot = 0;
      for (int i = 0; i < kWarps; i++) tot += s_warp[i];
      tile_cnt[b] = tot;
    }
    return;
  }
  int base = tile_cnt[b];
  const unsigned lt = (1u << lane) - 1;
  for (int r0 = p0; r0 < p1; r0 += kThreads) {
    const int p = r0 + t;
    const bool sel = p < p1 && selected(p);
    const unsigned bal = __ballot_sync(kFull, sel);
    if (lane == 0) s_warp[warp] = __popc(bal);
    __syncthreads();
    int off = base, tot = 0;
    for (int i = 0; i < kWarps; i++) {
      off += i < warp ? s_warp[i] : 0;
      tot += s_warp[i];
    }
    if (sel) {
      const int o = off + __popc(bal & lt);
      out_hash[o] = s_h[p - a];
      out_pos[o] = (int32_t)(gs + p);
      out_strand[o] = s_strand[p - a];
    }
    __syncthreads();  // s_warp is the next round's
    base += tot;
  }
}

// hist[d * nblocks + b] = block b's items of digit d.
__global__ void __launch_bounds__(kThreads) ref_sort_hist_kernel(const uint64_t* __restrict__ keys, int m,
                                                              int shift, int nblocks,
                                                              int32_t* __restrict__ hist) {
  __shared__ int32_t s_cnt[kBins];
  s_cnt[threadIdx.x] = 0;
  __syncthreads();
  const int i0 = blockIdx.x * kSortTile, i1 = min(i0 + kSortTile, m);
  for (int i = i0 + threadIdx.x; i < i1; i += kThreads)
    atomicAdd(&s_cnt[(int)((keys[i] >> shift) & (kBins - 1))], 1);
  __syncthreads();
  hist[threadIdx.x * nblocks + blockIdx.x] = s_cnt[threadIdx.x];
}

// One stable pass: block b's items go, in order within each digit, to
// offs[d * nblocks + b] (the offset within digit d) + the totals
// offs[kBins * nblocks + d'] of the digits d' < d on. kFirst reads pos and strand apart, kLast writes
// them apart; between, they travel as pos << 1 | strand.
template <bool kFirst, bool kLast>
__global__ void __launch_bounds__(kThreads) ref_sort_scatter_kernel(
    const uint64_t* __restrict__ keys, const uint32_t* __restrict__ vals,
    const int32_t* __restrict__ pos_in, const uint8_t* __restrict__ strand_in, int m, int shift,
    int nblocks, const int32_t* __restrict__ offs, uint64_t* __restrict__ keys_out,
    uint32_t* __restrict__ vals_out, int32_t* __restrict__ pos_out,
    uint8_t* __restrict__ strand_out) {
  __shared__ int32_t s_run[kBins];
  __shared__ int32_t s_wc[kWarps * kBins];
  __shared__ int32_t s_warp[kWarps];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const unsigned lt = (1u << lane) - 1;
  int32_t all;  // the digits' first slots: the exclusive sum of their totals
  s_run[t] = offs[t * nblocks + blockIdx.x] + block_exclusive(offs[kBins * nblocks + t], s_warp, &all);
  const int i0 = blockIdx.x * kSortTile, i1 = min(i0 + kSortTile, m);
  for (int r0 = i0; r0 < i1; r0 += kThreads) {
    const int i = r0 + t;
    const bool valid = i < i1;
    uint64_t key = 0;
    uint32_t val = 0;
    int d = kBins;  // matches no item's digit
    if (valid) {
      key = keys[i];
      val = kFirst ? ((uint32_t)pos_in[i] << 1) | strand_in[i] : vals[i];
      d = (int)((key >> shift) & (kBins - 1));
    }
    for (int j = t; j < kWarps * kBins; j += kThreads) s_wc[j] = 0;
    __syncthreads();
    const unsigned peers = __match_any_sync(kFull, d);
    if (valid && lane == __ffs(peers) - 1) s_wc[warp * kBins + d] = __popc(peers);
    __syncthreads();
    if (valid) {
      int o = s_run[d] + __popc(peers & lt);
      for (int j = 0; j < warp; j++) o += s_wc[j * kBins + d];
      keys_out[o] = key;
      if (kLast) {
        pos_out[o] = (int32_t)(val >> 1);
        strand_out[o] = (uint8_t)(val & 1u);
      } else {
        vals_out[o] = val;
      }
    }
    __syncthreads();
    int add = 0;
    for (int j = 0; j < kWarps; j++) add += s_wc[j * kBins + t];
    s_run[t] += add;
    __syncthreads();  // s_wc is zeroed for the next round
  }
}

int sort_blocks(int64_t m) { return (int)((m + kSortTile - 1) / kSortTile); }

}  // namespace

extern "C" {

// Every function returns a cudaError_t (0 on success) and launches on stream.

// write 0: tile_cnt[0..n_tiles] = the exclusive sum of each tile's selected
// positions, the total at [n_tiles]. write 1: the positions into out_hash
// (uint64 bits), out_pos and out_strand, tile_cnt as write 0 left it.
// tile must be the kernels' kSketchTile; 1 <= k <= 31, 1 <= w <= 255.
int phylign_ref_sketch(const void* codes, const void* c_start, const void* c_len,
                       const void* tile_first, int n_contigs, int n_tiles, int tile, int k,
                       int w, int write, void* tile_cnt, void* out_hash, void* out_pos,
                       void* out_strand, void* stream) {
  if (tile != kSketchTile || k < 1 || k > kKMax || w < 1 || w > kWMax || n_tiles < 0 ||
      n_contigs < 1)
    return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const auto* cd = (const uint8_t*)codes;
  const auto* cs = (const int64_t*)c_start;
  const auto* cl = (const int64_t*)c_len;
  const auto* tf = (const int32_t*)tile_first;
  auto* cnt = (int32_t*)tile_cnt;
  if (!write) {
    ref_sketch_kernel<false><<<n_tiles, kThreads, 0, s>>>(cd, cs, cl, tf, n_contigs, k, w, cnt,
                                                          nullptr, nullptr, nullptr);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ref_scan_kernel<<<1, kThreads, 0, s>>>(cnt, n_tiles, cnt + n_tiles);
    return (int)cudaGetLastError();
  }
  ref_sketch_kernel<true><<<n_tiles, kThreads, 0, s>>>(cd, cs, cl, tf, n_contigs, k, w, cnt,
                                                       (uint64_t*)out_hash, (int32_t*)out_pos,
                                                       (uint8_t*)out_strand);
  return (int)cudaGetLastError();
}

// The int32 entries of ref_sort's histogram workspace for m items.
int64_t phylign_ref_sort_hist_len(int64_t m) { return (int64_t)kBins * (sort_blocks(m) + 1); }

// (hash, pos, strand) of m items in position order -> out_* ordered by hash
// (its low `bits` bits; the rest must be 0), ties in their order. keys_a/b
// uint64 [m] and vals_a/b uint32 [m] are the passes' ping-pong buffers, hist
// int32 [phylign_ref_sort_hist_len(m)]. 1 <= bits <= 64.
int phylign_ref_sort(const void* hash, const void* pos, const void* strand, int64_t m64, int bits,
                     void* keys_a, void* vals_a, void* keys_b, void* vals_b, void* hist,
                     void* out_hash, void* out_pos, void* out_strand, void* stream) {
  if (m64 < 0 || m64 > 0x7fffffff || bits < 1 || bits > 64) return (int)cudaErrorInvalidValue;
  if (m64 == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const int m = (int)m64, nb = sort_blocks(m64), passes = (bits + 7) / 8;
  auto* h = (int32_t*)hist;
  const uint64_t* src_k = (const uint64_t*)hash;
  const uint32_t* src_v = nullptr;
  uint64_t* bk[2] = {(uint64_t*)keys_a, (uint64_t*)keys_b};
  uint32_t* bv[2] = {(uint32_t*)vals_a, (uint32_t*)vals_b};
  const auto* pin = (const int32_t*)pos;
  const auto* sin = (const uint8_t*)strand;
  auto* ok = (uint64_t*)out_hash;
  auto* op = (int32_t*)out_pos;
  auto* os = (uint8_t*)out_strand;
  for (int p = 0; p < passes; p++) {
    const int shift = 8 * p;
    const bool first = p == 0, last = p == passes - 1;
    ref_sort_hist_kernel<<<nb, kThreads, 0, s>>>(src_k, m, shift, nb, h);
    ref_scan_kernel<<<kBins, kThreads, 0, s>>>(h, nb, h + kBins * nb);
    uint64_t* dk = last ? ok : bk[p & 1];
    uint32_t* dv = bv[p & 1];
    if (first && last)
      ref_sort_scatter_kernel<true, true><<<nb, kThreads, 0, s>>>(src_k, nullptr, pin, sin, m, shift, nb, h, dk, nullptr, op, os);
    else if (first)
      ref_sort_scatter_kernel<true, false><<<nb, kThreads, 0, s>>>(src_k, nullptr, pin, sin, m, shift, nb, h, dk, dv, nullptr, nullptr);
    else if (last)
      ref_sort_scatter_kernel<false, true><<<nb, kThreads, 0, s>>>(src_k, src_v, nullptr, nullptr, m, shift, nb, h, dk, nullptr, op, os);
    else
      ref_sort_scatter_kernel<false, false><<<nb, kThreads, 0, s>>>(src_k, src_v, nullptr, nullptr, m, shift, nb, h, dk, dv, nullptr, nullptr);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    src_k = dk;
    src_v = dv;
  }
  return 0;
}

const char* phylign_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
