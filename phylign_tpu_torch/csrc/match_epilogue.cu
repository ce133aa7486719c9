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
//   B5c pack_hits       _pack_hits_ref. Blocks of 256 queries: each block
//                       sums min(n_keep, kk) over every query before its own
//                       (read from L2, so no block waits on another) for its
//                       first offset, ranks its own by a block scan, and
//                       writes its contiguous run of (score << 16 | doc)
//                       words with consecutive threads (each finds its query
//                       by a binary search of the block's offsets); words at
//                       or past cap are dropped. Each block writes its
//                       queries' n_keep, block 0 the total, and all blocks
//                       share out zeroing [min(total, cap), cap), with
//                       blocks past the queries' added so that about 4,096
//                       words fall to a block.
//
// What bounds it on an H100: bytes. B5b reads the [Q, 32 Wp] int32 score
// matrix B1/B2 wrote (80 MB at Q = 9,216, Wp = 68) and writes the [Q, kk]
// window; B5a reads the int64 hash halves (16 bytes a slot) and writes the
// int32 rows; B5c reads n_keep and the taken entries and writes the flat
// buffer. The design reads every score once in the usual case (n_keep <=
// kk), keeps one row's work inside one warp (no block barrier, no atomics
// to device memory), and launches each kernel once a call: 4 kernels a
// _hash_topk_flat call with B1/B2, against about 59 torch kernels.

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
// B5c: queries a block, and the most blocks a launch adds to zero words
constexpr int kPackThreads = 256;
constexpr int64_t kPackZeroBlocks = 1024;

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

// Output: int32 [cap + Q + 1] = [cap hit words | Q n_keep | total].
__global__ void __launch_bounds__(kPackThreads)
    pack_hits_kernel(const int32_t* __restrict__ vals, const int32_t* __restrict__ idx,
                     const int32_t* __restrict__ n_keep, int q, int kk, int cap,
                     int32_t* __restrict__ out) {
  constexpr int kWarps = kPackThreads / 32;
  __shared__ int s_before[kWarps], s_total[kWarps], s_own[kWarps];
  __shared__ int s_off[kPackThreads];  // each query's first word, from the block's first
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int q0 = blockIdx.x * kPackThreads;

  // unrolled so that several loads are in flight in each thread
  int before = 0, total = 0;
#pragma unroll 8
  for (int r = t; r < q; r += kPackThreads) {
    const int tk = min(n_keep[r], kk);
    total += tk;
    before += r < q0 ? tk : 0;
  }
  before = __reduce_add_sync(kFull, before);
  total = __reduce_add_sync(kFull, total);
  const int r = q0 + t;
  const int tk = r < q ? min(n_keep[r], kk) : 0;
  int wsum;
  const int excl = warp_excl(tk, lane, wsum);
  if (lane == 0) {
    s_before[warp] = before;
    s_total[warp] = total;
    s_own[warp] = wsum;
  }
  __syncthreads();
  int first = 0, all = 0, woff = 0, own = 0;
#pragma unroll
  for (int x = 0; x < kWarps; x++) {
    first += s_before[x];
    all += s_total[x];
    woff += x < warp ? s_own[x] : 0;
    own += s_own[x];
  }
  s_off[t] = woff + excl;
  if (r < q) out[cap + r] = n_keep[r];
  if (blockIdx.x == 0 && t == 0) out[cap + q] = all;
  __syncthreads();

  // the block's words first .. first + own - 1 that fall below cap, in
  // order, by consecutive threads
  const int n_copy = max(0, min(own, cap - first));
  for (int w = t; w < n_copy; w += kPackThreads) {
    int a = 0, b = kPackThreads - 1;  // the last query whose first word is <= w
    while (a < b) {
      const int mid = (a + b + 1) >> 1;
      if (s_off[mid] <= w) a = mid;
      else b = mid - 1;
    }
    const int64_t src = (int64_t)(q0 + a) * kk + (w - s_off[a]);
    out[first + w] = (int32_t)(((uint32_t)vals[src] << 16) | (uint32_t)idx[src]);
  }
  // the unused words [min(total, cap), cap), shared out over the blocks
  const int used = min(all, cap);
  for (int64_t x = used + (int64_t)blockIdx.x * kPackThreads + t; x < cap;
       x += (int64_t)gridDim.x * kPackThreads)
    out[x] = 0;
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

// B5c. vals, idx int32 [Q, kk]; n_keep int32 [Q]; out int32 [cap + Q + 1].
int phylign_pack_hits(const void* vals, const void* idx, const void* n_keep,
                      int q, int kk, int cap, void* out, void* stream) {
  if (q < 0 || kk < 0 || cap < 0) return (int)cudaErrorInvalidValue;
  // a block per 256 queries, and at least a block per 4,096 words to zero
  // (up to kPackZeroBlocks): the blocks past the queries only zero
  const int64_t qb = ((int64_t)q + kPackThreads - 1) / kPackThreads;
  const int64_t zb = (((int64_t)cap + 4095) / 4096) < kPackZeroBlocks ? ((int64_t)cap + 4095) / 4096 : kPackZeroBlocks;
  const unsigned grid = (unsigned)(qb > zb ? qb : (zb > 0 ? zb : 1));
  pack_hits_kernel<<<grid, kPackThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)vals, (const int32_t*)idx, (const int32_t*)n_keep, q, kk, cap,
      (int32_t*)out);
  return (int)cudaGetLastError();
}

const char* phylign_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
