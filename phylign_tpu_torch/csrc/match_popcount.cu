// Gather + vertical popcount: the match stage's scoring kernels for Hopper
// (sm_90a), with a plain C interface loaded through ctypes
// (phylign_tpu_torch/ops/_kernels.py).
//
// Contract, both kernels (the contract of phylign_tpu/ops/match.py:
// match_scores_xla):
//   words    uint32 [S+1, Wp]  packed Bloom bit-matrix, doc d at word d/32,
//                              bit d%32; row S is all zero (the padding
//                              row, which the kernel does not read)
//   row_idx  int32  [Q, K, H]  Bloom row of hash h of k-mer slot k of query q;
//                              padding slots hold S
//   out      int32  [Q, 32*Wp] out[q, 32*w + b] = number of slots k whose H
//                              rows all have bit b of word w set
//
// B1 replaces phylign_tpu/ops/match.py:match_scores_pallas (body
//    _match_kernel_body): any H, any K < 2**16.
// B2 replaces phylign_tpu/ops/match.py:match_scores_pallas_v2 (body
//    _v2_kernel_body): H == 1, K % 32 == 0 (the Pallas kernel's contract).
// Both run the one kernel below; B2 is its H == 1 instance.
//
// What bounds them on an H100: every query gathers K*H rows of 4*Wp bytes
// (272 B at Wp = 68) at random from a table of 4*(S+1)*Wp bytes (544 MB at
// S = 2M) that the 50 MB L2 cannot hold, and writes 128*Wp bytes: the bytes
// of that gather, not arithmetic. The design:
//   * A thread per (query, word): a warp reads 128 contiguous bytes of a
//     row, and a block of qt queries x Wp threads (one query at Wp = 68)
//     stages its row indices in shared memory first. Small blocks, many of
//     them resident: at Q = 2048 every block is resident at once.
//   * Little arithmetic. Counts are carry-save bit planes: plane j holds bit
//     j of every column's count, P = 8, 12 or 16 planes (K < 2**P). The H
//     rows of a slot are ANDed first; a group of 8 slots (their 8*H loads in
//     flight together) enters the planes through a Harley-Seal tree of 7
//     carry-save adders and one ripple into the upper planes: ~3 logic ops
//     per word and row, where PR 2's B1 spent 32 shift-mask-adds on a
//     counter per bit.
//   * Padding slots cost less: the zero row S is not read (a slot's first
//     row; in the matcher every read has K - n_kmers padding slots).
//   * Whole lines out. The planes are unpacked once, several counts per
//     register, into shared memory; the block then stores its queries'
//     contiguous 128*Wp*qt bytes with 16-byte stores, a warp writing whole
//     lines (straight stores where they would not fit).
// Measured on the card and not kept (PERF.md): 16-byte chunks per thread
// with 16 loads in flight in registers; a shared-memory ring fed by one
// cp.async.bulk copy per row on mbarriers (bound by the issue rate of the
// bulk copies); a ring fed by each thread's own 16-byte cp.async copies.
// None beat a thread per word on the one-hash gather.
//
// Three epilogues share that body (the template parameter EP):
//   store  out = the counts (B1, B2).
//   acc    the row-chunked matcher's accumulator out [Q, 32*Wp] (replaces
//          the jitted _acc_chunk_scores, phylign_tpu/models/matcher.py:
//          838-841, around B2). `words` holds only the global rows
//          [r0, r1) of the index, row r at r - r0, and row_idx holds
//          global rows: a slot counts only when its H rows all lie in the
//          window (a row outside is the JAX package's zero row), so the
//          block needs no zero row and the indices are not remapped per
//          block. Its modes (Epi::mode):
//            add     out += the counts, each 16-byte piece of out loaded,
//                    added to and stored once (match_scores_acc_);
//            first, middle, last, only: a pass over the blocks of the
//                    index (match_scores_acc_planes_). A pass's counts never
//                    exceed K < 2**np (np = bit_length(K)), so between its
//                    blocks the thread of word w keeps them as np bit planes
//                    in the first np int32 of out[q, 32w : 32w+32]: 4*np
//                    bytes, where int32 counts take 128. `first` stores the
//                    block's planes and reads nothing (out may be
//                    uninitialised); `middle` reads them, adds the block's
//                    by a ripple-carry add and stores them back, and skips
//                    both where the block adds nothing; `last` reads, adds
//                    and stores the 32 int32 counts; `only` (a one-block
//                    pass) stores the counts.
//          With the indices staged, each warp first compacts its queries'
//          slots that lie in the window (ballot and popcount prefix, in
//          order) into shared memory, the tail padded to a multiple of 8
//          with slots that read nothing: the threads then walk only those,
//          8 loads in flight a group, where a walk over all K slots spends
//          a latency round on nearly every group (a block of a third of the
//          index holds a third of a query's rows).
//   keep   out = the counts and keep[q, c] = f32(count) >= f32(threshold)
//          * f32(n_kmers[q]) and n_kmers[q] > 0, one byte a column
//          (replaces the jitted match_step, phylign_tpu/models/matcher.py:
//          252-268: the four elementwise ops after B1/B2). The product is
//          rounded once (__fmul_rn, never contracted), as XLA computes it.
//          match_step's Q = 2,048 fills half of the card's threads with
//          one thread a (query, word), each walking 16 groups in turn: so
//          a (query, word) takes `split` = s threads, adjacent lanes of a
//          warp, each counting a contiguous s-th of the slots in its own
//          planes; the partial planes are summed by carry-save (ripple)
//          addition through warp shuffles, and the first of the s threads
//          stores.
//
// Launch geometry (chosen by the caller, ops/match.py:launch_geometry, and
// keep_split and keep_geometry for the split): a block of qt queries x wt x s threads
// (qt * wt * s <= 256); thread t serves query qt*blockIdx.x + t/(wt*s),
// slot share t%s and words (t%(wt*s))/s, that + wt, ...; `staged` says the
// indices fit shared memory, `via_smem` that the counts do.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kGroup = 8;            // slots per carry-save group
constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a block can take

__device__ __forceinline__ void csa(uint32_t& hi, uint32_t& lo, uint32_t a,
                                    uint32_t b, uint32_t c) {
  const uint32_t u = a ^ b;
  hi = (a & b) | (u & c);
  lo = u ^ c;
}

// Carry-save counters of one 32-bit word: count(b) = sum_j bit b of p[j] << j.
template <int P>
struct Planes {
  uint32_t p[P];
  __device__ __forceinline__ void init() {
#pragma unroll
    for (int j = 0; j < P; ++j) p[j] = 0u;
  }
  template <int FROM>
  __device__ __forceinline__ void ripple(uint32_t carry) {
#pragma unroll
    for (int j = FROM; j < P; ++j) {
      const uint32_t t = p[j] & carry;
      p[j] ^= carry;
      carry = t;
    }
  }
  __device__ __forceinline__ void add1(uint32_t x) { ripple<0>(x); }
  // Harley-Seal: 8 words into planes 0..2 through 7 carry-save adders, the
  // carry of weight 8 rippled above
  __device__ __forceinline__ void add8(const uint32_t (&d)[kGroup]) {
    uint32_t t[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) csa(t[i], p[0], p[0], d[2 * i], d[2 * i + 1]);
    csa(t[0], p[1], p[1], t[0], t[1]);
    csa(t[1], p[1], p[1], t[2], t[3]);
    csa(t[0], p[2], p[2], t[0], t[1]);
    ripple<3>(t[0]);
  }
  // this += the P-bit vertical numbers b, a ripple-carry add (no count
  // reaches 2**P, so no carry leaves plane P - 1)
  __device__ __forceinline__ void add(const uint32_t (&b)[P]) {
    uint32_t c = 0u;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const uint32_t u = p[j] ^ b[j];
      const uint32_t carry = (p[j] & b[j]) | (u & c);
      p[j] = u ^ c;
      c = carry;
    }
  }
  __device__ __forceinline__ bool any() const {
    uint32_t x = 0u;
#pragma unroll
    for (int j = 0; j < P; ++j) x |= p[j];
    return x != 0u;
  }
  // the 32 counts of the word, several per register: LANE-bit lanes
  __device__ __forceinline__ void unpack(int32_t (&cnt)[32]) const {
    constexpr int LANE = P <= 8 ? 8 : 16;
    constexpr uint32_t ONES = P <= 8 ? 0x01010101u : 0x00010001u;
    constexpr uint32_t MASK = (1u << LANE) - 1u;
#pragma unroll
    for (int i = 0; i < LANE; ++i) {
      uint32_t acc = 0u;
#pragma unroll
      for (int j = 0; j < P; ++j) acc |= ((p[j] >> i) & ONES) << j;
#pragma unroll
      for (int m = 0; m < 32 / LANE; ++m)
        cnt[i + LANE * m] = (int32_t)((acc >> (LANE * m)) & MASK);
    }
  }
};

// planes 0..np-1 of a word from / to the first np int32 of its 128-byte
// span (16-byte pieces where whole; planes np..P-1 read as 0)
template <int P>
__device__ __forceinline__ void load_planes(const int32_t* span, int np, uint32_t (&b)[P]) {
#pragma unroll
  for (int j = 0; j < P; j += 4) {
    if (j + 4 <= np) {
      const int4 v = *reinterpret_cast<const int4*>(span + j);
      b[j] = v.x;
      b[j + 1] = v.y;
      b[j + 2] = v.z;
      b[j + 3] = v.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) b[j + i] = j + i < np ? (uint32_t)span[j + i] : 0u;
    }
  }
}

template <int P>
__device__ __forceinline__ void store_planes(int32_t* span, int np, const uint32_t (&b)[P]) {
#pragma unroll
  for (int j = 0; j < P; j += 4) {
    if (j + 4 <= np) {
      *reinterpret_cast<int4*>(span + j) = make_int4(b[j], b[j + 1], b[j + 2], b[j + 3]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (j + i < np) span[j + i] = (int32_t)b[j + i];
    }
  }
}

__device__ __forceinline__ int32_t clamp_row(int32_t r, int32_t last) {
  // clamp into [0, S] as XLA's gather does: a bad index reads a real row
  // (the zero row when too large), never outside the table
  return r < 0 ? 0 : (r > last ? last : r);
}

// The epilogues (see the head of the file) and what each takes beyond the
// counts' pointer `out`.
enum Epilogue { kStore = 0, kAcc = 1, kKeep = 2 };
enum AccMode { kAdd = 0, kFirst = 1, kMiddle = 2, kLast = 3, kOnly = 4 };
struct Epi {
  int32_t r0;                   // kAcc: words holds global rows [r0, r0 + n)
  uint32_t n;
  int mode;                     // kAcc: an AccMode
  int np;                       // kAcc: planes a word keeps, bit_length(K)
  const int32_t* n_kmers;       // kKeep: [Q]
  float threshold;              // kKeep: already rounded to f32
  uint8_t* keep;                // kKeep: [Q, 32 * Wp], 16-byte aligned
};

// kAcc: whether global row g lies in the window (wrapping past n for g < r0)
__device__ __forceinline__ bool in_window(int32_t g, const Epi& e) {
  return (uint32_t)g - (uint32_t)e.r0 < e.n;
}

// kAcc: word w of global row g, or 0 where g lies outside the window
__device__ __forceinline__ uint32_t window_word(const uint32_t* col, int32_t g, const Epi& e, int wp) {
  return in_window(g, e) ? __ldg(col + (int64_t)((uint32_t)g - (uint32_t)e.r0) * wp) : 0u;
}

// 16 bytes of 4 counts, added to what `at` holds when `add`
__device__ __forceinline__ void put4(int4* at, int4 v, bool add) {
  if (add) {
    const int4 a = *at;
    v = make_int4(a.x + v.x, a.y + v.y, a.z + v.z, a.w + v.w);
  }
  *at = v;
}

// kAcc, staged: one warp (or the block's last, partial warp: nl lanes)
// writes the slots of row_idx's query that lie wholly in the window, in
// order, to dst, pads them to a multiple of 8 (at most K) with slots whose
// rows are r1 (outside: read as nothing) and returns their count
__device__ __forceinline__ int compact_slots(const int32_t* __restrict__ src, int32_t* dst, int k,
                                             int hh, const Epi& e, int lane, int nl, unsigned mask) {
  int n = 0;
  for (int base = 0; base < k; base += nl) {
    const int j = base + lane;
    bool in = j < k;
    for (int t = 0; in && t < hh; ++t) in = in_window(src[j * hh + t], e);
    const unsigned b = __ballot_sync(mask, in);
    if (in) {
      const int at = n + __popc(b & ((1u << lane) - 1u));
      for (int t = 0; t < hh; ++t) dst[at * hh + t] = src[j * hh + t];
    }
    n += __popc(b);
  }
  const int np = min((n + kGroup - 1) / kGroup * kGroup, k);
  const int32_t out = e.r0 + (int32_t)e.n;
  for (int i = n * hh + lane; i < np * hh; i += nl) dst[i] = out;
  return np;
}

// HC: H at compile time (1 or 3), or 0 for a runtime h.
template <int P, int HC, int EP>
__global__ void __launch_bounds__(kMaxThreads)
match_popcount_kernel(const uint32_t* __restrict__ words, int32_t n_rows,
                      int wp, const int32_t* __restrict__ row_idx, int q,
                      int k, int h, int qt, int wt, int split, int staged,
                      int via_smem, Epi e, int32_t* __restrict__ out) {
  // shared memory: [qt, K*H] row indices (when staged), under kAcc then
  // [qt] slot counts, then [qt, 32*Wp] counts (when via_smem), each 16-byte
  // aligned
  extern __shared__ int4 smem[];
  const int hh = HC ? HC : h;
  const int kh = k * hh;
  const int s = EP == kKeep ? split : 1;
  const int q0 = blockIdx.x * qt;
  const int nq = min(qt, q - q0);
  const int32_t last = n_rows - 1;
  const bool compacted = EP == kAcc && staged;
  int32_t* rows_s = reinterpret_cast<int32_t*>(smem);
  int* n_slots = reinterpret_cast<int*>(smem + (staged ? (qt * kh + 3) / 4 : 0));
  int4* out_s = reinterpret_cast<int4*>(n_slots) + (compacted ? (qt + 3) / 4 : 0);
  if (staged) {
    const int32_t* src = row_idx + (int64_t)q0 * kh;
    if (compacted) {
      const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
      const int nl = min(32, (int)blockDim.x - 32 * warp);
      const unsigned mask = nl == 32 ? 0xffffffffu : (1u << nl) - 1u;
      for (int ql = warp; ql < nq; ql += (blockDim.x + 31) >> 5) {
        const int n = compact_slots(src + ql * kh, rows_s + ql * kh, k, hh, e, lane, nl, mask);
        if (lane == 0) n_slots[ql] = n;
      }
    } else {
      for (int i = threadIdx.x; i < nq * kh; i += blockDim.x) rows_s[i] = clamp_row(src[i], last);
    }
    __syncthreads();
  }
  const bool add = EP == kAcc && e.mode == kAdd;
  const bool counts_out = EP != kAcc || e.mode == kAdd || e.mode == kLast || e.mode == kOnly;
  const int tpq = wt * s;
  const int ql = threadIdx.x / tpq;
  if (ql < nq) {
    const int g = threadIdx.x % s;
    const int32_t* my = staged ? rows_s + ql * kh : row_idx + (int64_t)(q0 + ql) * kh;
    // this thread's slots [j0, j1): all of them, or under a split a run of
    // whole groups, its s-th share (s is 1 at compile time but under kKeep,
    // so the store instances keep their loop from slot 0 to K)
    const int ns = compacted ? n_slots[ql] : k;
    int j0 = 0, j1 = ns;
    if (s > 1) {
      const int share = (ns + s * kGroup - 1) / (s * kGroup) * kGroup;
      j0 = min(ns, g * share);
      j1 = min(ns, j0 + share);
    }
    float cut = 0.f;
    bool any = false;
    if constexpr (EP == kKeep) {
      const int32_t n = e.n_kmers[q0 + ql];
      cut = __fmul_rn(e.threshold, __int2float_rn(n));
      any = n > 0;
    }
    for (int w = (threadIdx.x % tpq) / s; w < wp; w += wt) {
      const uint32_t* col = words + w;
      // the AND of slot j's H rows. Compacted: every row lies in the window
      // but a pad's (its first row r1: not read); under kAcc otherwise a
      // row outside the window reads nothing; else the zero row is not
      // read (a predicated load: the group's loads still go out together)
      auto slot = [&](int j) -> uint32_t {
        const int32_t* rj = my + j * hh;
        if constexpr (EP == kAcc) {
          if (compacted) {
            const uint32_t r = (uint32_t)rj[0] - (uint32_t)e.r0;
            if (r >= e.n) return 0u;
            uint32_t x = __ldg(col + (int64_t)r * wp);
            for (int t = 1; t < hh; ++t) x &= __ldg(col + (int64_t)((uint32_t)rj[t] - (uint32_t)e.r0) * wp);
            return x;
          }
          uint32_t x = window_word(col, rj[0], e, wp);
          for (int t = 1; t < hh; ++t) x &= window_word(col, rj[t], e, wp);
          return x;
        }
        const int32_t r0 = clamp_row(rj[0], last);
        uint32_t x = r0 == last ? 0u : __ldg(col + (int64_t)r0 * wp);
        if constexpr (HC > 0) {
#pragma unroll
          for (int t = 1; t < HC; ++t) x &= __ldg(col + (int64_t)clamp_row(rj[t], last) * wp);
        } else {
          for (int t = 1; t < hh; ++t) x &= __ldg(col + (int64_t)clamp_row(rj[t], last) * wp);
        }
        return x;
      };
      Planes<P> acc;
      acc.init();
      int j = j0;
      for (; j + kGroup <= j1; j += kGroup) {
        uint32_t d[kGroup];
#pragma unroll
        for (int r = 0; r < kGroup; ++r) d[r] = slot(j + r);
        acc.add8(d);
      }
      for (; j < j1; ++j) acc.add1(slot(j));
      if (s > 1) {
        // the s threads of this (query, word), aligned lanes of one warp:
        // after log2(s) exchanges each holds the sum of their planes
        const int lane = threadIdx.x & 31;
        const unsigned gm = ((1u << s) - 1u) << (lane & ~(s - 1));
        for (int m = 1; m < s; m <<= 1) {
          uint32_t o[P];
#pragma unroll
          for (int i = 0; i < P; ++i) o[i] = __shfl_xor_sync(gm, acc.p[i], m);
          acc.add(o);
        }
        if (g) continue;
      }
      if constexpr (EP == kAcc) {
        int32_t* span = out + (int64_t)(q0 + ql) * 32 * wp + 32 * w;
        if (e.mode == kFirst) {
          store_planes<P>(span, e.np, acc.p);
          continue;
        }
        if (e.mode == kMiddle || e.mode == kLast) {
          if (e.mode == kMiddle && !acc.any()) continue;
          uint32_t o[P];
          load_planes<P>(span, e.np, o);
          acc.add(o);
          if (e.mode == kMiddle) {
            store_planes<P>(span, e.np, acc.p);
            continue;
          }
        }
      }
      int32_t cnt[32];
      acc.unpack(cnt);
      if constexpr (EP == kKeep) {
        // the 32 keep bytes of word w, two 16-byte stores
        uint32_t b[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          b[i] = 0u;
#pragma unroll
          for (int t = 0; t < 4; ++t)
            b[i] |= (uint32_t)(any && __int2float_rn(cnt[4 * i + t]) >= cut) << (8 * t);
        }
        int4* kd = reinterpret_cast<int4*>(e.keep + (int64_t)(q0 + ql) * 32 * wp + 32 * w);
        kd[0] = make_int4(b[0], b[1], b[2], b[3]);
        kd[1] = make_int4(b[4], b[5], b[6], b[7]);
      }
      // 32 counts of word w -> out[q, 32w : 32w+32]
      int4* dst = via_smem ? out_s + (int64_t)(ql * wp + w) * 8
                           : reinterpret_cast<int4*>(out + (int64_t)(q0 + ql) * 32 * wp + 32 * w);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int4 v = make_int4(cnt[4 * i], cnt[4 * i + 1], cnt[4 * i + 2], cnt[4 * i + 3]);
        if (via_smem) dst[i] = v;
        else put4(dst + i, v, add);
      }
    }
  }
  if (via_smem && counts_out) {
    // the block's queries are contiguous in out: whole lines, in order
    __syncthreads();
    int4* o4 = reinterpret_cast<int4*>(out + (int64_t)q0 * 32 * wp);
    for (int i = threadIdx.x; i < nq * 8 * wp; i += blockDim.x) put4(o4 + i, out_s[i], add);
  }
}

template <int P, int HC, int EP>
cudaError_t launch(const void* words, int64_t n_rows, int wp,
                   const void* row_idx, int q, int k, int h, int qt, int wt,
                   int split, int staged, int via_smem, const Epi& e, void* out,
                   void* stream) {
  const auto kernel = match_popcount_kernel<P, HC, EP>;
  const size_t smem = (staged ? ((size_t)qt * k * h + 3) / 4 * 16 : 0) +
                      (EP == kAcc && staged ? ((size_t)qt + 3) / 4 * 16 : 0) +
                      (via_smem ? (size_t)qt * wp * 128 : 0);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const unsigned grid = (unsigned)((q + qt - 1) / qt);
  kernel<<<grid, qt * wt * split, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)words, (int32_t)n_rows, wp, (const int32_t*)row_idx, q,
      k, h, qt, wt, split, staged, via_smem, e, (int32_t*)out);
  return cudaGetLastError();
}

template <int P, int EP>
cudaError_t launch_h(const void* words, int64_t n_rows, int wp,
                     const void* row_idx, int q, int k, int h, int qt, int wt,
                     int split, int staged, int via_smem, const Epi& e, void* out,
                     void* stream) {
  switch (h) {
    case 1:
      return launch<P, 1, EP>(words, n_rows, wp, row_idx, q, k, h, qt, wt, split, staged, via_smem, e, out, stream);
    case 3:
      return launch<P, 3, EP>(words, n_rows, wp, row_idx, q, k, h, qt, wt, split, staged, via_smem, e, out, stream);
    default:
      return launch<P, 0, EP>(words, n_rows, wp, row_idx, q, k, h, qt, wt, split, staged, via_smem, e, out, stream);
  }
}

template <int EP>
cudaError_t launch_any(const void* words, int64_t n_rows, int wp,
                       const void* row_idx, int q, int k, int h, int planes,
                       int qt, int wt, int split, int staged, int via_smem,
                       const Epi& e, void* out, void* stream) {
  if (q <= 0) return cudaSuccess;
  if (wp <= 0 || k <= 0 || h <= 0 || qt <= 0 || wt <= 0 ||
      (split != 1 && split != 2 && split != 4) || (EP != kKeep && split != 1) ||
      qt * wt * split > kMaxThreads || n_rows <= 0 || n_rows >= (int64_t(1) << 31) ||
      planes < 1 || planes > 16 || k > (1 << planes) - 1 ||
      (int64_t)qt * k * h >= (int64_t(1) << 31) || ((uintptr_t)out & 15u) ||
      (EP == kAcc && (e.mode < kAdd || e.mode > kOnly)) ||
      (EP == kKeep && (e.n_kmers == nullptr || ((uintptr_t)e.keep & 15u))))
    return cudaErrorInvalidValue;
  if (planes <= 8)
    return launch_h<8, EP>(words, n_rows, wp, row_idx, q, k, h, qt, wt, split, staged, via_smem, e, out, stream);
  if (planes <= 12)
    return launch_h<12, EP>(words, n_rows, wp, row_idx, q, k, h, qt, wt, split, staged, via_smem, e, out, stream);
  return launch_h<16, EP>(words, n_rows, wp, row_idx, q, k, h, qt, wt, split, staged, via_smem, e, out, stream);
}

}  // namespace

extern "C" {

// B1: any H, any K < 2**16, with `planes` >= bit_length(K). Returns a
// cudaError_t (0 on success).
int phylign_match_popcount_b1(const void* words, int64_t n_rows, int wp,
                              const void* row_idx, int q, int k, int h,
                              int planes, int qt, int wt, int staged,
                              int via_smem, void* out, void* stream) {
  return (int)launch_any<kStore>(words, n_rows, wp, row_idx, q, k, h, planes, qt, wt, 1,
                                 staged, via_smem, Epi{}, out, stream);
}

// B2: H == 1, K % 32 == 0.
int phylign_match_popcount_b2(const void* words, int64_t n_rows, int wp,
                              const void* row_idx, int q, int k, int h,
                              int planes, int qt, int wt, int staged,
                              int via_smem, void* out, void* stream) {
  if (h != 1 || k % 32) return (int)cudaErrorInvalidValue;
  return (int)launch_any<kStore>(words, n_rows, wp, row_idx, q, k, 1, planes, qt, wt, 1,
                                 staged, via_smem, Epi{}, out, stream);
}

// The accumulating instance on acc int32 [Q, 32 * Wp] (16-byte aligned):
// the counts of the slots whose rows all lie in [r0, r1), under `mode` (an
// AccMode: acc += the counts, or a pass's first, middle, last or only
// block, the counts kept as bit_length(K) = `planes` bit planes between
// them); words holds those rows, row r at r - r0 (at least r1 - r0 rows);
// row_idx holds global rows. 0 <= r0 < r1.
int phylign_match_popcount_acc(const void* words, int r0, int r1, int wp,
                               const void* row_idx, int q, int k, int h,
                               int planes, int qt, int wt, int staged,
                               int via_smem, int mode, void* acc, void* stream) {
  if (r0 < 0 || r1 <= r0) return (int)cudaErrorInvalidValue;
  Epi e{};
  e.r0 = r0;
  e.n = (uint32_t)(r1 - r0);
  e.mode = mode;
  e.np = planes;
  return (int)launch_any<kAcc>(words, r1 - r0, wp, row_idx, q, k, h, planes, qt, wt, 1,
                               staged, via_smem, e, acc, stream);
}

// The keep instance: out as B1/B2, and keep uint8 [Q, 32 * Wp] (16-byte
// aligned) = count >= threshold * n_kmers[q] in float32, and n_kmers[q] > 0;
// `split` (1, 2 or 4) threads a (query, word).
int phylign_match_popcount_keep(const void* words, int64_t n_rows, int wp,
                                const void* row_idx, int q, int k, int h,
                                int planes, int qt, int wt, int split, int staged,
                                int via_smem, const void* n_kmers,
                                float threshold, void* out, void* keep,
                                void* stream) {
  Epi e{};
  e.n_kmers = (const int32_t*)n_kmers;
  e.threshold = threshold;
  e.keep = (uint8_t*)keep;
  return (int)launch_any<kKeep>(words, n_rows, wp, row_idx, q, k, h, planes, qt, wt, split,
                                staged, via_smem, e, out, stream);
}

const char* phylign_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
