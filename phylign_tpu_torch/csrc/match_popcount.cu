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
//   acc    out += the counts, out being the row-chunked matcher's
//          accumulator (replaces the jitted _acc_chunk_scores,
//          phylign_tpu/models/matcher.py:838-841, around B2). `words`
//          holds only the global rows [r0, r1) of the index, row r at
//          r - r0, and row_idx holds global rows: a slot row outside the
//          window reads nothing (counts as a zero row), so the block needs
//          no zero row and the indices are not remapped per block. Each
//          16-byte piece of out is loaded, added to and stored once, where
//          a store then an add_ would pass over the matrix four times.
//   keep   out = the counts and keep[q, c] = f32(count) >= f32(threshold)
//          * f32(n_kmers[q]) and n_kmers[q] > 0, one byte a column
//          (replaces the jitted match_step, phylign_tpu/models/matcher.py:
//          252-268: the four elementwise ops after B1/B2). The product is
//          rounded once (__fmul_rn, never contracted), as XLA computes it.
//
// Launch geometry (chosen by the caller, ops/match.py:launch_geometry): a
// block of qt queries x wt threads (qt * wt <= 256); thread t serves query
// qt*blockIdx.x + t/wt and words t%wt, t%wt + wt, ...; `staged` says the
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

__device__ __forceinline__ int32_t clamp_row(int32_t r, int32_t last) {
  // clamp into [0, S] as XLA's gather does: a bad index reads a real row
  // (the zero row when too large), never outside the table
  return r < 0 ? 0 : (r > last ? last : r);
}

// The epilogues (see the head of the file) and what each takes beyond the
// counts' pointer `out`.
enum Epilogue { kStore = 0, kAcc = 1, kKeep = 2 };
struct Epi {
  int32_t r0;                   // kAcc: words holds global rows [r0, r0 + n)
  uint32_t n;
  const int32_t* n_kmers;       // kKeep: [Q]
  float threshold;              // kKeep: already rounded to f32
  uint8_t* keep;                // kKeep: [Q, 32 * Wp], 16-byte aligned
};

// kAcc: word w of global row g, or 0 where g lies outside the window
__device__ __forceinline__ uint32_t window_word(const uint32_t* col, int32_t g, const Epi& e, int wp) {
  const uint32_t r = (uint32_t)g - (uint32_t)e.r0;  // wraps past n for g < r0
  return r < e.n ? __ldg(col + (int64_t)r * wp) : 0u;
}

// 16 bytes of 4 counts, added to what `at` holds under kAcc
template <int EP>
__device__ __forceinline__ void put4(int4* at, int4 v) {
  if constexpr (EP == kAcc) {
    const int4 a = *at;
    v = make_int4(a.x + v.x, a.y + v.y, a.z + v.z, a.w + v.w);
  }
  *at = v;
}

// HC: H at compile time (1 or 3), or 0 for a runtime h.
template <int P, int HC, int EP>
__global__ void __launch_bounds__(kMaxThreads)
match_popcount_kernel(const uint32_t* __restrict__ words, int32_t n_rows,
                      int wp, const int32_t* __restrict__ row_idx, int q,
                      int k, int h, int qt, int wt, int staged, int via_smem,
                      Epi e, int32_t* __restrict__ out) {
  // shared memory: [qt, K*H] row indices (when staged), then [qt, 32*Wp]
  // counts (when via_smem), 16-byte aligned
  extern __shared__ int4 smem[];
  const int hh = HC ? HC : h;
  const int kh = k * hh;
  const int q0 = blockIdx.x * qt;
  const int nq = min(qt, q - q0);
  const int32_t last = n_rows - 1;
  int32_t* rows_s = reinterpret_cast<int32_t*>(smem);
  int4* out_s = smem + (staged ? (qt * kh + 3) / 4 : 0);
  if (staged) {
    const int32_t* src = row_idx + (int64_t)q0 * kh;
    for (int i = threadIdx.x; i < nq * kh; i += blockDim.x)
      rows_s[i] = EP == kAcc ? src[i] : clamp_row(src[i], last);
    __syncthreads();
  }
  const int ql = threadIdx.x / wt;
  if (ql < nq) {
    const int32_t* my = staged ? rows_s + ql * kh : row_idx + (int64_t)(q0 + ql) * kh;
    float cut = 0.f;
    bool any = false;
    if constexpr (EP == kKeep) {
      const int32_t n = e.n_kmers[q0 + ql];
      cut = __fmul_rn(e.threshold, __int2float_rn(n));
      any = n > 0;
    }
    for (int w = threadIdx.x % wt; w < wp; w += wt) {
      const uint32_t* col = words + w;
      // the AND of slot j's H rows; the zero row (under kAcc: a row outside
      // the window) is not read (a predicated load: the group's loads still
      // go out together)
      auto slot = [&](int j) -> uint32_t {
        const int32_t* rj = my + j * hh;
        if constexpr (EP == kAcc) {
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
      int j = 0;
      for (; j + kGroup <= k; j += kGroup) {
        uint32_t d[kGroup];
#pragma unroll
        for (int r = 0; r < kGroup; ++r) d[r] = slot(j + r);
        acc.add8(d);
      }
      for (; j < k; ++j) acc.add1(slot(j));
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
        else put4<EP>(dst + i, v);
      }
    }
  }
  if (via_smem) {
    // the block's queries are contiguous in out: whole lines, in order
    __syncthreads();
    int4* o4 = reinterpret_cast<int4*>(out + (int64_t)q0 * 32 * wp);
    for (int i = threadIdx.x; i < nq * 8 * wp; i += blockDim.x) put4<EP>(o4 + i, out_s[i]);
  }
}

template <int P, int HC, int EP>
cudaError_t launch(const void* words, int64_t n_rows, int wp,
                   const void* row_idx, int q, int k, int h, int qt, int wt,
                   int staged, int via_smem, const Epi& e, void* out, void* stream) {
  const auto kernel = match_popcount_kernel<P, HC, EP>;
  const size_t smem = (staged ? ((size_t)qt * k * h + 3) / 4 * 16 : 0) +
                      (via_smem ? (size_t)qt * wp * 128 : 0);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  static bool attr_set = false;  // per instance; the value is the same
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const unsigned grid = (unsigned)((q + qt - 1) / qt);
  kernel<<<grid, qt * wt, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)words, (int32_t)n_rows, wp, (const int32_t*)row_idx, q,
      k, h, qt, wt, staged, via_smem, e, (int32_t*)out);
  return cudaGetLastError();
}

template <int P, int EP>
cudaError_t launch_h(const void* words, int64_t n_rows, int wp,
                     const void* row_idx, int q, int k, int h, int qt, int wt,
                     int staged, int via_smem, const Epi& e, void* out, void* stream) {
  switch (h) {
    case 1:
      return launch<P, 1, EP>(words, n_rows, wp, row_idx, q, k, h, qt, wt, staged, via_smem, e, out, stream);
    case 3:
      return launch<P, 3, EP>(words, n_rows, wp, row_idx, q, k, h, qt, wt, staged, via_smem, e, out, stream);
    default:
      return launch<P, 0, EP>(words, n_rows, wp, row_idx, q, k, h, qt, wt, staged, via_smem, e, out, stream);
  }
}

template <int EP>
cudaError_t launch_any(const void* words, int64_t n_rows, int wp,
                       const void* row_idx, int q, int k, int h, int planes,
                       int qt, int wt, int staged, int via_smem, const Epi& e,
                       void* out, void* stream) {
  if (q <= 0) return cudaSuccess;
  if (wp <= 0 || k <= 0 || h <= 0 || qt <= 0 || wt <= 0 ||
      qt * wt > kMaxThreads || n_rows <= 0 || n_rows >= (int64_t(1) << 31) ||
      planes < 1 || planes > 16 || k > (1 << planes) - 1 ||
      (int64_t)qt * k * h >= (int64_t(1) << 31) || ((uintptr_t)out & 15u) ||
      (EP == kKeep && (e.n_kmers == nullptr || ((uintptr_t)e.keep & 15u))))
    return cudaErrorInvalidValue;
  if (planes <= 8)
    return launch_h<8, EP>(words, n_rows, wp, row_idx, q, k, h, qt, wt, staged, via_smem, e, out, stream);
  if (planes <= 12)
    return launch_h<12, EP>(words, n_rows, wp, row_idx, q, k, h, qt, wt, staged, via_smem, e, out, stream);
  return launch_h<16, EP>(words, n_rows, wp, row_idx, q, k, h, qt, wt, staged, via_smem, e, out, stream);
}

}  // namespace

extern "C" {

// B1: any H, any K < 2**16, with `planes` >= bit_length(K). Returns a
// cudaError_t (0 on success).
int phylign_match_popcount_b1(const void* words, int64_t n_rows, int wp,
                              const void* row_idx, int q, int k, int h,
                              int planes, int qt, int wt, int staged,
                              int via_smem, void* out, void* stream) {
  return (int)launch_any<kStore>(words, n_rows, wp, row_idx, q, k, h, planes, qt, wt,
                                 staged, via_smem, Epi{}, out, stream);
}

// B2: H == 1, K % 32 == 0.
int phylign_match_popcount_b2(const void* words, int64_t n_rows, int wp,
                              const void* row_idx, int q, int k, int h,
                              int planes, int qt, int wt, int staged,
                              int via_smem, void* out, void* stream) {
  if (h != 1 || k % 32) return (int)cudaErrorInvalidValue;
  return (int)launch_any<kStore>(words, n_rows, wp, row_idx, q, k, 1, planes, qt, wt,
                                 staged, via_smem, Epi{}, out, stream);
}

// The accumulating instance: acc int32 [Q, 32 * Wp] (16-byte aligned) +=
// the counts of the slots' rows that lie in [r0, r1); words holds those
// rows, row r at r - r0 (at least r1 - r0 rows); row_idx holds global
// rows. 0 <= r0 < r1.
int phylign_match_popcount_acc(const void* words, int r0, int r1, int wp,
                               const void* row_idx, int q, int k, int h,
                               int planes, int qt, int wt, int staged,
                               int via_smem, void* acc, void* stream) {
  if (r0 < 0 || r1 <= r0) return (int)cudaErrorInvalidValue;
  Epi e{};
  e.r0 = r0;
  e.n = (uint32_t)(r1 - r0);
  return (int)launch_any<kAcc>(words, r1 - r0, wp, row_idx, q, k, h, planes, qt, wt,
                               staged, via_smem, e, acc, stream);
}

// The keep instance: out as B1/B2, and keep uint8 [Q, 32 * Wp] (16-byte
// aligned) = count >= threshold * n_kmers[q] in float32, and n_kmers[q] > 0.
int phylign_match_popcount_keep(const void* words, int64_t n_rows, int wp,
                                const void* row_idx, int q, int k, int h,
                                int planes, int qt, int wt, int staged,
                                int via_smem, const void* n_kmers,
                                float threshold, void* out, void* keep,
                                void* stream) {
  Epi e{};
  e.n_kmers = (const int32_t*)n_kmers;
  e.threshold = threshold;
  e.keep = (uint8_t*)keep;
  return (int)launch_any<kKeep>(words, n_rows, wp, row_idx, q, k, h, planes, qt, wt,
                                staged, via_smem, e, out, stream);
}

const char* phylign_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
