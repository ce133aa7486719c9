// Gather + vertical popcount: the match stage's scoring kernels for Hopper
// (sm_90a), with a plain C interface loaded through ctypes
// (phylign_tpu_torch/ops/_kernels.py).
//
// Contract, both kernels (the contract of phylign_tpu/ops/match.py:
// match_scores_xla):
//   words    uint32 [S+1, Wp]  packed Bloom bit-matrix, doc d at word d/32,
//                              bit d%32; row S is all zero (padding row)
//   row_idx  int32  [Q, K, H]  Bloom row of hash h of k-mer slot k of query q;
//                              padding slots hold S
//   out      int32  [Q, 32*Wp] out[q, 32*w + b] = number of slots k whose H
//                              rows all have bit b of word w set
//
// B1 replaces phylign_tpu/ops/match.py:match_scores_pallas (body
//    _match_kernel_body): any H, any K. One counter per bit (32 registers);
//    each row costs 32 shift-mask-adds.
// B2 replaces phylign_tpu/ops/match.py:match_scores_pallas_v2 (body
//    _v2_kernel_body): H == 1. A carry-save counter over PLANES =
//    ceil(log2(K+1)) bit planes (registers); each row costs 2*PLANES logic
//    ops, and the planes are unpacked once at the end.
//
// What bounds them on an H100: every query gathers K*H rows of 4*Wp bytes
// (272 B at Wp = 68) at random from a table of 4*(S+1)*Wp bytes (544 MB at
// S = 2M) that the 50 MB L2 cannot hold, and writes 128*Wp bytes. They are
// bound by the latency and bytes of that gather, not by arithmetic. The
// design keeps each row read coalesced (neighbouring threads read
// neighbouring words of the same row), keeps all accumulators in registers,
// stages the tile's row indices in shared memory (the TPU kernels' scalar
// prefetch), and writes each thread's 32 counts as eight 16-byte stores
// straight into the [Q, 32*Wp] layout. The TPU's 16-deep DMA ring, its
// waves and its 8-query sublane tile follow VMEM and have no counterpart.
// Left for later: cp.async staging of rows, warp specialisation, and
// fusing the threshold / top-k / compaction epilogue (ROADMAP B5).
//
// Launch geometry (chosen by the caller, ops/match.py:launch_geometry):
// a block holds qt queries x wt word-threads (qt * wt <= 256); thread t
// serves query qt*blockIdx.x + t/wt and words t%wt, t%wt + wt, ...

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;

// B1: 32 per-bit counters.
struct CountAcc {
  uint32_t c[32];
  __device__ __forceinline__ void init() {
#pragma unroll
    for (int b = 0; b < 32; ++b) c[b] = 0u;
  }
  __device__ __forceinline__ void add(uint32_t x) {
#pragma unroll
    for (int b = 0; b < 32; ++b) c[b] += (x >> b) & 1u;
  }
  __device__ __forceinline__ int count(int b) const { return (int)c[b]; }
};

// B2: carry-save bit planes; plane j holds bit j of every bit's count.
template <int PLANES>
struct PlaneAcc {
  uint32_t p[PLANES];
  __device__ __forceinline__ void init() {
#pragma unroll
    for (int j = 0; j < PLANES; ++j) p[j] = 0u;
  }
  __device__ __forceinline__ void add(uint32_t x) {
    uint32_t carry = x;
#pragma unroll
    for (int j = 0; j < PLANES; ++j) {
      const uint32_t t = p[j] & carry;
      p[j] ^= carry;
      carry = t;
    }
  }
  __device__ __forceinline__ int count(int b) const {
    uint32_t v = 0u;
#pragma unroll
    for (int j = 0; j < PLANES; ++j) v |= ((p[j] >> b) & 1u) << j;
    return (int)v;
  }
};

template <class Acc>
__global__ void __launch_bounds__(kMaxThreads)
match_popcount_kernel(const uint32_t* __restrict__ words, int64_t n_rows,
                      int wp, const int32_t* __restrict__ row_idx, int q,
                      int k, int h, int qt, int wt,
                      int32_t* __restrict__ out) {
  extern __shared__ int32_t rows_s[];  // [qt, k*h]: this tile's row indices
  const int q0 = blockIdx.x * qt;
  const int nq = min(qt, q - q0);
  const int kh = k * h;
  const int total = nq * kh;
  const int32_t pad = (int32_t)(n_rows - 1);
  const int32_t* src = row_idx + (int64_t)q0 * kh;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int32_t r = src[i];
    // clamp into [0, S] as XLA's gather does: a bad index reads a real row
    // (the zero row when too large), never outside the table
    rows_s[i] = r < 0 ? 0 : (r > pad ? pad : r);
  }
  __syncthreads();

  const int ql = threadIdx.x / wt;
  if (ql >= nq) return;
  const int32_t* my = rows_s + ql * kh;
  int32_t* orow = out + (int64_t)(q0 + ql) * 32 * wp;
  for (int w = threadIdx.x % wt; w < wp; w += wt) {
    const uint32_t* col = words + w;
    Acc acc;
    acc.init();
    if (h == 1) {
#pragma unroll 8
      for (int j = 0; j < k; ++j) acc.add(__ldg(col + (int64_t)my[j] * wp));
    } else {
      for (int j = 0; j < k; ++j) {
        const int32_t* rj = my + j * h;
        uint32_t x = __ldg(col + (int64_t)rj[0] * wp);
        for (int t = 1; t < h; ++t) x &= __ldg(col + (int64_t)rj[t] * wp);
        acc.add(x);
      }
    }
    // 32 counts of word w -> out[q, 32w : 32w+32], 128-byte aligned
    int4* dst = reinterpret_cast<int4*>(orow + 32 * w);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      dst[i] = make_int4(acc.count(4 * i), acc.count(4 * i + 1),
                         acc.count(4 * i + 2), acc.count(4 * i + 3));
  }
}

template <class Acc>
cudaError_t launch(const void* words, int64_t n_rows, int wp,
                   const void* row_idx, int q, int k, int h, int qt, int wt,
                   void* out, void* stream) {
  if (q <= 0) return cudaSuccess;
  if (wp <= 0 || k <= 0 || h <= 0 || qt <= 0 || wt <= 0 ||
      qt * wt > kMaxThreads || n_rows <= 0)
    return cudaErrorInvalidValue;
  const size_t smem = (size_t)qt * k * h * sizeof(int32_t);
  const unsigned grid = (unsigned)((q + qt - 1) / qt);
  match_popcount_kernel<Acc><<<grid, qt * wt, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)words, n_rows, wp, (const int32_t*)row_idx, q, k, h,
      qt, wt, (int32_t*)out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// B1: any H, any K. Returns a cudaError_t (0 on success).
int phylign_match_popcount_b1(const void* words, int64_t n_rows, int wp,
                              const void* row_idx, int q, int k, int h,
                              int qt, int wt, void* out, void* stream) {
  return (int)launch<CountAcc>(words, n_rows, wp, row_idx, q, k, h, qt, wt,
                               out, stream);
}

// B2: H == 1, with `planes` = ceil(log2(K+1)) bit planes (6..14).
int phylign_match_popcount_b2(const void* words, int64_t n_rows, int wp,
                              const void* row_idx, int q, int k, int planes,
                              int qt, int wt, void* out, void* stream) {
  if (k > (1 << planes) - 1) return (int)cudaErrorInvalidValue;
#define PHYLIGN_B2_CASE(P)                                                   \
  case P:                                                                    \
    return (int)launch<PlaneAcc<P>>(words, n_rows, wp, row_idx, q, k, 1, qt, \
                                    wt, out, stream);
  switch (planes) {
    PHYLIGN_B2_CASE(6)
    PHYLIGN_B2_CASE(7)
    PHYLIGN_B2_CASE(8)
    PHYLIGN_B2_CASE(9)
    PHYLIGN_B2_CASE(10)
    PHYLIGN_B2_CASE(11)
    PHYLIGN_B2_CASE(12)
    PHYLIGN_B2_CASE(13)
    PHYLIGN_B2_CASE(14)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PHYLIGN_B2_CASE
}

const char* phylign_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
