// Chain DP scan: kernel B3 of the align stage for Hopper (sm_90a), with a
// plain C interface loaded through ctypes (phylign_tpu_torch/ops/_kernels.py).
//
// Replaces the lax.scan of phylign_tpu/ops/chain.py:chain_anchors (its step
// function, chain.py:148-173). Contract (phylign_tpu_torch/ops/chain.py:
// chain_dp_ref):
//   rpos    int32 [P, A]            anchor ref positions, 2**30 = padding
//   qpos    int32 or uint16 [P, A]  anchor query positions
//   cost    f32 [bandwidth + 1]     cost(dd) for the integer dd
//   f       f32 [P, A]              best chain score ending at each slot
//                                   (-1e30 for padding)
//   parent  int32 [P, A]            its predecessor slot, -1 for a start
// f[i] = max(k, max_j f[j] + min(dq, dr, k) - cost(dd)) over the W previous
// slots j, in f32 exactly as the JAX scan rounds: positions converted to
// f32 (padding at 2e9), dr / dq / dd f32 differences, (f + gain) - cost with
// no contraction into fused multiply-adds (explicit _rn intrinsics). Ties go
// to the nearest predecessor; a parent only when strictly better than k.
//
// What bounds it on an H100: neither bytes nor operations. Each anchor set
// is a chain of A dependent steps, each a W-wide max-reduction, so the time
// is A times the latency of one step; the card only fills with many sets in
// flight (a flush has tens of thousands). The design:
//   * One warp per anchor set, looping over its A slots in order. The window
//     of W = min(64, A) predecessors is a ring indexed by slot mod W, two
//     ring slots per lane in registers: no shift per step.
//   * Each step: every lane scores its ring slots, then a 5-round shuffle
//     max-reduction with ties to the larger slot index; the lane owning
//     slot i mod W writes (f, r, q) into its ring slot.
//   * rpos / qpos are read 32 slots at a time, one coalesced load per warp,
//     and broadcast with shuffles; f and parent are held one per lane over
//     the same 32 slots and stored coalesced.
//   * The cost table replaces 0.01*k*dd + 0.5*log2(dd + 1): the answer does
//     not depend on the card's log2f, and the special-function unit leaves
//     the inner loop.
// Pointer doubling and chain selection stay torch ops (ops/chain.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kNeg = -1e30f;
constexpr float kPadF = 2.0e9f;
constexpr int32_t kPadPos = 1 << 30;

template <typename QT>
__global__ void chain_scan_kernel(const int32_t* __restrict__ rpos,
                                  const QT* __restrict__ qpos,
                                  const float* __restrict__ cost, int p, int a,
                                  int w, float kf, float gapf, float bandf,
                                  float* __restrict__ f_out,
                                  int32_t* __restrict__ par_out) {
  const int lane = threadIdx.x & 31;
  const int set = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (set >= p) return;  // warp-uniform
  const int64_t row = (int64_t)set * a;

  // ring slot s = lane + 32 * c holds the most recent slot j with
  // j % w == s: its (f, r, q, j); empty slots sit at the padding position
  float rf0 = kNeg, rr0 = kPadF, rq0 = kPadF;
  float rf1 = kNeg, rr1 = kPadF, rq1 = kPadF;
  int rj0 = -1, rj1 = -1;
  const bool has0 = lane < w, has1 = lane + 32 < w;

  for (int base = 0; base < a; base += 32) {
    const int idx = base + lane;
    float tr = kPadF, tq = kPadF;
    bool tvalid = false;
    if (idx < a) {
      const int32_t rv = rpos[row + idx];
      tvalid = rv < kPadPos;
      if (tvalid) {
        tr = __int2float_rn(rv);
        tq = __int2float_rn((int32_t)qpos[row + idx]);
      }
    }
    const int n = min(32, a - base);
    float my_f = kNeg;
    int my_par = -1;
    for (int t = 0; t < n; t++) {
      const int i = base + t;
      const float ri = __shfl_sync(kFull, tr, t);
      const float qi = __shfl_sync(kFull, tq, t);
      float bv = kNeg;
      int bj = -1;
#define PHYLIGN_SCORE_SLOT(HAS, RF, RR, RQ, RJ)                                \
  if (HAS) {                                                                   \
    const float dr = __fsub_rn(ri, RR);                                        \
    const float dq = __fsub_rn(qi, RQ);                                        \
    const float dd = fabsf(__fsub_rn(dr, dq));                                 \
    float cand = kNeg;                                                         \
    if (dr > 0.f && dq > 0.f && dr <= gapf && dq <= gapf && dd <= bandf) {     \
      const float gain = fminf(fminf(dq, dr), kf);                             \
      cand = __fsub_rn(__fadd_rn(RF, gain), __ldg(cost + (int)dd));            \
    }                                                                          \
    if (cand > bv || (cand == bv && RJ > bj)) {                                \
      bv = cand;                                                               \
      bj = RJ;                                                                 \
    }                                                                          \
  }
      PHYLIGN_SCORE_SLOT(has0, rf0, rr0, rq0, rj0)
      PHYLIGN_SCORE_SLOT(has1, rf1, rr1, rq1, rj1)
#undef PHYLIGN_SCORE_SLOT
      // warp max, ties toward the larger (nearer) slot index
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(kFull, bv, off);
        const int oj = __shfl_xor_sync(kFull, bj, off);
        if (ov > bv || (ov == bv && oj > bj)) {
          bv = ov;
          bj = oj;
        }
      }
      const float fi = fmaxf(bv, kf);
      const int par = bv > kf ? bj : -1;
      const int slot = i % w;
      if (slot == lane) {
        rf0 = fi; rr0 = ri; rq0 = qi; rj0 = i;
      } else if (slot == lane + 32) {
        rf1 = fi; rr1 = ri; rq1 = qi; rj1 = i;
      }
      if (t == lane) {
        my_f = fi;
        my_par = par;
      }
    }
    if (lane < n) {
      f_out[row + idx] = tvalid ? my_f : kNeg;
      par_out[row + idx] = my_par;
    }
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success). q16 != 0: qpos is uint16.
int phylign_chain_scan(const void* rpos, const void* qpos, int q16,
                       const void* cost, int p, int a, int w, int k,
                       int max_gap, int bandwidth, int warps_per_block,
                       void* f, void* parent, void* stream) {
  if (p <= 0 || a <= 0) return 0;
  if (w < 1 || w > 64 || w > a || warps_per_block < 1 ||
      warps_per_block > 32 || bandwidth < 0)
    return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((p + warps_per_block - 1) / warps_per_block);
  const unsigned threads = 32u * (unsigned)warps_per_block;
  cudaStream_t s = (cudaStream_t)stream;
  if (q16)
    chain_scan_kernel<uint16_t><<<grid, threads, 0, s>>>(
        (const int32_t*)rpos, (const uint16_t*)qpos, (const float*)cost, p, a,
        w, (float)k, (float)max_gap, (float)bandwidth, (float*)f,
        (int32_t*)parent);
  else
    chain_scan_kernel<int32_t><<<grid, threads, 0, s>>>(
        (const int32_t*)rpos, (const int32_t*)qpos, (const float*)cost, p, a,
        w, (float)k, (float)max_gap, (float)bandwidth, (float*)f,
        (int32_t*)parent);
  return (int)cudaGetLastError();
}

const char* phylign_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
