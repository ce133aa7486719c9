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
// What bounds it on an H100: instruction issue for the short-read buckets
// (tens of thousands of sets of 21-32 anchors), latency for the long-read
// ones (a few dozen sets of thousands of dependent steps). The design:
//   * G lanes per anchor set (a template: 4, 8, 16 or 32), 32/G sets per
//     warp. Each lane owns the window slots j with j % G == its lane and
//     keeps the newest SPL = ceil(W/G) of them as a shift register in
//     registers, newest first: the slot a step writes goes to lane i % G,
//     whose registers move down one; no index is known only at run time,
//     so nothing lands in local memory.
//   * Each step, every lane scores its SPL slots serially with no shuffle;
//     a log2(G)-round width-G shuffle argmax (ties to the larger slot)
//     combines the lanes, or at G = 32 two hardware warp reductions
//     (__reduce_max_sync: the value as an order-preserving key, then the
//     largest slot holding it), which shortens the long-read buckets' chain.
//   * Slot i-1 leaves the critical path. The best over j <= i-2 does not
//     depend on f[i-1], so it is reduced one step ahead, during step i-1;
//     step i folds in j = i-1 alone (its gain and cost known from the
//     positions), a tie going to i-1 as the nearest. max is exact in any
//     order. The dependent chain of a step is one add, one subtract and one
//     compare; with the step loop unrolled by two, the reductions of two
//     consecutive steps interleave.
//   * The cost table sits in shared memory (min(bandwidth, max_gap) + 1
//     floats, the only entries a transition can read), loaded once a block.
//   * Positions are read G slots at a time, one load per lane, a chunk
//     ahead, and broadcast in the group with shuffles.
// Pointer doubling and chain selection stay torch ops (ops/chain.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr float kPadF = 2.0e9f;
constexpr int32_t kPadPos = 1 << 30;
constexpr int kThreads = 128;

struct Params {
  int p, a, w;
  float kf, gapf, bandf;
};

// the f32 positions of slot idx (the padding position past A or for a
// padded slot), without a branch
template <typename QT>
__device__ __forceinline__ void load_pos(const int32_t* rpos, const QT* qpos,
                                         int64_t row, int a, int idx,
                                         float& r, float& q) {
  const int k = min(idx, a - 1);
  const int32_t rv = rpos[row + k];
  const int32_t qv = (int32_t)qpos[row + k];
  const bool valid = idx < a && rv < kPadPos;
  r = valid ? __int2float_rn(rv) : kPadF;
  q = valid ? __int2float_rn(qv) : kPadF;
}

// the transition j -> i: whether it is allowed, its gain and its cost
__device__ __forceinline__ bool transition(float ri, float qi, float rj,
                                           float qj, const Params& pr,
                                           const float* tab, float& gain,
                                           float& cost) {
  const float dr = __fsub_rn(ri, rj);
  const float dq = __fsub_rn(qi, qj);
  const float dd = fabsf(__fsub_rn(dr, dq));
  const bool ok = dr > 0.f && dq > 0.f && dr <= pr.gapf && dq <= pr.gapf &&
                  dd <= pr.bandf;
  gain = fminf(fminf(dq, dr), pr.kf);
  cost = ok ? tab[(int)dd] : 0.f;
  return ok;
}

// float -> uint32 with the same order (no NaN; -0 never occurs here)
__device__ __forceinline__ unsigned ordered_key(float x) {
  const unsigned u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_ordered_key(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

template <int G, int SPL, typename QT>
__global__ void __launch_bounds__(kThreads)
    chain_scan_kernel(const int32_t* __restrict__ rpos,
                      const QT* __restrict__ qpos,
                      const float* __restrict__ cost, int tab_n, Params pr,
                      float* __restrict__ f_out,
                      int32_t* __restrict__ par_out) {
  extern __shared__ float tab[];
  for (int x = threadIdx.x; x < tab_n; x += blockDim.x) tab[x] = cost[x];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int t = lane & (G - 1);  // lane within the set's group
  const unsigned gmask = (unsigned)((1ull << G) - 1ull) << (lane - t);
  const int set = blockIdx.x * (kThreads / G) + threadIdx.x / G;
  if (set >= pr.p) return;  // group-uniform
  const int a = pr.a;
  const int64_t row = (int64_t)set * a;

  // this lane's window slots, newest first: slot jl - m*G in entry m
  float rf[SPL], rr[SPL], rq[SPL];
#pragma unroll
  for (int m = 0; m < SPL; m++) {
    rf[m] = kNeg;
    rr[m] = kPadF;
    rq[m] = kPadF;
  }
  int jl = t - G;

  // positions G slots at a time: lane t holds slot c*G + t of chunk c
  float cr, cq, nr, nq;
  load_pos(rpos, qpos, row, a, t, cr, cq);
  load_pos(rpos, qpos, row, a, G + t, nr, nq);
  float ri = __shfl_sync(gmask, cr, 0, G), qi = __shfl_sync(gmask, cq, 0, G);
  float rn = __shfl_sync(gmask, cr, 1, G), qn = __shfl_sync(gmask, cq, 1, G);

  float bv = kNeg;  // best over j <= i-2 for slot i
  int bj = -1;
  float fprev = kNeg;  // f[i-1] and the transition i-1 -> i
  bool okp = false;
  float gp = 0.f, cp = 0.f;
  // unrolled by two: the reduction for slot i+2 depends on f[i], not on the
  // one for slot i+1, so the two interleave
#pragma unroll 2
  for (int i = 0; i < a; i++) {
    // the best for slot i+1 over j in [i+1-w, i-1] (independent of f[i])
    const int lo = i + 1 - pr.w;
    float nv = kNeg;
    int nj = -1;
#pragma unroll
    for (int m = 0; m < SPL; m++) {
      const int j = jl - m * G;
      float gain, c;
      const bool ok = transition(rn, qn, rr[m], rq[m], pr, tab, gain, c);
      const float cand = ok && j >= lo ? __fsub_rn(__fadd_rn(rf[m], gain), c) : kNeg;
      if (cand > nv) {  // newest first: a tie keeps the larger j
        nv = cand;
        nj = j;
      }
    }
    if constexpr (G == 32) {
      // two warp reductions in hardware (redux.sync): the largest value as
      // an order-preserving key, then the largest j holding it
      const unsigned top = __reduce_max_sync(gmask, ordered_key(nv));
      nj = __reduce_max_sync(gmask, ordered_key(nv) == top ? nj : -1);
      nv = from_ordered_key(top);
    } else {
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(gmask, nv, off, G);
        const int oj = __shfl_xor_sync(gmask, nj, off, G);
        if (ov > nv || (ov == nv && oj > nj)) {
          nv = ov;
          nj = oj;
        }
      }
    }
    // slot i: fold j = i-1 into the best over j <= i-2
    const float cf = okp ? __fsub_rn(__fadd_rn(fprev, gp), cp) : kNeg;
    if (cf >= bv) {
      bv = cf;
      bj = i - 1;
    }
    const float fi = fmaxf(bv, pr.kf);
    if (t == 0) {
      f_out[row + i] = ri < kPadF ? fi : kNeg;
      par_out[row + i] = bv > pr.kf ? bj : -1;
    }
    okp = transition(rn, qn, ri, qi, pr, tab, gp, cp);
    // slot i joins the window of lane i % G
    if (t == (i & (G - 1))) {
#pragma unroll
      for (int m = SPL - 1; m > 0; m--) {
        rf[m] = rf[m - 1];
        rr[m] = rr[m - 1];
        rq[m] = rq[m - 1];
      }
      rf[0] = fi;
      rr[0] = ri;
      rq[0] = qi;
      jl = i;
    }
    fprev = fi;
    bv = nv;
    bj = nj;
    ri = rn;
    qi = qn;
    // the positions of slot i+2
    const int s = i + 2;
    if ((s & (G - 1)) == 0) {  // s starts chunk s / G: move up a chunk
      cr = nr;
      cq = nq;
      load_pos(rpos, qpos, row, a, s + G + t, nr, nq);
    }
    rn = __shfl_sync(gmask, cr, s & (G - 1), G);
    qn = __shfl_sync(gmask, cq, s & (G - 1), G);
  }
}

template <int G, int SPL, typename QT>
cudaError_t launch(const void* rpos, const void* qpos, const void* cost,
                   int tab_n, const Params& pr, void* f, void* parent,
                   cudaStream_t s) {
  const size_t smem = (size_t)tab_n * sizeof(float);
  auto kern = chain_scan_kernel<G, SPL, QT>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const unsigned grid = (unsigned)((pr.p + kThreads / G - 1) / (kThreads / G));
  kern<<<grid, kThreads, smem, s>>>((const int32_t*)rpos, (const QT*)qpos,
                                    (const float*)cost, tab_n, pr, (float*)f,
                                    (int32_t*)parent);
  return cudaGetLastError();
}

template <int G, int SPL>
cudaError_t launch_q(const void* rpos, const void* qpos, int q16,
                     const void* cost, int tab_n, const Params& pr, void* f,
                     void* parent, cudaStream_t s) {
  return q16 ? launch<G, SPL, uint16_t>(rpos, qpos, cost, tab_n, pr, f, parent, s)
             : launch<G, SPL, int32_t>(rpos, qpos, cost, tab_n, pr, f, parent, s);
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success). q16 != 0: qpos is uint16. lanes is
// G (4, 8, 16 or 32); each lane holds 32/G window slots when w <= 32,
// 64/G when w <= 64.
int phylign_chain_scan(const void* rpos, const void* qpos, int q16,
                       const void* cost, int p, int a, int w, int lanes,
                       int k, int max_gap, int bandwidth, void* f,
                       void* parent, void* stream) {
  if (p <= 0 || a <= 0) return 0;
  if (w < 1 || w > 64 || w > a || bandwidth < 0 || max_gap < 0)
    return (int)cudaErrorInvalidValue;
  const int tab_n = (bandwidth < max_gap ? bandwidth : max_gap) + 1;
  if (tab_n > 56 * 1024) return (int)cudaErrorInvalidValue;
  const Params pr{p, a, w, (float)k, (float)max_gap, (float)bandwidth};
  cudaStream_t s = (cudaStream_t)stream;
  const bool wide = w > 32;
#define PHYLIGN_B3(G)                                                            \
  if (lanes == G)                                                                \
    return (int)(wide ? launch_q<G, 64 / G>(rpos, qpos, q16, cost, tab_n, pr, f, \
                                            parent, s)                           \
                      : launch_q<G, 32 / G>(rpos, qpos, q16, cost, tab_n, pr, f, \
                                            parent, s));
  PHYLIGN_B3(4)
  PHYLIGN_B3(8)
  PHYLIGN_B3(16)
  PHYLIGN_B3(32)
#undef PHYLIGN_B3
  return (int)cudaErrorInvalidValue;
}

const char* phylign_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
