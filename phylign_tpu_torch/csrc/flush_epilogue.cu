// Fused flush epilogue: kernel B6 of the align stage for Hopper (sm_90a),
// with a plain C interface loaded through ctypes (phylign_tpu_torch/ops/
// _kernels.py).
//
// Replaces the rest of the jitted align flush around the two scans: the tail
// of phylign_tpu/ops/chain.py:chain_anchors after its lax.scan (:184-274) and
// the body of phylign_tpu/align/fused.py:select_extend (jax.jit at :377):
// _select_extend_core (:104-344) and _compact_cold (:347-367). Four kernels,
// each equal bit for bit to its plain PyTorch version:
//   B6a chain_select   ops/chain.py:_chain_tail_ref. Up to kWarpMaxSlots
//                      slots a warp per anchor set, kWarpSets sets a block:
//                      each lane holds N = ceil(A / 32) slots (slot
//                      32 s + lane) in registers; chain root and edge count
//                      of every slot by pointer doubling (the plain
//                      version's rounds; shuffles at N = 1, else a
//                      warp-private slice of shared memory and __syncwarp);
//                      then the primary (first argmax of f), the s2 alt
//                      (best slot overlapping the primary off its root) and
//                      n_sup greedy split segments, each one redux.sync
//                      argmax (max of an order-preserving key, then min
//                      index among its holders); the winner's lane stages
//                      its fields and the block writes each field row's run
//                      of sets. Longer sets: one block per set, the set in
//                      shared memory up to kSmemSlots slots, else its
//                      pointers and counts in a device workspace.
//   B6b select_window  align/fused.py:_select_ref. A block of 32 pairs:
//                      first one thread a pair runs its selection (<= 6
//                      candidates read through cand_map from the buckets'
//                      ChainResults, no concatenation; templated on n_sup
//                      and n_out, so the candidates stay in registers) and
//                      writes its hot row (without the extension's bits),
//                      scores and bounds, staging the window's origin and
//                      the cold row in shared memory; then the block's 256
//                      threads write the cold rows coalesced and gather the
//                      2-bit window, its in-contig mask and the
//                      strand-adjusted query for kernel B4 as 16-byte
//                      stores: 16 codes from two 32-bit pool words by a
//                      funnel shift, spread to bytes by shifts and masks.
//   B6c finish_pack    align/fused.py:_finish_ref. One warp per pair, 8
//                      consecutive columns a lane (256 a tile): the query
//                      as one 8-byte load, the window from the aligned
//                      words around its 8 bytes by funnel shifts (byte by
//                      byte at the plain version's clamp where they leave
//                      the row); the lane's big-endian mismatch byte by a
//                      per-byte compare, stored as it is; the total by one
//                      redux.sync add, the lane's first rank by one warp
//                      scan of the popcounts, the z-drop running peak by
//                      one exclusive max-scan of the lanes' own maxima;
//                      each lane's minima and largest drop by a loop over
//                      its mismatch bits, then three redux.sync reductions. A row
//                      past 256 columns counts its tiles first, then
//                      reloads them carrying the count and the peak. ORs
//                      the diagonal, full-span and end_d bits into the hot
//                      row.
//       compact_cold   align/fused.py:_compact_cold. A block of 256 rows:
//                      its first rank from every row's need flag before it
//                      (each block counts them all, so none waits on
//                      another), ranks inside it by ballot + popcount; the
//                      needed rows of rank < COLD_CAP copied into one
//                      contiguous run of slots by consecutive threads, the
//                      unused slots zeroed by all blocks.
// Every output goes straight into its region of the packed byte buffer
// engine._fused_finish unpacks (hot int32 [P, 4], flts f32 [P, 2], mismatch
// bits u8 [P, lmax / 8], compacted cold int32 [CAP, 4 + 6*n_out + 5] and f32
// [CAP, n_out]); the caller passes each region's pointer (align/fused.py:
// _packed_views holds the layout). The full cold rows are separate.
//
// int32 arithmetic wraps as torch's does (w* helpers); float compares and
// the score's clamp and truncation are those of the plain version.
//
// What bounds it on an H100: bytes, about 2 KB a pair in and out (window,
// query and mask written by B6b and read by B4 and B6c), a few microseconds
// at P = 8,192; the chain tail a few argmax passes over registers. In
// practice it is latency bound: one launch per stage, every item of a stage
// independent, so each item's chain of dependent steps is kept short (B6a's
// and B6c's warp reductions by redux.sync, no block barrier inside a set or
// a pair, B6b's byte outputs written 16 bytes a store).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNeg = -1e30f;
constexpr int32_t kPadPos = 1 << 30;
constexpr int32_t kBig = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;
// flag bits of the hot row's third word (align/fused.py)
constexpr int32_t kHas = 1, kDiag = 2, kFullSpan = 4, kStrand = 8,
                  kPrimType = 16, kSup0 = 32, kProbe = 128;
// chain sets a B6b table holds, ChainResult fields, split segments
constexpr int kMaxBuckets = 8;
constexpr int kFields = 17;
constexpr int kMaxSup = 2;
// B6a: the longest anchor set kept in shared memory (19-21 bytes a slot);
// the longest set a warp takes (8 slots a lane) and the sets of its block
constexpr int kSmemSlots = 8192;
constexpr int kWarpMaxSlots = 256;
constexpr int kWarpSets = 8;

// -inf: below every value, so a thread with no slot never wins an argmax
__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}
__device__ __forceinline__ int32_t wsub(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a - (uint32_t)b);
}
__device__ __forceinline__ int32_t wmul(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a * (uint32_t)b);
}

// a[i] for a runtime i without indexing a register array (which would put
// it in local memory): a chain of selects over the compile-time indices
template <int N, typename T>
__device__ __forceinline__ T pick(const T (&a)[N], int i) {
  T v = a[0];
#pragma unroll
  for (int x = 1; x < N; x++)
    if (i == x) v = a[x];
  return v;
}

// (value, index) argmax: the larger value, on a tie the smaller index
__device__ __forceinline__ void arg_better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

// ---------------------------------------------------------------------------
// B6a: the chain tail
// ---------------------------------------------------------------------------

// the block's first index of its largest value; every thread passes its own
// (value, index) and gets the result. blockDim.x is a multiple of 32.
__device__ void block_argmax(float& v, int& i, float* sv, int* si) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, off);
    const int oi = __shfl_xor_sync(kFull, i, off);
    arg_better(v, i, ov, oi);
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    sv[warp] = v;
    si[warp] = i;
  }
  __syncthreads();
  v = sv[0];
  i = si[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); w++) arg_better(v, i, sv[w], si[w]);
  __syncthreads();
}

template <typename QT, typename IT>
struct TailState {
  const QT* qp;
  const IT* root;
  int32_t k;
  __device__ int32_t qs(int i) const { return (int32_t)qp[root[i]]; }
  __device__ int32_t qe(int i) const { return wadd((int32_t)qp[i], k); }
  // slot i's query interval overlaps [sqs, sqe) by at least half of the
  // shorter span, compared in f32 (ops/chain.py: overlap_frac_ok)
  __device__ bool ov_ok(int i, int32_t sqs, int32_t sqe) const {
    const int32_t a = qs(i), b = qe(i);
    const int32_t ov = max(wsub(min(b, sqe), max(a, sqs)), 0);
    const int32_t span = min(wsub(b, a), wsub(sqe, sqs));
    return __int2float_rn(ov) >= __fmul_rn(0.5f, __int2float_rn(span));
  }
};

// B6a's device workspace a set of a slots needs when it is longer than
// kSmemSlots: int32 pointers and counts, two of each, and the blocked bytes
__host__ __device__ inline int64_t select_ws_stride(int a) {
  return ((17 * (int64_t)a + 15) / 16) * 16;
}

// Output: int32 [11 + 6 * n_sup, P] as fields: score (f32 bits), count, qs,
// qe, rs, re, alt_score (f32 bits), alt_qs, alt_qe, alt_rs, alt_re, one
// [P] row each; then sup_score (f32 bits), sup_count, sup_qs, sup_qe, sup_rs,
// sup_re, one [P, n_sup] block each. ws == nullptr: the set in shared
// memory (f, rpos, qpos, then the pointers and counts as IT, the blocked
// bytes); else f, rpos and qpos read in place and the rest in ws.
template <typename QT, typename IT>
__global__ void chain_select_kernel(const float* __restrict__ f,
                                    const int32_t* __restrict__ parent,
                                    const int32_t* __restrict__ rpos,
                                    const QT* __restrict__ qpos, int p, int a,
                                    int k, int n_sup, int rounds,
                                    unsigned char* __restrict__ ws,
                                    int32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red_v[32];
  __shared__ int red_i[32];

  const int set = blockIdx.x;
  const int64_t row = (int64_t)set * a;
  const int t = threadIdx.x, nt = blockDim.x;
  const float* sf;
  const int32_t* srp;
  const QT* sqp;
  unsigned char* work;
  if (ws == nullptr) {
    float* xf = (float*)smem;
    int32_t* xr = (int32_t*)(xf + a);
    QT* xq = (QT*)(xr + a);
    for (int i = t; i < a; i += nt) {
      xf[i] = f[row + i];
      xr[i] = rpos[row + i];
      xq[i] = qpos[row + i];
    }
    sf = xf;
    srp = xr;
    sqp = xq;
    work = (unsigned char*)(xq + a);
  } else {
    sf = f + row;
    srp = rpos + row;
    sqp = qpos + row;
    work = ws + (int64_t)set * select_ws_stride(a);
  }
  IT* par0 = (IT*)work;
  IT* par1 = par0 + a;
  IT* cnt0 = par1 + a;
  IT* cnt1 = cnt0 + a;
  uint8_t* blocked = (uint8_t*)(cnt1 + a);
  for (int i = t; i < a; i += nt) {
    const int32_t pa = parent[row + i];  // -1 or a slot before i (B3)
    par0[i] = (IT)(pa >= 0 ? min(pa, a - 1) : i);
    cnt0[i] = pa >= 0 ? 1 : 0;
  }
  __syncthreads();
  // pointer doubling, the plain version's rounds: cnt += cnt[par]; par =
  // par[par]; roots loop on themselves with count 0
  IT *pc = par0, *pn = par1, *cc = cnt0, *cn = cnt1;
  for (int r = 0; r < rounds; r++) {
    for (int i = t; i < a; i += nt) {
      const int j = pc[i];
      cn[i] = (IT)(cc[i] + cc[j]);
      pn[i] = pc[j];
    }
    __syncthreads();
    IT* x = pc;
    pc = pn;
    pn = x;
    x = cc;
    cc = cn;
    cn = x;
  }
  const TailState<QT, IT> st{sqp, pc, k};
  const int P = p;
  float* outf = (float*)out;

  // primary: the first argmax of f
  float v = t < a ? sf[t] : neg_inf();
  int ix = t < a ? t : 0x7fffffff;
  for (int i = t + nt; i < a; i += nt)
    if (sf[i] > v) {
      v = sf[i];
      ix = i;
    }
  block_argmax(v, ix, red_v, red_i);
  const int end = ix;
  const float score1 = v;
  const int32_t qs1 = st.qs(end), qe1 = st.qe(end);
  const bool live1 = score1 > 0.f;
  const int prim_root = pc[end];
  if (t == 0) {
    outf[0 * P + set] = score1;
    out[1 * P + set] = (int32_t)cc[end] + 1;
    out[2 * P + set] = qs1;
    out[3 * P + set] = qe1;
    out[4 * P + set] = srp[prim_root];
    out[5 * P + set] = wadd(srp[end], k);
  }

  // s2 alt: the best valid slot overlapping the primary, off its root; the
  // slots the primary blocks for the split segments
  v = neg_inf();
  ix = 0x7fffffff;
  for (int i = t; i < a; i += nt) {
    const bool ov = live1 && st.ov_ok(i, qs1, qe1);
    const bool valid = srp[i] < kPadPos;
    const float x = (ov && valid && pc[i] != prim_root) ? sf[i] : kNeg;
    if (i == t || x > v) {
      v = x;
      ix = i;
    }
    blocked[i] = ov || !valid;
  }
  block_argmax(v, ix, red_v, red_i);
  if (t == 0) {
    const int e = ix;
    outf[6 * P + set] = v;
    out[7 * P + set] = st.qs(e);
    out[8 * P + set] = st.qe(e);
    out[9 * P + set] = srp[pc[e]];
    out[10 * P + set] = wadd(srp[e], k);
  }

  // split segments: greedily the best slot not yet blocked
  const int64_t sb = (int64_t)P * n_sup;
  for (int n = 0; n < n_sup; n++) {
    v = neg_inf();
    ix = 0x7fffffff;
    for (int i = t; i < a; i += nt) {
      const float x = blocked[i] ? kNeg : sf[i];
      if (i == t || x > v) {
        v = x;
        ix = i;
      }
    }
    block_argmax(v, ix, red_v, red_i);
    const int e = ix;
    const bool live = v > 0.f;
    const int32_t qs_n = st.qs(e), qe_n = st.qe(e);
    if (t == 0) {
      const int64_t o = 11 * (int64_t)P + (int64_t)set * n_sup + n;
      outf[o] = v;
      out[o + sb] = (int32_t)cc[e] + 1;
      out[o + 2 * sb] = qs_n;
      out[o + 3 * sb] = qe_n;
      out[o + 4 * sb] = srp[pc[e]];
      out[o + 5 * sb] = wadd(srp[e], k);
    }
    // each thread updates only its own slots: no barrier needed
    for (int i = t; i < a; i += nt)
      blocked[i] = blocked[i] || (live && (st.ov_ok(i, qs_n, qe_n) || i == e));
  }
}

// an order-preserving int32 key of a float (-0 as +0, so that equal floats
// give equal keys): a < b as floats iff key(a) < key(b)
__device__ __forceinline__ int32_t fkey(float x) {
  int32_t b = __float_as_int(x);
  b = b == (int32_t)0x80000000 ? 0 : b;
  return b >= 0 ? b : b ^ 0x7fffffff;
}

// the warp's first slot of its largest key: each lane passes its own best
// (key, slot), and every lane gets the winner's slot (torch.argmax's tie rule)
__device__ __forceinline__ int warp_argmax(int32_t key, int slot) {
  const int32_t top = __reduce_max_sync(kFull, key);
  return __reduce_min_sync(kFull, key == top ? slot : 0x7fffffff);
}

// B6a's block for sets of up to 32 N slots: warp w takes set kWarpSets *
// blockIdx.x + w, lane l its slots 32 s + l (s < N). Shared memory: the
// block's output stage [11 + 6 * n_sup fields x kWarpSets sets] (fields
// 0-10 a row of kWarpSets sets each, the six split-segment fields a run of
// kWarpSets * n_sup each, as the output lays them out), then, at N > 1, each
// warp's slice: the packed (root | count << 16), qpos and rpos of its slots.
template <typename QT, int N>
__global__ void __launch_bounds__(kWarpSets * 32)
    chain_select_warp_kernel(const float* __restrict__ f, const int32_t* __restrict__ parent,
                             const int32_t* __restrict__ rpos, const QT* __restrict__ qpos, int p,
                             int a, int k, int n_sup, int rounds, int32_t* __restrict__ out) {
  extern __shared__ __align__(16) int32_t wsm[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int set0 = blockIdx.x * kWarpSets;
  const int set = set0 + warp;
  int32_t* stage = wsm;
  float* stagef = (float*)wsm;
  const int sup0 = 11 * kWarpSets;  // the split-segment fields' stage
  const int sup_run = kWarpSets * n_sup;

  if (set < p) {
    const int64_t row = (int64_t)set * a;
    float fv[N];
    int32_t rp[N], qe[N], qs[N], par[N], cnt[N];
#pragma unroll
    for (int s = 0; s < N; s++) {
      const int i = 32 * s + lane;
      const bool in = i < a;
      fv[s] = in ? f[row + i] : neg_inf();  // a slot past A never wins
      rp[s] = in ? rpos[row + i] : kPadPos;
      qs[s] = in ? (int32_t)qpos[row + i] : 0;  // qpos until the roots are known
      const int32_t pa = in ? parent[row + i] : -1;  // -1 or a slot before i (B3)
      par[s] = pa >= 0 ? min(pa, a - 1) : i;
      cnt[s] = pa >= 0 ? 1 : 0;
    }
    // pointer doubling, the plain version's rounds: cnt += cnt[par]; par =
    // par[par], both from the round before; roots loop on themselves
    uint32_t* spc = (uint32_t*)wsm + 11 * kWarpSets + sup_run * 6 + warp * 3 * 32 * N;
    int32_t* sq = (int32_t*)spc + 32 * N;
    int32_t* sr = sq + 32 * N;
    if (N == 1) {
      for (int r = 0; r < rounds; r++) {
        const int32_t c = __shfl_sync(kFull, cnt[0], par[0]);
        par[0] = __shfl_sync(kFull, par[0], par[0]);
        cnt[0] += c;
      }
    } else {
#pragma unroll
      for (int s = 0; s < N; s++) {
        spc[32 * s + lane] = (uint32_t)par[s] | ((uint32_t)cnt[s] << 16);
        sq[32 * s + lane] = qs[s];
        sr[32 * s + lane] = rp[s];
      }
      __syncwarp();
      for (int r = 0; r < rounds; r++) {
        uint32_t nx[N];
#pragma unroll
        for (int s = 0; s < N; s++) nx[s] = spc[par[s]];
        __syncwarp();
#pragma unroll
        for (int s = 0; s < N; s++) {
          par[s] = (int32_t)(nx[s] & 0xffffu);
          cnt[s] += (int32_t)(nx[s] >> 16);
          spc[32 * s + lane] = (uint32_t)par[s] | ((uint32_t)cnt[s] << 16);
        }
        __syncwarp();
      }
    }
#pragma unroll
    for (int s = 0; s < N; s++) {
      qe[s] = wadd(qs[s], k);  // the end anchor of slot i is i itself
      qs[s] = N == 1 ? __shfl_sync(kFull, qs[0], par[0]) : sq[par[s]];
    }
    // the rpos of a slot's root, read only for the winners
    const int32_t rs0 = N == 1 ? __shfl_sync(kFull, rp[0], par[0]) : 0;
    auto root_rpos = [&](int so) { return N == 1 ? rs0 : sr[pick(par, so)]; };

    // the order keys of f (a slot past A holds -inf's, the least) and of
    // -1e30, the value of a masked slot; real: bit s set for a slot < A
    const int32_t key_neg = fkey(kNeg);
    int32_t kf[N];
    unsigned real = 0;
#pragma unroll
    for (int s = 0; s < N; s++) {
      kf[s] = fkey(fv[s]);
      real |= (unsigned)(32 * s + lane < a) << s;
    }
    // the slot of the first largest key(s) over the set
    auto argmax = [&](auto key) {
      int32_t bk = key(0);
      int bi = lane;
#pragma unroll
      for (int s = 1; s < N; s++) {
        const int32_t kx = key(s);
        if (kx > bk) {
          bk = kx;
          bi = 32 * s + lane;
        }
      }
      return warp_argmax(bk, bi);
    };
    // a real slot's key: f's when take, else -1e30's
    auto masked = [&](int s, bool take) { return ((real >> s) & 1u) ? (take ? kf[s] : key_neg) : kf[s]; };
    auto bcast = [&](const int32_t(&x)[N], int e) { return __shfl_sync(kFull, pick(x, e >> 5), e & 31); };
    auto ov_ok = [&](int s, int32_t sqs, int32_t sqe) {
      const int32_t ov = max(wsub(min(qe[s], sqe), max(qs[s], sqs)), 0);
      const int32_t span = min(wsub(qe[s], qs[s]), wsub(sqe, sqs));
      return __int2float_rn(ov) >= __fmul_rn(0.5f, __int2float_rn(span));
    };

    // primary: the first argmax of f
    const int e1 = argmax([&](int s) { return kf[s]; });
    const int s1 = e1 >> 5;
    const float score1 = __shfl_sync(kFull, pick(fv, s1), e1 & 31);
    const int32_t qs1 = bcast(qs, e1), qe1 = bcast(qe, e1), root1 = bcast(par, e1);
    const bool live1 = score1 > 0.f;
    if (lane == (e1 & 31)) {
      stagef[0 * kWarpSets + warp] = score1;
      stage[1 * kWarpSets + warp] = pick(cnt, s1) + 1;
      stage[2 * kWarpSets + warp] = qs1;
      stage[3 * kWarpSets + warp] = qe1;
      stage[4 * kWarpSets + warp] = root_rpos(s1);
      stage[5 * kWarpSets + warp] = wadd(pick(rp, s1), k);
    }

    // s2 alt: the best valid slot overlapping the primary, off its root; the
    // slots the primary blocks for the split segments (bit s: slot 32 s + lane)
    unsigned blocked = 0, alt = 0;
#pragma unroll
    for (int s = 0; s < N; s++) {
      const bool ov = live1 && ov_ok(s, qs1, qe1);
      const bool valid = rp[s] < kPadPos;
      alt |= (unsigned)(ov && valid && par[s] != root1) << s;
      blocked |= (unsigned)(ov || !valid) << s;
    }
    const int e2 = argmax([&](int s) { return masked(s, (alt >> s) & 1u); });
    if (lane == (e2 & 31)) {
      const int so = e2 >> 5;
      stagef[6 * kWarpSets + warp] = ((alt >> so) & 1u) ? pick(fv, so) : kNeg;
      stage[7 * kWarpSets + warp] = pick(qs, so);
      stage[8 * kWarpSets + warp] = pick(qe, so);
      stage[9 * kWarpSets + warp] = root_rpos(so);
      stage[10 * kWarpSets + warp] = wadd(pick(rp, so), k);
    }

    // split segments: greedily the best slot not yet blocked
    for (int n = 0; n < n_sup; n++) {
      const int e = argmax([&](int s) { return masked(s, !((blocked >> s) & 1u)); });
      const int so = e >> 5;
      const float v = __shfl_sync(kFull, ((blocked >> so) & 1u) ? kNeg : pick(fv, so), e & 31);
      const int32_t qs_n = bcast(qs, e), qe_n = bcast(qe, e);
      if (lane == (e & 31)) {
        const int o = sup0 + warp * n_sup + n;
        stagef[o] = v;
        stage[o + sup_run] = pick(cnt, so) + 1;
        stage[o + 2 * sup_run] = qs_n;
        stage[o + 3 * sup_run] = qe_n;
        stage[o + 4 * sup_run] = root_rpos(so);
        stage[o + 5 * sup_run] = wadd(pick(rp, so), k);
      }
      if (v > 0.f) {
#pragma unroll
        for (int s = 0; s < N; s++)
          blocked |= (unsigned)(ov_ok(s, qs_n, qe_n) || 32 * s + lane == e) << s;
      }
    }
  }
  __syncthreads();

  // each field row's run of the block's sets
  const int nw = min(kWarpSets, p - set0);
  for (int x = threadIdx.x; x < 11 * nw; x += blockDim.x) {
    const int r = x / nw;
    out[r * (int64_t)p + set0 + (x - r * nw)] = stage[r * kWarpSets + (x - r * nw)];
  }
  const int run = nw * n_sup;
  for (int x = threadIdx.x; x < 6 * run; x += blockDim.x) {
    const int r = x / run;
    out[(11 + r * (int64_t)n_sup) * p + (int64_t)set0 * n_sup + (x - r * run)] =
        stage[sup0 + r * sup_run + (x - r * run)];
  }
}

// ---------------------------------------------------------------------------
// B6b: candidate selection, window gather, strand-adjusted query
// ---------------------------------------------------------------------------

// the ChainResult fields of every anchor bucket, in ChainResult order; the
// buckets' rows stacked: flat set s of bucket b is row s - start[b], and
// s == start[nb] is the dummy set (no chain)
struct ChainTable {
  const void* field[kMaxBuckets][kFields];
  int start[kMaxBuckets + 1];
  int nb;
};

struct SelParams {
  int p, lmax, wlen, half, nqb, min_cnt, n_contigs;
  float min_score;
  int64_t pool_bytes, pool_codes;  // the pool's bytes and 4 * that
  bool pool_words;                 // the pool may be read as aligned 32-bit words
};

// the candidates of one pair in host insertion order [P+, P-, S+0.., S-0..]
// and their strand sets' alt fields; N = 2 * (1 + NSUP) is compile-time, so
// every loop over them unrolls and the arrays stay in registers
template <int NSUP>
struct Cands {
  static constexpr int N = 2 * (1 + NSUP);
  float sc[N];
  int32_t cnt[N], qs[N], qe[N], rs[N], re[N];
  float alt[2];
  int32_t alt_qs[2], alt_qe[2], alt_rs[2], alt_re[2];
  __host__ __device__ static constexpr int strand(int x) { return x < 2 ? x : (x - 2 >= NSUP ? 1 : 0); }
};

// fills side `side` of c from flat set s: the bucket found once, then the
// row's fields read straight from that bucket's arrays
template <int NSUP>
__device__ __forceinline__ void load_side(const ChainTable& tab, int s, int side,
                                          Cands<NSUP>& c) {
  const int total = tab.start[tab.nb];
  if (s < 0) s += total + 1;  // torch's index from the end
  int b = 0;
  while (b < tab.nb && s >= tab.start[b + 1]) b++;
  const bool dummy = b == tab.nb;  // -1e30 scores, zero coordinates
  const int64_t i = dummy ? 0 : s - tab.start[b];
  const void* const* fl = tab.field[dummy ? 0 : b];
  auto I = [&](int x, int64_t o) { return dummy ? 0 : ((const int32_t*)fl[x])[o]; };
  auto F = [&](int x, int64_t o) { return dummy ? kNeg : ((const float*)fl[x])[o]; };
  c.sc[side] = F(0, i);
  c.cnt[side] = I(1, i);
  c.qs[side] = I(2, i);
  c.qe[side] = I(3, i);
  c.rs[side] = I(4, i);
  c.re[side] = I(5, i);
  c.alt[side] = F(6, i);
  c.alt_qs[side] = I(7, i);
  c.alt_qe[side] = I(8, i);
  c.alt_rs[side] = I(9, i);
  c.alt_re[side] = I(10, i);
#pragma unroll
  for (int j = 0; j < NSUP; j++) {
    const int x = 2 + side * NSUP + j;
    const int64_t o = i * NSUP + j;
    c.sc[x] = F(11, o);
    c.cnt[x] = I(12, o);
    c.qs[x] = I(13, o);
    c.qe[x] = I(14, o);
    c.rs[x] = I(15, o);
    c.re[x] = I(16, o);
  }
}

// argmin of (-score, strand, qs, insertion order) over the candidates in
// mask: ascending c with strict comparisons, so the first wins a tie; c = 0
// when none is in mask (fused.py: lex_select)
template <int NSUP>
__device__ __forceinline__ void lex_select(const Cands<NSUP>& c, unsigned mask,
                                           bool& has, int& bc) {
  has = false;
  bc = 0;
  float bsc = kNeg;
  int bst = 0;
  int32_t bqs = 0;
#pragma unroll
  for (int x = 0; x < Cands<NSUP>::N; x++) {
    const float sc = c.sc[x];
    const int st = Cands<NSUP>::strand(x);
    const bool better =
        ((mask >> x) & 1u) &&
        (!has || sc > bsc || (sc == bsc && st < bst) ||
         (sc == bsc && st == bst && c.qs[x] < bqs));
    if (better) {
      bsc = sc;
      bst = st;
      bqs = c.qs[x];
      bc = x;
      has = true;
    }
  }
}

// the host's _qov(a, b) >= 0.5 in integers (fused.py: qov_ge_half)
__device__ __forceinline__ bool qov_ge_half(int32_t aqs, int32_t aqe,
                                            int32_t bqs, int32_t bqe) {
  const int32_t ov = max(wsub(min(aqe, bqe), max(aqs, bqs)), 0);
  const int32_t span = max(min(wsub(aqe, aqs), wsub(bqe, bqs)), 1);
  return wmul(2, ov) >= span;
}

// B6b's block: kSelPairs consecutive pairs, selected one a thread by the
// first kSelPairs threads, then gathered by all kSelThreads threads
constexpr int kSelPairs = 32;
constexpr int kSelThreads = 256;
constexpr int kMaxColdCols = 4 + 6 * kMaxSup + 5;

// what the selection hands the gather, per pair of the block
struct SelStage {
  int32_t w0[kSelPairs], lo[kSelPairs], hi[kSelPairs], ql[kSelPairs];
  uint8_t strand[kSelPairs];
  int32_t cold[kSelPairs * kMaxColdCols];
};

// 4 codes in the low byte -> 4 bytes, code i in byte i
__device__ __forceinline__ uint32_t expand4(uint32_t v) {
  uint32_t x = v & 0xffu;
  x = (x | (x << 12)) & 0x000F000Fu;
  return (x | (x << 6)) & 0x03030303u;
}

// 16 codes (code i at bits 2i) -> 16 bytes
__device__ __forceinline__ uint4 expand16(uint32_t v) {
  return make_uint4(expand4(v), expand4(v >> 8), expand4(v >> 16), expand4(v >> 24));
}

// the 16 2-bit codes from code position pos of a byte-packed row, code i at
// bits 2i: the 4 or 5 bytes they span read one by one and funnel-shifted;
// the caller keeps pos + 15 inside the row
__device__ __forceinline__ uint32_t codes16(const uint8_t* row, int pos) {
  const uint8_t* b = row + (pos >> 2);
  const int sh = (pos & 3) * 2;
  uint64_t u = (uint64_t)b[0] | ((uint64_t)b[1] << 8) | ((uint64_t)b[2] << 16) |
               ((uint64_t)b[3] << 24);
  if (sh) u |= (uint64_t)b[4] << 32;
  return (uint32_t)(u >> sh);
}

// the 16 2-bit groups of v in reverse order
__device__ __forceinline__ uint32_t rev2(uint32_t v) {
  const uint32_t x = __brev(v);
  return ((x >> 1) & 0x55555555u) | ((x & 0x55555555u) << 1);
}

// 16 bytes, byte i = fn(i), as a vector (no array, so nothing is indexed at
// run time even where the loops stay rolled)
template <typename Fn>
__device__ __forceinline__ uint4 bytes16(Fn fn) {
  auto four = [&](int i0) {
    uint32_t x = 0;
#pragma unroll
    for (int i = 0; i < 4; i++) x |= (uint32_t)fn(i0 + i) << (8 * i);
    return x;
  };
  return make_uint4(four(0), four(4), four(8), four(12));
}

// writes the block's rows [0, n) of a [., row] byte output whose first row
// is `out`: every 16-byte aligned chunk inside the rows as one vector store
// (a chunk inside one row from chunk(r, j), one across rows byte by byte),
// the unaligned bytes before the first and after the last chunk one by one;
// byte(r, j) is the value of row r, column j. n * row < 2^31 (the host
// checks it).
template <typename Chunk, typename Byte>
__device__ __forceinline__ void write_rows(uint8_t* out, int n, int row, Chunk chunk,
                                           Byte byte) {
  const int len = n * row;
  const int head = min((int)((16 - ((uintptr_t)out & 15)) & 15), len);
  const int n_vec = (len - head) >> 4;
  const int tail0 = head + 16 * n_vec;
  const int t = threadIdx.x;
  auto at = [&](int f) {
    const int r = f / row;
    return byte(r, f - r * row);
  };
  for (int f = t; f < head; f += kSelThreads) out[f] = at(f);
  for (int f = tail0 + t; f < len; f += kSelThreads) out[f] = at(f);
  for (int v = t; v < n_vec; v += kSelThreads) {
    const int f = head + 16 * v;
    const int r = f / row;
    const int j = f - r * row;
    *(uint4*)(out + f) = j + 16 <= row ? chunk(r, j) : bytes16([&](int i) { return at(f + i); });
  }
}

template <int NSUP, int NOUT>
__global__ void __launch_bounds__(kSelThreads) select_window_kernel(
    ChainTable tab, SelParams sp, const int32_t* __restrict__ cand_map,
    const int32_t* __restrict__ pair_base,
    const int32_t* __restrict__ pair_reflen,
    const uint8_t* __restrict__ q_pack, const int32_t* __restrict__ q_len,
    const uint8_t* __restrict__ pool, const int32_t* __restrict__ cst,
    const int32_t* __restrict__ clen, uint8_t* __restrict__ q_codes,
    uint8_t* __restrict__ rwin, uint8_t* __restrict__ rvalid,
    int32_t* __restrict__ lohi, int32_t* __restrict__ hot,
    float* __restrict__ flts, int32_t* __restrict__ cold_i,
    float* __restrict__ cold_f) {
  constexpr int kCols = 4 + 6 * NOUT + 5;
  __shared__ SelStage st;
  const int p0 = blockIdx.x * kSelPairs;
  const int n = min(kSelPairs, sp.p - p0);
  const int t = threadIdx.x;

  if (t < n) {
    const int pair = p0 + t;
    const int32_t base = pair_base[pair], reflen = pair_reflen[pair];
    const int32_t ql = q_len[pair];
    Cands<NSUP> c;
    load_side(tab, cand_map[2 * pair], 0, c);
    load_side(tab, cand_map[2 * pair + 1], 1, c);
    constexpr int N = Cands<NSUP>::N;
    unsigned valid = 0;
#pragma unroll
    for (int x = 0; x < N; x++)
      if (c.cnt[x] >= sp.min_cnt && c.sc[x] >= sp.min_score) valid |= 1u << x;

    bool has_prim;
    int pc;
    lex_select(c, valid, has_prim, pc);
    const float prim_score = pick(c.sc, pc);
    const int prim_strand = Cands<NSUP>::strand(pc);
    const int32_t prim_qs = pick(c.qs, pc), prim_qe = pick(c.qe, pc);
    const int32_t prim_rs = pick(c.rs, pc), prim_re = pick(c.re, pc);
    const bool prim_is_primary = pc < 2;
    const float prim_alt = prim_is_primary ? fmaxf(pick(c.alt, pc), 0.f) : 0.f;

    // s2: the best other candidate covering the primary, or the chain DP's alt
    float s2_cand = kNeg;
    int c2 = 0;
#pragma unroll
    for (int x = 0; x < N; x++) {
      const bool ok = ((valid >> x) & 1u) && x != pc &&
                      qov_ge_half(c.qs[x], c.qe[x], prim_qs, prim_qe);
      const float sc = ok ? c.sc[x] : kNeg;
      if (x == 0 || sc > s2_cand) {
        s2_cand = sc;
        c2 = x;
      }
    }
    const float alt_term = (prim_is_primary && has_prim) ? prim_alt : 0.f;
    const float s2 = has_prim ? fmaxf(fmaxf(s2_cand, alt_term), 0.f) : 0.f;
    const bool use_alt = alt_term > fmaxf(s2_cand, 0.f);
    const int ps = pc == 0 ? 0 : 1;  // the strand set of the alt (min(max(pc, 0), 1))

    // split segments: greedily the best candidate mostly disjoint from every
    // segment picked before (the primary first)
    int32_t* crow = st.cold + t * kCols;
    unsigned taken = 1u << pc;
    int32_t pk_qs[NOUT + 1], pk_qe[NOUT + 1];
    bool pk_live[NOUT + 1];
    pk_qs[0] = prim_qs;
    pk_qe[0] = prim_qe;
    pk_live[0] = has_prim;
    int32_t flags = (has_prim ? kHas : 0) | (prim_strand ? kStrand : 0) |
                    (prim_is_primary ? kPrimType : 0) | (s2 > 0.f ? kProbe : 0);
    float seg_sc[NOUT > 0 ? NOUT : 1];
#pragma unroll
    for (int s = 0; s < NOUT; s++) {
      unsigned ok = 0;
#pragma unroll
      for (int x = 0; x < N; x++) {
        bool blk = false;
#pragma unroll
        for (int q = 0; q <= s; q++)
          blk = blk || (qov_ge_half(c.qs[x], c.qe[x], pk_qs[q], pk_qe[q]) && pk_live[q]);
        if (((valid >> x) & 1u) && !((taken >> x) & 1u) && !blk && has_prim) ok |= 1u << x;
      }
      bool found;
      int ch;
      lex_select(c, ok, found, ch);
      if (found) {
        taken |= 1u << ch;
        flags |= kSup0 << s;
      }
      pk_qs[s + 1] = pick(c.qs, ch);
      pk_qe[s + 1] = pick(c.qe, ch);
      pk_live[s + 1] = found;
      int32_t* o = crow + 4 + 6 * s;
      o[0] = Cands<NSUP>::strand(ch);
      o[1] = pk_qs[s + 1];
      o[2] = pk_qe[s + 1];
      o[3] = pick(c.rs, ch);
      o[4] = pick(c.re, ch);
      o[5] = pick(c.cnt, ch);
      seg_sc[s] = pick(c.sc, ch);
    }

    // the window: the primary's contig by binary search over the starts
    const int32_t rs_c = wadd(min(max(prim_rs, 0), wsub(reflen, 1)), base);
    int lo_b = 0, hi_b = sp.n_contigs;  // first start > rs_c
    while (lo_b < hi_b) {
      const int mid = (lo_b + hi_b) >> 1;
      if (cst[mid] <= rs_c) lo_b = mid + 1;
      else hi_b = mid;
    }
    const int32_t ci = lo_b - 1;
    const int ci_l = ci < 0 ? ci + sp.n_contigs : ci;  // -1 reads the last
    const int32_t c_start = cst[ci_l];
    const int32_t c_end = wadd(c_start, clen[ci_l]);
    const int32_t w0 = wsub(wsub(wadd(base, prim_rs), prim_qs), sp.half);
    const int32_t lo = min(max(wsub(c_start, w0), 0), sp.wlen);
    const int32_t hi = min(max(wsub(c_end, w0), 0), sp.wlen);

    ((int4*)hot)[pair] = make_int4(wsub(w0, c_start), ci, flags, pick(c.cnt, pc));
    ((float2*)flts)[pair] = make_float2(prim_score, s2);
    ((int2*)lohi)[pair] = make_int2(lo, hi);
#pragma unroll
    for (int s = 0; s < NOUT; s++) cold_f[(int64_t)pair * NOUT + s] = seg_sc[s];
    crow[0] = prim_qs;
    crow[1] = prim_qe;
    crow[2] = prim_rs;
    crow[3] = prim_re;
    int32_t* pr = crow + 4 + 6 * NOUT;  // the MAPQ probe's coordinates
    pr[0] = use_alt ? prim_strand : Cands<NSUP>::strand(c2);
    pr[1] = use_alt ? pick(c.alt_qs, ps) : pick(c.qs, c2);
    pr[2] = use_alt ? pick(c.alt_qe, ps) : pick(c.qe, c2);
    pr[3] = use_alt ? pick(c.alt_rs, ps) : pick(c.rs, c2);
    pr[4] = use_alt ? pick(c.alt_re, ps) : pick(c.re, c2);
    st.w0[t] = w0;
    st.lo[t] = lo;
    st.hi[t] = hi;
    st.ql[t] = ql;
    st.strand[t] = (uint8_t)prim_strand;
  }
  __syncthreads();
  if (n <= 0) return;

  // the block's cold rows are one contiguous run of words
  int32_t* cdst = cold_i + (int64_t)p0 * kCols;
  for (int x = t; x < n * kCols; x += kSelThreads) cdst[x] = st.cold[x];

  // the window codes: 16 a chunk from two aligned pool words when the chunk
  // lies inside the pool (and int32), else code by code as the plain
  // version clamps them
  const uint32_t* pool32 = (const uint32_t*)pool;
  auto win_byte = [&](int r, int j) -> uint8_t {
    int64_t idx = wadd(st.w0[r], j);
    idx = idx < 0 ? 0 : (idx < sp.pool_codes ? idx : sp.pool_codes - 1);
    return (pool[idx >> 2] >> ((idx & 3) * 2)) & 3;
  };
  write_rows(rwin + (int64_t)p0 * sp.wlen, n, sp.wlen,
             [&](int r, int j) -> uint4 {
               const int64_t x = (int64_t)st.w0[r] + j;
               const int64_t k = x >> 4;
               if (sp.pool_words && x >= 0 && x + 15 <= 0x7fffffff &&
                   x + 16 <= sp.pool_codes && 4 * (k + 2) <= sp.pool_bytes) {
                 const uint32_t v =
                     __funnelshift_r(pool32[k], pool32[k + 1], (unsigned)(x & 15) * 2);
                 return expand16(v);
               }
               return bytes16([&](int i) { return win_byte(r, j + i); });
             },
             win_byte);

  // the in-contig mask
  auto valid_byte = [&](int r, int j) -> uint8_t { return j >= st.lo[r] && j < st.hi[r]; };
  write_rows(rvalid + (int64_t)p0 * sp.wlen, n, sp.wlen,
             [&](int r, int j) { return bytes16([&](int i) { return valid_byte(r, j + i); }); },
             valid_byte);

  // the strand-adjusted query: the forward codes, or the reverse complement
  // from them (3 - c is c ^ 3)
  const uint8_t* qrows = q_pack + (int64_t)p0 * sp.nqb;
  auto q_byte = [&](int r, int j) -> uint8_t {
    const uint8_t* qp = qrows + (int64_t)r * sp.nqb;
    if (st.strand[r] == 1) {
      const int32_t ql = st.ql[r];
      const int32_t x = min(max(wsub(wsub(ql, 1), j), 0), sp.lmax - 1);
      return j < ql ? (uint8_t)(3 - ((qp[x >> 2] >> ((x & 3) * 2)) & 3)) : 0;
    }
    return (qp[j >> 2] >> ((j & 3) * 2)) & 3;
  };
  write_rows(q_codes + (int64_t)p0 * sp.lmax, n, sp.lmax,
             [&](int r, int j) -> uint4 {
               const uint8_t* qp = qrows + (int64_t)r * sp.nqb;
               if (st.strand[r] != 1) return expand16(codes16(qp, j));
               const int32_t ql = st.ql[r];
               if (j >= ql) return make_uint4(0, 0, 0, 0);
               if (j + 16 <= ql && ql <= sp.lmax)  // codes ql-1-j down to ql-16-j
                 return expand16(rev2(codes16(qp, ql - 16 - j)) ^ 0xffffffffu);
               return bytes16([&](int i) { return q_byte(r, j + i); });
             },
             q_byte);
}

// ---------------------------------------------------------------------------
// B6c: gapless, Kadane and z-drop checks; the mismatch bits
// ---------------------------------------------------------------------------

struct FinParams {
  int p, lmax, wlen, match, mismatch, min_dp, zdrop;
};

// B6c's tile: 8 consecutive columns a lane
constexpr int kLaneCols = 8;
constexpr int kTileCols = 32 * kLaneCols;

// the window bytes of columns col0 .. col0 + 7 of a row of wlen bytes, as
// two little-endian words: from the aligned words that hold them (each
// holds one of them) by funnel shifts when all 8 lie in the row, else byte
// by byte at the plain version's clamped column
__device__ __forceinline__ uint2 window8(const uint8_t* __restrict__ w, int32_t col0, int wlen) {
  if (col0 >= 0 && col0 <= wlen - kLaneCols) {
    const int off = (int)((uintptr_t)(w + col0) & 3);
    const uint32_t* b = (const uint32_t*)(w + (col0 - off));
    const unsigned sh = (unsigned)off * 8;
    const uint32_t w0 = __ldg(b), w1 = __ldg(b + 1), w2 = sh ? __ldg(b + 2) : 0u;
    return make_uint2(__funnelshift_r(w0, w1, sh), __funnelshift_r(w1, w2, sh));
  }
  uint32_t lo = 0, hi = 0;
#pragma unroll
  for (int s = 0; s < 4; s++) {
    lo |= (uint32_t)w[min(max(wadd(col0, s), 0), wlen - 1)] << (8 * s);
    hi |= (uint32_t)w[min(max(wadd(col0, s + 4), 0), wlen - 1)] << (8 * s);
  }
  return make_uint2(lo, hi);
}

// the mismatch byte of 8 columns (byte s of q and w: column s), big-endian:
// column s at bit 7 - s. Each byte compare gives 0xff or 0; the masks keep
// one distinct bit of each, and the multiply sums the 4 bytes of a word
// into its top byte without a carry.
__device__ __forceinline__ uint32_t neq_byte(uint2 q, uint2 w) {
  const uint32_t lo = __vcmpne4(q.x, w.x) & 0x10204080u;
  const uint32_t hi = __vcmpne4(q.y, w.y) & 0x01020408u;
  return ((lo | hi) * 0x01010101u) >> 24;
}

// kOneTile: lmax <= kTileCols, the row held in registers from one load
// (and 32 registers against 44 for the loop over tiles: two thirds more
// warps an SM)
template <bool kOneTile>
__global__ void finish_pack_kernel(FinParams fp, const uint8_t* __restrict__ q_codes,
                                   const int32_t* __restrict__ q_len,
                                   const uint8_t* __restrict__ rwin,
                                   const int32_t* __restrict__ lohi,
                                   const float* __restrict__ ext_score,
                                   const int32_t* __restrict__ end_d,
                                   int32_t* __restrict__ hot,
                                   uint8_t* __restrict__ neq_bits) {
  const int lane = threadIdx.x & 31;
  const int pair = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (pair >= fp.p) return;  // warp-uniform
  const int32_t e = end_d[pair], ql = q_len[pair];
  const int32_t lo = lohi[2 * (int64_t)pair], hi = lohi[2 * (int64_t)pair + 1];
  // lane 0's last reads, issued first so that they are not on the tail
  int32_t* h = hot + 4 * (int64_t)pair + 2;
  const float ext = lane == 0 ? ext_score[pair] : 0.f;
  const int32_t h0 = lane == 0 ? *h : 0;
  const uint8_t* q = q_codes + (int64_t)pair * fp.lmax;
  const uint8_t* w = rwin + (int64_t)pair * fp.wlen;
  uint8_t* bits = neq_bits + (int64_t)pair * (fp.lmax >> 3);
  const int tiles = kOneTile ? 1 : (fp.lmax + kTileCols - 1) / kTileCols;

  // this lane's 8 columns j0 .. j0 + 7 of tile t: the mismatch byte, and
  // whether each column is in the contig or past the query
  uint32_t mb = 0;
  bool vok = true;
  auto load = [&](int t) {
    const int j0 = t * kTileCols + kLaneCols * lane;
    mb = 0;
    vok = true;
    if (j0 >= fp.lmax) return;  // lmax % 32 == 0: a lane's columns are all in or all out
    const int32_t col0 = wadd(e, j0);
    const int n_in = ql <= j0 ? 0 : min(ql - j0, kLaneCols);  // columns before ql
    mb = neq_byte(__ldg((const uint2*)(q + j0)), window8(w, col0, fp.wlen)) & ((0xff00u >> n_in) & 0xffu);
    if (col0 <= 0x7fffffff - kLaneCols) {  // no wrap: the n_in columns are one run
      vok = n_in == 0 || (col0 >= lo && col0 + n_in - 1 < hi);
    } else {
#pragma unroll
      for (int s = 0; s < kLaneCols; s++) {
        const int32_t col = wadd(col0, s);
        vok = vok && ((col >= lo && col < hi) || s >= n_in);
      }
    }
  };

  // pass 1: the mismatch count and whether every column is in the contig;
  // the mismatch bytes stored as they are
  int32_t neq_tot = 0;
  bool vall = true;
  for (int t = 0; t < tiles; t++) {
    load(t);
    neq_tot += __reduce_add_sync(kFull, __popc(mb));
    vall = vall && vok;
    const int j0 = t * kTileCols + kLaneCols * lane;
    if (j0 < fp.lmax) bits[j0 >> 3] = (uint8_t)mb;
  }
  vall = __all_sync(kFull, vall);

  // pass 2 (a row of one tile keeps it in registers): running count,
  // Kadane prefix/suffix minima, z-drop running peak, all over the
  // mismatch columns only, each lane looping over its set bits. The plain
  // version's column values, with cum the mismatches of columns 0 .. j,
  //   prefv = m (j + 1) - step cum, r_before = m j - step (cum - 1) and
  //   sufv = m (ql - j) - step (neq_tot - cum + 1),
  // are taken in the same wrapping int32 ring as (m j0 - step cum0) +
  // m (s + 1) - step r for the lane's r-th mismatch at column j0 + s,
  // prefv + (step - m) and (m ql - step (neq_tot + 1) + m) - prefv: the
  // same bits.
  const int32_t m = fp.match, step = wadd(fp.match, fp.mismatch);
  const int32_t d_rb = wsub(step, m);
  const int32_t k_suf = wadd(wsub(wmul(m, ql), wmul(step, wadd(neq_tot, 1))), m);
  int32_t carry = 0, peak = -kBig;
  int32_t min_pref = kBig, min_suf = kBig, dropmax = -kBig;
  for (int t = 0; t < tiles; t++) {
    if (tiles > 1) load(t);
    const int j0 = t * kTileCols + kLaneCols * lane;
    // the mismatches before this lane's columns: an exclusive scan of the
    // lanes' counts after the count carried in
    const int32_t c = __popc(mb);
    int32_t incl = c;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int32_t o = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += o;
    }
    const int32_t cum0 = carry + incl - c;
    // the lane's minima and largest r_before over its mismatch columns
    const int32_t base = wsub(wmul(m, j0), wmul(step, cum0));
    auto prefv = [&](int s, int32_t r) { return wadd(base, wsub(wmul(m, s + 1), wmul(step, r))); };
    int32_t lpeak = -kBig;
    uint32_t left = mb;
    for (int32_t r = 1; left; r++) {
      const int s = __clz(left) - 24;  // the next mismatch, column j0 + s (bit 7 - s)
      left ^= 0x80u >> s;
      const int32_t pv = prefv(s, r);
      min_pref = min(min_pref, pv);
      min_suf = min(min_suf, wsub(k_suf, pv));
      lpeak = max(lpeak, wadd(pv, d_rb));
    }
    // the running peak before this lane's columns: an exclusive max-scan of
    // the lanes' own peaks after the peak carried in
    int32_t pk = lpeak;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int32_t o = __shfl_up_sync(kFull, pk, off);
      if (lane >= off) pk = max(pk, o);
    }
    int32_t run = __shfl_up_sync(kFull, pk, 1);
    run = max(lane == 0 ? -kBig : run, peak);
    if (tiles > 1) {  // what the next tile carries in
      carry += __shfl_sync(kFull, incl, 31);
      peak = max(peak, __shfl_sync(kFull, pk, 31));
    }
    left = mb;
    for (int32_t r = 1; left; r++) {
      const int s = __clz(left) - 24;
      left ^= 0x80u >> s;
      const int32_t pv = prefv(s, r);
      run = max(run, wadd(pv, d_rb));
      dropmax = max(dropmax, wsub(run, pv));
    }
  }
  min_pref = __reduce_min_sync(kFull, min_pref);
  min_suf = __reduce_min_sync(kFull, min_suf);
  dropmax = __reduce_max_sync(kFull, dropmax);
  if (lane == 0) {
    const int32_t best_gapless =
        wsub(wmul(m, wsub(ql, neq_tot)), wmul(fp.mismatch, neq_tot));
    const int32_t ext_i = __float2int_rz(fminf(fmaxf(ext, -1e9f), 1e9f));
    const bool diag = vall && best_gapless == ext_i;
    const bool full = diag && best_gapless >= fp.min_dp &&
                      (neq_tot == 0 || (min_pref > 0 && min_suf > 0)) &&
                      dropmax <= fp.zdrop;
    *h = h0 | (diag ? kDiag : 0) | (full ? kFullSpan : 0) | (int32_t)((uint32_t)e << 8);
  }
}

// the cold rows that are needed (a gapped primary, a split segment or a
// probe), in pair order into the first cap slots; the other slots zeroed.
// One launch over many blocks, kCompactThreads rows a block, one a thread.
// Every block counts the need flags of all P rows (4-byte words, read from
// L2): those before its own rows give its first rank, all of them the slots
// used. No block waits on another, so the result is deterministic.
constexpr int kCompactThreads = 256;

__device__ __forceinline__ int cold_needed(int32_t fl) {
  return ((fl & kHas) && !(fl & kFullSpan)) || (fl & 0xE0);
}

template <int NOUT>
__global__ void __launch_bounds__(kCompactThreads)
    compact_cold_kernel(const int32_t* __restrict__ hot,
                        const int32_t* __restrict__ cold_i,
                        const float* __restrict__ cold_f, int p, int cap,
                        int32_t* __restrict__ cc_i, float* __restrict__ cc_f) {
  // the row widths as constants: the copies divide by them
  constexpr int ci_cols = 4 + 6 * NOUT + 5, cf_cols = NOUT;
  constexpr int kWarps = kCompactThreads / 32;
  __shared__ int s_before[kWarps], s_total[kWarps], s_own[kWarps];
  __shared__ int s_rows[kCompactThreads];  // the block's needed rows, in order
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int r0 = blockIdx.x * kCompactThreads;

  // unrolled so that several flag loads are in flight in each thread
  int before = 0, total = 0;
#pragma unroll 8
  for (int r = t; r < p; r += kCompactThreads) {
    const int nd = cold_needed(hot[4 * (int64_t)r + 2]);
    total += nd;
    before += r < r0 ? nd : 0;
  }
  before = __reduce_add_sync(kFull, before);
  total = __reduce_add_sync(kFull, total);
  const int r = r0 + t;
  const bool mine = r < p && cold_needed(hot[4 * (int64_t)r + 2]);
  const unsigned b = __ballot_sync(kFull, mine);
  if (lane == 0) {
    s_before[warp] = before;
    s_total[warp] = total;
    s_own[warp] = __popc(b);
  }
  __syncthreads();
  int first = 0, all = 0, own = 0, off = 0;
#pragma unroll
  for (int x = 0; x < kWarps; x++) {
    first += s_before[x];
    all += s_total[x];
    off += x < warp ? s_own[x] : 0;
    own += s_own[x];
  }
  if (mine) s_rows[off + __popc(b & ((1u << lane) - 1u))] = r;
  __syncthreads();

  // the block's ranks first .. first + own - 1 that fall below cap: one
  // contiguous run of slots, written by consecutive threads
  const int n_copy = max(0, min(own, cap - first));
#pragma unroll 4
  for (int w = t; w < n_copy * ci_cols; w += kCompactThreads) {
    const int d = w / ci_cols;
    cc_i[(int64_t)first * ci_cols + w] = cold_i[(int64_t)s_rows[d] * ci_cols + (w - d * ci_cols)];
  }
  if constexpr (cf_cols > 0) {
#pragma unroll 4
    for (int w = t; w < n_copy * cf_cols; w += kCompactThreads) {
      const int d = w / cf_cols;
      cc_f[(int64_t)first * cf_cols + w] = cold_f[(int64_t)s_rows[d] * cf_cols + (w - d * cf_cols)];
    }
  }
  // the unused slots [used, cap), shared out over the blocks
  const int used = min(all, cap);
  const int stride = gridDim.x * kCompactThreads;
  for (int x = used * ci_cols + blockIdx.x * kCompactThreads + t; x < cap * ci_cols; x += stride)
    cc_i[x] = 0;
  for (int x = used * cf_cols + blockIdx.x * kCompactThreads + t; x < cap * cf_cols; x += stride)
    cc_f[x] = 0.f;
}

constexpr int kPairThreads = 128;  // 4 pairs a block in B6c

template <int NSUP, int NOUT>
int launch_select_window(const ChainTable& tab, const SelParams& sp, const void* const* in,
                         void* const* out, cudaStream_t s) {
  const unsigned grid = (unsigned)((sp.p + kSelPairs - 1) / kSelPairs);
  select_window_kernel<NSUP, NOUT><<<grid, kSelThreads, 0, s>>>(
      tab, sp, (const int32_t*)in[0], (const int32_t*)in[1], (const int32_t*)in[2],
      (const uint8_t*)in[3], (const int32_t*)in[4], (const uint8_t*)in[5],
      (const int32_t*)in[6], (const int32_t*)in[7], (uint8_t*)out[0], (uint8_t*)out[1],
      (uint8_t*)out[2], (int32_t*)out[3], (int32_t*)out[4], (float*)out[5],
      (int32_t*)out[6], (float*)out[7]);
  return (int)cudaGetLastError();
}

template <int NSUP>
int launch_select_window(int n_out, const ChainTable& tab, const SelParams& sp,
                         const void* const* in, void* const* out, cudaStream_t s) {
  return n_out == 0 ? launch_select_window<NSUP, 0>(tab, sp, in, out, s)
       : n_out == 1 ? launch_select_window<NSUP, 1>(tab, sp, in, out, s)
                    : launch_select_window<NSUP, 2>(tab, sp, in, out, s);
}

static_assert(kMaxSup == 2, "launch_select_window instantiates n_sup and n_out 0..2");

template <typename QT, typename IT>
int launch_chain_select(const void* f, const void* parent, const void* rpos,
                        const void* qpos, int p, int a, int k, int n_sup,
                        int rounds, void* ws, void* out, cudaStream_t s) {
  auto kern = chain_select_kernel<QT, IT>;
  const size_t smem = ws ? 0 : (size_t)a * (4 + 4 + sizeof(QT) + 4 * sizeof(IT) + 1);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int threads = a >= 256 ? 256 : ((a + 31) / 32) * 32;
  kern<<<p, threads, smem, s>>>((const float*)f, (const int32_t*)parent,
                                (const int32_t*)rpos, (const QT*)qpos, p, a, k,
                                n_sup, rounds, (unsigned char*)ws, (int32_t*)out);
  return (int)cudaGetLastError();
}

template <typename QT, int N>
int launch_chain_select_warp(const void* f, const void* parent, const void* rpos,
                             const void* qpos, int p, int a, int k, int n_sup,
                             int rounds, void* out, cudaStream_t s) {
  auto kern = chain_select_warp_kernel<QT, N>;
  const size_t smem = 4 * (size_t)kWarpSets * ((11 + 6 * (size_t)n_sup) + (N > 1 ? 3 * 32 * N : 0));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned grid = (unsigned)((p + kWarpSets - 1) / kWarpSets);
  kern<<<grid, kWarpSets * 32, smem, s>>>((const float*)f, (const int32_t*)parent,
                                          (const int32_t*)rpos, (const QT*)qpos, p, a, k,
                                          n_sup, rounds, (int32_t*)out);
  return (int)cudaGetLastError();
}

// a set of a <= kWarpMaxSlots slots: a warp of ceil(a / 32) slots a lane,
// rounded up to a power of two
template <typename QT>
int launch_chain_select_warp(const void* f, const void* parent, const void* rpos,
                             const void* qpos, int p, int a, int k, int n_sup,
                             int rounds, void* out, cudaStream_t s) {
  auto go = [&](auto n) {
    return launch_chain_select_warp<QT, decltype(n)::value>(f, parent, rpos, qpos, p, a, k, n_sup,
                                                            rounds, out, s);
  };
  return a <= 32    ? go(std::integral_constant<int, 1>())
         : a <= 64  ? go(std::integral_constant<int, 2>())
         : a <= 128 ? go(std::integral_constant<int, 4>())
                    : go(std::integral_constant<int, 8>());
}

static_assert(kWarpMaxSlots == 8 * 32, "launch_chain_select_warp instantiates 1, 2, 4 and 8 slots a lane");

}  // namespace

extern "C" {

// B6a's device workspace in bytes for p sets of a slots: 0 when a set fits
// shared memory (a <= kSmemSlots).
int64_t phylign_chain_select_workspace(int p, int a) {
  return a <= kSmemSlots ? 0 : (int64_t)p * select_ws_stride(a);
}

// B6a. Returns a cudaError_t (0 on success). q16 != 0: qpos is uint16
// bits. ws: phylign_chain_select_workspace(p, a) bytes of device memory
// (null when that is 0). out: int32 [11 + 6 * n_sup, P]
// (chain_select_kernel's layout). A set of up to kWarpMaxSlots slots takes
// the warp kernel, a longer one the block kernel.
int phylign_chain_select(const void* f, const void* parent, const void* rpos,
                         const void* qpos, int q16, int p, int a, int k,
                         int n_sup, int rounds, void* ws, void* out,
                         void* stream) {
  if (p <= 0) return 0;
  if (a < 1 || n_sup < 0 || rounds < 1 || ((a > kSmemSlots) != (ws != nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (a <= kWarpMaxSlots)
    return q16 ? launch_chain_select_warp<uint16_t>(f, parent, rpos, qpos, p, a, k, n_sup, rounds, out, s)
               : launch_chain_select_warp<int32_t>(f, parent, rpos, qpos, p, a, k, n_sup, rounds, out, s);
  if (ws == nullptr)
    return q16 ? launch_chain_select<uint16_t, uint16_t>(f, parent, rpos, qpos, p, a, k, n_sup, rounds, ws, out, s)
               : launch_chain_select<int32_t, uint16_t>(f, parent, rpos, qpos, p, a, k, n_sup, rounds, ws, out, s);
  return q16 ? launch_chain_select<uint16_t, int32_t>(f, parent, rpos, qpos, p, a, k, n_sup, rounds, ws, out, s)
             : launch_chain_select<int32_t, int32_t>(f, parent, rpos, qpos, p, a, k, n_sup, rounds, ws, out, s);
}

// B6b. fields: n_buckets * 17 device pointers (host array, ChainResult order
// per bucket), rows: each bucket's sets (host array). Writes q_codes u8
// [P, lmax], rwin and rvalid u8 [P, wlen], lohi int32 [P, 2], the hot rows
// int32 [P, 4] (without the extension's bits) and flts f32 [P, 2], and the
// full cold rows cold_i int32 [P, 4 + 6 * n_out + 5], cold_f f32 [P, n_out].
int phylign_select_window(const void* const* fields, const int* rows,
                          int n_buckets, int n_sup, const void* cand_map,
                          const void* pair_base, const void* pair_reflen,
                          const void* q_pack, int nqb, const void* q_len,
                          const void* pool, int64_t pool_bytes,
                          const void* cst, const void* clen, int n_contigs,
                          int p, int lmax, int wlen, int half, int min_cnt,
                          float min_score, int n_out, void* q_codes,
                          void* rwin, void* rvalid, void* lohi, void* hot,
                          void* flts, void* cold_i, void* cold_f,
                          void* stream) {
  if (p <= 0) return 0;
  if (n_buckets < 1 || n_buckets > kMaxBuckets || n_sup < 0 ||
      n_sup > kMaxSup || n_out < 0 || n_out > kMaxSup || n_contigs < 1 ||
      pool_bytes < 1 || lmax < 1 || wlen < 1 ||
      (int64_t)kSelPairs * (lmax > wlen ? lmax : wlen) >= (int64_t)1 << 31 ||
      ((uintptr_t)hot & 15) || ((uintptr_t)flts & 7) || ((uintptr_t)lohi & 7))
    return (int)cudaErrorInvalidValue;
  ChainTable tab;
  tab.nb = n_buckets;
  tab.start[0] = 0;
  for (int b = 0; b < kMaxBuckets; b++) {
    for (int x = 0; x < kFields; x++)
      tab.field[b][x] = b < n_buckets ? fields[b * kFields + x] : nullptr;
    if (b < n_buckets) tab.start[b + 1] = tab.start[b] + rows[b];
  }
  const SelParams sp{p, lmax, wlen, half, nqb, min_cnt, n_contigs, min_score,
                     pool_bytes, 4 * pool_bytes, ((uintptr_t)pool & 3) == 0};
  const void* in[8] = {cand_map, pair_base, pair_reflen, q_pack, q_len, pool, cst, clen};
  void* out[8] = {q_codes, rwin, rvalid, lohi, hot, flts, cold_i, cold_f};
  cudaStream_t s = (cudaStream_t)stream;
  return n_sup == 0 ? launch_select_window<0>(n_out, tab, sp, in, out, s)
       : n_sup == 1 ? launch_select_window<1>(n_out, tab, sp, in, out, s)
                    : launch_select_window<2>(n_out, tab, sp, in, out, s);
}

// B6c. ORs the extension's flag bits and end_d into the hot rows int32
// [P, 4] and writes the mismatch bits u8 [P, lmax / 8]. lmax % 32 == 0;
// q_codes 8-byte aligned (its rows are read 8 bytes a lane).
int phylign_finish_pack(const void* q_codes, const void* q_len,
                        const void* rwin, const void* lohi,
                        const void* ext_score, const void* end_d, int p,
                        int lmax, int wlen, int match, int mismatch,
                        int min_dp, int zdrop, void* hot, void* neq,
                        void* stream) {
  if (p <= 0) return 0;
  if (lmax < 32 || lmax % 32 != 0 || wlen < lmax || ((uintptr_t)q_codes & 7))
    return (int)cudaErrorInvalidValue;
  const FinParams fp{p, lmax, wlen, match, mismatch, min_dp, zdrop};
  const unsigned grid = (unsigned)((p + kPairThreads / 32 - 1) / (kPairThreads / 32));
  auto kern = lmax <= kTileCols ? finish_pack_kernel<true> : finish_pack_kernel<false>;
  kern<<<grid, kPairThreads, 0, (cudaStream_t)stream>>>(
      fp, (const uint8_t*)q_codes, (const int32_t*)q_len,
      (const uint8_t*)rwin, (const int32_t*)lohi, (const float*)ext_score,
      (const int32_t*)end_d, (int32_t*)hot, (uint8_t*)neq);
  return (int)cudaGetLastError();
}

// B6c's second launch: from the hot rows int32 [P, 4] and the full cold
// rows, the compacted cold rows cc_i int32 [cap, 4 + 6 * n_out + 5] and cc_f
// f32 [cap, n_out]. One kernel launch.
int phylign_compact_cold(const void* hot, const void* cold_i,
                         const void* cold_f, int p, int n_out, int cap,
                         void* cc_i, void* cc_f, void* stream) {
  if (p <= 0) return 0;
  if (cap < 0 || cap > (1 << 24) || n_out < 0 || n_out > kMaxSup) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((p + kCompactThreads - 1) / kCompactThreads);
  auto kern = n_out == 0 ? compact_cold_kernel<0> : n_out == 1 ? compact_cold_kernel<1> : compact_cold_kernel<2>;
  kern<<<grid, kCompactThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)hot, (const int32_t*)cold_i, (const float*)cold_f, p, cap, (int32_t*)cc_i,
      (float*)cc_f);
  return (int)cudaGetLastError();
}

const char* phylign_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
