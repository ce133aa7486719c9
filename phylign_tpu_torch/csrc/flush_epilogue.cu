// Fused flush epilogue: kernel B6 of the align stage for Hopper (sm_90a),
// with a plain C interface loaded through ctypes (phylign_tpu_torch/ops/
// _kernels.py).
//
// Replaces the rest of the jitted align flush around the two scans: the tail
// of phylign_tpu/ops/chain.py:chain_anchors after its lax.scan (:184-274) and
// the body of phylign_tpu/align/fused.py:select_extend (jax.jit at :377):
// _select_extend_core (:104-344) and _compact_cold (:347-367). Four kernels,
// each equal bit for bit to its plain PyTorch version:
//   B6a chain_select   ops/chain.py:_chain_tail_ref. One block per anchor
//                      set: chain root and edge count of every slot by
//                      pointer doubling (the plain version's rounds), then
//                      the primary (first argmax of f), the s2 alt (best
//                      slot overlapping the primary off its root) and n_sup
//                      greedy split segments, each a block argmax; every
//                      ChainResult field out. Up to kSmemSlots slots the set
//                      lives in shared memory; a longer set reads its inputs
//                      in place and keeps its pointers and counts in a
//                      device workspace.
//   B6b select_window  align/fused.py:_select_ref. One warp per pair: every
//                      lane runs the pair's selection (<= 6 candidates read
//                      through cand_map from the buckets' ChainResults, no
//                      concatenation) redundantly, so nothing is shuffled;
//                      lane 0 writes the hot row (without the extension's
//                      bits), the scores and the cold row; the lanes gather
//                      the 2-bit window and the strand-adjusted query for
//                      kernel B4, and its in-contig mask.
//   B6c finish_pack    align/fused.py:_finish_ref. One warp per pair over
//                      the query columns, 32 at a time: the mismatch bit of
//                      a column by ballot, its running count by popcount,
//                      the running peak of the z-drop check by a shuffle
//                      max-scan; the big-endian mismatch bytes are the
//                      ballot's reversed bits. ORs the diagonal, full-span
//                      and end_d bits into the hot row.
//       compact_cold   align/fused.py:_compact_cold. One block: an ordered
//                      rank over the pairs' need flags (ballot + popcount),
//                      the first COLD_CAP needed cold rows copied in order,
//                      the other slots zeroed.
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
// at P = 8,192; the chain tail is a few argmax passes over shared memory.
// In practice it is launch and latency bound: the design is one launch per
// stage and a warp (or block) per independent item, simple and exact first.

#include <cuda_runtime.h>
#include <stdint.h>

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
constexpr int kMaxCand = 2 * (1 + kMaxSup);
// B6a: the longest anchor set kept in shared memory (19-21 bytes a slot)
constexpr int kSmemSlots = 8192;

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

struct SetRow {
  float score, alt;
  int32_t count, qs, qe, rs, re, alt_qs, alt_qe, alt_rs, alt_re;
  float sup_score[kMaxSup];
  int32_t sup_count[kMaxSup], sup_qs[kMaxSup], sup_qe[kMaxSup],
      sup_rs[kMaxSup], sup_re[kMaxSup];
};

__device__ SetRow load_set(const ChainTable& tab, int s, int n_sup) {
  SetRow r;
  const int total = tab.start[tab.nb];
  if (s < 0) s += total + 1;  // torch's index from the end
  int b = 0;
  while (b < tab.nb && s >= tab.start[b + 1]) b++;
  if (b == tab.nb) {  // the dummy row: -1e30 scores, zero coordinates
    r.score = r.alt = kNeg;
    r.count = r.qs = r.qe = r.rs = r.re = 0;
    r.alt_qs = r.alt_qe = r.alt_rs = r.alt_re = 0;
    for (int j = 0; j < kMaxSup; j++) {
      r.sup_score[j] = kNeg;
      r.sup_count[j] = r.sup_qs[j] = r.sup_qe[j] = r.sup_rs[j] = r.sup_re[j] = 0;
    }
    return r;
  }
  const int64_t i = s - tab.start[b];
  const void* const* fl = tab.field[b];
  auto I = [&](int x, int64_t o) { return ((const int32_t*)fl[x])[o]; };
  auto F = [&](int x, int64_t o) { return ((const float*)fl[x])[o]; };
  r.score = F(0, i);
  r.count = I(1, i);
  r.qs = I(2, i);
  r.qe = I(3, i);
  r.rs = I(4, i);
  r.re = I(5, i);
  r.alt = F(6, i);
  r.alt_qs = I(7, i);
  r.alt_qe = I(8, i);
  r.alt_rs = I(9, i);
  r.alt_re = I(10, i);
  for (int j = 0; j < kMaxSup; j++) {
    if (j < n_sup) {
      const int64_t o = i * n_sup + j;
      r.sup_score[j] = F(11, o);
      r.sup_count[j] = I(12, o);
      r.sup_qs[j] = I(13, o);
      r.sup_qe[j] = I(14, o);
      r.sup_rs[j] = I(15, o);
      r.sup_re[j] = I(16, o);
    }
  }
  return r;
}

struct Cands {
  float sc[kMaxCand];
  int32_t cnt[kMaxCand], qs[kMaxCand], qe[kMaxCand], rs[kMaxCand], re[kMaxCand];
  int st[kMaxCand];
  int n;
};

// argmin of (-score, strand, qs, insertion order) over the candidates in
// mask: ascending c with strict comparisons, so the first wins a tie; c = 0
// when none is in mask (fused.py: lex_select)
__device__ __forceinline__ void lex_select(const Cands& c, unsigned mask,
                                           bool& has, int& bc) {
  has = false;
  bc = 0;
  float bsc = kNeg;
  int bst = 0;
  int32_t bqs = 0;
  for (int x = 0; x < c.n; x++) {
    const float sc = c.sc[x];
    const bool better =
        ((mask >> x) & 1u) &&
        (!has || sc > bsc || (sc == bsc && c.st[x] < bst) ||
         (sc == bsc && c.st[x] == bst && c.qs[x] < bqs));
    if (better) {
      bsc = sc;
      bst = c.st[x];
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

struct SelParams {
  int p, lmax, wlen, half, nqb, n_sup, n_out, min_cnt, n_contigs;
  float min_score;
  int64_t pool_codes;  // 4 * the pool's bytes
};

__global__ void select_window_kernel(
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
  const int lane = threadIdx.x & 31;
  const int pair = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (pair >= sp.p) return;  // warp-uniform
  const int n_sup = sp.n_sup;

  // the candidates in host insertion order: [P+, P-, S+0.., S-0..]
  SetRow sr[2];
  sr[0] = load_set(tab, cand_map[2 * pair], n_sup);
  sr[1] = load_set(tab, cand_map[2 * pair + 1], n_sup);
  Cands c;
  c.n = 2 * (1 + n_sup);
  unsigned valid = 0;
  for (int x = 0; x < c.n; x++) {
    const int side = x < 2 ? x : (x - 2 >= n_sup);
    const SetRow& s = sr[side];
    if (x < 2) {
      c.sc[x] = s.score;
      c.cnt[x] = s.count;
      c.qs[x] = s.qs;
      c.qe[x] = s.qe;
      c.rs[x] = s.rs;
      c.re[x] = s.re;
    } else {
      const int j = x - 2 - side * n_sup;
      c.sc[x] = s.sup_score[j];
      c.cnt[x] = s.sup_count[j];
      c.qs[x] = s.sup_qs[j];
      c.qe[x] = s.sup_qe[j];
      c.rs[x] = s.sup_rs[j];
      c.re[x] = s.sup_re[j];
    }
    c.st[x] = side;
    if (c.cnt[x] >= sp.min_cnt && c.sc[x] >= sp.min_score) valid |= 1u << x;
  }

  bool has_prim;
  int pc;
  lex_select(c, valid, has_prim, pc);
  const float prim_score = c.sc[pc];
  const int prim_strand = c.st[pc];
  const int32_t prim_qs = c.qs[pc], prim_qe = c.qe[pc];
  const int32_t prim_rs = c.rs[pc], prim_re = c.re[pc];
  const bool prim_is_primary = pc < 2;
  const float prim_alt = prim_is_primary ? fmaxf(sr[pc].alt, 0.f) : 0.f;

  // s2: the best other candidate covering the primary, or the chain DP's alt
  float s2_cand = kNeg;
  int c2 = 0;
  for (int x = 0; x < c.n; x++) {
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
  const SetRow& ps = sr[min(max(pc, 0), 1)];

  // split segments: greedily the best candidate mostly disjoint from every
  // segment picked before (the primary first)
  unsigned taken = 1u << pc;
  int32_t pk_qs[kMaxSup + 1], pk_qe[kMaxSup + 1];
  bool pk_live[kMaxSup + 1];
  pk_qs[0] = prim_qs;
  pk_qe[0] = prim_qe;
  pk_live[0] = has_prim;
  int32_t flags = (has_prim ? kHas : 0) | (prim_strand ? kStrand : 0) |
                  (prim_is_primary ? kPrimType : 0) | (s2 > 0.f ? kProbe : 0);
  const int ci_cols = 4 + 6 * sp.n_out + 5;
  int32_t* crow = cold_i + (int64_t)pair * ci_cols;
  for (int s = 0; s < sp.n_out; s++) {
    unsigned ok = 0;
    for (int x = 0; x < c.n; x++) {
      bool blk = false;
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
    pk_qs[s + 1] = c.qs[ch];
    pk_qe[s + 1] = c.qe[ch];
    pk_live[s + 1] = found;
    if (lane == 0) {
      int32_t* o = crow + 4 + 6 * s;
      o[0] = c.st[ch];
      o[1] = c.qs[ch];
      o[2] = c.qe[ch];
      o[3] = c.rs[ch];
      o[4] = c.re[ch];
      o[5] = c.cnt[ch];
      cold_f[(int64_t)pair * sp.n_out + s] = c.sc[ch];
    }
  }

  // the window: the primary's contig by binary search over the starts
  const int32_t base = pair_base[pair];
  const int32_t rs_c =
      wadd(min(max(prim_rs, 0), wsub(pair_reflen[pair], 1)), base);
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

  if (lane == 0) {
    int32_t* h = hot + 4 * (int64_t)pair;
    h[0] = wsub(w0, c_start);
    h[1] = ci;
    h[2] = flags;
    h[3] = c.cnt[pc];
    flts[2 * (int64_t)pair] = prim_score;
    flts[2 * (int64_t)pair + 1] = s2;
    lohi[2 * (int64_t)pair] = lo;
    lohi[2 * (int64_t)pair + 1] = hi;
    crow[0] = prim_qs;
    crow[1] = prim_qe;
    crow[2] = prim_rs;
    crow[3] = prim_re;
    int32_t* pr = crow + 4 + 6 * sp.n_out;  // the MAPQ probe's coordinates
    pr[0] = use_alt ? prim_strand : c.st[c2];
    pr[1] = use_alt ? ps.alt_qs : c.qs[c2];
    pr[2] = use_alt ? ps.alt_qe : c.qe[c2];
    pr[3] = use_alt ? ps.alt_rs : c.rs[c2];
    pr[4] = use_alt ? ps.alt_re : c.re[c2];
  }

  const int64_t wrow = (int64_t)pair * sp.wlen;
  for (int j = lane; j < sp.wlen; j += 32) {
    int64_t idx = wadd(w0, j);
    idx = idx < 0 ? 0 : (idx < sp.pool_codes ? idx : sp.pool_codes - 1);
    rwin[wrow + j] = (pool[idx >> 2] >> ((idx & 3) * 2)) & 3;
    rvalid[wrow + j] = j >= lo && j < hi;
  }
  const uint8_t* qp = q_pack + (int64_t)pair * sp.nqb;
  const int32_t ql = q_len[pair];
  const int64_t qrow = (int64_t)pair * sp.lmax;
  for (int j = lane; j < sp.lmax; j += 32) {
    uint8_t code;
    if (prim_strand == 1) {
      // the reverse complement, from the forward codes
      const int32_t r = min(max(wsub(wsub(ql, 1), j), 0), sp.lmax - 1);
      code = j < ql ? (uint8_t)(3 - ((qp[r >> 2] >> ((r & 3) * 2)) & 3)) : 0;
    } else {
      code = (qp[j >> 2] >> ((j & 3) * 2)) & 3;
    }
    q_codes[qrow + j] = code;
  }
}

// ---------------------------------------------------------------------------
// B6c: gapless, Kadane and z-drop checks; the mismatch bits
// ---------------------------------------------------------------------------

struct FinParams {
  int p, lmax, wlen, match, mismatch, min_dp, zdrop;
};

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
  const uint8_t* q = q_codes + (int64_t)pair * fp.lmax;
  const uint8_t* w = rwin + (int64_t)pair * fp.wlen;
  const unsigned le_mask = 0xffffffffu >> (31 - lane);  // lanes <= this one

  // column j's mismatch bit and in-contig test
  auto column = [&](int j, bool& neq, bool& vseg) {
    const int32_t col = wadd(e, j);
    const bool in_q = j < ql;
    const int cc = min(max(col, 0), fp.wlen - 1);
    neq = in_q && q[j] != w[cc];
    vseg = (col >= lo && col < hi) || !in_q;
  };

  // pass 1: the mismatch count and whether every column is in the contig
  int32_t neq_tot = 0;
  bool vall = true;
  for (int j0 = 0; j0 < fp.lmax; j0 += 32) {
    bool neq, vseg;
    column(j0 + lane, neq, vseg);
    neq_tot += __popc(__ballot_sync(kFull, neq));
    vall = vall && vseg;
  }
  vall = __all_sync(kFull, vall);

  // pass 2: running count, Kadane prefix/suffix minima, z-drop running peak
  const int32_t m = fp.match, step = fp.match + fp.mismatch;
  int32_t carry = 0, peak = -kBig;
  int32_t min_pref = kBig, min_suf = kBig, dropmax = -kBig;
  uint8_t* bits = neq_bits + (int64_t)pair * (fp.lmax >> 3);
  for (int j0 = 0; j0 < fp.lmax; j0 += 32) {
    const int32_t j = j0 + lane;
    bool neq, vseg;
    column(j, neq, vseg);
    const unsigned b = __ballot_sync(kFull, neq);
    const int32_t cum = carry + __popc(b & le_mask);
    carry += __popc(b);
    const int32_t prefv = wsub(wmul(m, j + 1), wmul(step, cum));
    const int32_t sufv =
        wsub(wmul(m, wsub(ql, j)), wmul(step, wadd(wsub(neq_tot, cum), 1)));
    const int32_t r_before = wsub(wmul(m, j), wmul(step, wsub(cum, 1)));
    // inclusive max-scan over the lanes, after the peak carried in
    int32_t rp = neq ? r_before : -kBig;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int32_t o = __shfl_up_sync(kFull, rp, off);
      if (lane >= off) rp = max(rp, o);
    }
    rp = max(rp, peak);
    peak = __shfl_sync(kFull, rp, 31);
    if (neq) {
      min_pref = min(min_pref, prefv);
      min_suf = min(min_suf, sufv);
      dropmax = max(dropmax, wsub(rp, prefv));
    }
    // big-endian bytes: column 8i + s at bit 7 - s of byte i
    if (lane == 0) *(uint32_t*)(bits + (j0 >> 3)) = __byte_perm(__brev(b), 0, 0x0123);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    min_pref = min(min_pref, __shfl_xor_sync(kFull, min_pref, off));
    min_suf = min(min_suf, __shfl_xor_sync(kFull, min_suf, off));
    dropmax = max(dropmax, __shfl_xor_sync(kFull, dropmax, off));
  }
  if (lane == 0) {
    const int32_t best_gapless =
        wsub(wmul(m, wsub(ql, neq_tot)), wmul(fp.mismatch, neq_tot));
    const int32_t ext_i = __float2int_rz(fminf(fmaxf(ext_score[pair], -1e9f), 1e9f));
    const bool diag = vall && best_gapless == ext_i;
    const bool full = diag && best_gapless >= fp.min_dp &&
                      (neq_tot == 0 || (min_pref > 0 && min_suf > 0)) &&
                      dropmax <= fp.zdrop;
    int32_t* h = hot + 4 * (int64_t)pair + 2;
    *h = *h | (diag ? kDiag : 0) | (full ? kFullSpan : 0) |
         (int32_t)((uint32_t)e << 8);
  }
}

// the cold rows that are needed (a gapped primary, a split segment or a
// probe), in pair order into the first cap slots; the other slots zeroed
constexpr int kCompactThreads = 1024;

__global__ void __launch_bounds__(kCompactThreads)
    compact_cold_kernel(const int32_t* __restrict__ hot,
                        const int32_t* __restrict__ cold_i,
                        const float* __restrict__ cold_f, int p, int ci_cols,
                        int cf_cols, int cap, int32_t* __restrict__ cc_i,
                        float* __restrict__ cc_f) {
  __shared__ int warp_n[kCompactThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int base = 0;
  for (int r0 = 0; r0 < p; r0 += blockDim.x) {
    const int r = r0 + threadIdx.x;
    bool need = false;
    if (r < p) {
      const int32_t fl = hot[4 * (int64_t)r + 2];
      need = ((fl & kHas) && !(fl & kFullSpan)) || (fl & 0xE0);
    }
    const unsigned b = __ballot_sync(kFull, need);
    if (lane == 0) warp_n[warp] = __popc(b);
    __syncthreads();
    int before = 0, tot = 0;
    for (int x = 0; x < nw; x++) {
      before += x < warp ? warp_n[x] : 0;
      tot += warp_n[x];
    }
    const int rank = base + before + __popc(b & ((1u << lane) - 1u));
    if (need && rank < cap) {
      for (int x = 0; x < ci_cols; x++)
        cc_i[(int64_t)rank * ci_cols + x] = cold_i[(int64_t)r * ci_cols + x];
      for (int x = 0; x < cf_cols; x++)
        cc_f[(int64_t)rank * cf_cols + x] = cold_f[(int64_t)r * cf_cols + x];
    }
    base += tot;
    __syncthreads();
  }
  const int used = min(base, cap);
  for (int64_t x = (int64_t)used * ci_cols + threadIdx.x; x < (int64_t)cap * ci_cols; x += blockDim.x)
    cc_i[x] = 0;
  for (int64_t x = (int64_t)used * cf_cols + threadIdx.x; x < (int64_t)cap * cf_cols; x += blockDim.x)
    cc_f[x] = 0.f;
}

constexpr int kPairThreads = 128;  // 4 pairs a block in B6b and B6c

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
// (chain_select_kernel's layout).
int phylign_chain_select(const void* f, const void* parent, const void* rpos,
                         const void* qpos, int q16, int p, int a, int k,
                         int n_sup, int rounds, void* ws, void* out,
                         void* stream) {
  if (p <= 0) return 0;
  if (a < 1 || n_sup < 0 || rounds < 1 || ((a > kSmemSlots) != (ws != nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
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
      pool_bytes < 1 || lmax < 1 || wlen < 1)
    return (int)cudaErrorInvalidValue;
  ChainTable tab;
  tab.nb = n_buckets;
  tab.start[0] = 0;
  for (int b = 0; b < kMaxBuckets; b++) {
    for (int x = 0; x < kFields; x++)
      tab.field[b][x] = b < n_buckets ? fields[b * kFields + x] : nullptr;
    if (b < n_buckets) tab.start[b + 1] = tab.start[b] + rows[b];
  }
  const SelParams sp{p, lmax, wlen, half, nqb, n_sup, n_out, min_cnt,
                     n_contigs, min_score, 4 * pool_bytes};
  const unsigned grid = (unsigned)((p + kPairThreads / 32 - 1) / (kPairThreads / 32));
  select_window_kernel<<<grid, kPairThreads, 0, (cudaStream_t)stream>>>(
      tab, sp, (const int32_t*)cand_map, (const int32_t*)pair_base,
      (const int32_t*)pair_reflen, (const uint8_t*)q_pack,
      (const int32_t*)q_len, (const uint8_t*)pool, (const int32_t*)cst,
      (const int32_t*)clen, (uint8_t*)q_codes, (uint8_t*)rwin,
      (uint8_t*)rvalid, (int32_t*)lohi, (int32_t*)hot, (float*)flts, (int32_t*)cold_i,
      (float*)cold_f);
  return (int)cudaGetLastError();
}

// B6c. ORs the extension's flag bits and end_d into the hot rows int32
// [P, 4] and writes the mismatch bits u8 [P, lmax / 8]. lmax % 32 == 0.
int phylign_finish_pack(const void* q_codes, const void* q_len,
                        const void* rwin, const void* lohi,
                        const void* ext_score, const void* end_d, int p,
                        int lmax, int wlen, int match, int mismatch,
                        int min_dp, int zdrop, void* hot, void* neq,
                        void* stream) {
  if (p <= 0) return 0;
  if (lmax < 32 || lmax % 32 != 0 || wlen < lmax) return (int)cudaErrorInvalidValue;
  const FinParams fp{p, lmax, wlen, match, mismatch, min_dp, zdrop};
  const unsigned grid = (unsigned)((p + kPairThreads / 32 - 1) / (kPairThreads / 32));
  finish_pack_kernel<<<grid, kPairThreads, 0, (cudaStream_t)stream>>>(
      fp, (const uint8_t*)q_codes, (const int32_t*)q_len,
      (const uint8_t*)rwin, (const int32_t*)lohi, (const float*)ext_score,
      (const int32_t*)end_d, (int32_t*)hot, (uint8_t*)neq);
  return (int)cudaGetLastError();
}

// B6c's second launch: from the hot rows int32 [P, 4] and the full cold
// rows, the compacted cold rows cc_i int32 [cap, 4 + 6 * n_out + 5] and cc_f
// f32 [cap, n_out].
int phylign_compact_cold(const void* hot, const void* cold_i,
                         const void* cold_f, int p, int n_out, int cap,
                         void* cc_i, void* cc_f, void* stream) {
  if (p <= 0) return 0;
  if (cap < 0 || n_out < 0) return (int)cudaErrorInvalidValue;
  compact_cold_kernel<<<1, kCompactThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)hot, (const int32_t*)cold_i, (const float*)cold_f, p,
      4 + 6 * n_out + 5, n_out, cap, (int32_t*)cc_i, (float*)cc_f);
  return (int)cudaGetLastError();
}

const char* phylign_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
