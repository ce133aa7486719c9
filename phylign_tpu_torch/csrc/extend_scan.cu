// Banded dual-affine extension scan: kernel B4 of the align stage for
// Hopper (sm_90a), with a plain C interface loaded through ctypes
// (phylign_tpu_torch/ops/_kernels.py).
//
// Replaces the lax.scan of phylign_tpu/ops/extend.py:_extend_impl (its row
// function, extend.py:181-225). Contract (phylign_tpu_torch/ops/extend.py:
// extend_ref):
//   q       uint8 [P, L]           query codes 0..3 (strand-adjusted)
//   q_len   int32 [P]              query lengths (<= L)
//   rwin    uint8 [P, L + band]    ref window codes 0..3; row i, band cell d
//                                  reads column i + d
//   rvalid  uint8 [P, L + band]    1 where the column lies in the contig
//   score   f32 [P]                best cell of row q_len - 1 (-1e30 if none)
//   end_d   int32 [P]              its band offset, the lowest on ties
//   plane   f32 [P, L, band]       with `collect`: P = max(diag, I1, I2) of
//                                  every cell, the traceback's input
// The packed instance (phylign_extend_scan_packed) replaces the jitted
// programs phylign_tpu/ops/extend.py:extend_banded_scores_packed and
// extend_banded_packed, whose unpack and mask XLA fuses into the scan's
// reads. It takes the delegated extension's upload as it comes:
//   q_pack  uint8 [P, ceil(L/4)]   query codes, 4 a byte (code j in bits
//                                  2*(j%4) of byte j/4: ops/extend.pack2bit)
//   r_pack  uint8 [P, ceil((L + band)/4)]  ref window codes, the same way
//   lo, hi  int32 [P]              column j lies in the contig iff
//                                  lo <= j < hi (lo >= hi: none does)
// Its routes (ops/extend.py PACKED_ROUTES) at band 128 (both passes) and
// the score pass at band 256 run the wavefront body below
// (extend_wave_kernel), which replaces there the row body: at the
// delegated pass's few hundred pairs the grid is under one warp a
// scheduler, so a pair's own chain of rows is the time, and each row
// waited on a log2(G)-round shuffle scan and two passes over the lane's
// cells; the wavefront needs no scan, only a shuffle each way a step. The
// other routes keep the row body at 32 lanes, which reads code j and its
// validity in registers where the unpacked instances load rwin[j] and
// rvalid[j]: the prologue's selectors, the new window column a row and the
// query code a row.
// Glocal: row -1 is all zeros (free leading ref overhang). Per row,
// H = max(P, D1, D2) with insertions from row i-1 at d+1 and deletions as
// an exclusive prefix max of the keyed values P[d'] + d'*e.
//
// Integer DP. Every value of the plain version is an integer-valued f32
// below 2^24 in magnitude, or exactly -1e30 (f32 absorbs any such integer
// added to -1e30). The kernel runs the same recurrence in int32 with the
// sentinel kS = -2^28 for -1e30: a value derived from it stays below
// kT = -2^27 (at most a few bounded terms are added to it before a max
// drops it), every real value stays above, and values below kT leave the
// kernel as -1e30f. The wrapper checks the integer scoring and the 2^24
// bound and raises otherwise.
//
// What bounds it on an H100: instruction issue. A cell is ~15 integer
// instructions on registers and reads 2 bytes; rows depend on each other,
// so each pair is a chain of L dependent rows. The design:
//   * G lanes per pair (a template: 8, 16 or 32), band/G consecutive cells
//     per lane, 32/G pairs per warp; H, I1, I2 and the window's selectors
//     stay in registers from row to row. The per-row shuffles (the d+1
//     shift of H, I1, I2 and of the window, the group scans) use width-G
//     shuffles on the group's own mask and are amortised over band/G cells.
//   * Hopper's DPX instructions fuse the recurrence: insertions are
//     __viaddmax_s32(I[d+1], -e, H[d+1] - o), P = __vimax3_s32(diag, I1, I2),
//     the keyed deletion scan run = __viaddmax_s32(P, d*e, run), and
//     H = max(P, D1, D2) as two __viaddmax_s32 of the keyed prefixes and
//     -(open + d*e).
//   * The substitution score is one byte permute (prmt with sign
//     replication): each window cell keeps a selector that picks its byte
//     of a per-row table {match, -mismatch} indexed by the query code, or
//     the bytes of kS for a column outside the contig. Scoring whose match
//     or -mismatch does not fit a signed byte takes the kernel's WIDE
//     instance instead, chosen at launch: the same selector, compared with
//     the row's query code, picks from the int32 pair {match, -mismatch}
//     (a compare and two selects instead of the permute; the byte
//     instance is unchanged).
//   * Deletions: the lane's total of the keyed values (one DPX a cell), a
//     log2(G)-round shuffle scan of the totals across the group, then a
//     second in-lane pass that carries the exclusive prefix into each cell.
//   * The group's last lane loads the one new window column a row needs,
//     and every lane the row's query code, both a row ahead; a group loops
//     to its own pair's last row (pairs of a warp may differ).
//   * The row argmax (only the row q_len - 1) is an in-lane scan and a
//     width-G shuffle reduction, ties to the lowest d as jnp.argmax.
//   * Plane rows are stored as each lane's band/G consecutive floats with
//     16-byte stores: a group writes the row's 4*band contiguous bytes.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kS = -(1 << 28);  // the integer -1e30
constexpr int kT = -(1 << 27);  // below: derived from kS
// byte 4 of the permute is 0x00, byte 5 is 0xF0: selector 0x5444 gives kS
constexpr unsigned kSentinelBytes = 0x0000F000u;
constexpr unsigned kInvalidSel = 0x5444u;

struct IScoring {
  int match, mismatch;  // +match / -mismatch
  int o1, e1, o2, e2;   // insertion open (gap_open + gap_ext) and extend
  int do1, do2;         // deletion opens: the bare gap_open of a family
  unsigned mis4;        // the byte -mismatch in all four bytes
  unsigned mxor;        // (match ^ -mismatch) & 0xff
};

// int32 from byte (s & 7) of {b:a}, the sign of that byte replicated when
// the selector nibble has bit 3 (PTX prmt, generic mode)
__device__ __forceinline__ int prmt(unsigned a, unsigned b, unsigned s) {
  int r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(s));
  return r;
}

// the permute selector of a window column: byte (code) of the row's table,
// sign-extended, or kS outside the contig
__device__ __forceinline__ unsigned column_sel(uint8_t code, uint8_t valid) {
  return valid ? (unsigned)(code & 3) * 0x1111u + 0x8880u : kInvalidSel;
}

// the substitution score of the wide instance: match where the column's
// code equals the query's, -mismatch where it differs, kS outside the contig
__device__ __forceinline__ int wide_sub(unsigned sel, uint8_t qc,
                                        const IScoring& sc) {
  if (sel == kInvalidSel) return kS;
  return (sel & 3u) == (unsigned)(qc & 3) ? sc.match : -sc.mismatch;
}

__device__ __forceinline__ float to_f32(int v) {
  return v < kT ? kNeg : __int2float_rn(v);
}

// code j of a 2-bit packed row: bits 2*(j%4) of byte j/4
__device__ __forceinline__ uint8_t code2(const uint8_t* row, int j) {
  return (row[j >> 2] >> (2 * (j & 3))) & 3;
}

// at 16 cells a lane the compiler takes ~180 registers, 2 blocks an SM;
// capped for 3 blocks (no spill; measured faster on the score pass).
// kPacked: q and rwin are 2-bit packed rows and the window's validity is
// [lo, hi) (rvalid unused); otherwise lo and hi are unused.
template <int G, int CPL, bool kWide, bool kPacked>
__global__ void __launch_bounds__(128, CPL >= 16 ? 3 : 1)
    extend_scan_kernel(const uint8_t* __restrict__ q,
                       const int32_t* __restrict__ q_len,
                       const uint8_t* __restrict__ rwin,
                       const uint8_t* __restrict__ rvalid, int p, int l,
                       IScoring sc, int collect, float* __restrict__ score,
                       int32_t* __restrict__ end_d,
                       float* __restrict__ plane,
                       const int32_t* __restrict__ lo_col,
                       const int32_t* __restrict__ hi_col) {
  constexpr int band = G * CPL;
  const int lane = threadIdx.x & 31;
  const int t = lane & (G - 1);  // lane within the pair's group
  const unsigned gmask = (unsigned)((1ull << G) - 1ull) << (lane - t);
  const int pair = blockIdx.x * (blockDim.x / G) + threadIdx.x / G;
  if (pair >= p) return;  // group-uniform
  const int wlen = l + band;
  // a packed row of n codes is ceil(n/4) bytes
  const uint8_t* qrow = q + (int64_t)pair * (kPacked ? (l + 3) >> 2 : l);
  const uint8_t* rrow = rwin + (int64_t)pair * (kPacked ? (wlen + 3) >> 2 : wlen);
  const uint8_t* vrow = kPacked ? nullptr : rvalid + (int64_t)pair * wlen;
  const int lo = kPacked ? lo_col[pair] : 0, hi = kPacked ? hi_col[pair] : 0;
  // query code i, window column j's code and whether it lies in the contig
  // (j < wlen and i < l: the packing's padding codes are never read)
  auto query_code = [&](int i) -> uint8_t { return kPacked ? code2(qrow, i) : qrow[i]; };
  auto window_code = [&](int j) -> uint8_t { return kPacked ? code2(rrow, j) : rrow[j]; };
  auto window_valid = [&](int j) -> uint8_t { return kPacked ? (j >= lo && j < hi) : vrow[j]; };
  const int qlen = q_len[pair];
  const int rows = collect ? l : min(l, max(qlen, 0));
  const int d0 = t * CPL;
  const bool last_lane = t == G - 1;
  const int de1_0 = d0 * sc.e1, de2_0 = d0 * sc.e2;
  const int cd1_0 = sc.do1 + de1_0, cd2_0 = sc.do2 + de2_0;

  int h[CPL], i1[CPL], i2[CPL];
  unsigned sel[CPL];  // selector of window column i + d
#pragma unroll
  for (int c = 0; c < CPL; c++) {
    h[c] = 0;
    i1[c] = kS;
    i2[c] = kS;
    sel[c] = column_sel(window_code(d0 + c), window_valid(d0 + c));
  }
  float best = kNeg;
  int best_d = 0;
  // the next row's query code and new window column, loaded a row ahead
  uint8_t qc_next = rows > 0 ? query_code(0) : 0;
  uint8_t code_next = window_code(band), valid_next = window_valid(band);

  for (int i = 0; i < rows; i++) {
    const uint8_t qc = qc_next, code = code_next, valid = valid_next;
    if (i + 1 < rows) {
      qc_next = query_code(i + 1);
      code_next = window_code(i + band);
      valid_next = window_valid(i + band);
    }
    if (i > 0) {  // slide the window one column: cell d takes cell d+1's
      const unsigned nxt = __shfl_down_sync(gmask, sel[0], 1, G);
#pragma unroll
      for (int c = 0; c < CPL - 1; c++) sel[c] = sel[c + 1];
      sel[CPL - 1] = last_lane ? column_sel(code, valid) : nxt;
    }
    const unsigned lut = sc.mis4 ^ (sc.mxor << (8 * (qc & 3)));
    // the previous row at d+1 (the group's last cell reads past the band)
    int hs = __shfl_down_sync(gmask, h[0], 1, G);
    int i1s = __shfl_down_sync(gmask, i1[0], 1, G);
    int i2s = __shfl_down_sync(gmask, i2[0], 1, G);
    if (last_lane) hs = i1s = i2s = kS;
    int pm[CPL];
    int run1 = kS, run2 = kS;
#pragma unroll
    for (int c = 0; c < CPL; c++) {
      const int hn = c < CPL - 1 ? h[c + 1] : hs;
      const int i1n = c < CPL - 1 ? i1[c + 1] : i1s;
      const int i2n = c < CPL - 1 ? i2[c + 1] : i2s;
      const int hd = h[c] + (kWide ? wide_sub(sel[c], qc, sc)
                                   : prmt(lut, kSentinelBytes, sel[c]));
      const int n1 = __viaddmax_s32(i1n, -sc.e1, hn - sc.o1);
      const int n2 = __viaddmax_s32(i2n, -sc.e2, hn - sc.o2);
      i1[c] = n1;
      i2[c] = n2;
      pm[c] = __vimax3_s32(hd, n1, n2);
      run1 = __viaddmax_s32(pm[c], de1_0 + c * sc.e1, run1);
      run2 = __viaddmax_s32(pm[c], de2_0 + c * sc.e2, run2);
    }
    // exclusive prefix max of the lane totals across the group
#pragma unroll
    for (int off = 1; off < G; off <<= 1) {
      const int a1 = __shfl_up_sync(gmask, run1, off, G);
      const int a2 = __shfl_up_sync(gmask, run2, off, G);
      if (t >= off) {
        run1 = max(run1, a1);
        run2 = max(run2, a2);
      }
    }
    run1 = __shfl_up_sync(gmask, run1, 1, G);
    run2 = __shfl_up_sync(gmask, run2, 1, G);
    if (t == 0) run1 = run2 = kS;
#pragma unroll
    for (int c = 0; c < CPL; c++) {
      // H = max(P, D1, D2), D = (the keyed prefix) - (open + d*e)
      h[c] = __viaddmax_s32(run2, -(cd2_0 + c * sc.e2),
                            __viaddmax_s32(run1, -(cd1_0 + c * sc.e1), pm[c]));
      run1 = __viaddmax_s32(pm[c], de1_0 + c * sc.e1, run1);
      run2 = __viaddmax_s32(pm[c], de2_0 + c * sc.e2, run2);
    }
    if (collect) {
      float4* dst = reinterpret_cast<float4*>(plane + ((int64_t)pair * l + i) * band + d0);
#pragma unroll
      for (int c = 0; c < CPL; c += 4)
        dst[c / 4] = make_float4(to_f32(pm[c]), to_f32(pm[c + 1]),
                                 to_f32(pm[c + 2]), to_f32(pm[c + 3]));
    }
    if (i == qlen - 1) {  // group-uniform
      int bv = h[0];
      int bd = d0;
#pragma unroll
      for (int c = 1; c < CPL; c++) {
        if (h[c] > bv) {
          bv = h[c];
          bd = d0 + c;
        }
      }
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1) {
        const int ov = __shfl_xor_sync(gmask, bv, off, G);
        const int od = __shfl_xor_sync(gmask, bd, off, G);
        if (ov > bv || (ov == bv && od < bd)) {
          bv = ov;
          bd = od;
        }
      }
      best = to_f32(bv);
      best_d = bd;
    }
  }
  if (t == 0) {
    score[pair] = best;
    end_d[pair] = best_d;
  }
}

// --- the packed instance's wavefront body ------------------------------------
//
// One warp a pair sweeps the band's anti-diagonals t = 2i + d. Cell (i, d)
// reads (i, d-1) and (i-1, d+1), both on anti-diagonal t-1, and (i-1, d) on
// t-2, so the cells of one anti-diagonal are independent. Deletions run as
// the recurrence D(d) = max(D(d-1) - e, P(d-1) - (open + e)), which equals
// the row body's keyed prefix max (both unroll to the max over d' < d of
// P(d') - open - (d - d')*e), so no scan crosses a row.
//
// Lane k holds CPL = band/32 consecutive cells d = k*CPL + c. At step pair
// s (steps 2s and 2s+1) its cells 2m and 2m+1 are on row s - k*CPL/2 - m:
// the even cells move at step 2s, the odd ones at 2s+1, each from its
// neighbours' registers one step back and its own H two steps back. A
// lane's cell 0 reads lane k-1's top cell (P and the deletions) through
// three __shfl_up_sync; its top cell reads lane k+1's cell 0 (H and the
// insertions) through three __shfl_down_sync. Lanes 0 and 31 read their own
// values there and subtract kEdge (no select on the exchange's path). The
// state is stored with offsets that make each recurrence one DPX
// instruction: J = I + o (J = max(J[d+1] - e, H[d+1])), X = D + open + e
// (X = max(X[d-1] - e, P[d-1])); P = max(H + sub, J1 - o1, J2 - o2) and H =
// max(P, X1 - c1, X2 - c2) take two each: ten integer-pipe instructions a
// cell with the substitution's permute. 2(rows - 1) + band steps a pair;
// a cell of a negative row scores a substitution of 0, which leaves H = J
// = P = X = 0: row -1 (no guard in the first steps).
//
// Codes: before the sweep the warp builds two tables in its shared memory,
// the substitution's terms of each query code (its byte lookup table and
// the selector's sentinel bytes, 0 past the query's ends) and each window
// column's selector (from [lo, hi)). A cell's query code and window column
// advance by one a step pair, so a lane keeps its cells' entries in shift
// registers and loads one of each a step pair, a pair ahead.
//
// The score: a lane compares the H of its two cells on row q_len - 1 at the
// step pair they reach it (lowest d first), then one xor-shuffle reduction.
// The plane: each cell's P goes to a warp-private ring of band/2 rows of
// shared memory (row i at slot i mod band/2); row i is complete after step
// 2i + band - 1 and is then written by the warp in 16-byte stores, one
// contiguous pass of band*4 bytes; row i + band/2 first writes the slot at
// step 2i + band.
//
// What bounds it: the integer pipe and the step chain. At the delegated
// pass's P = 256-512 there is under one warp a scheduler, so a pair takes
// its own sweep's time: per step pair the integer pipe issues its cells'
// DPX instructions at half rate, and the two exchanges' shuffle latencies
// sit on the chain (the row body waited each row on a log2(G)-round scan
// and two passes over the lane's cells). A block is one warp: its pair
// index and loop bounds are uniform. Routes (ops/extend.py PACKED_ROUTES):
// the score and plane passes at band 128 and the score pass at band 256;
// the plane at band 256 (a ring of 128 KB a warp, one block an SM) and the
// bands 384 and 512 (2.5-2.7 times the row body's cells at 150-row reads:
// the sweep's empty triangles) measured slower and keep the row body.

constexpr int kMaxSharedBytes = 232448;
// subtracted from the values a lane-edge cell reads from its own lane (lane
// 0's left neighbour, lane 31's right one): they fall below kT as kS would
// (any value the DP holds, minus it, stays above INT_MIN)
constexpr int kEdge = 1 << 29;

// to_f32 with one integer-pipe instruction: 1 for a value below -1e8 (every
// value derived from kS is below kT; every real one is above -2^24), then
// -1e30 absorbs it, or 0 and the value is kept exactly
__device__ __forceinline__ float plane_f32(int v) {
  const float x = __int2float_rn(v);
  return __fmaf_rn(__saturatef(__fmaf_rn(x, -1e-6f, -100.0f)), kNeg, x);
}

template <int CPL, bool kWide, bool kCollect>
__global__ void __launch_bounds__(32)
    extend_wave_kernel(const uint8_t* __restrict__ q_pack,
                       const int32_t* __restrict__ q_len,
                       const uint8_t* __restrict__ r_pack,
                       const int32_t* __restrict__ lo_col,
                       const int32_t* __restrict__ hi_col, int l, IScoring sc,
                       float* __restrict__ score, int32_t* __restrict__ end_d,
                       float* __restrict__ plane) {
  constexpr int band = 32 * CPL;
  constexpr int H2 = CPL / 2;  // cells of one parity a lane
  constexpr int S = band / 2;  // rows of the plane's ring
  constexpr unsigned kFull = 0xffffffffu;
  extern __shared__ __align__(16) int wave_smem[];
  const int lane = threadIdx.x;
  const int pair = blockIdx.x;  // a warp a block
  int* ring = wave_smem;
  const int wlen = l + band;
  const int qlen = q_len[pair];
  const int rows = kCollect ? l : min(l, max(qlen, 0));
  const int qlast = qlen >= 1 && qlen <= rows ? qlen - 1 : -(1 << 30);
  const int lo = lo_col[pair];
  const unsigned vwidth = (unsigned)(max(hi_col[pair], lo) - lo);
  // the pair's tables: qtab[S + y] the substitution's terms of query code y
  // for y in [-S, l + S) (byte: the lookup table and the selector's
  // sentinel bytes; wide: the code and a mask), 0 (wide: code 5, mask 0)
  // past the query's ends so that a cell of a negative row scores 0;
  // wtab[x] window column x's (byte: the selector; wide: the code, or 4
  // outside the contig, and the mismatch score or kS)
  uint2* qtab = reinterpret_cast<uint2*>(ring + (kCollect ? S * band : 0));
  uint2* wtab = qtab + l + 2 * S;
  {
    const uint8_t* qrow = q_pack + (int64_t)pair * ((l + 3) >> 2);
    const uint8_t* rrow = r_pack + (int64_t)pair * ((wlen + 3) >> 2);
    for (int y = lane - S; y < l + S; y += 32) {
      uint2 t = make_uint2(kWide ? 5u : 0u, 0u);
      if (y >= 0 && y < l) {
        const unsigned qc = code2(qrow, y);
        t = kWide ? make_uint2(qc, ~0u)
                  : make_uint2(sc.mis4 ^ (sc.mxor << (8 * qc)), kSentinelBytes);
      }
      qtab[S + y] = t;
    }
    for (int x = lane; x < wlen; x += 32) {
      const unsigned rc = code2(rrow, x);
      const bool ok = (unsigned)(x - lo) < vwidth;
      wtab[x] = kWide ? make_uint2(ok ? rc : 4u, ok ? (unsigned)-sc.mismatch : (unsigned)kS)
                      : make_uint2(ok ? rc * 0x1111u + 0x8880u : kInvalidSel, 0u);
    }
  }
  __syncwarp();
  const int hh = lane * H2;  // cells 2m, 2m+1 at step pair s: row s - hh - m
  const int d0 = lane * CPL;
  const int c1 = sc.do1 + sc.e1, c2 = sc.do2 + sc.e2;  // a deletion's open + e
  const int el = lane == 0 ? kEdge : 0, er = lane == 31 ? kEdge : 0;

  // a cell's state from its last step: H, J = I + o, P, X = D + open + e
  int h[CPL], j1[CPL], j2[CPL], pv[CPL], x1[CPL], x2[CPL];
#pragma unroll
  for (int c = 0; c < CPL; c++) {
    h[c] = 0;  // row -1
    j1[c] = j2[c] = pv[c] = x1[c] = x2[c] = kS;
  }
  // shift registers, one step a pair: q[m] = qtab[S + s - hh - m] (row s -
  // hh - m), w[m] = wtab[s + hh + m]; the next pair's entries loaded ahead
  uint2 q[H2], w[H2 + 1];
#pragma unroll
  for (int m = 0; m < H2; m++) {
    q[m] = qtab[S - hh - 1 - m];  // before step pair 0's shift
    w[m + 1] = wtab[hh + m];
  }
  const uint2* qnext = qtab + S - hh;   // + s: query code s - hh
  const uint2* wnext = wtab + hh + H2;  // + s: window column s + hh + H2
  uint2 qn = qnext[0], wn = wnext[0];
  auto sub = [&](int m, int k) -> int {
    if (kWide) return w[k].x == q[m].x ? sc.match : (int)(w[k].y & q[m].y);
    return prmt(q[m].x, q[m].y, w[k].x);
  };
  // cell c from its own H (row i-1), its left neighbour's P and X (row i)
  // and its right neighbour's H and J (row i-1); ke and kx: e, or e + kEdge
  // at a lane edge
  auto cell = [&](int c, int sb, int pl, int xl1, int xl2, int hr, int jr1, int jr2, int ke1,
                  int ke2, int kx1, int kx2) {
    const int n1 = __viaddmax_s32(jr1, -ke1, hr);
    const int n2 = __viaddmax_s32(jr2, -ke2, hr);
    const int pc = __viaddmax_s32(n1, -sc.o1, __viaddmax_s32(n2, -sc.o2, h[c] + sb));
    const int y1 = __viaddmax_s32(xl1, -kx1, pl);
    const int y2 = __viaddmax_s32(xl2, -kx2, pl);
    h[c] = __viaddmax_s32(y1, -c1, __viaddmax_s32(y2, -c2, pc));
    j1[c] = n1;
    j2[c] = n2;
    pv[c] = pc;
    x1[c] = y1;
    x2[c] = y2;
  };
  int bv = INT_MIN, bd = 0;
  if (rows > 0) {
    const int s_end = rows + S - 2;  // its odd step: 2(rows - 1) + band - 1
#pragma unroll 4
    for (int s = 0; s <= s_end; s++) {
#pragma unroll
      for (int m = H2 - 1; m > 0; m--) q[m] = q[m - 1];
#pragma unroll
      for (int m = 0; m < H2; m++) w[m] = w[m + 1];
      q[0] = qn;
      w[H2] = wn;
      qn = qnext[s + 1];  // inside the tables: their pads cover s_end + 1
      wn = wnext[s + 1];
      const int ib = s - hh;  // the row of cells 0 and 1
      // step 2s: the even cells; cell 0 reads lane k-1's top cell
      const int pl = __shfl_up_sync(kFull, pv[CPL - 1], 1) - el;
      const int xl1 = __shfl_up_sync(kFull, x1[CPL - 1], 1);
      const int xl2 = __shfl_up_sync(kFull, x2[CPL - 1], 1);
#pragma unroll
      for (int m = 0; m < H2; m++) {
        const int c = 2 * m;
        if (c == 0)
          cell(c, sub(m, m), pl, xl1, xl2, h[1], j1[1], j2[1], sc.e1, sc.e2, sc.e1 + el,
               sc.e2 + el);
        else
          cell(c, sub(m, m), pv[c - 1], x1[c - 1], x2[c - 1], h[c + 1], j1[c + 1], j2[c + 1],
               sc.e1, sc.e2, sc.e1, sc.e2);
        if (kCollect) ring[((ib - m) & (S - 1)) * band + d0 + c] = pv[c];
      }
      // step 2s + 1: the odd cells; the top one reads lane k+1's cell 0
      const int hr = __shfl_down_sync(kFull, h[0], 1) - er;
      const int jr1 = __shfl_down_sync(kFull, j1[0], 1);
      const int jr2 = __shfl_down_sync(kFull, j2[0], 1);
#pragma unroll
      for (int m = 0; m < H2; m++) {
        const int c = 2 * m + 1;
        if (c == CPL - 1)
          cell(c, sub(m, m + 1), pv[c - 1], x1[c - 1], x2[c - 1], hr, jr1, jr2, sc.e1 + er,
               sc.e2 + er, sc.e1, sc.e2);
        else
          cell(c, sub(m, m + 1), pv[c - 1], x1[c - 1], x2[c - 1], h[c + 1], j1[c + 1],
               j2[c + 1], sc.e1, sc.e2, sc.e1, sc.e2);
        if (kCollect) ring[((ib - m) & (S - 1)) * band + d0 + c] = pv[c];
      }
      if (kCollect) {  // row s + 1 - S is complete: write it
        const int r = s + 1 - S;
        if (r >= 0 && r < rows) {
          __syncwarp();
          const int* src = ring + (r & (S - 1)) * band;
          float* dst = plane + ((int64_t)pair * l + r) * band;
#pragma unroll
          for (int n = 0; n < band / 128; n++) {
            const int k = lane + 32 * n;
            const int4 v = reinterpret_cast<const int4*>(src)[k];
            reinterpret_cast<float4*>(dst)[k] =
                make_float4(plane_f32(v.x), plane_f32(v.y), plane_f32(v.z), plane_f32(v.w));
          }
        }
      }
      const int mq = ib - qlast;  // cells 2mq, 2mq + 1 hold row q_len - 1
      if ((unsigned)mq < (unsigned)H2) {
#pragma unroll
        for (int m = 0; m < H2; m++) {
          if (m == mq) {
            if (h[2 * m] > bv) {
              bv = h[2 * m];
              bd = d0 + 2 * m;
            }
            if (h[2 * m + 1] > bv) {
              bv = h[2 * m + 1];
              bd = d0 + 2 * m + 1;
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int ov = __shfl_xor_sync(kFull, bv, off);
    const int od = __shfl_xor_sync(kFull, bd, off);
    if (ov > bv || (ov == bv && od < bd)) {
      bv = ov;
      bd = od;
    }
  }
  if (lane == 0) {
    score[pair] = to_f32(bv);
    end_d[pair] = bd;
  }
}

template <int CPL, bool kWide, bool kCollect>
cudaError_t launch_wave(const void* q, const void* q_len, const void* r,
                        const void* lo, const void* hi, int p, int l,
                        const IScoring& sc, void* score, void* end_d,
                        void* plane, cudaStream_t stream) {
  constexpr int band = 32 * CPL;
  // a block is one warp (one pair): the plane's ring (band/2 rows), then
  // the tables of the query codes (band/2 entries of pad at each end) and
  // of the window columns
  const size_t smem = (size_t)(kCollect ? band * band / 2 : 0) * 4 + (size_t)(2 * l + 2 * band) * 8;
  if (smem > (size_t)kMaxSharedBytes) return cudaErrorInvalidValue;
  auto kernel = extend_wave_kernel<CPL, kWide, kCollect>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<p, 32, smem, stream>>>((const uint8_t*)q, (const int32_t*)q_len,
                                  (const uint8_t*)r, (const int32_t*)lo,
                                  (const int32_t*)hi, l, sc, (float*)score,
                                  (int32_t*)end_d, (float*)plane);
  return cudaGetLastError();
}

// the wavefront instance of a route (band, wide, collect): the score and
// plane passes at band 128, the score pass at band 256
template <bool kWide>
cudaError_t launch_wave_band(int band, int collect, const void* q,
                             const void* q_len, const void* r, const void* lo,
                             const void* hi, int p, int l, const IScoring& sc,
                             void* score, void* end_d, void* plane,
                             cudaStream_t stream) {
#define PHYLIGN_B4W(B, C)                                                        \
  if (band == B && collect == C)                                                \
    return launch_wave<B / 32, kWide, C>(q, q_len, r, lo, hi, p, l, sc, score, \
                                         end_d, plane, stream);
  PHYLIGN_B4W(128, 0)
  PHYLIGN_B4W(128, 1)
  PHYLIGN_B4W(256, 0)
#undef PHYLIGN_B4W
  return cudaErrorInvalidValue;
}

template <int G, int CPL, bool kPacked>
cudaError_t launch(const void* q, const void* q_len, const void* rwin,
                   const void* rvalid, const void* lo, const void* hi, int p,
                   int l, const IScoring& sc, int wide, int collect,
                   void* score, void* end_d, void* plane, void* stream) {
  constexpr int kThreads = 128;
  const unsigned grid = (unsigned)((p + kThreads / G - 1) / (kThreads / G));
  if (wide)
    extend_scan_kernel<G, CPL, true, kPacked><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)q, (const int32_t*)q_len, (const uint8_t*)rwin,
        (const uint8_t*)rvalid, p, l, sc, collect, (float*)score,
        (int32_t*)end_d, (float*)plane, (const int32_t*)lo, (const int32_t*)hi);
  else
    extend_scan_kernel<G, CPL, false, kPacked><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)q, (const int32_t*)q_len, (const uint8_t*)rwin,
        (const uint8_t*)rvalid, p, l, sc, collect, (float*)score,
        (int32_t*)end_d, (float*)plane, (const int32_t*)lo, (const int32_t*)hi);
  return cudaGetLastError();
}

// checks the arguments and launches the (band, lanes) instance
template <bool kPacked>
int extend_scan(const void* q, const void* q_len, const void* rwin,
                const void* rvalid, const void* lo, const void* hi, int p,
                int l, int band, int lanes, int match, int mismatch, int o1,
                int e1, int o2, int e2, int open1, int open2, int wide,
                int collect, void* score, void* end_d, void* plane,
                void* stream) {
  if (p <= 0) return 0;
  if (l < 1 || match < 0 || mismatch < 0 ||
      (!wide && (match > 127 || mismatch > 128)) ||
      (collect && ((uintptr_t)plane & 15u)))
    return (int)cudaErrorInvalidValue;
  const unsigned mis = (unsigned)(-mismatch) & 0xffu;
  const IScoring sc{match, mismatch, o1, e1, o2, e2, open1, open2,
                    mis * 0x01010101u, ((unsigned)match ^ mis) & 0xffu};
  if constexpr (kPacked) {
    if (lanes == 0)  // the wavefront body
      return (int)(wide ? launch_wave_band<true> : launch_wave_band<false>)(
          band, collect, q, q_len, rwin, lo, hi, p, l, sc, score, end_d, plane,
          (cudaStream_t)stream);
  }
  // the row body: every geometry unpacked; packed, 32 lanes at every band
  // (the routes the wavefront leaves to it, and queries whose tables
  // exceed its shared memory: ops/extend.py packed_lanes)
#define PHYLIGN_B4(G, B, ROUTED)                                                \
  if constexpr (!kPacked || ROUTED)                                             \
    if (lanes == G && band == B)                                                \
      return (int)launch<G, B / G, kPacked>(q, q_len, rwin, rvalid, lo, hi, p,  \
                                            l, sc, wide, collect, score, end_d, \
                                            plane, stream);
  PHYLIGN_B4(8, 128, false)
  PHYLIGN_B4(16, 128, false)
  PHYLIGN_B4(32, 128, true)
  PHYLIGN_B4(16, 256, false)
  PHYLIGN_B4(32, 256, true)
  PHYLIGN_B4(32, 384, true)
  PHYLIGN_B4(32, 512, true)
#undef PHYLIGN_B4
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success). (band, lanes) must be one of the
// instances above; the scoring values are the integers the wrapper checked.
// wide = 0 takes the byte-permute substitution (match <= 127, mismatch <=
// 128), wide = 1 the int32 one (any scoring).
int phylign_extend_scan(const void* q, const void* q_len, const void* rwin,
                        const void* rvalid, int p, int l, int band, int lanes,
                        int match, int mismatch, int o1, int e1, int o2,
                        int e2, int open1, int open2, int wide, int collect,
                        void* score, void* end_d, void* plane, void* stream) {
  return extend_scan<false>(q, q_len, rwin, rvalid, nullptr, nullptr, p, l,
                            band, lanes, match, mismatch, o1, e1, o2, e2,
                            open1, open2, wide, collect, score, end_d, plane,
                            stream);
}

// The same from the 2-bit packed rows q_pack [P, ceil(l/4)] and r_pack
// [P, ceil((l + band)/4)] and the window bounds lo, hi [P]. lanes = 0
// takes the wavefront body (a warp a pair: both passes at band 128, the
// score pass at band 256, up to its shared memory), lanes = 32 the row body
// at 32 lanes a pair (every band).
int phylign_extend_scan_packed(const void* q_pack, const void* q_len,
                               const void* r_pack, const void* lo,
                               const void* hi, int p, int l, int band,
                               int lanes, int match, int mismatch, int o1,
                               int e1, int o2, int e2, int open1, int open2,
                               int wide, int collect, void* score,
                               void* end_d, void* plane, void* stream) {
  return extend_scan<true>(q_pack, q_len, r_pack, nullptr, lo, hi, p, l, band,
                           lanes, match, mismatch, o1, e1, o2, e2, open1,
                           open2, wide, collect, score, end_d, plane, stream);
}

const char* phylign_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
