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
// and reads code j and its validity in registers where the unpacked
// instances load rwin[j] and rvalid[j]: the prologue's selectors, the new
// window column a row and the query code a row. Nothing else differs.
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
#define PHYLIGN_B4(G, B)                                                      \
  if (lanes == G && band == B)                                                \
    return (int)launch<G, B / G, kPacked>(q, q_len, rwin, rvalid, lo, hi, p,  \
                                          l, sc, wide, collect, score, end_d, \
                                          plane, stream);
  PHYLIGN_B4(8, 128)
  PHYLIGN_B4(16, 128)
  PHYLIGN_B4(32, 128)
  PHYLIGN_B4(16, 256)
  PHYLIGN_B4(32, 256)
  PHYLIGN_B4(32, 384)
  PHYLIGN_B4(32, 512)
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
// [P, ceil((l + band)/4)] and the window bounds lo, hi [P].
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
