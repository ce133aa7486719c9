// The delegated extension's traceback on the card: each gapped pair's edit
// ops from kernel B4's P plane, with a plain C interface loaded through
// ctypes (phylign_tpu_torch/ops/_kernels.py).
//
// Replaces the host's ops/extend.reconstruct_planes + traceback_walk for a
// plane that lives on one card, so the plane never leaves it. Contract
// (phylign_tpu_torch/ops/extend.py: traceback_ref, held to traceback_walk):
//   plane   f32 [>= n, L, band]   B4's plane pass: P = max(diag, I1, I2)
//   q_pack  uint8 [>= n, ceil(L/4)]           query codes, 4 a byte
//   r_pack  uint8 [>= n, ceil((L + band)/4)]  ref window codes
//   q_len, lo, hi, end_d  int32 [>= n]  rows, the window's [lo, hi) in the
//                                  contig, the band offset of the best cell
//                                  of row q_len - 1 (the walk's start)
//   dirs    uint8 [n, L, band]    workspace: a direction byte a cell
//   ops     uint8 [n, 2L + band]  pair g's ops (0 '=', 1 'X', 2 'I', 3 'D')
//                                 in order in its last meta[g, 0] bytes
//   meta    int32 [n, 2]          (number of ops, start_d: the band offset
//                                 at row 0), or (-1, 0) where the walk failed
//
// The values are traceback_walk's: f32 arithmetic in reconstruct_planes'
// order (keyed = P + d*e, D = prefix max - (open + d*e), H = max(P, D1,
// D2), I = max(H(i-1, d+1) - o, I(i-1, d+1) - e)), so every comparison is
// the host's, -1e30 and its sums included (f32 absorbs the scoring's
// integers there as the host's f32 and f64 do). Its tie rules:
//   H: a D family where H != P (D1 where H = D1); else the diagonal where
//      the cell lies in [lo, hi) and P = H(i-1, d) + sub (0 on row 0);
//      else I1 where P = I1, I2 where P = I2; else the diagonal.
//   D: the nearest gap start d' < d, P(d') - open - (d - d')*e = D(d):
//      the last d' < d whose keyed value is its row's running maximum.
//   I: opens where I = H(i-1, d+1) - o (0 on row 0, -1e30 past the band),
//      else extends.
// A walk that reaches no gap start, leaves the band or ends inside an
// insertion fails as the host's does, and meta says so.
//
// The design: a warp a pair (pairs differ in rows; their count, a few
// hundred a chunk, is under a warp a scheduler).
//   * The sweep: rows in order, lane k holding cells d = k*CPL.. (band/32
//     a lane). A row is its P cells (16-byte loads, in a ring of rows
//     loaded up to 4 rows ahead), the two keyed prefix maxima as an
//     in-lane scan and a 5-round shuffle scan, the insertions from the
//     previous row's H and I one slot over (a shuffle at the lane edge),
//     and one direction byte a cell: bits 0-2 the H cell's move (=, X, I1,
//     I2, D1, D2), bits 3-4 whether I1 / I2 opens there, bits 5-6 whether
//     the cell holds its row's running maximum of D1's / D2's keyed
//     values. A cell takes selects and no branch, so that the compiler
//     interleaves a lane's cells (branches, one a cell, made it 1.4-2.4x
//     slower on an H100). The bytes go to the workspace, a quarter of the
//     plane, in 4-byte stores.
//   * The walk: the warp stages a tile of rows of bytes (8 KB, the rows
//     just below the walk's row) in shared memory, and lane 0 follows the
//     bytes from (q_len - 1, end_d) down to the tile's first row; the ops
//     go out back to front, so they end in order at the end of the row.
// What bounds it: the sweep's chain of q_len rows, about 330 instructions
// a row at band 128 with a 5-round shuffle scan in the middle, at a warp
// or two a scheduler (the pairs of a chunk are few); then the walk, one
// shared-memory read a step on one lane (a fifth of the time).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;          // pairs a block
constexpr int kTileBytes = 8192;   // a warp's tile of direction rows

// the H cell's move (bits 0-2); = and X are the ops' codes too
constexpr int kEq = 0, kX = 1, kI1 = 2, kI2 = 3, kD1 = 4, kD2 = 5;
constexpr int kOpen1 = 8, kOpen2 = 16, kRun1 = 32, kRun2 = 64;
constexpr uint8_t kOpI = 2, kOpD = 3;
// the walk's states
constexpr int kStH = 0, kStI1 = 1, kStI2 = 2, kStD1 = 3, kStD2 = 4;

struct Scoring {
  float match, mismatch;  // +match / -mismatch
  float o1, e1, o2, e2;   // insertion open (gap_open + gap_ext) and extend
  float open1, open2;     // deletion opens: the bare gap_open of a family
};

// the lane's CPL cells of a plane row, in 16-byte loads
template <int CPL>
__device__ __forceinline__ void load_row(float (&v)[CPL], const float* src) {
#pragma unroll
  for (int c = 0; c < CPL; c += 4) {
    const float4 x = __ldg((const float4*)(src + c));
    v[c] = x.x;
    v[c + 1] = x.y;
    v[c + 2] = x.z;
    v[c + 3] = x.w;
  }
}

template <int CPL>
__global__ void __launch_bounds__(kWarps * 32)
traceback_walk_kernel(const float* __restrict__ plane,
                      const uint8_t* __restrict__ q_pack,
                      const int32_t* __restrict__ q_len,
                      const uint8_t* __restrict__ r_pack,
                      const int32_t* __restrict__ lo_a,
                      const int32_t* __restrict__ hi_a,
                      const int32_t* __restrict__ end_d_a, int n, int l,
                      Scoring sc, uint8_t* __restrict__ dirs,
                      uint8_t* __restrict__ ops, int32_t* __restrict__ meta) {
  constexpr int band = 32 * CPL;
  constexpr int kTileRows = kTileBytes / band;
  __shared__ __align__(16) uint8_t tiles[kWarps][kTileBytes];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = blockIdx.x * kWarps + warp;
  if (g >= n) return;  // the whole warp
  const int qlen = min(q_len[g], l);
  const int wlen = l + band;
  const uint8_t* qrow = q_pack + (size_t)g * ((l + 3) >> 2);
  const uint8_t* rrow = r_pack + (size_t)g * ((wlen + 3) >> 2);
  const int lo = lo_a[g], hi = hi_a[g];
  const int d0 = lane * CPL;
  const float* prow = plane + (size_t)g * l * band + d0;
  uint8_t* dpair = dirs + (size_t)g * l * band;

  // ---- the sweep ----
  float hprev[CPL], i1p[CPL], i2p[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    hprev[c] = 0.f;  // row -1
    i1p[c] = kNeg;
    i2p[c] = kNeg;
  }
  // a cell's keyed offsets d*e and deletion opens open + d*e
  float de1[CPL], de2[CPL], t1[CPL], t2[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const float fd = (float)(d0 + c);
    de1[c] = __fmul_rn(fd, sc.e1);
    de2[c] = __fmul_rn(fd, sc.e2);
    t1[c] = __fadd_rn(sc.open1, de1[c]);
    t2[c] = __fadd_rn(sc.open2, de2[c]);
  }
  // rows in flight: PD rows of the plane (and their codes' bytes) are
  // loaded ahead of the row in use, in a ring indexed at compile time
  constexpr int PD = CPL <= 4 ? 4 : (CPL <= 8 ? 2 : 1);
  constexpr int NB = CPL / 4 + 1;  // bytes of window codes a lane's row reads
  float pre[PD][CPL];
  uint8_t preq[PD], prer[PD][NB];
  auto fetch = [&](int k, int i) {
    load_row<CPL>(pre[k], prow + (size_t)i * band);
    preq[k] = __ldg(qrow + (i >> 2));
#pragma unroll
    for (int b = 0; b < NB; ++b) prer[k][b] = __ldg(rrow + ((i + d0) >> 2) + b);
  };
#pragma unroll
  for (int k = 0; k < PD; ++k)
    if (k < qlen) fetch(k, k);
  for (int i0 = 0; i0 < qlen; i0 += PD) {
#pragma unroll
   for (int k = 0; k < PD; ++k) {
    const int i = i0 + k;
    if (i >= qlen) break;
    float p[CPL];
#pragma unroll
    for (int c = 0; c < CPL; ++c) p[c] = pre[k][c];
    // the row's query code and the lane's window codes (columns i + d)
    const int qc = (preq[k] >> (2 * (i & 3))) & 3;
    const int col0 = i + d0;
    uint64_t w = 0;
#pragma unroll
    for (int b = 0; b < NB; ++b) w |= (uint64_t)prer[k][b] << (8 * b);
    w >>= 2 * (col0 & 3);
    if (i + PD < qlen) fetch(k, i + PD);

    // the keyed values and their running maxima, in the lane, then across
    float k1[CPL], k2[CPL], c1[CPL], c2[CPL];
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      k1[c] = __fadd_rn(p[c], de1[c]);
      k2[c] = __fadd_rn(p[c], de2[c]);
      c1[c] = c ? fmaxf(c1[c - 1], k1[c]) : k1[c];
      c2[c] = c ? fmaxf(c2[c - 1], k2[c]) : k2[c];
    }
    float s1 = c1[CPL - 1], s2 = c2[CPL - 1];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v1 = __shfl_up_sync(kFull, s1, off);
      const float v2 = __shfl_up_sync(kFull, s2, off);
      if (lane >= off) {
        s1 = fmaxf(s1, v1);
        s2 = fmaxf(s2, v2);
      }
    }
    float x1 = __shfl_up_sync(kFull, s1, 1), x2 = __shfl_up_sync(kFull, s2, 1);
    if (lane == 0) {
      x1 = -INFINITY;
      x2 = -INFINITY;
    }
    // the previous row one slot over (d + 1), -1e30 past the band
    float hn = __shfl_down_sync(kFull, hprev[0], 1);
    float i1n = __shfl_down_sync(kFull, i1p[0], 1);
    float i2n = __shfl_down_sync(kFull, i2p[0], 1);
    if (lane == 31) hn = i1n = i2n = kNeg;

    uint32_t bytes[CPL / 4];
#pragma unroll
    for (int c = 0; c < CPL / 4; ++c) bytes[c] = 0;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {  // selects, no branch: the cells interleave
      const float ex1 = c ? fmaxf(x1, c1[c - 1]) : x1;
      const float ex2 = c ? fmaxf(x2, c2[c - 1]) : x2;
      const float dd1 = __fsub_rn(c || lane ? ex1 : kNeg, t1[c]);  // d = 0: -1e30
      const float dd2 = __fsub_rn(c || lane ? ex2 : kNeg, t2[c]);
      const float h = fmaxf(p[c], fmaxf(dd1, dd2));
      const float hs = c + 1 < CPL ? hprev[c + 1] : hn;
      const float i1 = fmaxf(__fsub_rn(hs, sc.o1), __fsub_rn(c + 1 < CPL ? i1p[c + 1] : i1n, sc.e1));
      const float i2 = fmaxf(__fsub_rn(hs, sc.o2), __fsub_rn(c + 1 < CPL ? i2p[c + 1] : i2n, sc.e2));
      const float hso = i ? hs : 0.f;
      const int col = col0 + c;
      const bool ok = (col >= lo) & (col < hi);
      const bool m = ok & ((int)((w >> (2 * c)) & 3) == qc);
      const int diag = m ? kEq : kX;
      const bool by_diag = ok & (p[c] == __fadd_rn(hprev[c], m ? sc.match : -sc.mismatch));
      int mv = p[c] == i2 ? kI2 : diag;
      mv = p[c] == i1 ? kI1 : mv;
      mv = by_diag ? diag : mv;
      mv = h != p[c] ? (h == dd1 ? kD1 : kD2) : mv;
      const int b = mv | (i1 == __fsub_rn(hso, sc.o1) ? kOpen1 : 0) |
                    (i2 == __fsub_rn(hso, sc.o2) ? kOpen2 : 0) |
                    (k1[c] >= ex1 ? kRun1 : 0) | (k2[c] >= ex2 ? kRun2 : 0);
      bytes[c >> 2] |= (uint32_t)b << (8 * (c & 3));
      hprev[c] = h;  // read above only at c + 1 > c: safe to overwrite
      i1p[c] = i1;
      i2p[c] = i2;
    }
#pragma unroll
    for (int c = 0; c < CPL / 4; ++c)
      ((uint32_t*)(dpair + (size_t)i * band + d0))[c] = bytes[c];
   }
  }
  __syncwarp();

  // ---- the walk ----
  const int wops = 2 * l + band;
  uint8_t* orow = ops + (size_t)g * wops;
  uint8_t* tile = tiles[warp];
  int i = qlen - 1, d = end_d_a[g], st = kStH, pos = wops, fail = d < 0 || d >= band;
  while (i >= 0 && !fail) {
    const int t0 = max(0, i - kTileRows + 1);
    const int words = (i - t0 + 1) * band / 16;
    const uint4* src = (const uint4*)(dpair + (size_t)t0 * band);
    for (int k = lane; k < words; k += 32) ((uint4*)tile)[k] = src[k];
    __syncwarp();
    if (lane == 0) {
      while (i >= t0 && !fail) {
        const uint8_t* row = tile + (i - t0) * band;
        if (st == kStH) {
          const int mv = row[d] & 7;
          if (mv <= kX) {
            if (pos == 0) { fail = 1; break; }
            orow[--pos] = (uint8_t)mv;
            --i;
          } else if (mv == kI1 || mv == kI2) {
            st = mv == kI1 ? kStI1 : kStI2;
          } else {
            st = mv == kD1 ? kStD1 : kStD2;
          }
        } else if (st == kStD1 || st == kStD2) {
          const int bit = st == kStD1 ? kRun1 : kRun2;
          int dp = d - 1;
          while (dp >= 0 && !(row[dp] & bit)) --dp;
          if (dp < 0 || pos < d - dp) { fail = 1; break; }
          for (int k = dp; k < d; ++k) orow[--pos] = kOpD;
          d = dp;
          st = kStH;
        } else {
          if (pos == 0) { fail = 1; break; }
          orow[--pos] = kOpI;
          if (row[d] & (st == kStI1 ? kOpen1 : kOpen2)) st = kStH;
          --i;
          ++d;
          if (d >= band && i >= 0) fail = 1;
        }
      }
    }
    __syncwarp();
    i = __shfl_sync(kFull, i, 0);
    d = __shfl_sync(kFull, d, 0);
    st = __shfl_sync(kFull, st, 0);
    pos = __shfl_sync(kFull, pos, 0);
    fail = __shfl_sync(kFull, fail, 0);
    __syncwarp();  // the tile is read before the next one is written
  }
  if (lane == 0) {
    fail = fail || st != kStH;
    meta[2 * g] = fail ? -1 : wops - pos;
    meta[2 * g + 1] = fail ? 0 : d;
  }
}

template <int CPL>
cudaError_t launch(const void* plane, const void* q_pack, const void* q_len,
                   const void* r_pack, const void* lo, const void* hi,
                   const void* end_d, int n, int l, const Scoring& sc,
                   void* dirs, void* ops, void* meta, cudaStream_t stream) {
  const unsigned grid = (unsigned)((n + kWarps - 1) / kWarps);
  traceback_walk_kernel<CPL><<<grid, kWarps * 32, 0, stream>>>(
      (const float*)plane, (const uint8_t*)q_pack, (const int32_t*)q_len,
      (const uint8_t*)r_pack, (const int32_t*)lo, (const int32_t*)hi,
      (const int32_t*)end_d, n, l, sc, (uint8_t*)dirs, (uint8_t*)ops,
      (int32_t*)meta);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success). band is one of 128, 256, 384, 512;
// plane and dirs 16-byte aligned; the scoring is the host's, as floats.
int phylign_traceback_walk(const void* plane, const void* q_pack,
                           const void* q_len, const void* r_pack,
                           const void* lo, const void* hi, const void* end_d,
                           int n, int l, int band, float match,
                           float mismatch, float o1, float e1, float o2,
                           float e2, float open1, float open2, void* dirs,
                           void* ops, void* meta, void* stream) {
  if (n <= 0) return 0;
  if (l < 1 || ((uintptr_t)plane & 15u) || ((uintptr_t)dirs & 15u))
    return (int)cudaErrorInvalidValue;
  const Scoring sc{match, mismatch, o1, e1, o2, e2, open1, open2};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (band) {
    case 128:
      return (int)launch<4>(plane, q_pack, q_len, r_pack, lo, hi, end_d, n, l, sc, dirs, ops, meta, s);
    case 256:
      return (int)launch<8>(plane, q_pack, q_len, r_pack, lo, hi, end_d, n, l, sc, dirs, ops, meta, s);
    case 384:
      return (int)launch<12>(plane, q_pack, q_len, r_pack, lo, hi, end_d, n, l, sc, dirs, ops, meta, s);
    case 512:
      return (int)launch<16>(plane, q_pack, q_len, r_pack, lo, hi, end_d, n, l, sc, dirs, ops, meta, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* phylign_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
