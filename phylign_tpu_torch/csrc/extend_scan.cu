// Banded dual-affine extension scan: kernel B4 of the align stage for
// Hopper (sm_90a), with a plain C interface loaded through ctypes
// (phylign_tpu_torch/ops/_kernels.py).
//
// Replaces the lax.scan of phylign_tpu/ops/extend.py:_extend_impl (its row
// function, extend.py:181-225). Contract (phylign_tpu_torch/ops/extend.py:
// extend_ref):
//   q       uint8 [P, L]           query codes (strand-adjusted)
//   q_len   int32 [P]              query lengths (<= L)
//   rwin    uint8 [P, L + band]    ref window codes; row i, band cell d
//                                  reads column i + d
//   rvalid  uint8 [P, L + band]    1 where the column lies in the contig
//   score   f32 [P]                best cell of row q_len - 1 (-1e30 if none)
//   end_d   int32 [P]              its band offset, the lowest on ties
//   plane   f32 [P, L, band]       with `collect`: P = max(diag, I1, I2) of
//                                  every cell, the traceback's input
// Glocal: row -1 is all zeros (free leading ref overhang). Per row,
// H = max(P, D1, D2) with insertions from row i-1 at d+1 and deletions as
// an exclusive prefix max of the keyed values P[d'] + d'*e. Every value is
// an integer-valued f32 or -1e30-based, so the result equals the plain
// version bit for bit when each f32 operation is the same: explicit _rn
// intrinsics, no fused multiply-add.
//
// What bounds it on an H100: the operations. A cell is ~25 f32 operations
// on registers and reads 2 bytes; with the plane it also writes 4 bytes.
// Rows depend on each other, so each pair is a chain of L dependent rows.
// The design:
//   * One warp per pair, band/32 consecutive cells per lane (4 at band 128,
//     16 at band 512). H, I1, I2 and the window codes stay in registers
//     from row to row.
//   * The d+1 shift of the insertion families and of the window codes is
//     one __shfl_down_sync at the lane edge; lane 31 loads the one new
//     window column a row needs.
//   * Deletions: an in-lane max scan over the lane's cells, then a 5-round
//     shuffle scan of the lane totals gives the exclusive prefix max, once
//     per gap family.
//   * The row argmax (only the row q_len - 1) is an in-lane scan and a
//     shuffle reduction, ties to the lowest d as jnp.argmax.
//   * Plane rows are stored as each lane's band/32 consecutive floats with
//     16-byte stores: a warp writes the row's 4*band contiguous bytes.
//   * Without the plane a pair stops after its row q_len - 1; with it all
//     L rows are computed, as the plain version does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kNeg = -1e30f;

struct Scoring {
  float match, mismatch;  // +match / -mismatch
  float o1, e1, o2, e2;   // insertion open (gap_open + gap_ext) and extend
  float do1, do2;         // deletion opens: the bare gap_open of a family
};

// exclusive prefix max over d of keyed (lane-major: d = lane * CPL + c)
template <int CPL>
__device__ __forceinline__ void excl_prefix_max(const float (&keyed)[CPL],
                                                float (&out)[CPL], int lane) {
  float run = kNeg;
#pragma unroll
  for (int c = 0; c < CPL; c++) {
    out[c] = run;
    run = fmaxf(run, keyed[c]);
  }
  float v = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float t = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v = fmaxf(v, t);
  }
  float before = __shfl_up_sync(kFull, v, 1);
  if (lane == 0) before = kNeg;
#pragma unroll
  for (int c = 0; c < CPL; c++) out[c] = fmaxf(before, out[c]);
}

template <int CPL>
__global__ void extend_scan_kernel(const uint8_t* __restrict__ q,
                                   const int32_t* __restrict__ q_len,
                                   const uint8_t* __restrict__ rwin,
                                   const uint8_t* __restrict__ rvalid, int p,
                                   int l, Scoring sc, int collect,
                                   float* __restrict__ score,
                                   int32_t* __restrict__ end_d,
                                   float* __restrict__ plane) {
  constexpr int band = 32 * CPL;
  const int lane = threadIdx.x & 31;
  const int pair = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (pair >= p) return;  // warp-uniform
  const int wlen = l + band;
  const uint8_t* qrow = q + (int64_t)pair * l;
  const uint8_t* rrow = rwin + (int64_t)pair * wlen;
  const uint8_t* vrow = rvalid + (int64_t)pair * wlen;
  const int qlen = q_len[pair];
  const int rows = collect ? l : min(l, max(qlen, 0));
  const int d0 = lane * CPL;

  float h[CPL], i1[CPL], i2[CPL], de1[CPL], de2[CPL];
  int rc[CPL];  // window column i + d of the current row: code | valid << 8
#pragma unroll
  for (int c = 0; c < CPL; c++) {
    h[c] = 0.f;
    i1[c] = kNeg;
    i2[c] = kNeg;
    de1[c] = __fmul_rn((float)(d0 + c), sc.e1);
    de2[c] = __fmul_rn((float)(d0 + c), sc.e2);
    rc[c] = (int)rrow[d0 + c] | (vrow[d0 + c] ? 256 : 0);
  }
  float best = kNeg;
  int best_d = 0;

  for (int i = 0; i < rows; i++) {
    if (i > 0) {  // slide the window one column: cell d takes cell d+1's
      const int nxt = __shfl_down_sync(kFull, rc[0], 1);
#pragma unroll
      for (int c = 0; c < CPL - 1; c++) rc[c] = rc[c + 1];
      rc[CPL - 1] = lane == 31 ? ((int)rrow[i - 1 + band] |
                                  (vrow[i - 1 + band] ? 256 : 0))
                               : nxt;
    }
    const int qc = qrow[i];
    // the previous row at d+1 (lane 31's last cell reads past the band)
    float hs = __shfl_down_sync(kFull, h[0], 1);
    float i1s = __shfl_down_sync(kFull, i1[0], 1);
    float i2s = __shfl_down_sync(kFull, i2[0], 1);
    if (lane == 31) hs = i1s = i2s = kNeg;
    float pm[CPL], k1[CPL], k2[CPL];
#pragma unroll
    for (int c = 0; c < CPL; c++) {
      const float hn = c < CPL - 1 ? h[c + 1] : hs;
      const float i1n = c < CPL - 1 ? i1[c + 1] : i1s;
      const float i2n = c < CPL - 1 ? i2[c + 1] : i2s;
      const float sub = (rc[c] & 256)
                            ? ((rc[c] & 255) == qc ? sc.match : -sc.mismatch)
                            : kNeg;
      const float hd = __fadd_rn(h[c], sub);
      const float n1 = fmaxf(__fsub_rn(hn, sc.o1), __fsub_rn(i1n, sc.e1));
      const float n2 = fmaxf(__fsub_rn(hn, sc.o2), __fsub_rn(i2n, sc.e2));
      i1[c] = n1;
      i2[c] = n2;
      pm[c] = fmaxf(hd, fmaxf(n1, n2));
      k1[c] = __fadd_rn(pm[c], de1[c]);
      k2[c] = __fadd_rn(pm[c], de2[c]);
    }
    float x1[CPL], x2[CPL];
    excl_prefix_max<CPL>(k1, x1, lane);
    excl_prefix_max<CPL>(k2, x2, lane);
#pragma unroll
    for (int c = 0; c < CPL; c++) {
      const float d1 = __fsub_rn(__fsub_rn(x1[c], sc.do1), de1[c]);
      const float d2 = __fsub_rn(__fsub_rn(x2[c], sc.do2), de2[c]);
      h[c] = fmaxf(pm[c], fmaxf(d1, d2));
    }
    if (collect) {
      float4* dst = reinterpret_cast<float4*>(
          plane + ((int64_t)pair * l + i) * band + d0);
#pragma unroll
      for (int c = 0; c < CPL; c += 4)
        dst[c / 4] = make_float4(pm[c], pm[c + 1], pm[c + 2], pm[c + 3]);
    }
    if (i == qlen - 1) {  // warp-uniform
      float bv = h[0];
      int bd = d0;
#pragma unroll
      for (int c = 1; c < CPL; c++) {
        if (h[c] > bv) {
          bv = h[c];
          bd = d0 + c;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(kFull, bv, off);
        const int od = __shfl_xor_sync(kFull, bd, off);
        if (ov > bv || (ov == bv && od < bd)) {
          bv = ov;
          bd = od;
        }
      }
      best = bv;
      best_d = bd;
    }
  }
  if (lane == 0) {
    score[pair] = best;
    end_d[pair] = best_d;
  }
}

template <int CPL>
cudaError_t launch(const void* q, const void* q_len, const void* rwin,
                   const void* rvalid, int p, int l, const Scoring& sc,
                   int collect, int wpb, void* score, void* end_d, void* plane,
                   void* stream) {
  const unsigned grid = (unsigned)((p + wpb - 1) / wpb);
  extend_scan_kernel<CPL><<<grid, 32u * (unsigned)wpb, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)q, (const int32_t*)q_len, (const uint8_t*)rwin,
      (const uint8_t*)rvalid, p, l, sc, collect, (float*)score,
      (int32_t*)end_d, (float*)plane);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success). band must be 128, 256, 384 or 512.
int phylign_extend_scan(const void* q, const void* q_len, const void* rwin,
                        const void* rvalid, int p, int l, int band,
                        float match, float mismatch, float o1, float e1,
                        float o2, float e2, float open1, float open2,
                        int collect, int warps_per_block, void* score,
                        void* end_d, void* plane, void* stream) {
  if (p <= 0) return 0;
  if (l < 1 || warps_per_block < 1 || warps_per_block > 32 ||
      (collect && ((uintptr_t)plane & 15u)))
    return (int)cudaErrorInvalidValue;
  const Scoring sc{match, mismatch, o1, e1, o2, e2, open1, open2};
  switch (band) {
    case 128:
      return (int)launch<4>(q, q_len, rwin, rvalid, p, l, sc, collect, warps_per_block, score, end_d, plane, stream);
    case 256:
      return (int)launch<8>(q, q_len, rwin, rvalid, p, l, sc, collect, warps_per_block, score, end_d, plane, stream);
    case 384:
      return (int)launch<12>(q, q_len, rwin, rvalid, p, l, sc, collect, warps_per_block, score, end_d, plane, stream);
    case 512:
      return (int)launch<16>(q, q_len, rwin, rvalid, p, l, sc, collect, warps_per_block, score, end_d, plane, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* phylign_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
