// Issue rates of the non-tensor instructions the kernel table's operation
// bounds count (chip_smoke.py: INT32_OPS_PER_S, DPX_OPS_PER_S,
// F32_OPS_PER_S), measured on the card: one block of 1024 threads per SM,
// each thread running kChains dependent rings of one operation, kUnroll
// steps a loop trip; each block reads the SM's clock (clock64) around its
// loop and records the SM it ran on. scripts/issue_rates.py builds this
// file, counts the operation's SASS instructions in the loop body
// (cuobjdump -sass) and divides by the cycles.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kChains = 8;
constexpr int kUnroll = 32;
constexpr int kThreads = 1024;

enum Op {
  kIadd, kImax, kViaddmax, kVimax3, kPrmt, kLop, kFadd, kFfma, kShfl, kRedux, kI2f, kOps
};

template <int OP>
__device__ __forceinline__ int32_t step(int32_t x, int32_t n, int32_t n2, int32_t y) {
  if constexpr (OP == kIadd) return x + n;
  if constexpr (OP == kImax) return max(x, n);
  if constexpr (OP == kViaddmax) return __viaddmax_s32(x, y, n);
  if constexpr (OP == kVimax3) return __vimax3_s32(x, n, n2);
  if constexpr (OP == kPrmt) return (int32_t)__byte_perm((unsigned)x, (unsigned)n, (unsigned)y);
  if constexpr (OP == kLop) return x ^ n;
  if constexpr (OP == kFadd) return __float_as_int(__fadd_rn(__int_as_float(x), __int_as_float(n)));
  if constexpr (OP == kFfma)
    return __float_as_int(__fmaf_rn(__int_as_float(x), __int_as_float(y), __int_as_float(n)));
  if constexpr (OP == kShfl) return __shfl_sync(0xffffffffu, n, y);
  if constexpr (OP == kRedux) return __reduce_max_sync(0xffffffffu, n ^ y);  // one LOP3 too
  if constexpr (OP == kI2f) return __float_as_int(__int2float_rn(n));
  return x;
}

// rec[3 b .. 3 b + 2]: block b's clock before and after its loop, its SM
template <int OP>
__global__ void __launch_bounds__(kThreads) rate_kernel(const int32_t* __restrict__ in, int trips,
                                                       int32_t* __restrict__ out,
                                                       long long* __restrict__ rec) {
  int32_t x[kChains];
#pragma unroll
  for (int c = 0; c < kChains; c++) x[c] = in[(threadIdx.x + 37 * c) & 1023];
  // y: a runtime operand (a lane index for the shuffle, a byte selector)
  const int32_t y = in[1024 + (threadIdx.x & 31)];
  __syncthreads();
  const long long t0 = clock64();
#pragma unroll 1
  for (int t = 0; t < trips; t++) {
#pragma unroll
    for (int u = 0; u < kUnroll; u++) {
#pragma unroll
      for (int c = 0; c < kChains; c++)
        x[c] = step<OP>(x[c], x[(c + 1) % kChains], x[(c + 2) % kChains], y);
    }
  }
  __syncthreads();
  const long long t1 = clock64();
  int32_t s = 0;
#pragma unroll
  for (int c = 0; c < kChains; c++) s ^= x[c];
  out[blockIdx.x * kThreads + threadIdx.x] = s;
  if (threadIdx.x == 0) {
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    rec[3 * blockIdx.x] = t0;
    rec[3 * blockIdx.x + 1] = t1;
    rec[3 * blockIdx.x + 2] = sm;
  }
}

template <int OP>
cudaError_t launch(int blocks, const int32_t* in, int trips, int32_t* out, long long* rec) {
  rate_kernel<OP><<<blocks, kThreads>>>(in, trips, out, rec);
  return cudaGetLastError();
}

using Launch = cudaError_t (*)(int, const int32_t*, int, int32_t*, long long*);
constexpr Launch kLaunch[kOps] = {
    launch<kIadd>, launch<kImax>, launch<kViaddmax>, launch<kVimax3>, launch<kPrmt>, launch<kLop>,
    launch<kFadd>, launch<kFfma>, launch<kShfl>, launch<kRedux>, launch<kI2f>};

}  // namespace

extern "C" {

int issue_rates_ops() { return kOps; }
int issue_rates_threads() { return kThreads; }

// Runs operation `op` in `blocks` blocks of kThreads threads for `trips`
// loop trips (after one warm-up launch) and copies the blocks' records,
// 3 a block, to host_rec. Returns a cudaError_t.
int issue_rates_run(int op, int blocks, int trips, const int32_t* host_in, long long* host_rec) {
  if (op < 0 || op >= kOps) return (int)cudaErrorInvalidValue;
  int32_t *in = nullptr, *out = nullptr;
  long long* rec = nullptr;
  cudaError_t e = cudaMalloc(&in, 2048 * sizeof(int32_t));
  if (e == cudaSuccess) e = cudaMalloc(&out, (size_t)blocks * kThreads * sizeof(int32_t));
  if (e == cudaSuccess) e = cudaMalloc(&rec, (size_t)blocks * 3 * sizeof(long long));
  if (e == cudaSuccess) e = cudaMemcpy(in, host_in, 2048 * sizeof(int32_t), cudaMemcpyHostToDevice);
  if (e == cudaSuccess) e = kLaunch[op](blocks, in, 1, out, rec);
  if (e == cudaSuccess) e = kLaunch[op](blocks, in, trips, out, rec);
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  if (e == cudaSuccess)
    e = cudaMemcpy(host_rec, rec, (size_t)blocks * 3 * sizeof(long long), cudaMemcpyDeviceToHost);
  cudaFree(in);
  cudaFree(out);
  cudaFree(rec);
  return (int)e;
}

}  // extern "C"
