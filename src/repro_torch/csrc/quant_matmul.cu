// Kernel K1: W8A8 matmul, int8 (M,K) x int8 (K,N) -> int32 accumulators,
// then the dequant epilogue into fp32.
//
// Replaces: src/repro/kernels/quant_matmul.py, quant_matmul (Pallas body
// _kernel), the TPU's multi-precision MAC bank.
//
// What bounds it on the H100: on the serving path it is dense0, a skinny
// long-K product (M = 1..64 slots, K = 35,072 or 8,704, N = 64).  Its work
// is 2*M*K*N int8 operations against M*K + K*N bytes of input, about
// 2*M operations per weight byte: far below the ~590 int8 operations per
// byte at which the tensor cores, not HBM, would be the limit.  It is bound
// by reading the weight once (2.2 MB at K = 35,072).
//
// What the design does about it: the only parallelism that covers 132 SMs
// at M = 8 and N = 64 is K, so the grid splits K into 256-deep chunks (137
// blocks at K = 35,072).  Each block reads its weight chunk once, coalesced,
// transposes it into shared memory so four consecutive K values of one
// column are one 32-bit word, and forms __dp4a int8 dot products for a
// 16 x 64 output tile.  Partial sums go to an int32 scratch with atomicAdd:
// integer addition is exact and associative, so the accumulators are
// bitwise deterministic in any block order.  A second small launch runs the
// epilogue, (acc * x_scale[m]) * w_scale[n] fused with + bias[n] as one
// FMA (the reference's CPU rounding), ReLU, min(clip).  The library is
// built with --fmad=false, so no other multiply-add is contracted.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 16;   // output rows per block
constexpr int kBN = 64;   // output columns per block
constexpr int kKC = 256;  // K depth per block (a multiple of 4)
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
qmm_splitk_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                  int* __restrict__ acc, int M, int K, int N) {
  __shared__ __align__(16) int8_t xs[kBM][kKC];
  // transposed weight chunk: wt[n][k]; the 4-byte pad keeps the row stride
  // an odd number of words, so the 32 columns of a warp hit 32 banks
  __shared__ __align__(16) int8_t wt[kBN][kKC + 4];

  const int k0 = blockIdx.x * kKC;
  const int n0 = blockIdx.y * kBN;
  const int m0 = blockIdx.z * kBM;
  const int tid = threadIdx.x;

  for (int i = tid; i < kBM * kKC; i += kThreads) {
    const int r = i / kKC, c = i % kKC;
    const int m = m0 + r, k = k0 + c;
    xs[r][c] = (m < M && k < K) ? x[(size_t)m * K + k] : int8_t(0);
  }
  for (int i = tid; i < kKC * kBN; i += kThreads) {
    const int r = i / kBN, c = i % kBN;
    const int k = k0 + r, n = n0 + c;
    wt[c][r] = (k < K && n < N) ? w[(size_t)k * N + n] : int8_t(0);
  }
  __syncthreads();

  const int n = tid % kBN;
  const int mg = tid / kBN;  // 0..3; rows mg, mg+4, mg+8, mg+12
  int a[kBM / 4] = {0, 0, 0, 0};
#pragma unroll 4
  for (int kk = 0; kk < kKC; kk += 4) {
    const int wv = *reinterpret_cast<const int*>(&wt[n][kk]);
#pragma unroll
    for (int j = 0; j < kBM / 4; ++j) {
      const int xv = *reinterpret_cast<const int*>(&xs[mg + 4 * j][kk]);
      a[j] = __dp4a(xv, wv, a[j]);
    }
  }
  if (n0 + n < N) {
#pragma unroll
    for (int j = 0; j < kBM / 4; ++j) {
      const int m = m0 + mg + 4 * j;
      if (m < M && a[j] != 0) atomicAdd(&acc[(size_t)m * N + n0 + n], a[j]);
    }
  }
}

__global__ void qmm_epilogue_kernel(const int* __restrict__ acc,
                                    const float* __restrict__ xs,
                                    const float* __restrict__ ws,
                                    const float* __restrict__ bias, float clip,
                                    int has_clip, int relu, int xs_per_row,
                                    int ws_per_col, float* __restrict__ out,
                                    int M, int N) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)M * N) return;
  const int m = (int)(i / N), n = (int)(i % N);
  const float t = __fmul_rn(__int2float_rn(acc[i]), xs[xs_per_row ? m : 0]);
  const float s = ws[ws_per_col ? n : 0];
  float y = bias ? __fmaf_rn(t, s, bias[n]) : __fmul_rn(t, s);
  // jnp.maximum / jnp.minimum: NaN propagates, -0 -> +0, ties take the bound
  if (relu) y = (y > 0.0f || y != y) ? y : 0.0f;
  if (has_clip) y = (y < clip || y != y) ? y : clip;
  out[i] = y;
}

}  // namespace

// acc: int32 (M, N) scratch, or the result when out is null (return_acc).
extern "C" int quant_matmul_i8(const void* x, const void* w, void* acc,
                               void* out, const void* xs, const void* ws,
                               const void* bias, float clip, int has_clip,
                               int relu, int xs_per_row, int ws_per_col, int M,
                               int K, int N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaMemsetAsync(acc, 0, sizeof(int) * (size_t)M * (size_t)N, st);
  if (err != cudaSuccess) return err;
  if (K > 0) {
    dim3 grid((K + kKC - 1) / kKC, (N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
    qmm_splitk_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
        static_cast<int*>(acc), M, K, N);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (out != nullptr) {
    const size_t total = (size_t)M * N;
    const int threads = 256;
    qmm_epilogue_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0,
                          st>>>(
        static_cast<const int*>(acc), static_cast<const float*>(xs),
        static_cast<const float*>(ws), static_cast<const float*>(bias), clip,
        has_clip, relu, xs_per_row, ws_per_col, static_cast<float*>(out), M, N);
  }
  return cudaGetLastError();
}
