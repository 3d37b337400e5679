// The DSP front-end's two per-row primitives, with bits that do not depend
// on the batch: the mel and DCT-II projections, and the per-row sums behind
// every mean of the front-end.
//
// Replaces: no TPU kernel.  The reference runs these inside its jitted
// front-end (src/repro/data/features_jax.py), the projections under
// jax.lax.map so that gemm blocking cannot change with the batch.  On the
// card the same hazard has three sources: cuBLAS picks its kernel by shape,
// PyTorch's reductions pick their split from the whole tensor's shape, and
// a row's bits must not depend on its co-batch (the serving contract
// streaming == batched).  Both kernels fix the order of every sum instead.
//
// project_rows: out[r, n] = sum over k of x[r, k] * m[k, n], k ascending,
// each product and each sum rounded on its own (--fmad=false), one thread
// per output.  A warp shares one row (x[r, k] is one broadcast load) and
// reads 32 neighbouring columns of m (one coalesced load).
//
// row_sum: the sum of each row in the reduction order of the reference's
// CPU compiler (xla_sum.cuh): a row of n <= 32 values is summed left to
// right from its first value; a longer one is cut into windows of exactly
// 32, the zero padding split between both ends, each window summed from 0,
// and the window sums are reduced again by the same rule.  One block per
// row, one thread per window of the first level; thread 0 runs the short
// later levels in place (xla_sum::reduce_levels).
//
// project_rows also computes every bf16/fp32 layer of the datapath
// (serving/accelerator.py): a dense layer as (B, K) @ (K, N), a conv as its
// im2col rows (B*L, K*Cin) @ (K*Cin, Cout), so that a float layer's row has
// the same bits at every batch size and on the CPU (its plain twin sums in
// the same order).
//
// What bounds them on the H100: at the front-end's serving shapes (8
// windows: 408 x 513 @ 513 x 64 for the mel projection, rows of 12 to 1096
// values for the sums) both are tiny and bound by launch latency and by the
// serial dependence of each fixed-order sum, not by bytes or operations.
// The float dense layers are the extreme: dense0 at the canonical width
// (8 x 35,072 @ 35,072 x 64) is 512 threads, each a 35,072-long chain of
// dependent adds.
#include <cuda_runtime.h>

#include "xla_sum.cuh"

namespace {

__global__ void project_rows_kernel(const float* __restrict__ x,
                                    const float* __restrict__ m,
                                    float* __restrict__ out, int R, int K,
                                    int N) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (r >= R || n >= N) return;
  const float* xr = x + (size_t)r * K;
  float acc = 0.0f;
  for (int k = 0; k < K; ++k)
    acc = __fadd_rn(acc, __fmul_rn(xr[k], m[(size_t)k * N + n]));
  out[(size_t)r * N + n] = acc;
}

__global__ void row_sum_kernel(const float* __restrict__ x,
                               float* __restrict__ out, int n) {
  __shared__ float sums[xla_sum::kMaxWindows];
  const float* xr = x + (size_t)blockIdx.x * n;
  const xla_sum::Split sp = xla_sum::split(n);
  if (sp.windows == 1) {  // left to right from the first value
    if (threadIdx.x == 0) {
      float acc = xr[0];
      for (int i = 1; i < n; ++i) acc = __fadd_rn(acc, xr[i]);
      out[blockIdx.x] = acc;
    }
    return;
  }
  for (int c = threadIdx.x; c < sp.windows; c += blockDim.x)
    sums[c] = xla_sum::window_sum(xr, n, sp.lo, c);
  __syncthreads();
  if (threadIdx.x == 0) out[blockIdx.x] = xla_sum::reduce_levels(sums, sp.windows);
}

}  // namespace

// x: (R, K) fp32, m: (K, N) fp32, out: (R, N) fp32, all contiguous
extern "C" int project_rows_f32(const void* x, const void* m, void* out, int R,
                                int K, int N, void* stream) {
  if (R <= 0 || N <= 0) return cudaSuccess;
  const dim3 block(32, 8);
  const dim3 grid((N + 31) / 32, (R + 7) / 8);
  project_rows_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(m),
      static_cast<float*>(out), R, K, N);
  return cudaGetLastError();
}

// x: (R, n) fp32 contiguous, out: (R,) fp32; n <= 32 * xla_sum::kMaxWindows
extern "C" int row_sum_f32(const void* x, void* out, int R, int n, void* stream) {
  if (R <= 0) return cudaSuccess;
  if (n <= 0 || xla_sum::split(n).windows > xla_sum::kMaxWindows) return cudaErrorInvalidValue;
  row_sum_kernel<<<R, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n);
  return cudaGetLastError();
}
