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
// CPU compiler (XLA splits a long reduction into windows): a row of n <= 32
// values is summed left to right from 0; a longer one is cut into
// ceil(n / 32) windows of width w = ceil(n / ceil(n / 32)) (the last one
// zero-padded), each window summed left to right, and the window sums are
// reduced again by the same rule.  One block per row, one thread per
// window of the first level; thread 0 runs the short later levels.
//
// What bounds them on the H100: at the serving shapes (8 windows: 408 x 513
// @ 513 x 64 for the mel projection, rows of 12 to 1096 values for the
// sums) both are tiny and bound by launch latency and by the serial
// dependence of each fixed-order sum, not by bytes or operations.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxWindows = 1024;  // first-level windows a block holds

__host__ __device__ __forceinline__ int window_width(int n) {
  if (n <= 32) return n;
  const int k = (n + 31) / 32;
  return (n + k - 1) / k;
}

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
  __shared__ float sums[kMaxWindows];
  const float* xr = x + (size_t)blockIdx.x * n;
  const int w = window_width(n);
  const int windows = (n + w - 1) / w;
  for (int c = threadIdx.x; c < windows; c += blockDim.x) {
    float acc = 0.0f;
    for (int i = c * w; i < c * w + w; ++i)
      acc = __fadd_rn(acc, i < n ? xr[i] : 0.0f);
    sums[c] = acc;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  int count = windows;
  while (count > 1) {
    const int w2 = window_width(count);
    const int next = (count + w2 - 1) / w2;
    for (int c = 0; c < next; ++c) {
      float acc = 0.0f;
      for (int i = c * w2; i < c * w2 + w2; ++i)
        acc = __fadd_rn(acc, i < count ? sums[i] : 0.0f);
      sums[c] = acc;  // windows before c * w2 are already consumed
    }
    count = next;
  }
  out[blockIdx.x] = sums[0];
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

// x: (R, n) fp32 contiguous, out: (R,) fp32; n <= 32 * kMaxWindows
extern "C" int row_sum_f32(const void* x, void* out, int R, int n, void* stream) {
  if (R <= 0) return cudaSuccess;
  if (n <= 0 || (n + window_width(n) - 1) / window_width(n) > kMaxWindows)
    return cudaErrorInvalidValue;
  row_sum_kernel<<<R, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n);
  return cudaGetLastError();
}
