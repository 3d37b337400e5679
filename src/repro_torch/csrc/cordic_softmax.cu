// Kernel K3: row softmax with CORDIC exponentials, fp32 (rows, cols) in and
// out: one warp per row of up to 32 values, one block per wider row.
//
// Replaces: src/repro/kernels/cordic_act.py, cordic_activation in "exp"
// mode (Pallas body _kernel -> _apply_mode -> _exp_core ->
// _cordic_sinh_cosh) under cordic_softmax, the classifier head.
//
// What bounds it on the H100: on the serving path it sees (slots, 2) fp32,
// 128 bytes in and out at 8 slots and about 200 instructions per value:
// bytes and issue rate bound it at a few nanoseconds, so the time is the
// launch's and the dependent chain's.  The chain is one value's: the row
// max, the 20 CORDIC stages, the row sum and one IEEE division, each step
// waiting on the one before.  chip_smoke.py measures the launch floor (an
// empty kernel, launch_floor.cu) beside it.
//
// What the design does about it: one launch does the whole softmax, and a
// row stays in registers.  For cols <= 32, lane c holds value c: the max
// takes ceil(log2(cols)) butterfly shuffles, the left-to-right sum is lane
// 0 adding the lanes' values in column order (the reference's order of
// additions, so its bits), the sum goes back to every lane by one shuffle,
// and each lane divides and stores once.  Nothing is stored and read back.
// The 2^k factor of the exp (cordic.cuh) is independent of the CORDIC
// chain, so its latency overlaps the stages.
//
// Rows of more than 32 values (no caller on the serving path) take a block
// each: the row max by a block reduction, one thread per window of 32
// columns summing the window's exps from 0 in column order into shared
// memory, thread 0 reducing the window sums level after level in the
// reference's order (xla_sum::reduce_levels, the rule row_sum follows), and
// every thread taking its values' exps again for the division rather than
// storing and reloading them.  Shared memory holds xla_sum::kMaxWindows
// window sums, so rows of up to 32,768 values; wider ones are refused.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "cordic.cuh"
#include "xla_sum.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

// A row of cols <= 32 values, value c in lane c.
__device__ __forceinline__ void softmax_row_regs(const float* __restrict__ xr,
                                                 float* __restrict__ orow,
                                                 int cols, int lane) {
  const bool live = lane < cols;
  const float v = live ? xr[lane] : -CUDART_INF_F;
  float m = v;
  for (int off = 1; off < cols; off <<= 1)
    m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
  const float e = cordic::cordic_exp(__fsub_rn(v, m));
  float s = e;  // lane 0's: e_0 + e_1 + ... + e_{cols-1}, in order
  for (int c = 1; c < cols; ++c) s = __fadd_rn(s, __shfl_sync(kFull, e, c));
  s = __shfl_sync(kFull, s, 0);
  if (live) orow[lane] = __fdiv_rn(e, s);
}

// A row of cols > 32 values, one block: the reference's order of additions
// (xla_sum.cuh), windows of 32 columns with the zero padding split between
// both ends, each from 0 in column order, then the later levels.
__global__ void cordic_softmax_wide_kernel(const float* __restrict__ x,
                                           float* __restrict__ out, int cols) {
  __shared__ float sums[xla_sum::kMaxWindows];
  __shared__ float warp_max[32];
  __shared__ float row_max, row_sum;
  const float* xr = x + (size_t)blockIdx.x * cols;
  float* orow = out + (size_t)blockIdx.x * cols;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  float m = -CUDART_INF_F;
  for (int c = threadIdx.x; c < cols; c += blockDim.x) m = fmaxf(m, xr[c]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < (int)(blockDim.x / 32) ? warp_max[lane] : -CUDART_INF_F;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
    if (lane == 0) row_max = m;
  }
  __syncthreads();
  m = row_max;
  const xla_sum::Split sp = xla_sum::split(cols);
  for (int j = threadIdx.x; j < sp.windows; j += blockDim.x) {
    float w = 0.0f;
    for (int i = 0; i < xla_sum::kSumWindow; ++i) {
      const int c = xla_sum::kSumWindow * j + i - sp.lo;
      w = __fadd_rn(w, c >= 0 && c < cols ? cordic::cordic_exp(__fsub_rn(xr[c], m)) : 0.0f);
    }
    sums[j] = w;
  }
  __syncthreads();
  if (threadIdx.x == 0) row_sum = xla_sum::reduce_levels(sums, sp.windows);
  __syncthreads();
  const float s = row_sum;
  for (int c = threadIdx.x; c < cols; c += blockDim.x)
    orow[c] = __fdiv_rn(cordic::cordic_exp(__fsub_rn(xr[c], m)), s);
}

__global__ void cordic_softmax_kernel(const float* __restrict__ x,
                                      float* __restrict__ out, int rows,
                                      int cols) {
  const int warp = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) / 32);
  const int lane = threadIdx.x % 32;
  if (warp >= rows) return;
  const float* xr = x + (size_t)warp * cols;
  float* orow = out + (size_t)warp * cols;
  softmax_row_regs(xr, orow, cols, lane);
}

}  // namespace

// x, out: (rows, cols) fp32 contiguous; 1 <= cols <= 32 * xla_sum::kMaxWindows
extern "C" int cordic_softmax_f32(const void* x, void* out, int rows, int cols,
                                  void* stream) {
  if (rows <= 0) return cudaSuccess;
  if (cols <= 0 || xla_sum::split(cols).windows > xla_sum::kMaxWindows) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cols > 32) {
    cordic_softmax_wide_kernel<<<rows, 256, 0, st>>>(static_cast<const float*>(x),
                                                     static_cast<float*>(out), cols);
    return cudaGetLastError();
  }
  const int threads = rows < 8 ? 32 * rows : 256;  // up to 8 rows per block
  const int blocks = (rows + threads / 32 - 1) / (threads / 32);
  cordic_softmax_kernel<<<blocks, threads, 0, st>>>(
      static_cast<const float*>(x), static_cast<float*>(out), rows, cols);
  return cudaGetLastError();
}

// Not launched: one lane's work on a row of the serving path's 2 values,
// with the loops unrolled, and a plain copy of one value, so that the
// library's disassembly shows what one value costs (chip_smoke.py).
extern "C" __global__ void sass_probe_softmax_row(const float* x, float* out) {
  softmax_row_regs(x, out, 2, threadIdx.x % 32);
}

extern "C" __global__ void sass_probe_copy(const float* x, float* out) {
  out[threadIdx.x] = x[threadIdx.x];
}
