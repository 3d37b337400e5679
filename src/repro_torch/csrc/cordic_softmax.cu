// Kernel K3: row softmax with CORDIC exponentials, fp32 (rows, cols) in and
// out, one warp per row.
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
// chain, so its latency overlaps the stages.  Rows of 33-1024 values loop
// over the reference's windows of 32 (its order of additions), and take
// the exp again for the division rather than store and reload it; the
// wrapper refuses wider rows.
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

// A row of 32 < cols <= 1024 values, in the reference's order of additions
// (xla_sum.cuh): windows of 32 columns, the zero padding split between both
// ends, each from 0 in column order, then the window sums from 0 in order.
// Lane i holds column 32 j + i - lo of window j; lane 0 adds the window's
// values in lane order (a padding zero leaves a non-negative sum as it is).
__device__ __forceinline__ void softmax_row_windows(const float* __restrict__ xr,
                                                    float* __restrict__ orow,
                                                    int cols, int lane) {
  float m = -CUDART_INF_F;
  for (int c = lane; c < cols; c += 32) m = fmaxf(m, xr[c]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
  const xla_sum::Split sp = xla_sum::split(cols);
  float s = 0.0f;  // lane 0's sum of the window sums
  for (int j = 0; j < sp.windows; ++j) {
    const int c = xla_sum::kSumWindow * j + lane - sp.lo;
    const float e = c >= 0 && c < cols ? cordic::cordic_exp(__fsub_rn(xr[c], m)) : 0.0f;
    float w = 0.0f;
    for (int i = 0; i < 32; ++i) w = __fadd_rn(w, __shfl_sync(kFull, e, i));
    s = __fadd_rn(s, w);
  }
  s = __shfl_sync(kFull, s, 0);
  for (int c = lane; c < cols; c += 32)
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
  if (cols <= 32)
    softmax_row_regs(xr, orow, cols, lane);
  else
    softmax_row_windows(xr, orow, cols, lane);
}

}  // namespace

extern "C" int cordic_softmax_f32(const void* x, void* out, int rows, int cols,
                                  void* stream) {
  const int threads = rows < 8 ? 32 * rows : 256;  // up to 8 rows per block
  const int blocks = (rows + threads / 32 - 1) / (threads / 32);
  cordic_softmax_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
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
