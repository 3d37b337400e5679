// Kernel K3: row softmax with CORDIC exponentials, fp32 (rows, cols) in and
// out, one warp per row.
//
// Replaces: src/repro/kernels/cordic_act.py, cordic_activation in "exp"
// mode (Pallas body _kernel -> _apply_mode -> _exp_core ->
// _cordic_sinh_cosh) under cordic_softmax, the classifier head.
//
// What bounds it on the H100: on the serving path it sees (slots, 2) fp32,
// 64 bytes in and out at 8 slots, and about 150 integer operations per
// value: it is bound by launch latency, not by HBM or by any arithmetic
// rate.
//
// What the design does about it: one launch does the whole softmax (row
// max, x - max, CORDIC exp, row sum, division), so the head costs one
// launch instead of the four passes of the reference's wrapper.  Each warp
// owns one row.  The exp is cordic.cuh's, shared with kernel K3b.  The row
// sum runs left to right in one lane.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "cordic.cuh"

namespace {

__global__ void cordic_softmax_kernel(const float* __restrict__ x,
                                      float* __restrict__ out, int rows,
                                      int cols) {
  const int warp = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) / 32);
  const int lane = threadIdx.x % 32;
  if (warp >= rows) return;
  const float* xr = x + (size_t)warp * cols;
  float* orow = out + (size_t)warp * cols;

  float m = -CUDART_INF_F;
  for (int c = lane; c < cols; c += 32) m = fmaxf(m, xr[c]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));

  for (int c = lane; c < cols; c += 32)
    orow[c] = cordic::cordic_exp(__fsub_rn(xr[c], m));
  __syncwarp();

  float s = 0.0f;
  if (lane == 0) {
    s = orow[0];
    for (int c = 1; c < cols; ++c) s = __fadd_rn(s, orow[c]);
  }
  s = __shfl_sync(0xffffffffu, s, 0);
  for (int c = lane; c < cols; c += 32) orow[c] = __fdiv_rn(orow[c], s);
}

}  // namespace

extern "C" int cordic_softmax_f32(const void* x, void* out, int rows, int cols,
                                  void* stream) {
  const int threads = 256;  // 8 rows per block
  const int blocks = (rows + threads / 32 - 1) / (threads / 32);
  cordic_softmax_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), rows, cols);
  return cudaGetLastError();
}
