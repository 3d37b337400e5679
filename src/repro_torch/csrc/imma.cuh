// Building blocks shared by the W8A8 kernels K1 (quant_matmul.cu) and K2
// (conv1d_fused.cu): the int8 tensor-core product, asynchronous 16-byte
// copies into shared memory, the 4 x 4 byte transposition, and the
// dequant epilogue in the reference's rounding.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace imma {

// D = A * B + D on the int8 tensor cores, one warp: A is 16 x 32 (row
// major), B 32 x 8 (column major), D 16 x 8 int32.  With g = lane / 4 and
// q = lane % 4 a lane holds
//   a[0] = A[g][4q .. 4q+3],      a[1] = A[g+8][4q .. 4q+3],
//   a[2] = A[g][16+4q .. 16+4q+3], a[3] = A[g+8][16+4q .. 16+4q+3],
//   b[0] = B[4q .. 4q+3][g],      b[1] = B[16+4q .. 16+4q+3][g],
//   d[0] = D[g][2q], d[1] = D[g][2q+1], d[2] = D[g+8][2q], d[3] = D[g+8][2q+1],
// four int8 values to a 32-bit word, the lowest index in the lowest byte.
// Integer products and sums are exact, so any tiling gives the same bits.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes from global to shared memory without passing through registers;
// the bytes past src_bytes (all 16 when it is 0) are written as zeros.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most n of this thread's committed groups are in flight.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n));
}

// Four 8 x 8 matrices of 16-bit values (8 rows of 16 bytes each) from shared
// memory: lane l gives the address of row l % 8 of matrix l / 8, and gets in
// r[j] bytes 4 (l % 4) .. 4 (l % 4) + 3 of row l / 4 of matrix j, which is
// the m16n8k32 fragment layout above when the matrices are the 16-byte
// halves of a tile's rows.  One instruction in place of four 32-bit loads.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const int8_t* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}

// Two matrices, the addresses from lanes 0-15.
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const int8_t* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(s)
               : "memory");
}

// *p += v at the device's L2, no value returned (RED, not ATOM).
__device__ __forceinline__ void red_add(int* p, int v) {
  asm volatile("red.relaxed.gpu.global.add.s32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// Four words r0..r3 hold bytes [k][0..3] of rows k = 0..3; returns in o[j]
// the word of column j, bytes [0..3][j] (the 4 x 4 byte transposition).
__device__ __forceinline__ void transpose4x4(uint32_t r0, uint32_t r1, uint32_t r2,
                                             uint32_t r3, uint32_t (&o)[4]) {
  const uint32_t t0 = __byte_perm(r0, r1, 0x5140);  // r0.0 r1.0 r0.1 r1.1
  const uint32_t t1 = __byte_perm(r2, r3, 0x5140);  // r2.0 r3.0 r2.1 r3.1
  const uint32_t t2 = __byte_perm(r0, r1, 0x7362);  // r0.2 r1.2 r0.3 r1.3
  const uint32_t t3 = __byte_perm(r2, r3, 0x7362);  // r2.2 r3.2 r2.3 r3.3
  o[0] = __byte_perm(t0, t1, 0x5410);
  o[1] = __byte_perm(t0, t1, 0x7632);
  o[2] = __byte_perm(t2, t3, 0x5410);
  o[3] = __byte_perm(t2, t3, 0x7632);
}

// The epilogue's arguments; out == nullptr means return the accumulators
// (then no scale or bias is read).  A kernel reads a thread's scales and
// biases into registers before its first store: a load after a store to
// out could not be moved ahead of it, and each would wait its own trip.
struct Epilogue {
  int* acc_out;
  float* out;
  const float* xs;    // x_scale: one value, or one a row (xs_per_row)
  const float* ws;    // w_scale: one value, or one a column (ws_per_col)
  const float* bias;  // one a column, or nullptr
  float clip;
  int has_clip, relu, xs_per_row, ws_per_col;

  // Scale rows are batch samples in K2 and rows of x in K1.
  __device__ __forceinline__ float x_scale(int srow) const {
    return out ? __ldg(xs + (xs_per_row ? srow : 0)) : 0.0f;
  }
  __device__ __forceinline__ float w_scale(int col) const {
    return out ? __ldg(ws + (ws_per_col ? col : 0)) : 0.0f;
  }
  __device__ __forceinline__ float bias_at(int col) const {
    return out && bias ? __ldg(bias + col) : 0.0f;
  }

  // fma(acc * x_scale, w_scale, bias) (the reference's CPU rounding; without
  // a bias (acc * x_scale) * w_scale), then ReLU and min(clip) as
  // jnp.maximum / jnp.minimum: NaN propagates, -0 -> +0, ties take the bound.
  __device__ __forceinline__ float apply(int acc, float xsv, float wsv, float bv) const {
    const float t = __fmul_rn(__int2float_rn(acc), xsv);
    float y = bias ? __fmaf_rn(t, wsv, bv) : __fmul_rn(t, wsv);
    if (relu) y = (y > 0.0f || y != y) ? y : 0.0f;
    if (has_clip) y = (y < clip || y != y) ? y : clip;
    return y;
  }

  // The result of one accumulator at flat index idx.
  __device__ __forceinline__ void store(size_t idx, int v, float xsv, float wsv, float bv) const {
    if (out == nullptr)
      acc_out[idx] = v;
    else
      out[idx] = apply(v, xsv, wsv, bv);
  }

  // Results of columns col and col + 1 of one row at flat index idx (w[j],
  // b[j]: their scale and bias); one 8-byte store when pair is set (both
  // columns exist and idx is even), else each existing column on its own.
  __device__ __forceinline__ void store2(size_t idx, int v0, int v1, float xsv,
                                         const float (&w)[2], const float (&b)[2],
                                         bool has1, bool pair) const {
    if (out == nullptr) {
      if (pair) {
        *reinterpret_cast<int2*>(acc_out + idx) = make_int2(v0, v1);
      } else {
        acc_out[idx] = v0;
        if (has1) acc_out[idx + 1] = v1;
      }
      return;
    }
    const float y0 = apply(v0, xsv, w[0], b[0]);
    if (pair) {
      *reinterpret_cast<float2*>(out + idx) = make_float2(y0, apply(v1, xsv, w[1], b[1]));
    } else {
      out[idx] = y0;
      if (has1) out[idx + 1] = apply(v1, xsv, w[1], b[1]);
    }
  }
};

}  // namespace imma
