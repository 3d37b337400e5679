// Shared device code of the two CORDIC kernels, K3 (cordic_softmax.cu) and
// K3b (cordic_act.cu): the Q15.16 hyperbolic CORDIC and the exp built on it.
//
// The CORDIC is the reference's bit-exact Q15.16 int32 shift-add: 20 stages
// with static shift amounts (iterations 4 and 13 repeated), signed >>
// (arithmetic in nvcc).  Rounding follows the reference's CPU numerics step
// for step: k = rint(v * f32(1/ln2)), r = v - k*ln2 with separate roundings
// (the library is built with --fmad=false), rint(r * 65536), and the 2^k
// factor is the reference's exp(ln2 * k) through the same FMA-contracted
// Cephes polynomial XLA uses, which is not an exact power of two.
#pragma once

#include <cuda_runtime.h>

namespace cordic {

// the hyperbolic iteration schedule and round(atanh(2^-i) * 2^16) for it;
// static, so each kernel source that includes this header has its own copy
static __constant__ int kIters[20] = {1, 2, 3, 4, 4, 5, 6, 7, 8, 9,
                                      10, 11, 12, 13, 13, 14, 15, 16, 17, 18};
static __constant__ int kAtanh[20] = {35999, 16739, 8235, 4101, 4101, 2049, 1024,
                                      512, 256, 128, 64, 32, 16, 8, 8, 4, 2, 1, 1, 0};
constexpr int kX0 = 79135;  // round(2^16 / CORDIC gain)

constexpr float kLn2 = 0x1.62e430p-1f;     // float32(ln 2)
constexpr float kInvLn2 = 0x1.715476p+0f;  // float32(1 / float32(ln 2))

// XLA's CPU float32 exp: Cephes range reduction and polynomial with FMAs.
__device__ __forceinline__ float ref_expf(float x) {
  x = fminf(fmaxf(x, -0x1.5f3334p+6f), 0x1.633334p+6f);  // [-87.8, 88.8]
  float n = floorf(__fmaf_rn(x, 0x1.715476p+0f, 0.5f));
  n = fminf(fmaxf(n, -127.0f), 127.0f);
  float r = __fmaf_rn(-0x1.63p-1f, n, x);         // - n * 0.693359375
  r = __fmaf_rn(0x1.bd0106p-13f, n, r);           // - n * -2.12194440e-4
  float z = __fmaf_rn(r, 0x1.a0d2cep-13f, 0x1.6e879cp-10f);
  z = __fmaf_rn(z, r, 0x1.111210p-7f);
  z = __fmaf_rn(z, r, 0x1.555382p-5f);
  z = __fmaf_rn(z, r, 0x1.555554p-3f);
  z = __fmaf_rn(z, r, 0.5f);
  z = __fmaf_rn(z, __fmul_rn(r, r), r);
  z = __fadd_rn(z, 1.0f);
  const float pow2 = __int_as_float(((int)n + 127) << 23);
  return __fmul_rn(z, pow2);
}

// Rotation-mode hyperbolic CORDIC on a Q15.16 angle: (cosh, sinh) in Q15.16.
__device__ __forceinline__ void sinh_cosh(int z, int& cx, int& sy) {
  cx = kX0;
  sy = 0;
#pragma unroll
  for (int i = 0; i < 20; ++i) {
    const int xs = cx >> kIters[i];
    const int ys = sy >> kIters[i];
    if (z >= 0) {
      cx += ys;
      sy += xs;
      z -= kAtanh[i];
    } else {
      cx -= ys;
      sy -= xs;
      z += kAtanh[i];
    }
  }
}

// exp(v) via base-2 range reduction and exp(r) = cosh r + sinh r.
__device__ __forceinline__ float cordic_exp(float v) {
  v = fminf(fmaxf(v, -30.0f), 30.0f);
  const float k = rintf(__fmul_rn(v, kInvLn2));
  const float r = __fsub_rn(v, __fmul_rn(k, kLn2));
  int cx, sy;
  sinh_cosh(__float2int_rn(__fmul_rn(r, 65536.0f)), cx, sy);
  const float e = __fmul_rn(__int2float_rn(cx + sy), 1.0f / 65536.0f);
  return __fmul_rn(e, ref_expf(__fmul_rn(kLn2, k)));
}

}  // namespace cordic
