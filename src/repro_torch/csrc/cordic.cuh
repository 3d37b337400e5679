// Shared device code of the two CORDIC kernels, K3 (cordic_softmax.cu) and
// K3b (cordic_act.cu): the Q15.16 hyperbolic CORDIC, the exp built on it,
// and the seven activation modes, one value at a time.
//
// The CORDIC is the reference's bit-exact Q15.16 int32 shift-add: 20 stages
// with static shift amounts (iterations 4 and 13 repeated), signed >> .  It
// runs here on the FP32 pipe, not the INT32 pipe, with the same bits: every
// Q15.16 angle the unit can see has |z| <= 72,090, and over those angles
// every intermediate of the three chains is an integer below 2^17, so fp32
// holds each one exactly.  The arithmetic shift v >> i is floor(v * 2^-i):
// the product is exact, and one FMA rounding down onto the ulp-1 grid of
// [2^23, 2^24) floors it (kMagic below); the adds x +- ys are FMAs with the
// direction d = +-1, exact because their results are integers below 2^24.
// A stage is then 7 FP32 instructions and one LOP3 for d, against 6-9
// INT32 instructions for the int32 form: the H100 issues FP32 on 128 lanes
// per SM and cycle, INT32 on 64.  Splitting the values between the pipes
// (some stages in int32) would not pay: the int32 form of a stage is 9
// instructions (a shift, a conditional negate and an add for x and y, a
// sign mask, a negate and an add for z), so every value moved there adds
// instructions and loads the half-rate pipe.
//
// Rounding follows the reference's CPU numerics step for step:
// k = rint(v * f32(1/ln2)), r = v - k*ln2 with separate roundings (the
// library is built with --fmad=false), rint(r * 65536), and the 2^k factor
// is the reference's exp(ln2 * k) through the same FMA-contracted Cephes
// polynomial XLA uses, which is not an exact power of two.
#pragma once

#include <cuda_runtime.h>

namespace cordic {

// the hyperbolic iteration schedule and round(atanh(2^-i) * 2^16) for it
constexpr int kIters[20] = {1, 2, 3, 4, 4, 5, 6, 7, 8, 9,
                            10, 11, 12, 13, 13, 14, 15, 16, 17, 18};
constexpr int kAtanh[20] = {35999, 16739, 8235, 4101, 4101, 2049, 1024,
                            512, 256, 128, 64, 32, 16, 8, 8, 4, 2, 1, 1, 0};
constexpr int kX0 = 79135;  // round(2^16 / CORDIC gain)

// table reads as constant expressions, so device code may use them
__host__ __device__ constexpr int iter_shift(int i) { return kIters[i]; }
__host__ __device__ constexpr int iter_atanh(int i) { return kAtanh[i]; }

constexpr float kLn2 = 0x1.62e430p-1f;     // float32(ln 2)
constexpr float kInvLn2 = 0x1.715476p+0f;  // float32(1 / float32(ln 2))
// 1.5 * 2^23: magic + t lies in [2^23, 2^24), whose floats are the integers,
// for every |t| < 2^22
constexpr float kMagic = 0x1.8p23f;

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
  // 2^n as ((n + 127) << 23): n + (2^23 + 127) is exact and its low bits
  // are n + 127 (n = -127 gives 0, as the reference's int arithmetic does)
  const float pow2 = __int_as_float(__float_as_int(__fadd_rn(n, 8388735.0f)) << 23);
  return __fmul_rn(z, pow2);
}

// rint(v * 2^16), half to even, for |v * 2^16| < 2^22: the product is exact
// and the FMA rounds it onto the integers.  Zero comes out as +0, and every
// stage's FMA gives +0 for an exact zero, so the sign bit of z is the int32
// test z < 0.
__device__ __forceinline__ float to_q16(float v) {
  return __fsub_rn(__fmaf_rn(v, 65536.0f, kMagic), kMagic);
}

// The bits of 1.0f, read from constant memory: the compiler cannot fold a
// value there into an immediate, so it keeps it in a register and the sign
// below is one LOP3 (two immediates would take two).
static __constant__ int kOneBits = 0x3f800000;

// d = +1 for z >= 0, -1 for z < 0 (z is never -0)
__device__ __forceinline__ float direction(float z) {
  return __int_as_float((__float_as_int(z) & 0x80000000) | kOneBits);
}

// kMagic again, from constant memory: held in one register, it leaves each
// stage's scale an immediate of the FMA (with kMagic an immediate, ptxas
// holds the scales in registers and reloads them a stage at a time)
static __constant__ float kMagicBank = kMagic;

// floor(v * scale) for a power-of-two scale: the product is exact, and the
// FMA rounding down onto the integers of [2^23, 2^24) floors it
__device__ __forceinline__ float floor_scaled(float v, float scale) {
  return __fsub_rn(__fmaf_rd(v, scale, kMagicBank), kMagicBank);
}

// One rotation stage on exact integer-valued floats.
template <int I>
__device__ __forceinline__ void stage(float& x, float& y, float& z) {
  constexpr float kScale = 1.0f / float(1 << iter_shift(I));
  constexpr float kE = float(iter_atanh(I));
  const float xs = floor_scaled(x, kScale);  // x >> i
  const float ys = floor_scaled(y, kScale);  // y >> i
  const float d = direction(z);
  x = __fmaf_rn(d, ys, x);
  y = __fmaf_rn(d, xs, y);
  z = __fmaf_rn(-d, kE, z);
}

template <int I>
__device__ __forceinline__ void stages(float& x, float& y, float& z) {
  if constexpr (I < 20) {
    stage<I>(x, y, z);
    stages<I + 1>(x, y, z);
  }
}

// Rotation-mode hyperbolic CORDIC on a Q15.16 angle given as an exact
// integer-valued float (from to_q16): (cosh, sinh) in Q15.16, as floats.
// Stages 0 and 1 start from the constants x = X0, y = 0: x >> 1 and y >> 1
// are known, and x is still X0 after stage 0.
__device__ __forceinline__ void sinh_cosh(float z, float& cx, float& sy) {
  static_assert(iter_shift(0) == 1 && iter_shift(1) == 2, "stages 0 and 1 shift by 1 and 2");
  float d = direction(z);
  float y = __fmul_rn(d, float(kX0 >> 1));
  z = __fmaf_rn(-d, float(iter_atanh(0)), z);
  d = direction(z);
  float x = __fmaf_rn(d, floor_scaled(y, 0.25f), float(kX0));
  y = __fmaf_rn(d, float(kX0 >> 2), y);
  z = __fmaf_rn(-d, float(iter_atanh(1)), z);
  stages<2>(x, y, z);
  cx = x;
  sy = y;
}

// exp(v) via base-2 range reduction and exp(r) = cosh r + sinh r.
__device__ __forceinline__ float cordic_exp(float v) {
  v = fminf(fmaxf(v, -30.0f), 30.0f);
  const float k = rintf(__fmul_rn(v, kInvLn2));
  // independent of the CORDIC chain, so its latency overlaps the stages
  const float pow2k = ref_expf(__fmul_rn(kLn2, k));
  const float r = __fsub_rn(v, __fmul_rn(k, kLn2));
  float cx, sy;
  sinh_cosh(to_q16(r), cx, sy);
  const float e = __fmul_rn(__fadd_rn(cx, sy), 1.0f / 65536.0f);  // exact sum
  return __fmul_rn(e, pow2k);
}

// ---------------------------------------------------------------------------
// the activation unit's seven modes (kernel K3b)
// ---------------------------------------------------------------------------

enum Mode { kTanh = 0, kSigmoid, kExp, kSwish, kGelu, kSelu, kRelu };

constexpr float kSeluAlpha = 1.6732632423543772f;
constexpr float kSeluScale = 1.0507009873554805f;

// torch.clamp / jnp.clip: NaN propagates
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// tanh via two doublings, tanh(2a) = 2t / (1 + t^2) with a = v/4.
__device__ __forceinline__ float tanh_core(float v) {
  const float a = __fmul_rn(clampf(v, -4.4f, 4.4f), 0.25f);
  float c, s;
  sinh_cosh(to_q16(a), c, s);
  float t = __fdiv_rn(s, fmaxf(c, 1.0f));
  t = __fdiv_rn(__fmul_rn(2.0f, t), __fmaf_rn(t, t, 1.0f));
  t = __fdiv_rn(__fmul_rn(2.0f, t), __fmaf_rn(t, t, 1.0f));
  return fabsf(v) >= 4.4f ? (v > 0.0f ? 1.0f : -1.0f) : t;
}

template <int MODE>
__device__ __forceinline__ float apply_mode(float v) {
  if constexpr (MODE == kTanh) return tanh_core(v);
  if constexpr (MODE == kSigmoid)
    return __fmul_rn(0.5f, __fadd_rn(1.0f, tanh_core(__fmul_rn(0.5f, v))));
  if constexpr (MODE == kExp) return cordic_exp(v);
  if constexpr (MODE == kSwish)
    return __fmul_rn(
        v, __fmul_rn(0.5f, __fadd_rn(1.0f, tanh_core(__fmul_rn(0.5f, v)))));
  if constexpr (MODE == kGelu) {
    const float cubic = __fmaf_rn(0.044715f, __fmul_rn(v, __fmul_rn(v, v)), v);
    const float inner = __fmul_rn(0.7978845608028654f, cubic);
    return __fmul_rn(__fmul_rn(0.5f, v), __fadd_rn(1.0f, tanh_core(inner)));
  }
  if constexpr (MODE == kSelu) {
    const float e = cordic_exp(v > 0.0f ? 0.0f : v);
    const float neg = __fmul_rn(kSeluAlpha, __fsub_rn(e, 1.0f));
    return __fmul_rn(kSeluScale, v > 0.0f ? v : neg);
  }
  // relu: jnp.maximum(v, 0), NaN passes through and -0 becomes +0
  return (v > 0.0f || v != v) ? v : 0.0f;
}

}  // namespace cordic
