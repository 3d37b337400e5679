// Kernel K3b: the elementwise CORDIC activation unit in all seven modes
// (tanh, sigmoid, exp, swish, gelu, selu, relu), fp32 in and out over a flat
// contiguous buffer, one thread per element.
//
// Replaces: src/repro/kernels/cordic_act.py, cordic_activation (Pallas body
// _kernel -> _apply_mode -> _tanh_core / _exp_core -> _cordic_sinh_cosh).
//
// What bounds it on the H100: 8 bytes of HBM traffic per value against
// roughly 130-170 integer and fp32 operations per value (the 20-stage
// shift-add, the range reduction, the exp polynomial); relu is 1 operation.
// At the reference sweep's 4096 x 128 values the two limits are about equal
// (~1.2 us each at the published peaks), so the CORDIC modes sit near the
// balance point and relu is bound by bytes.
//
// What the design does about it: nothing yet beyond one pass over the data
// with the mode as a template parameter (no branch on the mode per value).
// The arithmetic is the reference's bit for bit: Q15.16 shift-add with
// arithmetic >> (cordic.cuh, shared with K3), rint conversions (round half
// to even, like jnp.round), tanh saturating at |v| >= 4.4 with each doubling
// 2t / fma(t, t, 1), the gelu cubic as fma(0.044715, v*(v*v), v), selu on
// cordic_exp(min(v, 0)), and relu with jnp.maximum's semantics (NaN passes
// through, -0 becomes +0).  The library is built with --fmad=false, so only
// the reference's own FMAs are fused.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cordic.cuh"

namespace {

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
  int c, s;
  cordic::sinh_cosh(__float2int_rn(__fmul_rn(a, 65536.0f)), c, s);
  float t = __fdiv_rn(__int2float_rn(s), fmaxf(__int2float_rn(c), 1.0f));
  t = __fdiv_rn(__fmul_rn(2.0f, t), __fmaf_rn(t, t, 1.0f));
  t = __fdiv_rn(__fmul_rn(2.0f, t), __fmaf_rn(t, t, 1.0f));
  return fabsf(v) >= 4.4f ? (v > 0.0f ? 1.0f : -1.0f) : t;
}

template <int MODE>
__device__ __forceinline__ float apply_mode(float v) {
  if (MODE == kTanh) return tanh_core(v);
  if (MODE == kSigmoid)
    return __fmul_rn(0.5f, __fadd_rn(1.0f, tanh_core(__fmul_rn(0.5f, v))));
  if (MODE == kExp) return cordic::cordic_exp(v);
  if (MODE == kSwish)
    return __fmul_rn(
        v, __fmul_rn(0.5f, __fadd_rn(1.0f, tanh_core(__fmul_rn(0.5f, v)))));
  if (MODE == kGelu) {
    const float cubic = __fmaf_rn(0.044715f, __fmul_rn(v, __fmul_rn(v, v)), v);
    const float inner = __fmul_rn(0.7978845608028654f, cubic);
    return __fmul_rn(__fmul_rn(0.5f, v), __fadd_rn(1.0f, tanh_core(inner)));
  }
  if (MODE == kSelu) {
    const float e = cordic::cordic_exp(v > 0.0f ? 0.0f : v);
    const float neg = __fmul_rn(kSeluAlpha, __fsub_rn(e, 1.0f));
    return __fmul_rn(kSeluScale, v > 0.0f ? v : neg);
  }
  // relu: jnp.maximum(v, 0)
  return (v > 0.0f || v != v) ? v : 0.0f;
}

template <int MODE>
__global__ void cordic_act_kernel(const float* __restrict__ x,
                                  float* __restrict__ out, int n) {
  const int i = (int)(blockIdx.x * blockDim.x + threadIdx.x);
  if (i < n) out[i] = apply_mode<MODE>(x[i]);
}

template <int MODE>
void launch(const float* x, float* out, int n, cudaStream_t st) {
  const int threads = 256;
  cordic_act_kernel<MODE><<<(n + threads - 1) / threads, threads, 0, st>>>(x, out, n);
}

}  // namespace

// mode: index into (tanh, sigmoid, exp, swish, gelu, selu, relu)
extern "C" int cordic_activation_f32(const void* x, void* out, int n, int mode,
                                     void* stream) {
  const float* xi = static_cast<const float*>(x);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0) return cudaSuccess;
  switch (mode) {
    case kTanh: launch<kTanh>(xi, o, n, st); break;
    case kSigmoid: launch<kSigmoid>(xi, o, n, st); break;
    case kExp: launch<kExp>(xi, o, n, st); break;
    case kSwish: launch<kSwish>(xi, o, n, st); break;
    case kGelu: launch<kGelu>(xi, o, n, st); break;
    case kSelu: launch<kSelu>(xi, o, n, st); break;
    case kRelu: launch<kRelu>(xi, o, n, st); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
