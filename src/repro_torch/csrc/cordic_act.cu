// Kernel K3b: the elementwise CORDIC activation unit in all seven modes
// (tanh, sigmoid, exp, swish, gelu, selu, relu), fp32 in and out over a flat
// contiguous buffer.
//
// Replaces: src/repro/kernels/cordic_act.py, cordic_activation (Pallas body
// _kernel -> _apply_mode -> _tanh_core / _exp_core -> _cordic_sinh_cosh).
//
// What bounds it on the H100: 8 bytes of HBM traffic per value, against
// about 200 instructions per value in the CORDIC modes (20 shift-add
// stages, the range reduction, up to three IEEE divisions).  Instructions
// bound those modes, not bytes: at 132 SMs and 1.98 GHz the card issues one
// warp instruction per sub-partition and cycle (128 thread-instructions per
// SM and cycle), of which INT32 only 64 and FP32 128.  In the int32 form
// the 20 stages alone are 120-180 INT32 instructions per value, 3.8-5.6 us
// at the reference sweep's 4096 x 128 values against 1.25 us of bytes.
// Relu is one select per value and bound by bytes.  chip_smoke.py counts
// each mode's instructions from the built library's SASS (the
// sass_probe_* functions below) and computes the bound from them.
//
// What the design does about it: the stages run on the FP32 pipe with the
// same bits (cordic.cuh: 7 FP32 instructions and one LOP3 a stage), so the
// INT32 pipe no longer caps them and the issue rate does; the tail
// conversions are gone, since every Q15.16 value is already an exact
// float.  Each thread takes four values (four independent chains) through
// one 16-byte load and store, and the grid is sized to the SMs times the
// blocks each holds, looping over the rest.  The values before the first
// 16-byte boundary and after the last whole vector go one per thread; the
// wrapper gives the output the input's offset within 16 bytes, so a view
// at any float offset keeps the vector path.  The mode is a template parameter (no branch on the mode per
// value).  The arithmetic is the reference's bit for bit (cordic.cuh); the
// library is built with --fmad=false, so only the reference's own FMAs
// and the exact FMAs of the stages are fused.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cordic.cuh"

namespace {

using cordic::apply_mode;

constexpr int kThreads = 256;

template <int MODE>
__global__ void __launch_bounds__(kThreads)
cordic_act_kernel(const float* __restrict__ x, float* __restrict__ out, int n, int head) {
  const int tid = (int)(blockIdx.x * blockDim.x + threadIdx.x);
  const int stride = (int)(gridDim.x * blockDim.x);
  // x + head and out + head are 16-byte aligned (head = n when they cannot
  // both be, and then every value takes the scalar path)
  const int nvec = (n - head) >> 2;
  const float4* __restrict__ xv = reinterpret_cast<const float4*>(x + head);
  float4* __restrict__ ov = reinterpret_cast<float4*>(out + head);
  for (int i = tid; i < nvec; i += stride) {
    float4 v = xv[i];
    v.x = apply_mode<MODE>(v.x);  // four independent chains
    v.y = apply_mode<MODE>(v.y);
    v.z = apply_mode<MODE>(v.z);
    v.w = apply_mode<MODE>(v.w);
    ov[i] = v;
  }
  // the scalar edges: [0, head) and [head + 4 * nvec, n)
  const int tail0 = head + 4 * nvec;
  const int edges = head + (n - tail0);
  for (int j = tid; j < edges; j += stride) {
    const int i = j < head ? j : tail0 + (j - head);
    out[i] = apply_mode<MODE>(x[i]);
  }
}

template <int MODE>
int launch(const float* x, float* out, int n, cudaStream_t st) {
  auto kernel = cordic_act_kernel<MODE>;
  // SMs x resident blocks of this instantiation, per device
  static int cached_device = -1, grid_cap = 0;
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device != cached_device) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
    if (err != cudaSuccess) return err;
    grid_cap = sms * (per_sm > 0 ? per_sm : 1);
    cached_device = device;
  }
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x), oa = reinterpret_cast<uintptr_t>(out);
  int head = n;
  if ((xa & 15) == (oa & 15) && (xa & 3) == 0) {
    const int to_boundary = (int)(((16 - (xa & 15)) & 15) >> 2);
    head = to_boundary < n ? to_boundary : n;
  }
  const int nvec = (n - head) >> 2;
  const int edges = n - 4 * nvec;
  const int work = nvec > edges ? nvec : edges;
  int blocks = (work + kThreads - 1) / kThreads;
  if (blocks > grid_cap) blocks = grid_cap;
  kernel<<<blocks, kThreads, 0, st>>>(x, out, n, head);
  return cudaGetLastError();
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
    case cordic::kTanh: return launch<cordic::kTanh>(xi, o, n, st);
    case cordic::kSigmoid: return launch<cordic::kSigmoid>(xi, o, n, st);
    case cordic::kExp: return launch<cordic::kExp>(xi, o, n, st);
    case cordic::kSwish: return launch<cordic::kSwish>(xi, o, n, st);
    case cordic::kGelu: return launch<cordic::kGelu>(xi, o, n, st);
    case cordic::kSelu: return launch<cordic::kSelu>(xi, o, n, st);
    case cordic::kRelu: return launch<cordic::kRelu>(xi, o, n, st);
    default: return cudaErrorInvalidValue;
  }
}

// Not launched: four values through each mode, as a thread of the kernel
// takes them, and a plain copy of four, so that the library's disassembly
// (cuobjdump -sass) shows what a value costs; the copy is the load, store
// and indexing to subtract.
#define SASS_PROBE(name, mode)                                                  \
  extern "C" __global__ void sass_probe_##name(const float4* x, float4* out) { \
    float4 v = x[threadIdx.x];                                                  \
    v.x = apply_mode<mode>(v.x);                                                \
    v.y = apply_mode<mode>(v.y);                                                \
    v.z = apply_mode<mode>(v.z);                                                \
    v.w = apply_mode<mode>(v.w);                                                \
    out[threadIdx.x] = v;                                                       \
  }
SASS_PROBE(tanh, cordic::kTanh)
SASS_PROBE(sigmoid, cordic::kSigmoid)
SASS_PROBE(exp, cordic::kExp)
SASS_PROBE(swish, cordic::kSwish)
SASS_PROBE(gelu, cordic::kGelu)
SASS_PROBE(selu, cordic::kSelu)
SASS_PROBE(relu, cordic::kRelu)
#undef SASS_PROBE

extern "C" __global__ void sass_probe_copy4(const float4* x, float4* out) {
  out[threadIdx.x] = x[threadIdx.x];
}
