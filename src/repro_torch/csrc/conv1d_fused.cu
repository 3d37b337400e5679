// Kernel K2: fused W8A8 'same' 1-D convolution, int8 (B,L,Cin) x int8
// (K,Cin,Cout) -> int32 accumulators -> fused dequant epilogue into fp32.
//
// Replaces: src/repro/kernels/conv1d_fused.py, conv1d_fused_q (Pallas body
// _kernel), the TPU's in-VMEM im2col conv.
//
// What bounds it on the H100: on the serving path (B = 8 slots) conv1 and
// conv2 do 2*B*L*K*Cin*Cout = 0.43 and 0.43 G int8 operations against
// about 0.4 MB of int8 activations and weights in and 4.5 / 2.2 MB of fp32
// out, so they sit near the ridge between the int8 tensor-core rate and
// HBM; conv0 (Cin = 1) is pure data movement: 9 KB in, 2.2 MB fp32 out.
// This first version runs on the CUDA cores with __dp4a, so it is bound by
// its integer issue rate, far from either roof.
//
// What the design does about it: the grid is (B, L tiles of 64, Cout tiles
// of 64).  Each block stages the (64 + K - 1)-row activation slab of one
// sample, zero-padded at both edges ('same' padding), once in shared memory,
// and the weight tile transposed so that four consecutive input channels of
// one (tap, output channel) are one 32-bit word.  The K taps are shifted
// row reads of the same slab: no im2col tensor exists.  Input channels are
// staged 64 at a time, so any Cin fits.  Cin < 4 (conv0 has Cin = 1) takes
// a scalar multiply-add path instead of padding the channel dimension out
// to a dp4a word (the TPU padded it to 128 lanes).  The epilogue is fused:
// fma(acc * x_scale[b], w_scale[co], bias[co]) (the reference's CPU
// rounding), ReLU, min(clip), one fp32 store.  Fusing the following
// max-pool is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTL = 64;       // output rows per block
constexpr int kBN = 64;       // output channels per block
constexpr int kCC = 64;       // input channels staged per pass
constexpr int kThreads = 256;
constexpr int kRowsPerThread = kTL / (kThreads / kBN);  // 16

__host__ __device__ inline int round_up4(int v) { return (v + 3) & ~3; }

template <bool kDp4a>
__global__ void __launch_bounds__(kThreads)
conv1d_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
              int* __restrict__ acc_out, float* __restrict__ out,
              const float* __restrict__ xs, const float* __restrict__ ws,
              const float* __restrict__ bias, float clip, int has_clip,
              int relu, int xs_per_row, int ws_per_col, int L, int Cin,
              int Cout, int K) {
  extern __shared__ __align__(16) int8_t smem[];
  const int b = blockIdx.x;
  const int l0 = blockIdx.y * kTL;
  const int n0 = blockIdx.z * kBN;
  const int tid = threadIdx.x;
  const int pad_l = (K - 1) / 2;
  const int rows = kTL + K - 1;
  const int cc_max = kDp4a ? kCC : Cin;  // Cin < 4 on the scalar path

  const int co = tid % kBN;
  const int lg = tid / kBN;  // rows lg, lg + 4, ..., lg + 60
  int acc[kRowsPerThread];
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) acc[j] = 0;

  const int8_t* xb = x + (size_t)b * L * Cin;
  for (int c0 = 0; c0 < Cin; c0 += cc_max) {
    const int cn = min(cc_max, Cin - c0);
    const int ccp = kDp4a ? round_up4(cn) : cn;
    // the weight row stride is an odd number of 32-bit words
    const int wstride = K * ccp + 4;
    int8_t* slab = smem;                  // [rows][ccp]
    int8_t* wt = smem + rows * round_up4(cc_max);  // [kBN][wstride]

    for (int i = tid; i < rows * ccp; i += kThreads) {
      const int r = i / ccp, c = i % ccp;
      const int l = l0 - pad_l + r;
      slab[i] = (c < cn && l >= 0 && l < L) ? xb[(size_t)l * Cin + c0 + c]
                                            : int8_t(0);
    }
    for (int i = tid; i < K * ccp * kBN; i += kThreads) {
      const int o = i % kBN;
      const int rest = i / kBN;
      const int c = rest % ccp, t = rest / ccp;
      wt[o * wstride + t * ccp + c] =
          (c < cn && n0 + o < Cout) ? w[((size_t)t * Cin + c0 + c) * Cout + n0 + o]
                                    : int8_t(0);
    }
    __syncthreads();

    for (int t = 0; t < K; ++t) {
      const int8_t* wrow = wt + co * wstride + t * ccp;
      if (kDp4a) {
        for (int c = 0; c < ccp; c += 4) {
          const int wv = *reinterpret_cast<const int*>(wrow + c);
#pragma unroll
          for (int j = 0; j < kRowsPerThread; ++j) {
            const int xv = *reinterpret_cast<const int*>(
                slab + (lg + 4 * j + t) * ccp + c);
            acc[j] = __dp4a(xv, wv, acc[j]);
          }
        }
      } else {
        for (int c = 0; c < ccp; ++c) {
          const int wv = wrow[c];
#pragma unroll
          for (int j = 0; j < kRowsPerThread; ++j)
            acc[j] += int(slab[(lg + 4 * j + t) * ccp + c]) * wv;
        }
      }
    }
    __syncthreads();
  }

  const int o = n0 + co;
  if (o >= Cout) return;
  const float xsv = out ? xs[xs_per_row ? b : 0] : 0.0f;
  const float wsv = out ? ws[ws_per_col ? o : 0] : 0.0f;
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const int l = l0 + lg + 4 * j;
    if (l >= L) continue;
    const size_t idx = ((size_t)b * L + l) * Cout + o;
    if (out == nullptr) {
      acc_out[idx] = acc[j];
      continue;
    }
    const float t = __fmul_rn(__int2float_rn(acc[j]), xsv);
    float y = bias ? __fmaf_rn(t, wsv, bias[o]) : __fmul_rn(t, wsv);
    // jnp.maximum / jnp.minimum: NaN propagates, -0 -> +0, ties take the bound
    if (relu) y = (y > 0.0f || y != y) ? y : 0.0f;
    if (has_clip) y = (y < clip || y != y) ? y : clip;
    out[idx] = y;
  }
}

template <bool kDp4a>
cudaError_t launch(const void* x, const void* w, void* acc, void* out,
                   const void* xs, const void* ws, const void* bias, float clip,
                   int has_clip, int relu, int xs_per_row, int ws_per_col,
                   int B, int L, int Cin, int Cout, int K, cudaStream_t st) {
  const int cc = kDp4a ? kCC : Cin;
  const size_t smem = (size_t)(kTL + K - 1) * round_up4(cc) +
                      (size_t)kBN * (K * round_up4(cc) + 4);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        conv1d_kernel<kDp4a>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(B, (L + kTL - 1) / kTL, (Cout + kBN - 1) / kBN);
  conv1d_kernel<kDp4a><<<grid, kThreads, smem, st>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<int*>(acc), static_cast<float*>(out),
      static_cast<const float*>(xs), static_cast<const float*>(ws),
      static_cast<const float*>(bias), clip, has_clip, relu, xs_per_row,
      ws_per_col, L, Cin, Cout, K);
  return cudaGetLastError();
}

}  // namespace

// Writes int32 accumulators to acc when out is null (return_acc), else the
// fused-epilogue fp32 result to out.
extern "C" int conv1d_fused_i8(const void* x, const void* w, void* acc,
                               void* out, const void* xs, const void* ws,
                               const void* bias, float clip, int has_clip,
                               int relu, int xs_per_row, int ws_per_col, int B,
                               int L, int Cin, int Cout, int K, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Cin < 4)
    return launch<false>(x, w, acc, out, xs, ws, bias, clip, has_clip, relu,
                         xs_per_row, ws_per_col, B, L, Cin, Cout, K, st);
  return launch<true>(x, w, acc, out, xs, ws, bias, clip, has_clip, relu,
                      xs_per_row, ws_per_col, B, L, Cin, Cout, K, st);
}
