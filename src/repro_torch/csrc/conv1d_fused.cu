// Kernel K2: fused W8A8 'same' 1-D convolution, int8 (B,L,Cin) x int8
// (K,Cin,Cout) -> int32 accumulators -> fused dequant epilogue into fp32.
//
// Replaces: src/repro/kernels/conv1d_fused.py, conv1d_fused_q (Pallas body
// _kernel), the TPU's in-VMEM im2col conv.
//
// What bounds it on the H100: bytes.  On the serving path (B = 8 slots)
// each conv block writes 2.24 MB of fp32 and reads under 0.2 MB of int8;
// conv1 and conv2 do 0.43 G int8 operations each, about a fifth of a
// microsecond at the int8 tensor-core peak against 0.7 us of stores at the
// HBM rate.  conv0 (Cin = 1) is pure data movement.  Measured, a serving
// call takes several times its bytes' time: it is as long as one block's
// chain of dependent steps (launch, staging, products, stores), and
// removing any one of the three kinds of work shortens it by about a third
// (PERF.md).
//
// What the design does about it:
// * Cin >= 4 runs on the int8 tensor cores (mma.sync m16n8k32, imma.cuh).
//   mma.sync and not wgmma: the operations are a fifth of the bytes' time,
//   so the simpler warp-level product with 16- and 32-row tiles is enough,
//   and it lets the tiles stay small enough for every layer to fill the
//   card.  Block tile BM output rows x BN output channels (32 or 64 each,
//   chosen in kernels/conv1d_fused.py::conv_tiling so that a layer puts
//   about two blocks on every SM), four warps of (BM/2) x (BN/2).  Eight
//   warps in two groups over alternate chunks were slower.
// * Both operands are K-major (Cin contiguous), as the tensor cores take
//   them: x already is; the weight is packed once per weight tensor into
//   (K, Cout, Cin) by the wrapper, which caches the packed copy, so a call
//   makes no extra launch and the public layout stays the JAX one.
// * Each block stages its (BM + K - 1)-row activation slab, halo rows and
//   the 'same' zero padding included, and the K x BN weight rows, 32 input
//   channels at a time, with 16-byte cp.async (zero-filled past the edges
//   and past Cin, so ragged Cin is padded to the MMA depth in shared memory
//   only), in a ring of two to four stages: up to four chunks are in
//   flight from the block's start, and for wider Cin the copies of the
//   next channels overlap the products of this one.  The K taps are
//   shifted row reads of the one slab: no im2col tensor exists.  Fragments
//   come from shared memory by ldmatrix (one instruction for four 32-bit
//   registers a lane); rows are 48 bytes, so its eight rows a phase hit 32
//   banks.  Cin that is not a multiple of 16 (edge shapes) stages byte by
//   byte.
// * The epilogue runs from the accumulator fragments, each value on its
//   own: fma(acc * x_scale[b], w_scale[co], bias[co]) (the reference's CPU
//   rounding, --fmad=false), ReLU, min(clip), one fp32 store; a lane writes
//   two neighbouring channels as one 8-byte store, four lanes a whole
//   32-byte sector.
// * Cin < 4 (conv0) gains nothing from the tensor cores: a thread computes
//   four neighbouring output channels of one row with scalar multiply-adds
//   and writes them as one 16-byte store, 548 blocks for conv0 (four rows a
//   thread, loading the weights and scales once for them, was slower).
// Fusing the following max-pool is later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "imma.cuh"

namespace {

constexpr int kThreads = 128;   // four warps, 2 x 2 over the block tile
constexpr int kCC = 32;         // input channels a stage holds: one MMA depth
constexpr int kStride = kCC + 16;  // bytes a staged row takes (bank spread)
constexpr int kSmallThreads = 256;

struct ConvShape {
  const int8_t* x;   // (B, L, Cin)
  const int8_t* wp;  // (K, Cout, Cin), packed
  int B, L, Cin, Cout, K;
  int l_tiles;  // ceil(L / BM)
  int stages;   // 2, 3 or 4
};

// Stage `chunk` (input channels 32 chunk .. 32 chunk + 31) of the slab and
// of the weight rows at st, then commit one cp.async group (an empty one
// past the last chunk, so that every iteration commits one).
template <int BM, int BN, bool kVec>
__device__ __forceinline__ void stage_chunk(int8_t* st, const ConvShape& a, int b, int l0,
                                            int n0, int chunk, int chunks) {
  if (chunk < chunks) {
    const int tid = threadIdx.x;
    const int pad_l = (a.K - 1) / 2;
    const int rows_x = BM + a.K - 1;
    const int rows = rows_x + a.K * BN;
    const int c0 = chunk * kCC;
    if (kVec) {
      for (int i = tid; i < rows * (kCC / 16); i += kThreads) {
        const int r = i / (kCC / 16);
        const int c = c0 + 16 * (i % (kCC / 16));
        const int8_t* src = a.x;
        bool ok = c < a.Cin;
        if (r < rows_x) {
          const int l = l0 - pad_l + r;
          ok = ok && l >= 0 && l < a.L;
          if (ok) src = a.x + ((size_t)b * a.L + l) * a.Cin + c;
        } else {
          const int t = (r - rows_x) / BN, co = n0 + (r - rows_x) % BN;
          ok = ok && co < a.Cout;
          if (ok) src = a.wp + ((size_t)t * a.Cout + co) * a.Cin + c;
        }
        imma::cp_async16(st + r * kStride + (c - c0), src, ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < rows * kCC; i += kThreads) {
        const int r = i / kCC, c = c0 + i % kCC;
        int8_t v = 0;
        if (c < a.Cin) {
          if (r < rows_x) {
            const int l = l0 - pad_l + r;
            if (l >= 0 && l < a.L) v = a.x[((size_t)b * a.L + l) * a.Cin + c];
          } else {
            const int t = (r - rows_x) / BN, co = n0 + (r - rows_x) % BN;
            if (co < a.Cout) v = a.wp[((size_t)t * a.Cout + co) * a.Cin + c];
          }
        }
        st[r * kStride + (c - c0)] = v;
      }
    }
  }
  imma::cp_async_commit();
}

template <int BM, int BN, bool kVec>
__global__ void __launch_bounds__(kThreads)
conv1d_mma_kernel(ConvShape a, imma::Epilogue ep) {
  extern __shared__ __align__(16) int8_t smem[];
  constexpr int WM = BM / 2, WN = BN / 2;  // a warp's tile
  constexpr int MT = WM / 16, NT = WN / 8;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int wm0 = (warp >> 1) * WM, wn0 = (warp & 1) * WN;
  const int b = blockIdx.x / a.l_tiles;
  const int l0 = (blockIdx.x % a.l_tiles) * BM;
  const int n0 = blockIdx.y * BN;
  const int rows_x = BM + a.K - 1;
  const int stage_bytes = (rows_x + a.K * BN) * kStride;
  const int chunks = (a.Cin + kCC - 1) / kCC;

  int acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;

  // the epilogue's scales and biases of this thread's channels, read now so
  // that their loads overlap the staging
  const float xsv = ep.x_scale(b);
  float wsv[NT][2], bv[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int co = n0 + wn0 + 8 * nt + 2 * q + j;
      wsv[nt][j] = co < a.Cout ? ep.w_scale(co) : 0.0f;
      bv[nt][j] = co < a.Cout ? ep.bias_at(co) : 0.0f;
    }

  for (int s = 0; s < a.stages - 1; ++s)
    stage_chunk<BM, BN, kVec>(smem + s * stage_bytes, a, b, l0, n0, s, chunks);
  for (int ch = 0; ch < chunks; ++ch) {
    // the slot of chunk ch + stages - 1 was read in iteration ch - 1
    const int next = ch + a.stages - 1;
    stage_chunk<BM, BN, kVec>(smem + (next % a.stages) * stage_bytes, a, b, l0, n0, next,
                              chunks);
    if (a.stages == 4)
      imma::cp_async_wait<3>();
    else if (a.stages == 3)
      imma::cp_async_wait<2>();
    else
      imma::cp_async_wait<1>();
    __syncthreads();
    const int8_t* xs = smem + (ch % a.stages) * stage_bytes;
    const int8_t* wt = xs + rows_x * kStride;
    for (int t = 0; t < a.K; ++t) {
      // fragments by ldmatrix: A's four matrices are rows 0-7 / 8-15 x
      // bytes 0-15 / 16-31 of the tap's 16 slab rows; B's, two n-tiles'
      // rows x bytes 0-15 / 16-31
      uint32_t af[MT][4], bf[NT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        imma::ldsm_x4(af[mt], xs + (wm0 + 16 * mt + t + (lane & 15)) * kStride + 16 * (lane >> 4));
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        uint32_t r[4];
        imma::ldsm_x4(r, wt + (t * BN + wn0 + 8 * nt + (lane & 7) + 8 * (lane >> 4)) * kStride +
                             16 * ((lane >> 3) & 1));
        bf[nt][0] = r[0];
        bf[nt][1] = r[1];
        bf[nt + 1][0] = r[2];
        bf[nt + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) imma::mma_s8(acc[mt][nt], af[mt], bf[nt]);
    }
    __syncthreads();
  }

  // d[2h], d[2h+1] of tile (mt, nt): row l0 + wm0 + 16 mt + g + 8 h,
  // channels co, co + 1 with co = n0 + wn0 + 8 nt + 2 q
  const bool even = (a.Cout & 1) == 0;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int l = l0 + wm0 + 16 * mt + g + 8 * h;
      if (l >= a.L) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int co = n0 + wn0 + 8 * nt + 2 * q;
        if (co >= a.Cout) continue;
        const bool has1 = co + 1 < a.Cout;
        ep.store2(((size_t)b * a.L + l) * a.Cout + co, acc[mt][nt][2 * h],
                  acc[mt][nt][2 * h + 1], xsv, wsv[nt], bv[nt], has1, has1 && even);
      }
    }
}

// Cin < 4: one thread, four neighbouring output channels of one row.
template <bool kVec4>
__global__ void __launch_bounds__(kSmallThreads)
conv1d_small_cin_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                        imma::Epilogue ep, int B, int L, int Cin, int Cout, int K) {
  const int groups = (Cout + 3) / 4;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)B * L * groups) return;
  const int row = (int)(i / groups), co0 = 4 * (int)(i % groups);
  const int b = row / L, l = row % L;
  const int pad_l = (K - 1) / 2;
  const float xsv = ep.x_scale(b);
  float wsv[4], bv[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    wsv[j] = co0 + j < Cout ? ep.w_scale(co0 + j) : 0.0f;
    bv[j] = co0 + j < Cout ? ep.bias_at(co0 + j) : 0.0f;
  }
  int acc[4] = {0, 0, 0, 0};
  for (int t = 0; t < K; ++t) {
    const int li = l + t - pad_l;
    if (li < 0 || li >= L) continue;
    for (int c = 0; c < Cin; ++c) {
      const int xv = x[((size_t)b * L + li) * Cin + c];
      const int8_t* wr = w + ((size_t)t * Cin + c) * Cout + co0;
      if (kVec4) {
        const char4 wv = *reinterpret_cast<const char4*>(wr);
        acc[0] += xv * wv.x;
        acc[1] += xv * wv.y;
        acc[2] += xv * wv.z;
        acc[3] += xv * wv.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (co0 + j < Cout) acc[j] += xv * wr[j];
      }
    }
  }
  const size_t idx = (size_t)row * Cout + co0;
  if (kVec4) {
    if (ep.out == nullptr) {
      *reinterpret_cast<int4*>(ep.acc_out + idx) = make_int4(acc[0], acc[1], acc[2], acc[3]);
    } else {
      *reinterpret_cast<float4*>(ep.out + idx) = make_float4(
          ep.apply(acc[0], xsv, wsv[0], bv[0]), ep.apply(acc[1], xsv, wsv[1], bv[1]),
          ep.apply(acc[2], xsv, wsv[2], bv[2]), ep.apply(acc[3], xsv, wsv[3], bv[3]));
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (co0 + j < Cout) ep.store(idx + j, acc[j], xsv, wsv[j], bv[j]);
  }
}

template <int BM, int BN, bool kVec>
cudaError_t launch_mma(const ConvShape& a, const imma::Epilogue& ep, cudaStream_t st) {
  const size_t smem = (size_t)a.stages * (BM + a.K - 1 + a.K * BN) * kStride;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv1d_mma_kernel<BM, BN, kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(a.B * a.l_tiles, (a.Cout + BN - 1) / BN);
  conv1d_mma_kernel<BM, BN, kVec><<<grid, kThreads, smem, st>>>(a, ep);
  return cudaGetLastError();
}

template <int BM, int BN>
cudaError_t launch_tile(const ConvShape& a, const imma::Epilogue& ep, cudaStream_t st) {
  const bool vec = a.Cin % 16 == 0 && ((uintptr_t)a.x | (uintptr_t)a.wp) % 16 == 0;
  return vec ? launch_mma<BM, BN, true>(a, ep, st) : launch_mma<BM, BN, false>(a, ep, st);
}

}  // namespace

// x (B, L, Cin) and w (K, Cin, Cout) int8; wp the weight packed as
// (K, Cout, Cin) (used when Cin >= 4).  Writes int32 accumulators to acc
// when out is null (return_acc), else the fused-epilogue fp32 result to
// out.  bm, bn (32 or 64) and stages (2 to 4) are the tile of Cin >= 4.
extern "C" int conv1d_fused_i8(const void* x, const void* w, const void* wp, void* acc,
                               void* out, const void* xs, const void* ws, const void* bias,
                               float clip, int has_clip, int relu, int xs_per_row,
                               int ws_per_col, int B, int L, int Cin, int Cout, int K,
                               int bm, int bn, int stages, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const imma::Epilogue ep{static_cast<int*>(acc), static_cast<float*>(out),
                          static_cast<const float*>(xs), static_cast<const float*>(ws),
                          static_cast<const float*>(bias), clip, has_clip, relu,
                          xs_per_row, ws_per_col};
  if (Cin < 4) {
    const size_t threads = (size_t)B * L * ((Cout + 3) / 4);
    const unsigned blocks = (unsigned)((threads + kSmallThreads - 1) / kSmallThreads);
    const bool vec4 = Cout % 4 == 0 && (uintptr_t)w % 4 == 0;
    if (vec4)
      conv1d_small_cin_kernel<true><<<blocks, kSmallThreads, 0, st>>>(
          static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), ep, B, L, Cin, Cout, K);
    else
      conv1d_small_cin_kernel<false><<<blocks, kSmallThreads, 0, st>>>(
          static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), ep, B, L, Cin, Cout, K);
    return cudaGetLastError();
  }
  if (stages < 2 || stages > 4) return cudaErrorInvalidValue;
  const ConvShape a{static_cast<const int8_t*>(x), static_cast<const int8_t*>(wp),
                    B, L, Cin, Cout, K, (L + bm - 1) / bm, stages};
  if (bm == 64 && bn == 64) return launch_tile<64, 64>(a, ep, st);
  if (bm == 32 && bn == 64) return launch_tile<32, 64>(a, ep, st);
  if (bm == 64 && bn == 32) return launch_tile<64, 32>(a, ep, st);
  if (bm == 32 && bn == 32) return launch_tile<32, 32>(a, ep, st);
  return cudaErrorInvalidValue;
}
