// Kernel K1: W8A8 matmul, int8 (M,K) x int8 (K,N) -> int32 accumulators,
// then the dequant epilogue into fp32, in one launch.
//
// Replaces: src/repro/kernels/quant_matmul.py, quant_matmul (Pallas body
// _kernel), the TPU's multi-precision MAC bank.
//
// What bounds it on the H100: on the serving path it is dense0, a skinny
// long-K product (M = 8 slots, K = 35,072 or 8,704, N = 64): 2*M*K*N int8
// operations against M*K + K*N bytes, about 2*M operations a weight byte,
// far below the ~590 a byte at which the tensor cores and not HBM would be
// the limit.  It is bound by reading the 2.24 MB weight once (0.67 us at
// 3.35 TB/s) and, at that size, by how many of those bytes are in flight
// at once, plus the launch.  The im2col sign-off path (M = B*L = 8,768)
// is a regular tensor-core product.
//
// What the design does about it:
// * One launch a call: no memset and no second kernel.  The grid is
//   (M tiles, N tiles of 64, K splits).  The wrapper
//   (kernels/quant_matmul.py::qmm_tiling) splits K in 256-deep chunks only
//   as far as it takes to put about one block on each SM: 137 blocks at
//   dense0, none at the sign-off shapes.  A split block adds its int32
//   partial tile into a workspace with atomics (RED); one thread fences and
//   counts the block in the tile's counter; the last block to arrive reads
//   the sums back with atomicExch, which also leaves the workspace zero,
//   runs the epilogue and sets the counter back to 0.  Integer sums are
//   exact and associative, so the result is bitwise the same in any block
//   order.  Measured, that finishing chain (fence, counter, exchange,
//   store) and the weight's trip from memory take most of dense0's time.
//   The workspace and the counters are zeroed once when the wrapper
//   allocates them; it keeps one pair per device and stream (two streams
//   never share one), and drops the pair when a launch reports an error.
// * The weight stream is read with 16-byte loads, a thread's four rows of
//   16 columns in flight at once (all 2.24 MB of dense0 in one wave), and
//   transposed in registers with __byte_perm into K-major words (four k of
//   one column) in shared memory; the next chunk's loads are issued before
//   this chunk's products.  x is staged with 16-byte cp.async.
// * The products run on the int8 tensor cores (mma.sync m16n8k32) with
//   A and B swapped: the transposed weight is the 16-row operand (16
//   output columns) and x the 8-column one, so M <= 8 fills the 8 columns
//   exactly and no padded x rows are multiplied.  mma.sync and not wgmma:
//   the bytes bound every serving call many times over.  At M <= 8 the
//   eight warps split the chunk's depth in two and add their tiles in
//   shared memory; at larger M a block takes 64 rows of x.  Fragments come
//   from shared memory by ldmatrix.
// * The epilogue is fma(acc * x_scale[m], w_scale[n], bias[n]) (the
//   reference's CPU rounding; the library is built with --fmad=false), ReLU,
//   min(clip), from the accumulator fragments or the workspace.
// K or N that is not a multiple of 16 (dense1's N = 2, the sign-off conv0's
// K = 3, edge shapes) stages byte by byte.
#include <cuda_runtime.h>
#include <stdint.h>

#include "imma.cuh"

namespace {

constexpr int kThreads = 256;      // eight warps
constexpr int kKC = 256;           // depth of one chunk
constexpr int kBN = 64;            // output columns a block takes
constexpr int kStride = kKC + 16;  // bytes a staged row takes (bank spread)

struct QmmShape {
  const int8_t* x;     // (M, K)
  const int8_t* w;     // (K, N)
  int* ws;             // (M, N) int32 workspace, zero between calls (splits > 1)
  unsigned* counters;  // one a (M tile, N tile), zero between calls
  int M, K, N;
  int chunks_per_block;
};

template <int BM, bool kVec>
__global__ void __launch_bounds__(kThreads) qmm_kernel(QmmShape a, imma::Epilogue ep) {
  constexpr int WM = BM == 8 ? 1 : 2;  // warps along M
  constexpr int WK = 8 / (4 * WM);     // warps along the chunk's depth
  constexpr int MT = BM / (8 * WM);    // 8-column MMA tiles a warp takes
  __shared__ __align__(16) int8_t xs[BM * kStride];
  __shared__ __align__(16) int8_t wt[kBN * kStride];
  __shared__ int red[WK > 1 ? 4 * 32 * 4 * MT : 1];
  __shared__ int last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int wn = warp & 3, wm = (warp >> 2) % WM, wk = (warp >> 2) / WM;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * kBN;
  const int k_begin = blockIdx.z * a.chunks_per_block * kKC;
  const int k_stop = min(a.K, k_begin + a.chunks_per_block * kKC);
  const bool split = gridDim.z > 1;

  // the weight: thread (kq, nq) takes rows 4 kq .. 4 kq + 3 of columns
  // 16 nq .. 16 nq + 15; a pair of lanes reads one 32-byte sector a row
  const int kq = (tid >> 1) & 63, nq = (tid & 1) + 2 * (tid >> 7);
  uint4 wr[4];
  auto load_w = [&](int kc) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = kc + 4 * kq + i, n = n0 + 16 * nq;
      wr[i] = (k < a.K && n < a.N)
                  ? __ldg(reinterpret_cast<const uint4*>(a.w + (size_t)k * a.N + n))
                  : make_uint4(0, 0, 0, 0);
    }
  };
  auto store_w = [&]() {
    const uint32_t* r0 = &wr[0].x;
    const uint32_t* r1 = &wr[1].x;
    const uint32_t* r2 = &wr[2].x;
    const uint32_t* r3 = &wr[3].x;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t o[4];
      imma::transpose4x4(r0[j], r1[j], r2[j], r3[j], o);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        *reinterpret_cast<uint32_t*>(wt + (16 * nq + 4 * j + c) * kStride + 4 * kq) = o[c];
    }
  };
  auto stage = [&](int kc) {
    if (kVec) {
      for (int i = tid; i < BM * (kKC / 16); i += kThreads) {
        const int r = i / (kKC / 16), k = kc + 16 * (i % (kKC / 16)), m = m0 + r;
        const bool ok = m < a.M && k < a.K;
        imma::cp_async16(xs + r * kStride + (k - kc), ok ? a.x + (size_t)m * a.K + k : a.x,
                         ok ? 16 : 0);
      }
      imma::cp_async_commit();
      store_w();
    } else {
      // only the depth the products read (K rounded up to 32) and the
      // columns that exist: rows of wt past N feed only outputs never stored
      const int depth = min(kKC, (a.K - kc + 31) & ~31);
      const int cols = min(kBN, a.N - n0);
      for (int i = tid; i < BM * depth; i += kThreads) {
        const int r = i / depth, c = i - r * depth, k = kc + c, m = m0 + r;
        xs[r * kStride + c] = (m < a.M && k < a.K) ? a.x[(size_t)m * a.K + k] : 0;
      }
      for (int i = tid; i < depth * cols; i += kThreads) {
        const int c = i / cols, n = i - c * cols, k = kc + c;
        wt[n * kStride + c] = k < a.K ? a.w[(size_t)k * a.N + n0 + n] : 0;
      }
    }
  };

  // the epilogue's scales and biases, read now so that their loads overlap
  // the products.  Unsplit: a warp's fragment, columns n0 + 16 wn + g (+8)
  // and rows m0 + 8 (wm MT + mt) + 2 q (+1).  Split: the last block's
  // element j of a thread, column n0 + tid % 64, row m0 + tid / 64 + 4 j.
  constexpr int kPer = BM * kBN / kThreads;
  float xsv[MT][2], wsv[2], bv[2];
  float lxs[kPer], lws, lbv;
  if (!split) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = n0 + 16 * wn + g + 8 * j;
      wsv[j] = n < a.N ? ep.w_scale(n) : 0.0f;
      bv[j] = n < a.N ? ep.bias_at(n) : 0.0f;
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int m = m0 + 8 * (wm * MT + mt) + 2 * q + j;
        xsv[mt][j] = m < a.M ? ep.x_scale(m) : 0.0f;
      }
  } else {
    const int n = n0 + tid % kBN;
    lws = n < a.N ? ep.w_scale(n) : 0.0f;
    lbv = n < a.N ? ep.bias_at(n) : 0.0f;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int m = m0 + tid / kBN + 4 * j;
      lxs[j] = m < a.M ? ep.x_scale(m) : 0.0f;
    }
  }

  int acc[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[mt][i] = 0;

  if (kVec && k_begin < k_stop) load_w(k_begin);
  for (int kc = k_begin; kc < k_stop; kc += kKC) {
    stage(kc);
    if (kVec) {
      if (kc + kKC < k_stop) load_w(kc + kKC);  // in flight during the products
      imma::cp_async_wait<0>();
    }
    __syncthreads();
    const int depth = min(kKC, a.K - kc);
    for (int ks = 32 * wk; ks < depth; ks += 32 * WK) {
      // fragments by ldmatrix: A's four matrices are the warp's 16 columns
      // of W^T, rows 0-7 / 8-15 x bytes 0-15 / 16-31; B's, x's 8-row tiles
      // x bytes 0-15 / 16-31, two tiles to an x4
      uint32_t af[4];
      imma::ldsm_x4(af, wt + (16 * wn + (lane & 15)) * kStride + ks + 16 * (lane >> 4));
      const int8_t* xrow = xs + (wm * MT * 8 + (lane & 7)) * kStride + ks + 16 * ((lane >> 3) & 1);
      if (MT == 1) {
        uint32_t bf[2];
        imma::ldsm_x2(bf, xrow);
        imma::mma_s8(acc[0], af, bf);
      } else {
#pragma unroll
        for (int mt = 0; mt < MT; mt += 2) {
          uint32_t r[4];
          imma::ldsm_x4(r, xrow + (mt * 8 + 8 * (lane >> 4)) * kStride);
          const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
          imma::mma_s8(acc[mt], af, b0);
          imma::mma_s8(acc[mt + 1], af, b1);
        }
      }
    }
    __syncthreads();
  }

  if (WK > 1) {  // add the second half of the depth into the first
    int* mine = red + ((wn * 32 + lane) * MT) * 4;
    if (wk == 1) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i) mine[mt * 4 + i] = acc[mt][i];
    }
    __syncthreads();
    if (wk == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][i] += mine[mt * 4 + i];
    }
  }

  // d[i] of tile mt: column n = n0 + 16 wn + g (+ 8 for i >= 2), row
  // m = m0 + 8 (wm MT + mt) + 2 q (+ 1 for odd i)
  if (wk == 0) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = n0 + 16 * wn + g + 8 * (i >> 1);
        const int m = m0 + 8 * (wm * MT + mt) + 2 * q + (i & 1);
        if (m >= a.M || n >= a.N) continue;
        const size_t idx = (size_t)m * a.N + n;
        if (split) {
          if (acc[mt][i] != 0) imma::red_add(a.ws + idx, acc[mt][i]);
        } else {
          ep.store(idx, acc[mt][i], xsv[mt][i & 1], wsv[i >> 1], bv[i >> 1]);
        }
      }
  }
  if (!split) return;

  // the last block of the tile to arrive finishes it.  As in a grid-wide
  // barrier, one thread fences for the block after the barrier (the fence
  // is cumulative over the block's sums the barrier ordered before it)
  __syncthreads();
  const unsigned tile = blockIdx.y * gridDim.x + blockIdx.x;
  if (tid == 0) {
    __threadfence();
    last = atomicAdd(a.counters + tile, 1u) == gridDim.z - 1;
    if (last) __threadfence();
  }
  __syncthreads();
  if (!last) return;
  const int n = n0 + tid % kBN;
  int v[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {  // all exchanges in flight at once
    const int m = m0 + tid / kBN + 4 * j;
    v[j] = (m < a.M && n < a.N) ? atomicExch(a.ws + (size_t)m * a.N + n, 0) : 0;
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int m = m0 + tid / kBN + 4 * j;
    if (m < a.M && n < a.N) ep.store((size_t)m * a.N + n, v[j], lxs[j], lws, lbv);
  }
  if (tid == 0) atomicExch(a.counters + tile, 0u);
}

template <int BM>
cudaError_t launch(const QmmShape& a, const imma::Epilogue& ep, int splits, cudaStream_t st) {
  const dim3 grid((a.M + BM - 1) / BM, (a.N + kBN - 1) / kBN, splits);
  const bool vec = a.K % 16 == 0 && a.N % 16 == 0 && ((uintptr_t)a.x | (uintptr_t)a.w) % 16 == 0;
  if (vec)
    qmm_kernel<BM, true><<<grid, kThreads, 0, st>>>(a, ep);
  else
    qmm_kernel<BM, false><<<grid, kThreads, 0, st>>>(a, ep);
  return cudaGetLastError();
}

}  // namespace

// acc: the int32 result when out is null (return_acc).  ws / counters: the
// zeroed workspace (M*N ints) and tile counters, needed when splits > 1.
// bm (8 or 64), chunks_per_block and splits come from qmm_tiling.
extern "C" int quant_matmul_i8(const void* x, const void* w, void* acc, void* out,
                               const void* xs, const void* ws_scale, const void* bias,
                               float clip, int has_clip, int relu, int xs_per_row,
                               int ws_per_col, int M, int K, int N, void* workspace,
                               void* counters, int bm, int chunks_per_block, int splits,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (splits < 1 || chunks_per_block < 1 || (splits > 1 && (!workspace || !counters)))
    return cudaErrorInvalidValue;
  const imma::Epilogue ep{static_cast<int*>(acc), static_cast<float*>(out),
                          static_cast<const float*>(xs), static_cast<const float*>(ws_scale),
                          static_cast<const float*>(bias), clip, has_clip, relu,
                          xs_per_row, ws_per_col};
  const QmmShape a{static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
                   static_cast<int*>(workspace), static_cast<unsigned*>(counters),
                   M, K, N, chunks_per_block};
  if (bm == 8) return launch<8>(a, ep, splits, st);
  if (bm == 64) return launch<64>(a, ep, splits, st);
  return cudaErrorInvalidValue;
}
