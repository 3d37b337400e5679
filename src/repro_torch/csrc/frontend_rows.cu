// The DSP front-end's two per-row primitives, with bits that do not depend
// on the batch: the mel and DCT-II projections, and the per-row sums behind
// every mean of the front-end.
//
// Replaces: no TPU kernel.  The reference runs these inside its jitted
// front-end (src/repro/data/features_jax.py), the projections under
// jax.lax.map so that gemm blocking cannot change with the batch.  On the
// card the same hazard has three sources: cuBLAS picks its kernel by shape,
// PyTorch's reductions pick their split from the whole tensor's shape, and
// a row's bits must not depend on its co-batch (the serving contract
// streaming == batched).  Both kernels fix the order of every sum instead.
//
// project_rows: out[r, n] = sum over k of x[r, k] * m[k, n] in a two-level
// order that depends on K alone: k is cut into consecutive chunks of
// kProjectChunk (the last may be short), each chunk is summed from +0 in
// ascending k, and the chunk partials are added left to right from the
// first.  Each product and each sum is rounded on its own (__fmul_rn,
// __fadd_rn, --fmad=false).  For K <= kProjectChunk that is one ascending
// chain.  project_rows also computes every bf16/fp32 layer of the datapath
// (serving/accelerator.py): a dense layer as (B, K) @ (K, N), a conv as its
// im2col rows (B*L, K*Cin) @ (K*Cin, Cout).
//
// What bounds it on the H100: each output's chunk is a chain of up to
// 1,024 dependent adds, so a long K is bound by one chain plus the finish
// of the split, not by its bytes (a float dense0,
// 8 x 35,072 @ 35,072 x 64, reads 8.98 MB of m, 2.7 us at 3.35 TB/s); the
// front-end's mel and DCT (408 x 513 @ 513 x 64, 408 x 64 @ 64 x 20) are
// that chain at 513 and the launch; conv0's im2col rows (8,768 x 3 @
// 3 x 64) are bytes, mostly the 2.2 MB written.  The design:
// * A block owns a BR x BC output tile and one chunk of k (the grid's z).
//   Its x rows and m columns are staged in shared memory, KT values of k
//   at a time, in a ring of stages filled by cp.async (16-byte copies of
//   x where K is a multiple of 4, of m where N is, 4-byte copies
//   otherwise), so that m is read once per block, not once per row.
//   Each thread's copies are fixed slots of the slab, so a stage costs a
//   few instructions beside its KT steps.
// * A thread keeps a TM x TN micro-tile of outputs in registers, TM x TN
//   independent chains; a stage's x comes as float4 along k, m as one
//   vector along n.  No tensor core: none adds fp32 products one at a time
//   in a given order.
// * When K > kProjectChunk a block writes its chunk's partial tile into a
//   workspace and one thread counts the block in the tile's counter with
//   an acquire-release add; the last block of the tile to arrive adds the
//   partials in chunk order (its own from registers, all loads of a float
//   dense0's 35 partials in flight at once) and sets the counter back to
//   0.  The sum's order is fixed, so the result does not depend on which
//   block is last.  The wrapper (kernels/frontend.py) keeps one workspace
//   and counter set per device and stream, the counters zero between
//   calls.  That finish (stores, counter, loads, store) is a series of
//   trips to memory after the last chain.
// * The tile is chosen by shape in the wrapper (project_tiling), from the
//   four of project_rows_f32's switch, the same table on both sides: 8 x 8
//   outputs with KT = 256 for a split k, where one chain bounds the time
//   and the most warps should carry the chains; 8 x 16, 16 x 32 (2 x 2 a
//   thread) and 32 x 64 (4 x 4, float4 stores) for unsplit k, the larger
//   the shorter the chain.
//
// row_sum: the sum of each row in the reduction order of the reference's
// CPU compiler (xla_sum.cuh): a row of n <= 32 values is summed left to
// right from its first value; a longer one is cut into windows of exactly
// 32, the zero padding split between both ends, each window summed from 0,
// and the window sums are reduced again by the same rule.  The rows are
// staged into shared memory with coalesced loads (16-byte where aligned),
// in a layout padded to 33 floats a window (or an odd stride a short row)
// so that lane j reading window j is free of bank conflicts.  The work
// fits the row: rows of <= 32 values take a thread each, 128 rows a block;
// rows of up to 64 windows a warp each, a lane a window and the later
// levels inside the warp; longer rows (up to 1,024 windows, 32,768 values)
// a block each, eight warps over the windows, then one warp for the later
// levels.  At the front-end's shapes (rows of 12 to 1,096 values, eight
// launches a block) it is bound by launch latency.
#include <cuda_runtime.h>
#include <stdint.h>

#include "imma.cuh"
#include "xla_sum.cuh"

namespace {

// ---------------------------------------------------------------------------
// project_rows
// ---------------------------------------------------------------------------

constexpr int kProjectChunk = 1024;  // PROJECT_CHUNK in kernels/frontend.py
constexpr int kSmemFloats = 11264;   // a block's ring of stages, at most (44 KB)

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ unsigned atom_add_acq_rel(unsigned* p, unsigned v) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;\n"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

template <int TN>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[TN]) {
  if constexpr (TN == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else if constexpr (TN == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x, v[1] = q.y;
  } else {
#pragma unroll
    for (int t = 0; t < TN; ++t) v[t] = p[t];
  }
}

struct ProjArgs {
  const float* x;      // (R, K)
  const float* m;      // (K, N)
  float* out;          // (R, N)
  float* ws;           // (chunks, R, N) partials, when the grid splits k
  unsigned* counters;  // one a (row tile, column tile), zero between calls
  int R, K, N;
};

// A block owns BR x BC outputs, a thread TM x TN of them; a stage holds KT
// values of k
template <int BR, int BC, int TM, int TN, int KT>
struct Tile {
  static constexpr int TC = BC / TN;  // threads along n
  static constexpr int kThreads = (BR / TM) * TC;
  static constexpr int XS = KT + 4;  // floats a staged x row takes (16-byte rows, banks spread)
  static constexpr int kStageFloats = BR * XS + KT * BC;
  static constexpr int kStages = kSmemFloats / kStageFloats > 8 ? 8 : kSmemFloats / kStageFloats;
  static_assert(kStages >= 2, "a tile's ring needs two stages");
};

template <int W>
__device__ __forceinline__ void cp_async(float* smem, const float* gmem, bool ok) {
  if constexpr (W == 4)
    imma::cp_async16(smem, gmem, ok ? 16 : 0);
  else
    cp_async4(smem, gmem, ok ? 4 : 0);
}

// XV (MV): x rows (m rows) are copied 16 bytes at a time, K (N) a
// multiple of 4 and the operand 16-byte aligned, else 4 bytes at a time
template <int BR, int BC, int TM, int TN, int KT, bool XV, bool MV>
__global__ void __launch_bounds__(Tile<BR, BC, TM, TN, KT>::kThreads)
    project_rows_kernel(ProjArgs a) {
  using T = Tile<BR, BC, TM, TN, KT>;
  constexpr int kThreads = T::kThreads, XS = T::XS, kStages = T::kStages;
  constexpr int XW = XV ? 4 : 1, MW = MV ? 4 : 1;  // floats a copy moves
  constexpr int XP = BR * KT / XW, MP = KT * BC / MW;  // copies of a stage
  constexpr int XC = (XP + kThreads - 1) / kThreads, MC = (MP + kThreads - 1) / kThreads;
  __shared__ __align__(16) float smem[kStages * T::kStageFloats];
  __shared__ int last;

  const int tid = threadIdx.x;
  const int tx = tid % T::TC, ty = tid / T::TC;
  const int r0 = blockIdx.y * BR, c0 = blockIdx.x * BC;
  const int chunk = blockIdx.z;
  const int k_begin = chunk * kProjectChunk;
  const int k_end = min(a.K, k_begin + kProjectChunk);
  const int n_stages = (k_end - k_begin + KT - 1) / KT;

  // stage s of the chunk into ring slot s % kStages: copy p of the x slab
  // is row p / (KT / XW) at k (p % (KT / XW)) XW, copy p of the m slab row
  // p / (BC / MW) at column (p % (BC / MW)) MW; values past the chunk,
  // the rows or the columns are zero-filled (and never summed)
  auto stage = [&](int s) {
    float* xs = smem + (s % kStages) * T::kStageFloats;
    float* ms = xs + BR * XS;
    const int kb = k_begin + s * KT;
#pragma unroll
    for (int i = 0; i < XC; ++i) {
      const int p = tid + i * kThreads, r = p / (KT / XW), kk = XW * (p % (KT / XW));
      if (XC * kThreads != XP && p >= XP) break;
      const bool ok = r0 + r < a.R && kb + kk < k_end;
      cp_async<XW>(xs + r * XS + kk, a.x + (ok ? (r0 + r) * a.K + kb + kk : 0), ok);
    }
#pragma unroll
    for (int i = 0; i < MC; ++i) {
      const int p = tid + i * kThreads, kk = p / (BC / MW), c = MW * (p % (BC / MW));
      if (MC * kThreads != MP && p >= MP) break;
      const bool ok = kb + kk < k_end && c0 + c < a.N;
      cp_async<MW>(ms + kk * BC + c, a.m + (ok ? (kb + kk) * a.N + c0 + c : 0), ok);
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int t = 0; t < TN; ++t) acc[i][t] = 0.0f;

  // one step of k: every chain of the micro-tile adds x[r, k] * m[k, n]
  auto step = [&](const float (&xk)[TM], const float* mrow) {
    float mv[TN];
    load_vec<TN>(mrow + tx * TN, mv);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int t = 0; t < TN; ++t) acc[i][t] = __fadd_rn(acc[i][t], __fmul_rn(xk[i], mv[t]));
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_stages) stage(s);
    imma::cp_async_commit();
  }
  for (int s = 0; s < n_stages; ++s) {
    imma::cp_async_wait<kStages - 2>();
    __syncthreads();  // stage s has landed for every thread; slot s - 1 is free
    if (s + kStages - 1 < n_stages) stage(s + kStages - 1);
    imma::cp_async_commit();
    const float* xs = smem + (s % kStages) * T::kStageFloats;
    const float* ms = xs + BR * XS;
    const int kn = min(KT, k_end - (k_begin + s * KT));
    if (kn == KT) {
#pragma unroll
      for (int kk = 0; kk < KT; kk += 4) {
        float xq[TM][4];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float4 q = *reinterpret_cast<const float4*>(xs + (ty * TM + i) * XS + kk);
          xq[i][0] = q.x, xq[i][1] = q.y, xq[i][2] = q.z, xq[i][3] = q.w;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float xk[TM];
#pragma unroll
          for (int i = 0; i < TM; ++i) xk[i] = xq[i][j];
          step(xk, ms + (kk + j) * BC);
        }
      }
    } else {
      for (int kk = 0; kk < kn; ++kk) {
        float xk[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i) xk[i] = xs[(ty * TM + i) * XS + kk];
        step(xk, ms + kk * BC);
      }
    }
  }
  imma::cp_async_wait<0>();

  const bool split = gridDim.z > 1;
  const int rb = r0 + ty * TM, cb = c0 + tx * TN;
  if (split) {  // this chunk's partial tile into the workspace
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int t = 0; t < TN; ++t)
        if (rb + i < a.R && cb + t < a.N)
          a.ws[((size_t)chunk * a.R + rb + i) * a.N + cb + t] = acc[i][t];
    // as in a grid-wide barrier, one thread counts the block in after the
    // block's barrier, with an acquire-release add: the release covers the
    // stores the barrier ordered before it, the acquire the last block's
    // loads that the next barrier orders after it
    __syncthreads();
    const unsigned tile = blockIdx.y * gridDim.x + blockIdx.x;
    if (tid == 0) last = atom_add_acq_rel(a.counters + tile, 1u) == gridDim.z - 1;
    __syncthreads();
    if (!last) return;
    // the partials in chunk order, from the first; kBatch chunks' loads in
    // flight at once (a float dense0's 35 in one batch), this block's own
    // partial from its registers
    constexpr int kBatch = TM * TN >= 16 ? 3 : 48 / (TM * TN);
    float sum[TM][TN];
    for (int q0 = 0; q0 < (int)gridDim.z; q0 += kBatch) {
      float v[kBatch][TM][TN];
#pragma unroll
      for (int b = 0; b < kBatch; ++b)
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int t = 0; t < TN; ++t) {
            const int q = q0 + b;
            const bool ok = q < (int)gridDim.z && q != chunk && rb + i < a.R && cb + t < a.N;
            v[b][i][t] = ok ? __ldcg(a.ws + ((size_t)q * a.R + rb + i) * a.N + cb + t)
                            : acc[i][t];
          }
#pragma unroll
      for (int b = 0; b < kBatch; ++b)
        if (q0 + b < (int)gridDim.z)
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int t = 0; t < TN; ++t)
              sum[i][t] = q0 + b == 0 ? v[b][i][t] : __fadd_rn(sum[i][t], v[b][i][t]);
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int t = 0; t < TN; ++t) acc[i][t] = sum[i][t];
    if (tid == 0) atomicExch(a.counters + tile, 0u);
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    if (rb + i >= a.R) continue;
    float* o = a.out + (size_t)(rb + i) * a.N + cb;
    if constexpr (TN == 4) {
      if (cb + 4 <= a.N && ((uintptr_t)o & 15) == 0) {
        *reinterpret_cast<float4*>(o) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        continue;
      }
    }
#pragma unroll
    for (int t = 0; t < TN; ++t)
      if (cb + t < a.N) o[t] = acc[i][t];
  }
}

// The tiles project_tiling (kernels/frontend.py::PROJECT_TILES) chooses
// from, by index: (BR, BC, TM, TN) and the k a stage holds (KT), a block
// of (BR / TM) x (BC / TN) threads.
template <int BR, int BC, int TM, int TN, int KT>
cudaError_t launch_tile(const ProjArgs& a, int chunks, cudaStream_t st) {
  const dim3 grid((a.N + BC - 1) / BC, (a.R + BR - 1) / BR, chunks);
  constexpr int kThreads = Tile<BR, BC, TM, TN, KT>::kThreads;
  const bool xv = a.K % 4 == 0 && (uintptr_t)a.x % 16 == 0;
  const bool mv = a.N % 4 == 0 && (uintptr_t)a.m % 16 == 0;
  if (xv && mv)
    project_rows_kernel<BR, BC, TM, TN, KT, true, true><<<grid, kThreads, 0, st>>>(a);
  else if (mv)
    project_rows_kernel<BR, BC, TM, TN, KT, false, true><<<grid, kThreads, 0, st>>>(a);
  else if (xv)
    project_rows_kernel<BR, BC, TM, TN, KT, true, false><<<grid, kThreads, 0, st>>>(a);
  else
    project_rows_kernel<BR, BC, TM, TN, KT, false, false><<<grid, kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// row_sum
// ---------------------------------------------------------------------------

constexpr int kWin = xla_sum::kSumWindow;  // 32
constexpr int kPad = kWin + 1;              // floats a staged window takes
constexpr int kShortRows = 128;             // rows of <= 32 values a block takes

// src[0, count) into shared memory through put(f, value): coalesced
// 16-byte loads for the aligned body, U of a thread's in flight at once,
// and 4-byte loads for the head and the tail (fewer than 4 values each),
// issued before the body's so that their trip to memory overlaps it
template <int U, class Put>
__device__ __forceinline__ void stage_span(const float* __restrict__ src, int count, int lane,
                                           int lanes, Put put) {
  const int head = min(count, (int)(((16 - ((uintptr_t)src & 15)) & 15) >> 2));
  const int body = (count - head) >> 2;
  const int tail = head + 4 * body + lane;
  const float h = lane < head ? __ldg(src + lane) : 0.0f;
  const float t = tail < count ? __ldg(src + tail) : 0.0f;
  const float4* v = reinterpret_cast<const float4*>(src + head);
#pragma unroll U
  for (int i = lane; i < body; i += lanes) {
    const float4 q = __ldg(v + i);
    const int f = head + 4 * i;
    put(f, q.x), put(f + 1, q.y), put(f + 2, q.z), put(f + 3, q.w);
  }
  if (lane < head) put(lane, h);
  if (tail < count) put(tail, t);
}

// rows of n <= 32 values: a thread a row, left to right from the first
// value; the block's rows (one contiguous span) staged at an odd stride
__global__ void __launch_bounds__(kShortRows)
    row_sum_short_kernel(const float* __restrict__ x, float* __restrict__ out, int R, int n) {
  __shared__ float s[kShortRows * kPad];
  const int r0 = blockIdx.x * kShortRows;
  const int rows = min(kShortRows, R - r0);
  const int stride = n | 1;
  // f / n as a multiply-high by ceil(2^32 / n): exact for f < 2^32 / n
  const unsigned magic = n == 1 ? 0u : (unsigned)(((1ull << 32) + n - 1) / n);
  stage_span<kShortRows * kWin / 4 / kShortRows>(x + (size_t)r0 * n, rows * n, threadIdx.x,
                                                 kShortRows, [&](int f, float v) {
    const int q = n == 1 ? f : (int)__umulhi((unsigned)f, magic);
    s[q * stride + f - q * n] = v;
  });
  __syncthreads();
  if ((int)threadIdx.x >= rows) return;
  const float* v = s + threadIdx.x * stride;
  float acc = v[0];
  for (int i = 1; i < n; ++i) acc = __fadd_rn(acc, v[i]);
  out[r0 + threadIdx.x] = acc;
}

// rows of more than 32 values: WPR warps a row, WARPS / WPR rows a block.
// A warp stages SPAN windows of its row at a time (padded positions q =
// c + lo, window q / 32 at q / 32 * 33) and its lanes sum a window each;
// the window sums go to sums[j + j / 32] (padded alike), then the row's
// first warp runs the later levels: a lane a window of the window sums
// when there are more than 32 of them (at most 1,024: one such level),
// and lane 0 the last level left to right from its first value.
template <int WARPS, int WPR, int SPAN, int MAXW>
__global__ void __launch_bounds__(32 * WARPS)
    row_sum_windows_kernel(const float* __restrict__ x, float* __restrict__ out, int R, int n) {
  constexpr int kRows = WARPS / WPR;
  __shared__ float staged[WARPS][SPAN * kPad];
  __shared__ float sums[kRows][MAXW + MAXW / kWin];
  __shared__ float top[kRows][kWin];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slot = warp / WPR, part = warp % WPR;
  const int r = blockIdx.x * kRows + slot;
  if (r >= R) return;  // only when WPR == 1, where no block barrier follows
  const float* xr = x + (size_t)r * n;
  const xla_sum::Split sp = xla_sum::split(n);
  float* sw = staged[warp];
  float* ws = sums[slot];
  const int groups = (sp.windows + SPAN - 1) / SPAN;
  for (int g = part; g < groups; g += WPR) {
    const int q0 = g * SPAN * kWin;
    const int c0 = max(0, q0 - sp.lo), c1 = min(n, q0 + SPAN * kWin - sp.lo);
    __syncwarp();  // the last group's windows have been read
    stage_span<4>(xr + c0, c1 - c0, lane, 32, [&](int f, float v) {
      const int q = c0 + f + sp.lo - q0;
      sw[(q >> 5) * kPad + (q & 31)] = v;
    });
    __syncwarp();
#pragma unroll
    for (int w = lane; w < SPAN; w += 32) {
      const int j = g * SPAN + w;
      if (j >= sp.windows) break;
      float acc = 0.0f;  // from 0, padding zeros added like values
#pragma unroll
      for (int i = 0; i < kWin; ++i) {
        const int c = kWin * j + i - sp.lo;
        acc = __fadd_rn(acc, c >= 0 && c < n ? sw[w * kPad + i] : 0.0f);
      }
      ws[j + (j >> 5)] = acc;
    }
  }
  if (WPR > 1)
    __syncthreads();
  else
    __syncwarp();
  if (part != 0) return;
  int count = sp.windows;
  const float* v = ws;  // index j + j / 32 = j below 32
  if (count > kWin) {
    const xla_sum::Split s2 = xla_sum::split(count);
    if (lane < s2.windows) {
      float acc = 0.0f;
#pragma unroll
      for (int i = 0; i < kWin; ++i) {
        const int c = kWin * lane + i - s2.lo;
        acc = __fadd_rn(acc, c >= 0 && c < count ? ws[c + (c >> 5)] : 0.0f);
      }
      top[slot][lane] = acc;
    }
    __syncwarp();
    count = s2.windows;
    v = top[slot];
  }
  if (lane == 0) {
    float acc = v[0];
    for (int i = 1; i < count; ++i) acc = __fadd_rn(acc, v[i]);
    out[r] = acc;
  }
}

constexpr int kRowWarps = 4;     // rows of up to kWarpWindows windows: a warp each
constexpr int kWarpWindows = 64;
constexpr int kBlockWarps = 8;   // longer rows: a block each

}  // namespace

// the chunk of k project_rows sums in ascending order (PROJECT_CHUNK)
extern "C" int project_rows_chunk() { return kProjectChunk; }

// x: (R, K) fp32, m: (K, N) fp32, out: (R, N) fp32, all contiguous.  tile:
// an index into the tile table above.  ws: (ceil(K / chunk), R, N) fp32 and
// counters: one zeroed unsigned a (row tile, column tile), needed when K >
// the chunk.
extern "C" int project_rows_f32(const void* x, const void* m, void* out, int R, int K, int N,
                                int tile, void* ws, void* counters, void* stream) {
  if (R <= 0 || N <= 0) return cudaSuccess;
  // the kernel keeps 32-bit offsets into x and m
  if (K < 0 || (long long)R * K >= (1LL << 31) || (long long)K * N >= (1LL << 31))
    return cudaErrorInvalidValue;
  const int chunks = K > kProjectChunk ? (K + kProjectChunk - 1) / kProjectChunk : 1;
  if (chunks > 1 && (!ws || !counters)) return cudaErrorInvalidValue;
  const ProjArgs a{static_cast<const float*>(x), static_cast<const float*>(m),
                   static_cast<float*>(out), static_cast<float*>(ws),
                   static_cast<unsigned*>(counters), R, K, N};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 0: return launch_tile<8, 8, 1, 1, 256>(a, chunks, st);
    case 1: return launch_tile<8, 16, 1, 1, 128>(a, chunks, st);
    case 2: return launch_tile<16, 32, 2, 2, 64>(a, chunks, st);
    case 3: return launch_tile<32, 64, 4, 4, 32>(a, chunks, st);
    default: return cudaErrorInvalidValue;
  }
}

// x: (R, n) fp32 contiguous, out: (R,) fp32; n <= 32 * xla_sum::kMaxWindows
extern "C" int row_sum_f32(const void* x, void* out, int R, int n, void* stream) {
  if (R <= 0) return cudaSuccess;
  if (n <= 0 || xla_sum::split(n).windows > xla_sum::kMaxWindows) return cudaErrorInvalidValue;
  const float* xp = static_cast<const float*>(x);
  float* op = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int windows = xla_sum::split(n).windows;
  if (n <= kWin) {
    row_sum_short_kernel<<<(R + kShortRows - 1) / kShortRows, kShortRows, 0, st>>>(xp, op, R, n);
  } else if (windows <= kWarpWindows) {
    row_sum_windows_kernel<kRowWarps, 1, kWarpWindows, kWarpWindows>
        <<<(R + kRowWarps - 1) / kRowWarps, 32 * kRowWarps, 0, st>>>(xp, op, R, n);
  } else {
    row_sum_windows_kernel<kBlockWarps, kBlockWarps, kWin, xla_sum::kMaxWindows>
        <<<R, 32 * kBlockWarps, 0, st>>>(xp, op, R, n);
  }
  return cudaGetLastError();
}
