// The reference's order of additions for a sum over a row (jnp.sum on the
// CPU), the device side of src/repro_torch/kernels/xla_sum.py.  Rows of up
// to kSumWindow values are added left to right from their first value.  A
// longer row is cut into windows of exactly kSumWindow values, the zero
// padding split between both ends (the low end takes the smaller half),
// each window summed from 0 in order, and the window sums reduced again by
// the same rule, level after level.  Kernel K3 (cordic_softmax.cu) and
// row_sum (frontend_rows.cu) take the window split and the later levels
// from here; a block holds up to kMaxWindows first-level window sums, so
// both take rows of up to kSumWindow * kMaxWindows values.
#pragma once

namespace xla_sum {

constexpr int kSumWindow = 32;
constexpr int kMaxWindows = 1024;  // first-level windows a block holds

struct Split {
  int windows;  // windows of one level
  int lo;       // padding zeros before the first value
};

// One level over n values; n <= kSumWindow is one window, no padding.
__host__ __device__ __forceinline__ Split split(int n) {
  if (n <= kSumWindow) return {1, 0};
  const int windows = (n + kSumWindow - 1) / kSumWindow;
  return {windows, (windows * kSumWindow - n) / 2};
}

// Window j of one level over v[0, n): from 0, in order, padding zeros
// added like values (a zero turns a -0 sum into +0, as in the reference).
__device__ __forceinline__ float window_sum(const float* v, int n, int lo, int j) {
  float acc = 0.0f;
  for (int i = 0; i < kSumWindow; ++i) {
    const int c = j * kSumWindow + i - lo;
    acc = __fadd_rn(acc, c >= 0 && c < n ? v[c] : 0.0f);
  }
  return acc;
}

// The sum of count first-level window sums, reduced in place level after
// level by the same rule (window c of a level reads from index 32 c - 15
// on, past every sum written before it), the last level left to right from
// its first value.  One thread runs it.
__device__ __forceinline__ float reduce_levels(float* sums, int count) {
  while (count > kSumWindow) {
    const Split sp = split(count);
    for (int c = 0; c < sp.windows; ++c) sums[c] = window_sum(sums, count, sp.lo, c);
    count = sp.windows;
  }
  float acc = sums[0];
  for (int i = 1; i < count; ++i) acc = __fadd_rn(acc, sums[i]);
  return acc;
}

}  // namespace xla_sum
