// An empty kernel: its device time is the launch floor that chip_smoke.py
// sets beside the kernels whose work is too small to fill the card (K3 at
// the serving path's (slots, 2), K3b's relu on the sign-off path).  No
// TPU kernel behind it and no caller on any serving path.
#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}
