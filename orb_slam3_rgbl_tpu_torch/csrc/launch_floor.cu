// An empty kernel: the floor of one launch on this card. chip_smoke.py
// launches it at K1's and K2's grids and reports its device time and its
// CUDA-event time beside theirs, so that a reader can tell how much of a
// microsecond-sized kernel's time is the launch itself. Nothing in the
// port's tracking path calls it.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" int empty_launch(int blocks, int threads, cudaStream_t stream) {
  empty_kernel<<<blocks, threads, 0, stream>>>();
  return static_cast<int>(cudaGetLastError());
}
