// An empty kernel: the device time of a launch that does no work, timed
// beside the port's smallest kernels (the launch floor).

#include <cuda_runtime.h>

__global__ void empty_kernel() {}

extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
