// An empty kernel, launched at another kernel's geometry: the least a launch
// of that grid costs on the card (scheduling its blocks, and its clusters
// where it has them), which no kernel of that shape can go below.
// chip_smoke.py times it beside each of the port's kernels with the same
// CUDA-graph replays; the port itself never launches it.
#include <cuda_runtime.h>

namespace {

__global__ void launch_floor_kernel() {}

}  // namespace

// Launches gx x gy blocks of `threads` threads, in clusters of `cluster`
// blocks along y (1: no cluster), with `smem` bytes of dynamic shared
// memory, on `stream`; returns the launch's CUDA error.
extern "C" int launch_floor(int gx, int gy, int threads, int cluster,
                            int smem, void* stream) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(gx, gy, 1);
  config.blockDim = dim3(threads, 1, 1);
  config.dynamicSmemBytes = smem;
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = cluster;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = cluster > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&config, launch_floor_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
