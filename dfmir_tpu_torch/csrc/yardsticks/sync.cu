// Two yardsticks of the chains' synchronisation, timed by chip_smoke.py and
// on no path of the port:
// - dfmir_yard_grid_sync: one cooperative launch of `blocks` blocks of 256
//   threads that does nothing but `nsyncs` grid.sync() calls, the barrier
//   between the steps of vecint3d_fwd;
// - dfmir_yard_cluster_sync: `clusters` thread-block clusters of `size`
//   blocks of 256 threads that do nothing but `nsyncs` cluster barriers
//   (cg::this_cluster().sync()), the barrier between the phases of
//   vecint2d_bwd.
// Timed at two counts of syncs, their difference over the count is the
// cost of one barrier at that grid, without the work a step does.
// chip_smoke.py builds this file alone with nvcc into a library of its own.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) yard_grid_sync(int nsyncs) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < nsyncs; ++i) grid.sync();
}

__global__ void __launch_bounds__(kThreads) yard_cluster_sync(int nsyncs) {
  cg::cluster_group cluster = cg::this_cluster();
  for (int i = 0; i < nsyncs; ++i) cluster.sync();
}

}  // namespace

// Returns the launch's cudaError_t (a grid above what the card holds at
// once is refused).
extern "C" int dfmir_yard_grid_sync(int blocks, int nsyncs, void* stream) {
  void* args[] = {&nsyncs};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)yard_grid_sync, dim3(blocks), dim3(kThreads), args, 0,
      (cudaStream_t)stream);
  if (err != cudaSuccess) cudaGetLastError();
  return (int)err;
}

extern "C" int dfmir_yard_cluster_sync(int clusters, int size, int nsyncs,
                                       void* stream) {
  if (size > 8) {
    const cudaError_t err = cudaFuncSetAttribute(
        (const void*)yard_cluster_sync,
        cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(clusters * size);
  config.blockDim = dim3(kThreads);
  config.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = size;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&config, yard_cluster_sync,
                                             nsyncs);
  if (err != cudaSuccess) cudaGetLastError();
  return (int)err;
}
