// What the kernels of csrc/warp2d.cu and csrc/warp3d.cu share: the block
// size, the cooperative launch (the 3-D chains, B5, B2 with a source
// gradient), with a grid no larger than the blocks the card holds at once,
// and the launch of thread-block clusters (the 2-D chains).
//
// The co-resident limit is occupancy x SMs, computed on the first launch of
// each kernel on each device and cached by the caller.  A grid above it
// makes cudaLaunchCooperativeKernel fail; launch_chain returns that error
// (and clears it) and never runs the chain another way.  A cluster size
// the card refuses (above 16 blocks) makes launch_clusters fail the same
// way.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // threads a block, every kernel
constexpr int kMaxDevices = 64;

// The blocks of `kernel` that fit on the current device at once, computed
// on the first call for each device and cached in `cache`.
cudaError_t resident_blocks(const void* kernel, int* cache, int* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cache[dev] == 0) {
    int coop = 0, sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (err != cudaSuccess) return err;
    if (!coop) return cudaErrorNotSupported;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
    if (err != cudaSuccess) return err;
    if (per_sm * sms == 0) return cudaErrorCooperativeLaunchTooLarge;
    cache[dev] = per_sm * sms;
  }
  *blocks = cache[dev];
  return cudaSuccess;
}

// Launch `kernel` cooperatively over `units` work items, one a thread:
// `blocks` blocks, or, when 0, as many as the items need up to the
// co-resident limit.  A refused launch returns its error (and clears it),
// never runs another way.
cudaError_t launch_chain(const void* kernel, int* cache, long long units,
                         int blocks, void** args, void* stream) {
  if (blocks == 0) {
    int resident = 0;
    const cudaError_t err = resident_blocks(kernel, cache, &resident);
    if (err != cudaSuccess) return err;
    const long long need = (units + kThreads - 1) / kThreads;
    blocks = (int)(need < resident ? need : resident);
  }
  const cudaError_t err = cudaLaunchCooperativeKernel(
      kernel, dim3(blocks), dim3(kThreads), args, 0, (cudaStream_t)stream);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  return cudaGetLastError();
}

// Launch `kernel` as `clusters` thread-block clusters of `size` blocks of
// `threads` threads, one after another along x (cudaLaunchKernelEx with a
// cluster dimension), each block with `smem` bytes of dynamic shared
// memory; more than 8 blocks a cluster (the portable size) and more than
// 48 KB of dynamic shared memory are allowed first.  A refused launch
// returns its error (and clears it).
inline cudaError_t launch_clusters(const void* kernel, int threads,
                                   int clusters, int size, int smem,
                                   void** args, void* stream) {
  if (size < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  if (size > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (err == cudaSuccess && smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = size;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(clusters * size);
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = smem;
  config.stream = (cudaStream_t)stream;
  config.attrs = &attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelExC(&config, kernel, args);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  return cudaGetLastError();
}

// The clusters of `size` blocks of `threads` threads of `kernel` that the
// card holds at once (cudaOccupancyMaxActiveClusters), in *active.
inline cudaError_t active_clusters(const void* kernel, int threads,
                                   int size, int* active) {
  if (size > 8) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = size;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(size);
  config.blockDim = dim3(threads);
  config.attrs = &attr;
  config.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(active, kernel, &config);
}

}  // namespace
