// What the kernels of csrc/warp2d.cu and csrc/warp3d.cu share: the block
// size, and VecInt's chains' cooperative launch, with a grid no larger than
// the blocks the card holds at once.
//
// The co-resident limit is occupancy x SMs, computed on the first launch of
// each kernel on each device and cached by the caller.  A grid above it
// makes cudaLaunchCooperativeKernel fail; launch_chain returns that error
// (and clears it) and never runs the chain another way.

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

}  // namespace
