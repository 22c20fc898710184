// Host helpers shared by the kernels' launchers.
#pragma once

#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <tuple>
#include <utility>

// The blocks of a persistent grid for kernel `kern` at `threads` threads
// and `smem` bytes of dynamic shared memory on the current device: the
// occupancy API's blocks an SM times the SMs.  Raises the kernel's
// shared-memory attribute on that device first where it must grow (it
// only grows, since one instance serves many shapes).  The answers are
// kept per (kernel, device, threads, shared memory) under one lock, so a
// call of a shape seen before asks the runtime nothing, and host threads
// that launch on different cards never read each other's half-written
// entries.
inline cudaError_t persistent_grid(const void* kern, int threads, size_t smem,
                                   int* grid) {
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, size_t> attr;
  static std::map<std::tuple<const void*, int, int, size_t>, int> grids;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(kern, dev, threads, smem);
  const auto hit = grids.find(key);
  if (hit != grids.end()) {
    *grid = hit->second;
    return cudaSuccess;
  }
  size_t& granted = attr[std::make_pair(kern, dev)];
  if (smem > granted) {
    if ((e = cudaFuncSetAttribute(kern,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
      return e;
    granted = smem;
  }
  int sms = 0, per_sm = 0;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                         threads, smem)) !=
      cudaSuccess)
    return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *grid = grids[key] = per_sm * sms;
  return cudaSuccess;
}
