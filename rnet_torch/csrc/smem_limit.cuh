// Launch helpers of the port's kernels: dynamic shared-memory limits,
// raised once, and launches of thread-block clusters.
//
// A kernel that takes more than 48 KB of dynamic shared memory needs
// cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
// bytes) before its launch. The launchers used to call it before every
// launch. They now keep the largest limit set so far in a static of their
// own (one per kernel instantiation; a process drives one card) and call
// it only when a launch needs more. So a launch captured into a CUDA graph
// (rnet_torch/train/graphs.py) makes no attribute call: the graph's
// warm-up launch at the same shape has already raised the limit.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

// `allowed` is the caller's static for this kernel instantiation.
template <typename Kern>
inline cudaError_t raise_smem_limit(Kern kern, size_t smem, size_t& allowed) {
  if (smem <= allowed) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) allowed = smem;
  return err;
}

// Launches kern<<<grid, threads, smem, st>>>(args...) with `cl` CTAs a
// cluster (none when cl = 1) through cudaLaunchKernelEx, which a CUDA graph
// captures like any launch; returns the launch's error or cudaGetLastError().
template <typename... P, typename... A>
inline cudaError_t launch_cluster(void (*kern)(P...), int grid, int threads, size_t smem, cudaStream_t st, int cl,
                                  A... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cl > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kern, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}
