// Dynamic shared-memory limits of the port's kernels, raised once.
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
