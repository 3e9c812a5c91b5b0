// The question embedding's backward for Hopper (sm_90a): the gradient of the
// masked gather x = weight[tokens] * (tokens != 0) with respect to the
// (V, E) fp32 table, summed by token in one order fixed by the shape.
//
// No TPU kernel of rnet stands behind it: rnet's gather is differentiated by
// XLA (a scatter-add). In the port the gather's autograd backward was
// index_put_(accumulate=True): it sorts the N = B*T indices and gives each
// distinct row one warp, which sums the row's duplicates one after another.
// CLEVR questions are ~62 % pads (token 0), so one warp summed ~19,000 rows
// of zeros at B = 640, T = 48 (3.3 ms a step on an H100).
//
// What bounds it: bytes. The work is to read dX (N x E fp32) and the tokens
// (N int64) once and write V x E floats: 4.2 MB at B = 640, E = 32, ~1.3 us
// at 3.35 TB/s. A 90 x 32 fp32 table is 11.5 KB, so every warp can keep a
// table of its own in shared memory:
//
//   * pass 1 (embedding_bwd_kernel): W warps in each of G CTAs; warp
//     j = g*W + w owns positions [j*chunk, (j+1)*chunk) of the N. Lane =
//     column (columns c, c+32, ... for E > 32, one walk of the warp's
//     positions per group of 32 columns), so a row's add is one conflict-free
//     shared-memory access and needs no atomics. The warp walks its positions
//     in order and adds dX[p] into its table's row tokens[p], skipping
//     tokens[p] == 0 (and any id outside [1, V), which the forward's gather
//     has already refused). The CTA then sums its warps' tables in warp order
//     and writes one (V, E) partial to partials[g].
//   * pass 2 (embedding_bwd_sum_kernel): one thread per (v, e) sums the G
//     partials in the order g = 0 .. G-1 and writes the gradient.
//
// Every add's order is fixed by (N, V, E, G, W, chunk), which the host picks
// from the shape alone (rnet_torch/kernels/embedding.py::plan), so runs and
// graph replays give the same bits, and embedding_bwd_reference there
// computes the same sums in the same order. Skipping a pad equals adding its
// zero row (dX[p] * 0) for every finite gradient: the same sum without ~62 %
// of its terms.

#include <cuda_runtime.h>
#include <stdint.h>

#include "smem_limit.cuh"

namespace {

constexpr int UNROLL = 8;  // positions whose loads a lane issues before their adds

__global__ void embedding_bwd_kernel(const float* __restrict__ dx, const long long* __restrict__ tokens,
                                     float* __restrict__ partials, long long N, int V, int E, int chunk) {
  extern __shared__ float tables[];  // W tables of V x E
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, W = blockDim.x >> 5;
  const int VE = V * E;
  float* tab = tables + (size_t)w * VE;
  for (int i = threadIdx.x; i < W * VE; i += blockDim.x) tables[i] = 0.f;
  __syncthreads();

  const long long start = ((long long)blockIdx.x * W + w) * chunk;
  const long long end = start + chunk < N ? start + chunk : N;
  for (int c0 = 0; c0 < E; c0 += 32) {
    const int c = c0 + lane;
    for (long long base = start; base < end; base += 32) {
      const int cnt = end - base < 32 ? (int)(end - base) : 32;
      // the warp's next 32 tokens, one coalesced load; position base + k's
      // token is lane k's
      const long long mine = lane < cnt ? tokens[base + lane] : 0;
      const int tok_lane = (mine > 0 && mine < V) ? (int)mine : 0;
      for (int k0 = 0; k0 < cnt; k0 += UNROLL) {
        int tok[UNROLL];
        float val[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int k = k0 + u;
          tok[u] = __shfl_sync(0xffffffffu, tok_lane, k & 31);
          if (k >= cnt) tok[u] = 0;
          val[u] = (tok[u] != 0 && c < E) ? dx[(base + k) * E + c] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
          if (tok[u] != 0 && c < E) tab[tok[u] * E + c] += val[u];
      }
    }
  }
  __syncthreads();

  float* out = partials + (size_t)blockIdx.x * VE;
  for (int i = threadIdx.x; i < VE; i += blockDim.x) {
    float acc = tables[i];
    for (int u = 1; u < W; ++u) acc += tables[(size_t)u * VE + i];
    out[i] = acc;
  }
}

__global__ void embedding_bwd_sum_kernel(const float* __restrict__ partials, float* __restrict__ grad, int G,
                                         int VE) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= VE) return;
  float acc = partials[i];
#pragma unroll 16
  for (int g = 1; g < G; ++g) acc += partials[(size_t)g * VE + i];
  grad[i] = acc;
}

}  // namespace

extern "C" {

// dx (N, E) fp32, tokens (N,) int64, partials (G, V, E) fp32 scratch, grad
// (V, E) fp32, all contiguous on one device; G CTAs of W warps, each warp on
// `chunk` positions (G * W * chunk >= N). Launches both passes on `stream`;
// returns the error of raise_smem_limit (W tables of V x E floats that do not
// fit a CTA) or of a launch.
int rnet_embedding_bwd(const void* dx, const void* tokens, void* partials, void* grad, long long N, int V, int E,
                       int G, int W, int chunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  static size_t allowed = 0;
  const size_t smem = (size_t)W * V * E * sizeof(float);
  cudaError_t err = raise_smem_limit(embedding_bwd_kernel, smem, allowed);
  if (err != cudaSuccess) return (int)err;
  embedding_bwd_kernel<<<G, 32 * W, smem, st>>>(static_cast<const float*>(dx),
                                                static_cast<const long long*>(tokens),
                                                static_cast<float*>(partials), N, V, E, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int VE = V * E, threads = 256;
  embedding_bwd_sum_kernel<<<(VE + threads - 1) / threads, threads, 0, st>>>(static_cast<const float*>(partials),
                                                                           static_cast<float*>(grad), G, VE);
  return (int)cudaGetLastError();
}

const char* rnet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
