// Fused pairwise g_theta forward for Hopper (sm_90a), bf16 in, fp32 out.
//
// Replaces the TPU kernel rnet/kernels/pairwise.py::_fwd_kernel (launched by
// _fwd_pallas) and, when pair_keep < 1, its pair mask _pair_mask. For every
// sample b it computes
//
//     out[b] = sum_{i<ni, j<nj} m_bij * g_{L-1}(... g_1(relu(u[b,i] + v[b,j] + s[b])))
//     g_l(a) = relu(a . W_l + b_l [+ qa[b] if l == inject])
//
// with m_bij = 1 at pair_keep = 1 and, below it, the inverted-dropout scale
// of philox.cuh (1/keep for a kept pair, 0 for a dropped one), applied to
// the last layer's fp32 row before the pool as _fwd_kernel does (:113-115).
// keep = 1 compiles to a kernel without any Philox work (template DROP).
//
// with the same rounding points as _fwd_kernel: the layer-0 add in fp32, the
// L-1 products on bf16 operands with fp32 accumulation, bias and injection
// added in fp32, every relu output rounded to bf16, and the pooled sum in
// fp32. The n^2 pair rows never reach device memory.
//
// What bounds it: 2*B*ni*nj*(L-1)*H^2 multiply-adds on the tensor cores. At
// the B=64 serving bucket of original-fp (n=64, H=256, L=4) that is 103 GFLOP,
// 0.104 ms at 989 TFLOP/s bf16, against ~4.6 MB of inputs (1.4 us at
// 3.35 TB/s): the kernel is compute-bound.
//
// Design. One CTA (8 warps) takes one sample b and a block of BM = 64
// consecutive pair rows p = i*nj + j of it. It forms a0 = relu(u_i + v_j + s)
// for its rows in shared memory and runs the L-1 layers there, ping-ponging
// two (BM, H) bf16 activation buffers. The TPU kept all of (L-1, H, H) in
// VMEM; 3*256*256 bf16 is 384 KB, more than the 227 KB of shared memory a
// CTA may have, so each W_l streams through shared memory in (KC, NC) chunks.
// Products use wmma bf16 16x16x16 fragments with fp32 accumulators; each warp
// owns one 16-row tile and NC/32 column tiles of the (BM, NC) output chunk,
// and its epilogue adds bias (+ qa), applies relu and rounds to bf16 through
// a per-warp fp32 staging tile. Ragged last blocks zero their surplus rows
// and leave them out of the pool.
//
// The TPU summed into its output across the sequential i-tile axis; CTAs run
// in no order, so each CTA writes its fp32 column sums to partial[b, blk, :]
// and a second kernel adds the blocks in a fixed order. Serving answers are
// therefore the same from run to run (no atomics).
//
// Simple first: the weight chunks are loaded synchronously and every CTA
// reads all of W from L2. Pipelined TMA loads and wgmma are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int BM = 64;              // pair rows per CTA
constexpr int KC = 64;              // rows of W_l per streamed chunk
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int PAD = 8;              // bf16 row padding in shared memory (bank spread)
constexpr int ROW_TILES = BM / 16;  // 4; WARPS / ROW_TILES warps share a row tile

template <int NC>
size_t smem_bytes(int H) {
  return 2 * (size_t)BM * (H + PAD) * sizeof(bf16)   // activation ping-pong
         + (size_t)KC * (NC + PAD) * sizeof(bf16)     // weight chunk
         + (size_t)WARPS * 256 * sizeof(float)        // epilogue staging
         + (size_t)BM * sizeof(float);                // per-row dropout scale
}

template <int NC, bool DROP>
__global__ void __launch_bounds__(THREADS)
pairwise_fwd_kernel(const bf16* __restrict__ u, const bf16* __restrict__ v,
                    const bf16* __restrict__ s, const bf16* __restrict__ qa,
                    const bf16* __restrict__ ws, const bf16* __restrict__ bs,
                    float* __restrict__ partial, int ni, int nj, int H, int L,
                    int inject, const int64_t* __restrict__ seed, uint32_t thr,
                    float inv_keep) {
  constexpr int TPW = NC / 16 / (WARPS / ROW_TILES);  // column tiles per warp
  extern __shared__ __align__(128) unsigned char smem[];
  const int LDA = H + PAD;
  const int LDW = NC + PAD;
  bf16* cur = reinterpret_cast<bf16*>(smem);
  bf16* nxt = cur + BM * LDA;
  bf16* wbuf = nxt + BM * LDA;
  float* stage_all = reinterpret_cast<float*>(wbuf + KC * LDW);
  float* stage = stage_all + (threadIdx.x / 32) * 256;
  float* rowscale = stage_all + WARPS * 256;

  const int b = blockIdx.y;
  const int p0 = blockIdx.x * BM;
  const int rows = min(BM, ni * nj - p0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int rt = warp % ROW_TILES;
  const int ct0 = (warp / ROW_TILES) * TPW;

  if (DROP) {  // inverted pair dropout: this block's rows, from philox.cuh
    const uint64_t key = (uint64_t)*seed;
    for (int r = threadIdx.x; r < BM; r += THREADS)
      rowscale[r] = (r < rows && rnet::pair_kept(key, p0 + r, b, thr)) ? inv_keep : 0.0f;
  }

  // ---- layer 0: a0 = relu(u_i + v_j + s) in fp32, rounded to bf16 ----
  const int vec = H / 8;  // 16-byte vectors per row
  for (int idx = threadIdx.x; idx < BM * vec; idx += THREADS) {
    const int r = idx / vec;
    const int c8 = (idx % vec) * 8;
    uint4 packed = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows) {
      const int p = p0 + r;
      const int i = p / nj;
      const int j = p - i * nj;
      const uint4 uu = *reinterpret_cast<const uint4*>(u + ((size_t)b * ni + i) * H + c8);
      const uint4 vv = *reinterpret_cast<const uint4*>(v + ((size_t)b * nj + j) * H + c8);
      const uint4 ss = *reinterpret_cast<const uint4*>(s + (size_t)b * H + c8);
      const bf16* pu = reinterpret_cast<const bf16*>(&uu);
      const bf16* pv = reinterpret_cast<const bf16*>(&vv);
      const bf16* ps = reinterpret_cast<const bf16*>(&ss);
      bf16* po = reinterpret_cast<bf16*>(&packed);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float x = __bfloat162float(pu[k]) + __bfloat162float(pv[k]) + __bfloat162float(ps[k]);
        po[k] = __float2bfloat16(fmaxf(x, 0.0f));
      }
    }
    *reinterpret_cast<uint4*>(cur + r * LDA + c8) = packed;
  }

  // ---- layers 1..L-1 ----
  for (int l = 1; l < L; ++l) {
    const bf16* W = ws + (size_t)(l - 1) * H * H;
    const bf16* bias = bs + (size_t)(l - 1) * H;
    const bool inj = (l == inject);
    for (int n0 = 0; n0 < H; n0 += NC) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[TPW];
#pragma unroll
      for (int t = 0; t < TPW; ++t) wmma::fill_fragment(acc[t], 0.0f);

      for (int k0 = 0; k0 < H; k0 += KC) {
        __syncthreads();  // wbuf free; cur complete
        constexpr int VPR = NC / 8;
        for (int idx = threadIdx.x; idx < KC * VPR; idx += THREADS) {
          const int r = idx / VPR;
          const int c8 = (idx % VPR) * 8;
          *reinterpret_cast<uint4*>(wbuf + r * LDW + c8) =
              *reinterpret_cast<const uint4*>(W + (size_t)(k0 + r) * H + n0 + c8);
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < KC; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
          wmma::load_matrix_sync(af, cur + rt * 16 * LDA + k0 + kk, LDA);
#pragma unroll
          for (int t = 0; t < TPW; ++t) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
            wmma::load_matrix_sync(bfr, wbuf + kk * LDW + (ct0 + t) * 16, LDW);
            wmma::mma_sync(acc[t], af, bfr, acc[t]);
          }
        }
      }

      // epilogue: + bias (+ qa), relu, round to bf16, into nxt
#pragma unroll
      for (int t = 0; t < TPW; ++t) {
        wmma::store_matrix_sync(stage, acc[t], 16, wmma::mem_row_major);
        __syncwarp();
        const int col0 = n0 + (ct0 + t) * 16;
        for (int e = lane; e < 256; e += 32) {
          const int r = e / 16;
          const int c = col0 + e % 16;
          float x = stage[e] + __bfloat162float(bias[c]);
          if (inj) x += __bfloat162float(qa[(size_t)b * H + c]);
          nxt[(rt * 16 + r) * LDA + c] = __float2bfloat16(fmaxf(x, 0.0f));
        }
        __syncwarp();
      }
    }
    __syncthreads();  // nxt complete before it is read
    bf16* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }

  // ---- pool this block's valid rows in fp32 (kept rows scaled by 1/keep) ----
  for (int c = threadIdx.x; c < H; c += THREADS) {
    float sum = 0.0f;
    for (int r = 0; r < rows; ++r) {
      float x = __bfloat162float(cur[r * LDA + c]);
      if (DROP) x *= rowscale[r];
      sum += x;
    }
    partial[((size_t)b * gridDim.x + blockIdx.x) * H + c] = sum;
  }
}

// mask[b, p] = 1 if pair p of sample b is kept, else 0 (philox.cuh). Used
// to hold the in-kernel bits against the plain version; not on the model's
// path, where the two pairwise kernels draw the bits themselves.
__global__ void pair_mask_kernel(uint8_t* __restrict__ mask, int B, int npairs,
                                 const int64_t* __restrict__ seed, uint32_t thr) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (p >= npairs) return;
  mask[(size_t)b * npairs + p] = rnet::pair_kept((uint64_t)*seed, p, b, thr) ? 1 : 0;
}

// out[b, c] = sum over blocks of partial[b, blk, c], in block order.
__global__ void pool_partials_kernel(const float* __restrict__ partial,
                                     float* __restrict__ out, int nblk, int H) {
  const int b = blockIdx.y;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= H) return;
  const float* src = partial + (size_t)b * nblk * H + c;
  float sum = 0.0f;
  for (int k = 0; k < nblk; ++k) sum += src[(size_t)k * H];
  out[(size_t)b * H + c] = sum;
}

template <int NC, bool DROP>
cudaError_t launch_main(const bf16* u, const bf16* v, const bf16* s, const bf16* qa,
                        const bf16* ws, const bf16* bs, float* partial, int B,
                        int ni, int nj, int H, int L, int inject, int nblk,
                        const int64_t* seed, uint32_t thr, float inv_keep,
                        cudaStream_t stream) {
  const size_t smem = smem_bytes<NC>(H);
  cudaError_t err = cudaFuncSetAttribute(
      pairwise_fwd_kernel<NC, DROP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  pairwise_fwd_kernel<NC, DROP><<<dim3(nblk, B), THREADS, smem, stream>>>(
      u, v, s, qa, ws, bs, partial, ni, nj, H, L, inject, seed, thr, inv_keep);
  return cudaGetLastError();
}

template <bool DROP>
cudaError_t launch_width(const bf16* u, const bf16* v, const bf16* s, const bf16* qa,
                         const bf16* ws, const bf16* bs, float* partial, int B,
                         int ni, int nj, int H, int L, int inject, int nblk,
                         const int64_t* seed, uint32_t thr, float inv_keep,
                         cudaStream_t stream) {
  return (H % 256 == 0)
             ? launch_main<256, DROP>(u, v, s, qa, ws, bs, partial, B, ni, nj, H, L, inject,
                                      nblk, seed, thr, inv_keep, stream)
             : launch_main<128, DROP>(u, v, s, qa, ws, bs, partial, B, ni, nj, H, L, inject,
                                      nblk, seed, thr, inv_keep, stream);
}

}  // namespace

extern "C" {

// Rows of pair activations per CTA; the wrapper sizes `partial` as
// (B, ceil(ni*nj / BM), H) fp32.
int rnet_pairwise_fwd_block_rows() { return BM; }

// Shared memory one CTA needs at width H (the wrapper checks it fits).
long long rnet_pairwise_fwd_smem_bytes(int H) {
  return (long long)(H % 256 == 0 ? smem_bytes<256>(H) : smem_bytes<128>(H));
}

// Launches the fused kernel and the block reduction on `stream`. All pointers
// are device pointers to contiguous tensors: u (B,ni,H), v (B,nj,H), s (B,H),
// qa (B,H), ws (L-1,H,H), bs (L-1,H) in bf16; partial (B,nblk,H) and out
// (B,H) in fp32; seed (1,) int64, read only when drop != 0. Pair dropout is
// on iff drop != 0, with threshold thr and scale inv_keep (philox.cuh).
// Requires H % 128 == 0 and L >= 2. Returns cudaGetLastError().
int rnet_pairwise_fwd(const void* u, const void* v, const void* s, const void* qa,
                      const void* ws, const void* bs, void* partial, void* out,
                      int B, int ni, int nj, int H, int L, int inject,
                      int drop, const void* seed, unsigned int thr, float inv_keep,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nblk = (ni * nj + BM - 1) / BM;
  const bf16* pu = static_cast<const bf16*>(u);
  const bf16* pv = static_cast<const bf16*>(v);
  const bf16* ps = static_cast<const bf16*>(s);
  const bf16* pq = static_cast<const bf16*>(qa);
  const bf16* pw = static_cast<const bf16*>(ws);
  const bf16* pb = static_cast<const bf16*>(bs);
  const int64_t* sd = static_cast<const int64_t*>(seed);
  float* part = static_cast<float*>(partial);
  cudaError_t err =
      drop ? launch_width<true>(pu, pv, ps, pq, pw, pb, part, B, ni, nj, H, L, inject, nblk,
                                sd, thr, inv_keep, st)
           : launch_width<false>(pu, pv, ps, pq, pw, pb, part, B, ni, nj, H, L, inject, nblk,
                                 sd, thr, inv_keep, st);
  if (err != cudaSuccess) return (int)err;
  pool_partials_kernel<<<dim3((H + 127) / 128, B), 128, 0, st>>>(
      part, static_cast<float*>(out), nblk, H);
  return (int)cudaGetLastError();
}

// Writes the keep mask (B, npairs) uint8 of philox.cuh for `seed` (1,) int64.
int rnet_pair_mask(void* mask, int B, int npairs, const void* seed, unsigned int thr,
                   void* stream) {
  pair_mask_kernel<<<dim3((npairs + 255) / 256, B), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(mask), B, npairs, static_cast<const int64_t*>(seed), thr);
  return (int)cudaGetLastError();
}

const char* rnet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
