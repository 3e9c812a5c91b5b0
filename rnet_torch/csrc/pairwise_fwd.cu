// Fused pairwise g_theta forward for Hopper (sm_90a), bf16 in, fp32 out.
//
// Replaces the TPU kernel rnet/kernels/pairwise.py::_fwd_kernel (:83,
// launched by _fwd_pallas, :454) and, when pair_keep < 1, its pair mask
// _pair_mask (:69). For every sample b it computes
//
//     out[b] = sum_{i<ni, j<nj} m_bij * g_{L-1}(... g_1(relu(u[b,i] + v[b,j] + s[b])))
//     g_l(a) = relu(a . W_l + b_l [+ qa[b] if l == inject])
//
// with m_bij = 1 at pair_keep = 1 and, below it, the inverted-dropout scale
// of philox.cuh (1/keep for a kept pair, 0 for a dropped one), applied to
// the last layer's rows before the pool as _fwd_kernel does (:113-115).
// Rounding points as _fwd_kernel: the layer-0 add in fp32, bf16 operands
// with fp32 accumulation, bias and injection added in fp32, every relu
// output rounded to bf16, the pool in fp32. The n^2 pair rows never reach
// device memory.
//
// What bounds it: 2*B*ni*nj*(L-1)*H^2 tensor-core FLOPs (0.834 ms at
// original-fp B=512 at 989 TFLOP/s bf16) against a few MB of inputs; at
// BM=128 rows a CTA also reads 2 B of W from L2 per 256 FLOPs. The earlier
// kernel (one CTA of 64 rows per sample and block, W loaded synchronously
// by every CTA, wmma) spent two fifths of its time waiting on W and in its
// epilogues.
//
// Design (pairwise_chain.cuh has the layout, the W feed and the products):
//   * a persistent grid of min(tiles, #SMs) CTAs walks the tiles t = b *
//     nblk + block of BM = 64*WGS consecutive pair rows p = i*nj + j;
//     small batches (serving buckets) take WGS = 1, so that 64-row tiles
//     still give every SM work;
//   * warpgroup WGS is the producer (one thread of it): it streams the packed W_l^T chunks of every
//     layer of every tile through the ring, running ahead across layers
//     and tiles; the WGS consumer warpgroups each own 64 rows of the tile,
//     read every chunk, and never wait for each other;
//   * a consumer builds a_0 for its rows in the core-matrix slot and runs
//     the L-1 layers as wgmma products (A = its rows, B = the ring), the
//     accumulators starting at b_l (+ qa), so that the epilogue from
//     registers into the other slot (ping-pong) is relu, round and store;
//     the last layer's epilogue pools its valid rows in fp32 from registers
//     (a thread's two rows, a fixed shuffle tree over the warp's 16 rows,
//     the 4 warps in order) into partial[b, block*WGS + wg, :];
//   * a second kernel adds the partials of a sample in a fixed order, so
//     served answers are the same from run to run (no atomics).
// With -DRNET_PHASE_TIMES the first consumer thread of each CTA sums
// clock64() per phase (products, epilogues, pool, feed waits, a_0,
// warpgroup barriers) into `phases` (grid, NPHASE).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "pairwise_chain.cuh"
#include "philox.cuh"

namespace {

using namespace rnet;

enum { PH_PRODUCTS, PH_EPILOGUES, PH_POOL, PH_FEED, PH_A0, PH_SYNC };

// Shared memory: two activation slots, the W ring and its mbarriers, the
// per-row scale, the biases in fp32 and one row of column sums per warp.
size_t smem_bytes(int bm, int H, int L, int stages) {
  return 2 * (size_t)bm * H * sizeof(bf16) + (size_t)stages * (CHUNK_BYTES + 16) + (size_t)bm * sizeof(float) +
         (size_t)(L - 1) * H * sizeof(float) + (size_t)(bm / 16) * H * sizeof(float);
}

template <int WGS, bool DROP>
__global__ void __launch_bounds__((WGS + 1) * WG_THREADS, 1)
pairwise_fwd_kernel(const bf16* __restrict__ u, const bf16* __restrict__ v, const bf16* __restrict__ s,
                    const bf16* __restrict__ qa, const bf16* __restrict__ chunks, const bf16* __restrict__ bs,
                    float* __restrict__ partial, int B, int ni, int nj, int H, int L, int inject, int stages,
                    const int64_t* __restrict__ seed, uint32_t thr, float inv_keep, long long* phases) {
  constexpr int BM = 64 * WGS;
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* slot0 = reinterpret_cast<bf16*>(smem);
  bf16* slot1 = slot0 + BM * H;
  unsigned char* ring = smem + 2 * (size_t)BM * H * sizeof(bf16);
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + (size_t)stages * CHUNK_BYTES);
  float* rowscale = reinterpret_cast<float*>(bars + 2 * stages);
  float* biasf = rowscale + BM;               // (L-1, H)
  float* colsum = biasf + (size_t)(L - 1) * H;  // (BM/16 warps, H)
  Ring r{smem_u32(ring), smem_u32(bars), smem_u32(bars + stages), stages, 0, 0};
  if (threadIdx.x == 0) {
    for (int k = 0; k < stages; ++k) {
      mbar_init(r.full + 8 * k, 1);
      mbar_init(r.empty + 8 * k, WGS);
    }
    mbar_fence_init();
  }
  for (int k = threadIdx.x; k < (L - 1) * H; k += blockDim.x) biasf[k] = __bfloat162float(bs[k]);
  __syncthreads();

  const int npairs = ni * nj;
  const int nblk = (npairs + BM - 1) / BM;
  const int ntiles = B * nblk;
  const int role = __shfl_sync(0xffffffffu, (int)threadIdx.x / WG_THREADS, 0);  // warp-uniform
  PhaseClock pc;
  pc.start(PH_A0);
  if (role == WGS) {  // the producer warpgroup: one thread streams W
    if (threadIdx.x == WGS * WG_THREADS) {
      const int per_tile = (L - 1) * (H / NT) * (H / KC);
      for (int t = blockIdx.x; t < ntiles; t += gridDim.x) produce(r, chunks, per_tile, pc, PH_FEED);
    }
  } else {
    const int wg = role;
    const int tid = threadIdx.x - wg * WG_THREADS;
    const int warp = threadIdx.x / 32;
    const int r0 = 64 * wg;  // this warpgroup's rows of the tile
    const int fbase = frag_base(tid, r0, H);
    const int frow = r0 + 16 * (warp % 4) + (tid & 31) / 4;  // the thread's first fragment row
    const uint64_t key = DROP ? (uint64_t)*seed : 0;

    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      const int b = t / nblk;
      const int p0 = (t % nblk) * BM;
      const int valid = min(BM, npairs - p0);
      pc.mark(PH_A0);
      if (tid < 64) {  // 1, or under pair dropout 1/keep or 0; 0 past the valid rows
        const int rr = r0 + tid;
        float sc = rr < valid ? 1.0f : 0.0f;
        if (DROP && rr < valid) sc = pair_kept(key, p0 + rr, b, thr) ? inv_keep : 0.0f;
        rowscale[rr] = sc;
      }
      make_a0(u, v, s, slot0, b, p0, r0, 64, valid, ni, nj, H, tid, WG_THREADS);
      pc.mark(PH_SYNC);
      fence_proxy_async();
      bar_sync(1 + wg, WG_THREADS);

      bf16* cur = slot0;
      bf16* nxt = slot1;
      for (int l = 1; l < L; ++l) {
        const float* bias = biasf + (size_t)(l - 1) * H;
        const bf16* qrow = (l == inject) ? qa + (size_t)b * H : nullptr;
        for (int nt = 0; nt < H / NT; ++nt) {
          // register 4j + 2h + e: row frow + 8h, column nt*NT + 8j + 2q + e.
          // The accumulator starts as b_l (+ qa) in fp32 and wgmma adds the
          // products onto it; the epilogue applies relu and rounds to bf16.
          // The last layer goes to the pool (times the row's scale) instead
          // of shared memory.
          float acc[NT / 2];
          const float* bq = bias + nt * NT + 2 * (tid & 3);
          const bf16* qq = qrow ? qrow + nt * NT + 2 * (tid & 3) : nullptr;
#pragma unroll
          for (int j = 0; j < NT / 8; ++j) {
            float2 bb = *reinterpret_cast<const float2*>(bq + 8 * j);
            if (qq) {
              const float2 q = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(qq + 8 * j));
              bb.x += q.x;
              bb.y += q.y;
            }
            acc[4 * j] = acc[4 * j + 2] = bb.x;
            acc[4 * j + 1] = acc[4 * j + 3] = bb.y;
          }
          pc.mark(PH_PRODUCTS);
          streamed_product(acc, smem_u32(cur + r0 * H), H, r, tid == 0, pc, PH_FEED);
          pc.mark(PH_EPILOGUES);
          float pool[NT / 4];
          if (l < L - 1) {
            bf16* o0 = nxt + fbase + nt * (NT / 8) * 64;
            bf16* o1 = o0 + 8 * H;
#pragma unroll
            for (int j = 0; j < NT / 8; ++j) {
              *reinterpret_cast<__nv_bfloat162*>(o0 + 64 * j) =
                  __floats2bfloat162_rn(fmaxf(acc[4 * j], 0.0f), fmaxf(acc[4 * j + 1], 0.0f));
              *reinterpret_cast<__nv_bfloat162*>(o1 + 64 * j) =
                  __floats2bfloat162_rn(fmaxf(acc[4 * j + 2], 0.0f), fmaxf(acc[4 * j + 3], 0.0f));
            }
          } else {  // the thread's two rows of each column, row frow first
            const float sc0 = rowscale[frow], sc1 = rowscale[frow + 8];
#pragma unroll
            for (int j = 0; j < NT / 8; ++j) {
              const float2 f0 =
                  __bfloat1622float2(__floats2bfloat162_rn(fmaxf(acc[4 * j], 0.0f), fmaxf(acc[4 * j + 1], 0.0f)));
              const float2 f1 = __bfloat1622float2(
                  __floats2bfloat162_rn(fmaxf(acc[4 * j + 2], 0.0f), fmaxf(acc[4 * j + 3], 0.0f)));
              pool[2 * j] = f0.x * sc0 + f1.x * sc1;
              pool[2 * j + 1] = f0.y * sc0 + f1.y * sc1;
            }
          }
          if (l == L - 1) {
            pc.mark(PH_POOL);
            // the 8 row lanes of each column by a fixed shuffle tree: the
            // column sums of the warp's 16 rows
#pragma unroll
            for (int k = 0; k < NT / 4; ++k) {
              float x = pool[k];
              x += __shfl_xor_sync(0xffffffffu, x, 4);
              x += __shfl_xor_sync(0xffffffffu, x, 8);
              x += __shfl_xor_sync(0xffffffffu, x, 16);
              if ((tid & 31) < 4) colsum[(size_t)warp * H + nt * NT + 8 * (k >> 1) + 2 * (tid & 3) + (k & 1)] = x;
            }
          }
        }
        if (l < L - 1) {
          pc.mark(PH_SYNC);
          fence_proxy_async();
          bar_sync(1 + wg, WG_THREADS);  // this warpgroup's rows of a_l are complete
          bf16* tmp = cur;
          cur = nxt;
          nxt = tmp;
        }
      }

      // ---- the warpgroup's pooled rows: its 4 warps' column sums in warp order ----
      pc.mark(PH_SYNC);
      bar_sync(1 + wg, WG_THREADS);
      pc.mark(PH_POOL);
      float* out = partial + ((size_t)t * WGS + wg) * H;
      for (int c = tid; c < H; c += WG_THREADS) {
        const float* cs = colsum + (size_t)(4 * wg) * H + c;
        out[c] = ((cs[0] + cs[H]) + cs[2 * H]) + cs[3 * H];
      }
      bar_sync(1 + wg, WG_THREADS);  // the sums are read before the next tile's pool writes them
    }
    pc.mark(PH_A0);
    if (tid == 0 && wg == 0 && phases) pc.store(phases + (size_t)blockIdx.x * NPHASE);
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

// out[b, c] = sum over parts of partial[b, part, c], in part order.
__global__ void pool_partials_kernel(const float* __restrict__ partial, float* __restrict__ out, int nparts,
                                     int H) {
  const int b = blockIdx.y;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= H) return;
  const float* src = partial + (size_t)b * nparts * H + c;
  float sum = 0.0f;
  for (int k = 0; k < nparts; ++k) sum += src[(size_t)k * H];
  out[(size_t)b * H + c] = sum;
}

struct Args {
  const bf16 *u, *v, *s, *qa, *chunks, *bs;
  float* partial;
  int B, ni, nj, H, L, inject, stages;
  const int64_t* seed;
  uint32_t thr;
  float inv_keep;
  long long* phases;
};

template <int WGS, bool DROP>
cudaError_t launch(const Args& a, int grid, size_t smem, cudaStream_t st) {
  auto kern = pairwise_fwd_kernel<WGS, DROP>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, (WGS + 1) * WG_THREADS, smem, st>>>(a.u, a.v, a.s, a.qa, a.chunks, a.bs, a.partial, a.B, a.ni, a.nj,
                                                   a.H, a.L, a.inject, a.stages, a.seed, a.thr, a.inv_keep,
                                                   a.phases);
  return cudaGetLastError();
}

template <bool DROP>
cudaError_t dispatch(const Args& a, int wgs, int grid, size_t smem, cudaStream_t st) {
  return wgs == 2 ? launch<2, DROP>(a, grid, smem, st) : launch<1, DROP>(a, grid, smem, st);
}

}  // namespace

extern "C" {

// Launches the fused kernel and the ordered pool on `stream`, for the tile
// plan (wgs, stages, grid, smem) of kernels/pairwise.py::tile_plan;
// returns cudaErrorInvalidValue for a plan it cannot take. Device pointers
// to contiguous tensors: u (B,ni,H), v (B,nj,H), s (B,H), qa (B,H), bs
// (L-1,H) in bf16; chunks = pack_weight_chunks(W^T); partial
// (B, nblk*wgs, H) and out (B,H) fp32; seed (1,) int64, read only when
// drop != 0 (pair dropout with threshold thr and scale inv_keep,
// philox.cuh); phases (grid, 8) int64 or null (read only by a build with
// -DRNET_PHASE_TIMES). Returns cudaGetLastError().
int rnet_pairwise_fwd(const void* u, const void* v, const void* s, const void* qa, const void* chunks,
                      const void* bs, void* partial, void* out, int B, int ni, int nj, int H, int L, int inject,
                      int wgs, int stages, int grid, long long smem, int drop, const void* seed,
                      unsigned int thr, float inv_keep, void* phases, void* stream) {
  const int bm = 64 * wgs;
  if ((wgs != 1 && wgs != 2) || H % NT != 0 || L < 2 || stages < 3 || grid < 1 ||
      smem != (long long)smem_bytes(bm, H, L, stages))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args a{static_cast<const bf16*>(u), static_cast<const bf16*>(v), static_cast<const bf16*>(s),
         static_cast<const bf16*>(qa), static_cast<const bf16*>(chunks), static_cast<const bf16*>(bs),
         static_cast<float*>(partial), B, ni, nj, H, L, inject, stages, static_cast<const int64_t*>(seed), thr,
         inv_keep, static_cast<long long*>(phases)};
  cudaError_t err = drop ? dispatch<true>(a, wgs, grid, (size_t)smem, st)
                         : dispatch<false>(a, wgs, grid, (size_t)smem, st);
  if (err != cudaSuccess) return (int)err;
  const int nparts = (ni * nj + bm - 1) / bm * wgs;
  pool_partials_kernel<<<dim3((H + 127) / 128, B), 128, 0, st>>>(static_cast<const float*>(partial),
                                                                  static_cast<float*>(out), nparts, H);
  return (int)cudaGetLastError();
}

// Writes the keep mask (B, npairs) uint8 of philox.cuh for `seed` (1,) int64.
int rnet_pair_mask(void* mask, int B, int npairs, const void* seed, unsigned int thr, void* stream) {
  pair_mask_kernel<<<dim3((npairs + 255) / 256, B), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(mask), B, npairs, static_cast<const int64_t*>(seed), thr);
  return (int)cudaGetLastError();
}

const char* rnet_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
