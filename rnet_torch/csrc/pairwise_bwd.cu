// Fused pairwise g_theta backward for Hopper (sm_90a): bf16 in, fp32 grads.
//
// Replaces the TPU kernel rnet/kernels/pairwise.py::_bwd_kernel (launched by
// _bwd_pallas, the custom VJP of _make_core), pair mask included. With
//     a_0 = bf16(relu(u_i + v_j + s)),  a_l = bf16(relu(a_{l-1} W_l + b_l [+ qa]))
// for every pair row p = i*nj + j of sample b, and the pooled upstream
// gradient g[b] broadcast to every row (times the pair's dropout scale of
// philox.cuh when pair_keep < 1, as at :161-164), it recomputes the row's
// activations and backpropagates with _bwd_kernel's rounding points:
//     dpre_l = bf16(d * [a_l > 0])            l = L-1 .. 1
//     dW_l  += a_{l-1}^T dpre_l,  db_l += sum_rows dpre_l   (fp32)
//     dqa   += sum_rows dpre_l                (l == inject)
//     d      = dpre_l W_l^T                   (fp32)
//     dpre_0 = d * [a_0 > 0]                  (fp32)
//     ds += sum_rows dpre_0,  du[i] += sum_j dpre_0,  dv[j] += sum_i dpre_0
// The n^2 pair rows never reach device memory.
//
// What bounds it: tensor-core operations. The recompute, d and dW products
// are each 2*B*ni*nj*(L-1)*H^2 FLOPs, 3x the forward: at original-fp B=512
// (n=64, H=256, L=4) 2.47 TFLOP, 2.50 ms at 989 TFLOP/s bf16, against ~20 MB
// of inputs and outputs (6 us at 3.35 TB/s).
//
// Design. The TPU summed dW, db (all samples) and dv, ds, dqa (all i-tiles
// of a sample) into output blocks revisited across its sequential grid. CTAs
// run in no order, so here every output has one fixed writer:
//   * a persistent grid of G = min(B, #SMs) CTAs; CTA k takes the samples
//     b = k, k+G, ... and walks all their blocks of BM pair rows in order;
//   * du, dv, ds, dqa of a sample are read-modified-written in device memory
//     by the one CTA that owns the sample, each column by one thread;
//   * each CTA adds its dW/db to its own fp32 partial (G, L-1, H, H) /
//     (G, L-1, H) (each dW tile by one warp), and a second kernel adds the
//     G partials in a fixed order.
// So gradients are bitwise the same from run to run (no atomics).
//
// A CTA (8 warps) keeps the activation tiles of its BM rows in shared
// memory, one slot each for a_1 .. a_{L-1}; a_0 lives in a_{L-1}'s slot
// until layer 1 has used it and is rebuilt from u, v, s (cheap) for the
// last backward layer. That is 3 slots of BM*(H+8) bf16 at L=4: 203 KB at
// BM=128, H=256. dpre_l overwrites a_l in place once a_l's relu mask has
// been read. W_l streams through two (32 x 128) chunk buffers with
// cp.async, the next chunk in flight while the tensor cores work on the
// current one: row-major for the recompute and transposed (the col-major
// wmma B operand) for d = dpre W^T. BM is the largest of 128/64/32 that
// fits 227 KB: 128 at H=256 (with 0.5 KB to spare), 64 at H=512 (wide-fp,
// original-sd). dpre_0 goes to a per-CTA fp32 scratch (BM, H) in device
// memory (L2-resident), from which the column pass forms du/dv/ds.
//
// What bounds this simple kernel is the dW partial: (L-1)*H*H fp32, read
// and written once per row block, more than L2 holds across 132 CTAs. Its
// traffic per pair row falls as 1/BM, which is why BM is as large as
// shared memory allows. Memory latency is hidden by keeping several
// requests in flight from one warp or thread: a warp updates 8 dW tiles of
// its partial at once (8 loads, 8*BM/16 products, 8 stores), and the
// column pass reads and writes dv for 8 pair rows at once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int KC = 32;   // reduction depth of a streamed W chunk
constexpr int NC = 128;  // output columns of a streamed W chunk
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int PAD = 8;   // bf16 row padding in shared memory (bank spread)
constexpr int WBUF = (KC * (NC + PAD) > NC * (KC + PAD)) ? KC * (NC + PAD) : NC * (KC + PAD);
constexpr int DW_TILES = 8;  // dW tiles a warp updates together
constexpr int COL_ROWS = 8;  // pair rows the column pass handles together

// Activation slots: a_1 .. a_{L-1} each have one; a_0 shares the slot of
// a_{L-1} (it is dead while a_{L-1} lives and is rebuilt from u, v, s for
// the last backward layer), except at L = 2, where it gets its own.
__host__ __device__ inline int act_slots(int L) { return L - 1 > 2 ? L - 1 : 2; }

size_t smem_bytes(int BM, int H, int L) {
  return (size_t)act_slots(L) * BM * (H + PAD) * sizeof(bf16)  // activation slots
         + 2 * (size_t)WBUF * sizeof(bf16)           // two weight chunks
         + (size_t)WARPS * 256 * sizeof(float)       // epilogue staging
         + (size_t)BM * sizeof(float);               // per-row gradient scale
}

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragAT = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBT = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// Starts the copy of chunk (n0, k0) of W into buf: W[k0:k0+KC, n0:n0+NC]
// row-major, or with TRANS the block W[n0:n0+NC, k0:k0+KC] as stored, which
// is the col-major B operand of D W^T.
template <bool TRANS>
__device__ __forceinline__ void issue_chunk(const bf16* __restrict__ W, int H, int n0, int k0, bf16* buf) {
  if (!TRANS) {
    for (int idx = threadIdx.x; idx < KC * (NC / 8); idx += THREADS) {
      const int r = idx / (NC / 8);
      const int c8 = (idx % (NC / 8)) * 8;
      cp_async16(buf + r * (NC + PAD) + c8, W + (size_t)(k0 + r) * H + n0 + c8);
    }
  } else {
    for (int idx = threadIdx.x; idx < NC * (KC / 8); idx += THREADS) {
      const int c = idx / (KC / 8);
      const int k8 = (idx % (KC / 8)) * 8;
      cp_async16(buf + c * (KC + PAD) + k8, W + (size_t)(n0 + c) * H + k0 + k8);
    }
  }
  cp_async_commit();
}

// acc = A[rt tile] . W (or W^T with BWD) over one (BM, NC) output chunk per
// n0, each warp owning row tile rt and TPW column tiles from ct0; W streams
// through wb[0], wb[1] in (n0, k0) chunk order. At the end of each n0 the
// epilogue runs on the warp's fragments:
//   forward:  out = bf16(relu(acc + bias [+ qa_row]))
//   backward: with prev, prev = bf16(acc * [prev > 0]) in place (dpre_{l-1});
//             without it (l == 1), acc is stored in fp32 to d0 (BM, H).
template <int TPW, bool BWD>
__device__ void chunked_layer(const bf16* A, const bf16* __restrict__ W, int H, int LDA,
                              bf16* const wb[2], float* stage, int rt, int ct0, int lane,
                              bf16* out, const bf16* __restrict__ bias,
                              const bf16* __restrict__ qa_row, float* d0) {
  const int kch = H / KC;
  const int nq = (H / NC) * kch;
  FragC acc[TPW];
  issue_chunk<BWD>(W, H, 0, 0, wb[0]);
  for (int q = 0; q < nq; ++q) {
    const int n0 = (q / kch) * NC;
    const int k0 = (q % kch) * KC;
    if (k0 == 0) {
#pragma unroll
      for (int t = 0; t < TPW; ++t) wmma::fill_fragment(acc[t], 0.0f);
    }
    if (q + 1 < nq) {
      issue_chunk<BWD>(W, H, ((q + 1) / kch) * NC, ((q + 1) % kch) * KC, wb[(q + 1) & 1]);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk q (and, at q == 0, A) complete for every warp
    const bf16* buf = wb[q & 1];
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      FragA af;
      wmma::load_matrix_sync(af, A + rt * 16 * LDA + k0 + kk, LDA);
#pragma unroll
      for (int t = 0; t < TPW; ++t) {
        if (BWD) {
          FragBT bfr;
          wmma::load_matrix_sync(bfr, buf + (ct0 + t) * 16 * (KC + PAD) + kk, KC + PAD);
          wmma::mma_sync(acc[t], af, bfr, acc[t]);
        } else {
          FragB bfr;
          wmma::load_matrix_sync(bfr, buf + kk * (NC + PAD) + (ct0 + t) * 16, NC + PAD);
          wmma::mma_sync(acc[t], af, bfr, acc[t]);
        }
      }
    }
    if (k0 + KC == H) {
#pragma unroll
      for (int t = 0; t < TPW; ++t) {
        const int col0 = n0 + (ct0 + t) * 16;
        if (BWD && out == nullptr) {
          wmma::store_matrix_sync(d0 + (size_t)rt * 16 * H + col0, acc[t], H, wmma::mem_row_major);
          continue;
        }
        wmma::store_matrix_sync(stage, acc[t], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          bf16* po = out + (rt * 16 + e / 16) * LDA + col0 + e % 16;
          if (BWD) {
            *po = __bfloat162float(*po) > 0.0f ? __float2bfloat16(stage[e]) : __float2bfloat16(0.0f);
          } else {
            const int c = col0 + e % 16;
            float x = stage[e] + __bfloat162float(bias[c]);
            if (qa_row) x += __bfloat162float(qa_row[c]);
            *po = __float2bfloat16(fmaxf(x, 0.0f));
          }
        }
        __syncwarp();
      }
    }
    __syncthreads();  // every warp is done with wb[q & 1] before chunk q+2 lands there
  }
}

// dW += Aprev^T D over the BM rows; warp w owns the dW row tiles w, w+8, ...
// and updates DW_TILES of their column tiles at a time.
template <int BM>
__device__ void weight_grad(const bf16* Aprev, const bf16* D, float* dW, int H, int LDA, int warp) {
  const int T = H / 16;
  for (int tr = warp; tr < T; tr += WARPS) {
    FragAT af[BM / 16];
#pragma unroll
    for (int k = 0; k < BM / 16; ++k)
      wmma::load_matrix_sync(af[k], Aprev + k * 16 * LDA + tr * 16, LDA);
    float* row = dW + (size_t)tr * 16 * H;
    for (int tc0 = 0; tc0 < T; tc0 += DW_TILES) {
      FragC acc[DW_TILES];
#pragma unroll
      for (int t = 0; t < DW_TILES; ++t)
        wmma::load_matrix_sync(acc[t], row + (tc0 + t) * 16, H, wmma::mem_row_major);
#pragma unroll
      for (int k = 0; k < BM / 16; ++k) {
#pragma unroll
        for (int t = 0; t < DW_TILES; ++t) {
          FragB bfr;
          wmma::load_matrix_sync(bfr, D + k * 16 * LDA + (tc0 + t) * 16, LDA);
          wmma::mma_sync(acc[t], af[k], bfr, acc[t]);
        }
      }
#pragma unroll
      for (int t = 0; t < DW_TILES; ++t)
        wmma::store_matrix_sync(row + (tc0 + t) * 16, acc[t], H, wmma::mem_row_major);
    }
  }
}

// a_0 = bf16(relu(u_i + v_j + s)) in fp32 for the BM rows from pair p0 of
// sample b (rows past `rows` zero), into the tile `a0` (leading dim LDA).
__device__ void make_a0(const bf16* __restrict__ u, const bf16* __restrict__ v,
                        const bf16* __restrict__ s, bf16* a0, int b, int p0, int rows, int ni,
                        int nj, int H, int LDA, int BM) {
  const int vec = H / 8;
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
    *reinterpret_cast<uint4*>(a0 + r * LDA + c8) = packed;
  }
}

template <int BM, bool DROP>
__global__ void __launch_bounds__(THREADS, 1)
pairwise_bwd_kernel(const bf16* __restrict__ u, const bf16* __restrict__ v,
                    const bf16* __restrict__ s, const bf16* __restrict__ qa,
                    const bf16* __restrict__ ws, const bf16* __restrict__ bs,
                    const float* __restrict__ g, float* __restrict__ du,
                    float* __restrict__ dv, float* __restrict__ ds, float* __restrict__ dqa,
                    float* __restrict__ dw_part, float* __restrict__ db_part,
                    float* __restrict__ scratch, int B, int ni, int nj, int H, int L,
                    int inject, const int64_t* __restrict__ seed, uint32_t thr,
                    float inv_keep) {
  constexpr int ROW_TILES = BM / 16;
  constexpr int TPW = NC / 16 / (WARPS / ROW_TILES);  // column tiles per warp and chunk
  extern __shared__ __align__(128) unsigned char smem[];
  const int LDA = H + PAD;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int rt = warp % ROW_TILES;
  const int ct0 = (warp / ROW_TILES) * TPW;
  const int slots = act_slots(L);
  bf16* acts = reinterpret_cast<bf16*>(smem);  // activation slots, BM*LDA each
  bf16* const wb[2] = {acts + (size_t)slots * BM * LDA, acts + (size_t)slots * BM * LDA + WBUF};
  float* stage_all = reinterpret_cast<float*>(wb[1] + WBUF);
  float* stage = stage_all + warp * 256;
  float* rowscale = stage_all + WARPS * 256;

  const int npairs = ni * nj;
  const int nblk = (npairs + BM - 1) / BM;
  float* dwp = dw_part + (size_t)blockIdx.x * (L - 1) * H * H;
  float* dbp = db_part + (size_t)blockIdx.x * (L - 1) * H;
  float* d0 = scratch + (size_t)blockIdx.x * BM * H;
  const uint64_t key = DROP ? (uint64_t)*seed : 0;
  auto act = [&](int l) { return acts + (size_t)(l == 0 ? slots - 1 : l - 1) * BM * LDA; };

  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    const float* gb = g + (size_t)b * H;
    for (int blk = 0; blk < nblk; ++blk) {
      const int p0 = blk * BM;
      const int rows = min(BM, npairs - p0);
      __syncthreads();  // the previous block's column pass is done with a_0, d0
      for (int r = threadIdx.x; r < BM; r += THREADS) {
        float sc = r < rows ? 1.0f : 0.0f;
        if (DROP && r < rows) sc = rnet::pair_kept(key, p0 + r, b, thr) ? inv_keep : 0.0f;
        rowscale[r] = sc;
      }

      make_a0(u, v, s, act(0), b, p0, rows, ni, nj, H, LDA, BM);
      // ---- recompute: a_1 .. a_{L-1} ----
      for (int l = 1; l < L; ++l)
        chunked_layer<TPW, false>(act(l - 1), ws + (size_t)(l - 1) * H * H, H, LDA, wb, stage, rt,
                                  ct0, lane, act(l), bs + (size_t)(l - 1) * H,
                                  l == inject ? qa + (size_t)b * H : nullptr, nullptr);

      // ---- dpre_{L-1} = bf16(g * scale_row * [a_{L-1} > 0]), in place ----
      bf16* top = act(L - 1);
      for (int idx = threadIdx.x; idx < BM * H; idx += THREADS) {
        const int r = idx / H;
        const int c = idx - r * H;
        bf16* pa = top + r * LDA + c;
        const float x = gb[c] * rowscale[r];
        *pa = __bfloat162float(*pa) > 0.0f ? __float2bfloat16(x) : __float2bfloat16(0.0f);
      }

      // ---- layers L-1 .. 1 ----
      for (int l = L - 1; l >= 1; --l) {
        __syncthreads();  // dpre_l complete
        if (l == 1 && L > 2) {  // a_0's slot is free again: rebuild a_0 for dW_1 and dpre_0
          make_a0(u, v, s, act(0), b, p0, rows, ni, nj, H, LDA, BM);
          __syncthreads();
        }
        const bf16* D = act(l);
        for (int c = threadIdx.x; c < H; c += THREADS) {
          float sum = 0.0f;
          for (int r = 0; r < rows; ++r) sum += __bfloat162float(D[r * LDA + c]);
          dbp[(size_t)(l - 1) * H + c] += sum;
          if (l == inject) dqa[(size_t)b * H + c] += sum;
        }
        weight_grad<BM>(act(l - 1), D, dwp + (size_t)(l - 1) * H * H, H, LDA, warp);
        chunked_layer<TPW, true>(D, ws + (size_t)(l - 1) * H * H, H, LDA, wb, stage, rt, ct0, lane,
                                 l >= 2 ? act(l - 1) : nullptr, nullptr, nullptr, d0);
      }
      __syncthreads();  // d0 complete

      // ---- column pass: dpre_0 = d0 * [a_0 > 0] into ds, du, dv ----
      // Thread c walks column c over the rows in groups of COL_ROWS, whose
      // dv entries are distinct when nj >= COL_ROWS: their loads are all
      // issued before the adds and stores. Smaller nj goes row by row.
      const bf16* a0 = act(0);
      const int group = nj >= COL_ROWS ? COL_ROWS : 1;
      for (int c = threadIdx.x; c < H; c += THREADS) {
        int i = p0 / nj;
        int j = p0 - i * nj;
        float run = 0.0f, ssum = 0.0f;
        for (int r0 = 0; r0 < rows; r0 += group) {
          const int nr = min(group, rows - r0);
          float x[COL_ROWS], old[COL_ROWS];
          size_t at[COL_ROWS];
#pragma unroll
          for (int k = 0; k < COL_ROWS; ++k) {
            if (k < nr) {
              const int r = r0 + k;
              const int jj = j + k < nj ? j + k : j + k - nj;
              at[k] = ((size_t)b * nj + jj) * H + c;
              x[k] = __bfloat162float(a0[r * LDA + c]) > 0.0f ? d0[(size_t)r * H + c] : 0.0f;
              old[k] = dv[at[k]];
            }
          }
#pragma unroll
          for (int k = 0; k < COL_ROWS; ++k) {
            if (k < nr) {
              dv[at[k]] = old[k] + x[k];
              ssum += x[k];
              run += x[k];
              if (++j == nj) {
                du[((size_t)b * ni + i) * H + c] += run;
                run = 0.0f;
                j = 0;
                ++i;
              }
            }
          }
        }
        if (j != 0) du[((size_t)b * ni + i) * H + c] += run;
        ds[(size_t)b * H + c] += ssum;
      }
    }
  }
}

// out[k] = sum over CTAs c = 0..G-1 of part[c, k], in CTA order.
__global__ void reduce_partials_kernel(const float* __restrict__ part, float* __restrict__ out,
                                       int G, long long n) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  float sum = 0.0f;
  for (int c = 0; c < G; ++c) sum += part[(size_t)c * n + k];
  out[k] = sum;
}

template <int BM, bool DROP>
cudaError_t launch_main(const bf16* u, const bf16* v, const bf16* s, const bf16* qa,
                        const bf16* ws, const bf16* bs, const float* g, float* du, float* dv,
                        float* ds, float* dqa, float* dw_part, float* db_part, float* scratch,
                        int B, int ni, int nj, int H, int L, int inject, int grid,
                        const int64_t* seed, uint32_t thr, float inv_keep, cudaStream_t stream) {
  const size_t smem = smem_bytes(BM, H, L);
  cudaError_t err = cudaFuncSetAttribute(pairwise_bwd_kernel<BM, DROP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  pairwise_bwd_kernel<BM, DROP><<<grid, THREADS, smem, stream>>>(
      u, v, s, qa, ws, bs, g, du, dv, ds, dqa, dw_part, db_part, scratch, B, ni, nj, H, L,
      inject, seed, thr, inv_keep);
  return cudaGetLastError();
}

template <bool DROP>
cudaError_t launch_rows(int BM, const bf16* u, const bf16* v, const bf16* s, const bf16* qa,
                        const bf16* ws, const bf16* bs, const float* g, float* du, float* dv,
                        float* ds, float* dqa, float* dw_part, float* db_part, float* scratch,
                        int B, int ni, int nj, int H, int L, int inject, int grid,
                        const int64_t* seed, uint32_t thr, float inv_keep, cudaStream_t st) {
  switch (BM) {
    case 128:
      return launch_main<128, DROP>(u, v, s, qa, ws, bs, g, du, dv, ds, dqa, dw_part, db_part,
                                    scratch, B, ni, nj, H, L, inject, grid, seed, thr, inv_keep, st);
    case 64:
      return launch_main<64, DROP>(u, v, s, qa, ws, bs, g, du, dv, ds, dqa, dw_part, db_part,
                                   scratch, B, ni, nj, H, L, inject, grid, seed, thr, inv_keep, st);
    case 32:
      return launch_main<32, DROP>(u, v, s, qa, ws, bs, g, du, dv, ds, dqa, dw_part, db_part,
                                   scratch, B, ni, nj, H, L, inject, grid, seed, thr, inv_keep, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Pair rows per block at width H and depth L: the largest of 128/64/32
// whose shared memory fits `smem_limit` bytes, or 0 if none does (H > 512
// at L = 4; no configuration is that wide).
int rnet_pairwise_bwd_block_rows(int H, int L, long long smem_limit) {
  for (int bm = 128; bm >= 32; bm /= 2)
    if ((long long)smem_bytes(bm, H, L) <= smem_limit) return bm;
  return 0;
}

// Launches the backward on `stream`: the fused kernel on `grid` CTAs (BM rows
// per block), then the ordered sums of the dW and db partials. Device
// pointers to contiguous tensors: u (B,ni,H), v (B,nj,H), s, qa (B,H),
// ws (L-1,H,H), bs (L-1,H) in bf16; g (B,H) fp32; outputs du (B,ni,H),
// dv (B,nj,H), ds, dqa (B,H), dws (L-1,H,H), dbs (L-1,H) fp32, of which du,
// dv, ds and dqa must be zero; dw_part (grid,L-1,H,H) and db_part
// (grid,L-1,H) fp32 zero; scratch (grid,BM,H) fp32. Pair dropout as in
// rnet_pairwise_fwd. Returns cudaGetLastError().
int rnet_pairwise_bwd(const void* u, const void* v, const void* s, const void* qa,
                      const void* ws, const void* bs, const void* g, void* du, void* dv,
                      void* ds, void* dqa, void* dws, void* dbs, void* dw_part, void* db_part,
                      void* scratch, int B, int ni, int nj, int H, int L, int inject, int BM,
                      int grid, int drop, const void* seed, unsigned int thr, float inv_keep,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* pu = static_cast<const bf16*>(u);
  const bf16* pv = static_cast<const bf16*>(v);
  const bf16* ps = static_cast<const bf16*>(s);
  const bf16* pq = static_cast<const bf16*>(qa);
  const bf16* pw = static_cast<const bf16*>(ws);
  const bf16* pb = static_cast<const bf16*>(bs);
  const float* pg = static_cast<const float*>(g);
  float* f_du = static_cast<float*>(du);
  float* f_dv = static_cast<float*>(dv);
  float* f_ds = static_cast<float*>(ds);
  float* f_dqa = static_cast<float*>(dqa);
  float* f_wp = static_cast<float*>(dw_part);
  float* f_bp = static_cast<float*>(db_part);
  float* f_sc = static_cast<float*>(scratch);
  const int64_t* sd = static_cast<const int64_t*>(seed);
  cudaError_t err =
      drop ? launch_rows<true>(BM, pu, pv, ps, pq, pw, pb, pg, f_du, f_dv, f_ds, f_dqa, f_wp, f_bp,
                               f_sc, B, ni, nj, H, L, inject, grid, sd, thr, inv_keep, st)
           : launch_rows<false>(BM, pu, pv, ps, pq, pw, pb, pg, f_du, f_dv, f_ds, f_dqa, f_wp, f_bp,
                                f_sc, B, ni, nj, H, L, inject, grid, sd, thr, inv_keep, st);
  if (err != cudaSuccess) return (int)err;
  const long long nw = (long long)(L - 1) * H * H;
  const long long nb = (long long)(L - 1) * H;
  reduce_partials_kernel<<<(unsigned)((nw + 255) / 256), 256, 0, st>>>(f_wp, static_cast<float*>(dws), grid, nw);
  reduce_partials_kernel<<<(unsigned)((nb + 255) / 256), 256, 0, st>>>(f_bp, static_cast<float*>(dbs), grid, nb);
  return (int)cudaGetLastError();
}

const char* rnet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
