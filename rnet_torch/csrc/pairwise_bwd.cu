// Fused pairwise g_theta backward for Hopper (sm_90a): bf16 in, fp32 grads.
//
// Replaces the TPU kernel rnet/kernels/pairwise.py::_bwd_kernel (:120,
// launched by _bwd_pallas, :485, the custom VJP of _make_core), pair mask
// included. With
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
// of inputs and outputs. Behind them: the W feed (every 128-row block reads
// all of W twice) and the dW partial, (L-1)*H^2 fp32 (786 KB at H=256)
// added once per block by each of up to 132 CTAs, 104 MB in all, twice L2.
//
// Design (pairwise_chain.cuh has the layout, the W feed and the products).
// CTAs run in no order, so every output has one fixed writer, and the
// gradients are bitwise the same from run to run:
//   * a persistent grid of min(B, #SMs) CTAs; CTA k owns the samples
//     b = k, k+G, ... and walks all their blocks of BM = 64*WGS pair rows in
//     order (WGS = 2 up to H=256, 1 at H=512); dW / db go to the CTA's own
//     fp32 partial, which a second kernel adds over the CTAs in CTA order;
//   * warpgroup WGS is the producer (one thread of it): per block it streams the packed W_l^T
//     chunks of the recompute and the packed W_l chunks of the L-1 d
//     products through the ring, running ahead into the next block;
//   * the WGS consumer warpgroups own 64 rows each and keep max(3, L-1)
//     activation slots of BM x H bf16 (192 KB at H=256 or 512, L=4):
//     a_0 .. a_{L-2} in slots 0 .. L-2, and dpre_{L-1}, which the last
//     recompute epilogue forms straight from its accumulators (no separate
//     pass), in slot L-1 or, when that does not exist, in slot 0 (a_0 is
//     rebuilt from u, v, s for layer 1). dpre_{l-1} overwrites a_{l-1} in
//     place in the epilogue of d = dpre_l W_l^T.
//   * The dW flush. dW_l = a_{l-1}^T dpre_l is wgmma on both slots read
//     MN-major, 64 x 128 tiles split between the warpgroups. The partial
//     tile, kept in the accumulator's own fragment order (coalesced 16-byte
//     loads and stores, one thread per element), is loaded as the
//     accumulator and wgmma adds the block's rows onto it; the next tile's
//     partial loads while this tile's product runs, so the load is off the
//     critical path, and the partials are read and written with an L2
//     evict-first policy, so that they do not push the W chunks and du / dv
//     out of L2. A fixed thread adds every element, once per block, in
//     block order: the order of adds is fixed. Vector reductions
//     (red.add.v4.f32) took as long, and there is no shared memory left for
//     a staged bulk reduction: the slots and a 4-stage ring fill 227 KB.
//   * The serial phases. db_l (and dqa) are one more wgmma, 1^T dpre_l,
//     against a single core matrix of ones read with both strides 0, so the
//     column sums come from the tensor cores. dpre_0 = d * [a_0 > 0] goes in
//     fp32 from the accumulators into a dead slot of shared memory, never to
//     device memory, and the column pass adds it into du, dv, ds with
//     fire-and-forget reductions, four threads per column pair, each du /
//     dv / ds entry by one fixed thread in row order (one thread's
//     reductions to one address apply in program order), so no thread waits
//     on a load from device memory.
// With -DRNET_PHASE_TIMES the first consumer thread of each CTA sums
// clock64() per phase (recompute, dW products, dW flush, d products,
// column pass, W feed waits, a_0, barriers) into `phases` (grid, NPHASE).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "pairwise_chain.cuh"
#include "philox.cuh"

namespace {

using namespace rnet;

enum { PH_RECOMPUTE, PH_DW, PH_FLUSH, PH_D, PH_COLUMNS, PH_FEED, PH_A0, PH_SYNC };

// Shared memory: the activation slots, the W ring and its mbarriers, the
// per-row scale and one core matrix of ones.
size_t smem_bytes(int bm, int H, int slots, int stages) {
  return (size_t)slots * bm * H * sizeof(bf16) + (size_t)stages * (CHUNK_BYTES + 16) + (size_t)bm * sizeof(float) +
         128;
}

// Element offset of (r, c) in the fp32 dpre_0 tile of width NT: rows of NT
// floats, 8-float groups swizzled by the row, so that a warp's fragment
// stores spread over the banks.
__device__ __forceinline__ int f32_off(int r, int c) { return r * NT + (c ^ ((r & 7) << 3)); }

// The consumer warpgroups' part of pairwise_bwd_kernel (below).
template <int WGS, bool DROP>
__device__ __forceinline__ void consumer(const bf16* __restrict__ u, const bf16* __restrict__ v,
                                         const bf16* __restrict__ s, const bf16* __restrict__ qa,
                                         const bf16* __restrict__ bs, const float* __restrict__ g,
                                         float* __restrict__ du, float* __restrict__ dv, float* __restrict__ ds,
                                         float* __restrict__ dqa, float* __restrict__ dw_part,
                                         float* __restrict__ db_part, int B, int ni, int nj, int H, int L,
                                         int inject, int nslots, bf16* slots, float* rowscale, const bf16* ones,
                                         Ring& r, PhaseClock& pc, const int64_t* __restrict__ seed, uint32_t thr,
                                         float inv_keep, long long* phases) {
  constexpr int BM = 64 * WGS;
  constexpr int NC = WGS * WG_THREADS;  // consumer threads
  const int npairs = ni * nj;
  const int nblk = (npairs + BM - 1) / BM;
  const int wg = threadIdx.x / WG_THREADS;
  const int tid = threadIdx.x - wg * WG_THREADS;  // thread in the warpgroup
  const int ctid = threadIdx.x;                   // thread among the consumers
  const int r0 = 64 * wg;                         // this warpgroup's rows of a block
  const int fbase = frag_base(tid, r0, H);
  const int frow = r0 + 16 * (tid / 32) + (tid & 31) / 4;  // the thread's first fragment row
  const int dtop = (L - 1 < nslots) ? L - 1 : 0;  // the slot of dpre_{L-1}
  auto slot = [&](int k) { return slots + (size_t)k * BM * H; };
  const int dw_tiles = (H / 64) * (H / NT);
  float* dwp = dw_part + (size_t)blockIdx.x * (L - 1) * H * H;
  float* dbp = db_part + (size_t)blockIdx.x * (L - 1) * H;
  const uint64_t key = DROP ? (uint64_t)*seed : 0;
  const uint64_t pol = l2_evict_first();

  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    const float* gb = g + (size_t)b * H;
    for (int blk = 0; blk < nblk; ++blk) {
      const int p0 = blk * BM;
      const int valid = min(BM, npairs - p0);
      pc.mark(PH_SYNC);
      bar_sync(1, NC);  // the previous block's column pass is done with the slots
      pc.mark(PH_A0);
      for (int rr = ctid; rr < BM; rr += NC) {
        float sc = rr < valid ? 1.0f : 0.0f;
        if (DROP && rr < valid) sc = pair_kept(key, p0 + rr, b, thr) ? inv_keep : 0.0f;
        rowscale[rr] = sc;
      }
      make_a0(u, v, s, slot(0), b, p0, r0, 64, valid, ni, nj, H, tid, WG_THREADS);
      pc.mark(PH_SYNC);
      fence_proxy_async();
      bar_sync(1, NC);

      // ---- recompute a_1 .. a_{L-2}; the last layer's epilogue forms dpre_{L-1} ----
      for (int l = 1; l < L; ++l) {
        const bf16* A = slot(l - 1);
        bf16* out = slot(l < L - 1 ? l : dtop);
        const bf16* bias = bs + (size_t)(l - 1) * H;
        const bf16* qrow = (l == inject) ? qa + (size_t)b * H : nullptr;
        for (int nt = 0; nt < H / NT; ++nt) {
          // register 4j + 2h + e: row frow + 8h, column nt*NT + 8j + 2q + e;
          // the accumulator starts as b_l (+ qa) in fp32
          float acc[NT / 2];
          const bf16* bq = bias + nt * NT + 2 * (tid & 3);
          const bf16* qq = qrow ? qrow + nt * NT + 2 * (tid & 3) : nullptr;
#pragma unroll
          for (int j = 0; j < NT / 8; ++j) {
            float2 bb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bq + 8 * j));
            if (qq) {
              const float2 q = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(qq + 8 * j));
              bb.x += q.x;
              bb.y += q.y;
            }
            acc[4 * j] = acc[4 * j + 2] = bb.x;
            acc[4 * j + 1] = acc[4 * j + 3] = bb.y;
          }
          pc.mark(PH_RECOMPUTE);
          streamed_product(acc, smem_u32(A + r0 * H), H, r, tid == 0, pc, PH_FEED);
          bf16* o0 = out + fbase + nt * (NT / 8) * 64;
          bf16* o1 = o0 + 8 * H;
          if (l < L - 1) {
#pragma unroll
            for (int j = 0; j < NT / 8; ++j) {
              *reinterpret_cast<__nv_bfloat162*>(o0 + 64 * j) =
                  __floats2bfloat162_rn(fmaxf(acc[4 * j], 0.0f), fmaxf(acc[4 * j + 1], 0.0f));
              *reinterpret_cast<__nv_bfloat162*>(o1 + 64 * j) =
                  __floats2bfloat162_rn(fmaxf(acc[4 * j + 2], 0.0f), fmaxf(acc[4 * j + 3], 0.0f));
            }
          } else {  // dpre_{L-1} = bf16(g * scale_row * [bf16(relu(pre)) > 0])
            const float* gq = gb + nt * NT + 2 * (tid & 3);
            const float sc0 = rowscale[frow], sc1 = rowscale[frow + 8];
#pragma unroll
            for (int j = 0; j < NT / 8; ++j) {
              const float2 gg = *reinterpret_cast<const float2*>(gq + 8 * j);
              const float2 f0 =
                  __bfloat1622float2(__floats2bfloat162_rn(fmaxf(acc[4 * j], 0.0f), fmaxf(acc[4 * j + 1], 0.0f)));
              const float2 f1 = __bfloat1622float2(
                  __floats2bfloat162_rn(fmaxf(acc[4 * j + 2], 0.0f), fmaxf(acc[4 * j + 3], 0.0f)));
              *reinterpret_cast<__nv_bfloat162*>(o0 + 64 * j) =
                  __floats2bfloat162_rn(f0.x > 0.0f ? gg.x * sc0 : 0.0f, f0.y > 0.0f ? gg.y * sc0 : 0.0f);
              *reinterpret_cast<__nv_bfloat162*>(o1 + 64 * j) =
                  __floats2bfloat162_rn(f1.x > 0.0f ? gg.x * sc1 : 0.0f, f1.y > 0.0f ? gg.y * sc1 : 0.0f);
            }
          }
        }
        pc.mark(PH_SYNC);
        fence_proxy_async();
        bar_sync(2 + wg, WG_THREADS);  // this warpgroup's rows of the layer's output are complete
      }

      // ---- layers L-1 .. 1 ----
      for (int l = L - 1; l >= 1; --l) {
        bf16* D = slot(l == L - 1 ? dtop : l);  // dpre_l
        bf16* P = slot(l - 1);                  // a_{l-1}
        pc.mark(PH_A0);
        if (l == 1 && dtop == 0)  // slot 0 held dpre_{L-1}, dead since layer L-2's barriers: rebuild a_0
          make_a0(u, v, s, slot(0), b, p0, r0, 64, valid, ni, nj, H, tid, WG_THREADS);
        pc.mark(PH_SYNC);
        fence_proxy_async();
        bar_sync(1, NC);  // dpre_l (and a_0) complete in every row

        // dW_l tiles (the warpgroup's tiles wg, wg + WGS, ...): the partial
        // tile, in fragment order, is the accumulator that wgmma adds the
        // block's rows onto; the next tile's partial loads while this one's
        // product runs. Then one tile per NT columns of 1^T dpre_l: every
        // row of it is the column sums db_l (and dqa at the inject layer).
        {
          float4* part = reinterpret_cast<float4*>(dwp + (size_t)(l - 1) * dw_tiles * 64 * NT) + tid;
          float nxt[NT / 2];
          pc.mark(PH_FLUSH);
          if (wg < dw_tiles) {
#pragma unroll
            for (int j = 0; j < NT / 8; ++j) {
              const float4 o = ld_stream(part + (size_t)wg * 16 * NT + j * WG_THREADS, pol);
              nxt[4 * j] = o.x;
              nxt[4 * j + 1] = o.y;
              nxt[4 * j + 2] = o.z;
              nxt[4 * j + 3] = o.w;
            }
          }
          for (int tile = wg; tile < dw_tiles; tile += WGS) {
            float acc[NT / 2];
#pragma unroll
            for (int i = 0; i < NT / 2; ++i) acc[i] = nxt[i];
            if (tile + WGS < dw_tiles) {
#pragma unroll
              for (int j = 0; j < NT / 8; ++j) {
                const float4 o = ld_stream(part + (size_t)(tile + WGS) * 16 * NT + j * WG_THREADS, pol);
                nxt[4 * j] = o.x;
                nxt[4 * j + 1] = o.y;
                nxt[4 * j + 2] = o.z;
                nxt[4 * j + 3] = o.w;
              }
            }
            pc.mark(PH_DW);
            dw_product(acc, smem_u32(P), smem_u32(D), tile / (H / NT), tile % (H / NT), H, BM);
            pc.mark(PH_FLUSH);
#pragma unroll
            for (int j = 0; j < NT / 8; ++j)
              st_stream(part + (size_t)tile * 16 * NT + j * WG_THREADS,
                        make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]), pol);
          }
        }
        for (int nt = wg; nt < H / NT; nt += WGS) {
          float acc[NT / 2];
          pc.mark(PH_DW);
          colsum_product(acc, smem_u32(ones), smem_u32(D), nt, H, BM);
          pc.mark(PH_FLUSH);
          if (tid < 4) {  // row 0 of the tile: registers i with (i / 2) even
#pragma unroll
            for (int i = 0; i < NT / 2; ++i) {
              if ((i >> 1) & 1) continue;
              const int c = nt * NT + frag_col(tid, i);
              atomicAdd(dbp + (size_t)(l - 1) * H + c, acc[i]);  // one writer: in order
              if (l == inject) atomicAdd(dqa + (size_t)b * H + c, acc[i]);
            }
          }
        }
        pc.mark(PH_SYNC);
        bar_sync(1, NC);  // every dW_l product has read a_{l-1} before it is overwritten

        // ---- d = dpre_l W_l^T: dpre_{l-1} in place over a_{l-1}, or dpre_0 ----
        for (int nt = 0; nt < H / NT; ++nt) {
          float acc[NT / 2];
#pragma unroll
          for (int i = 0; i < NT / 2; ++i) acc[i] = 0.0f;
          pc.mark(PH_D);
          streamed_product(acc, smem_u32(D + r0 * H), H, r, tid == 0, pc, PH_FEED);
          bf16* p0p = P + fbase + nt * (NT / 8) * 64;  // a_{l-1} at the fragment's rows
          bf16* p1p = p0p + 8 * H;
          if (l >= 2) {
#pragma unroll
            for (int j = 0; j < NT / 8; ++j) {
              __nv_bfloat162* q0 = reinterpret_cast<__nv_bfloat162*>(p0p + 64 * j);
              __nv_bfloat162* q1 = reinterpret_cast<__nv_bfloat162*>(p1p + 64 * j);
              const float2 a0 = __bfloat1622float2(*q0), a1 = __bfloat1622float2(*q1);
              *q0 = __floats2bfloat162_rn(a0.x > 0.0f ? acc[4 * j] : 0.0f, a0.y > 0.0f ? acc[4 * j + 1] : 0.0f);
              *q1 = __floats2bfloat162_rn(a1.x > 0.0f ? acc[4 * j + 2] : 0.0f, a1.y > 0.0f ? acc[4 * j + 3] : 0.0f);
            }
            continue;
          }
          // l == 1: dpre_0 = d * [a_0 > 0] in fp32, into the dead slots (slot 1 and 2
          // when one tile spans H; else slot 2), then the column pass of these NT columns
          float* F = reinterpret_cast<float*>(slot(H / NT == 1 ? 1 : 2));
          pc.mark(PH_SYNC);
          bar_sync(1, NC);  // every warpgroup's product has read dpre_1 (slot 1)
          pc.mark(PH_D);
          {
            const int sw = frow & 7;  // f32_off's swizzle, the same for both rows
            float* f0p = F + frow * NT + 2 * (tid & 3);
            float* f1p = f0p + 8 * NT;
#pragma unroll
            for (int j = 0; j < NT / 8; ++j) {
              const float2 a0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p0p + 64 * j));
              const float2 a1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p1p + 64 * j));
              *reinterpret_cast<float2*>(f0p + 8 * (j ^ sw)) =
                  make_float2(a0.x > 0.0f ? acc[4 * j] : 0.0f, a0.y > 0.0f ? acc[4 * j + 1] : 0.0f);
              *reinterpret_cast<float2*>(f1p + 8 * (j ^ sw)) =
                  make_float2(a1.x > 0.0f ? acc[4 * j + 2] : 0.0f, a1.y > 0.0f ? acc[4 * j + 3] : 0.0f);
            }
          }
          pc.mark(PH_SYNC);
          bar_sync(1, NC);  // dpre_0 of these columns complete
          pc.mark(PH_COLUMNS);
          // Four threads per column pair, lanes l, l+8, l+16, l+24 of a warp:
          // quarter h takes the j in [h*jq, (h+1)*jq). Every du, dv and ds
          // entry has one writer thread, in every block of the sample, which
          // adds to it with fire-and-forget 8-byte reductions in row order
          // (one thread's reductions to one address apply in program order),
          // so no load waits on device memory. du and ds add the quarters'
          // sums as (q0 + q1) + (q2 + q3).
          const int jq = (nj + 3) / 4;
          const int lane = ctid & 31;
          const int h = lane >> 3;
          const int pend = p0 + valid;
          for (int cp0 = 0; cp0 < NT / 2; cp0 += NC / 4) {
            const int cc = 2 * (cp0 + (ctid >> 5) * 8 + (lane & 7));
            const int c = nt * NT + cc;
            const int jlo = h * jq, jhi = min(nj, jlo + jq);
            float2 ssum = make_float2(0.0f, 0.0f);
            for (int i = p0 / nj; i * nj < pend; ++i) {
              float2 run = make_float2(0.0f, 0.0f);
              const int jb = min(jhi, pend - i * nj);
              for (int j = max(jlo, p0 - i * nj); j < jb; ++j) {
                const float2 x = *reinterpret_cast<const float2*>(F + f32_off(i * nj + j - p0, cc));
                atomicAdd(reinterpret_cast<float2*>(dv + ((size_t)b * nj + j) * H + c), x);
                run.x += x.x;
                run.y += x.y;
              }
              ssum.x += run.x;
              ssum.y += run.y;
              run.x += __shfl_xor_sync(0xffffffffu, run.x, 8);
              run.y += __shfl_xor_sync(0xffffffffu, run.y, 8);
              run.x += __shfl_xor_sync(0xffffffffu, run.x, 16);
              run.y += __shfl_xor_sync(0xffffffffu, run.y, 16);
              if (h == 0) atomicAdd(reinterpret_cast<float2*>(du + ((size_t)b * ni + i) * H + c), run);
            }
            ssum.x += __shfl_xor_sync(0xffffffffu, ssum.x, 8);
            ssum.y += __shfl_xor_sync(0xffffffffu, ssum.y, 8);
            ssum.x += __shfl_xor_sync(0xffffffffu, ssum.x, 16);
            ssum.y += __shfl_xor_sync(0xffffffffu, ssum.y, 16);
            if (h == 0) atomicAdd(reinterpret_cast<float2*>(ds + (size_t)b * H + c), ssum);
          }
          if (nt + 1 < H / NT) {
            pc.mark(PH_SYNC);
            bar_sync(1, NC);  // the column pass is done with F before the next tile's dpre_0
          }
        }
      }
    }
  }
  pc.mark(PH_A0);
  if (ctid == 0 && phases) pc.store(phases + (size_t)blockIdx.x * NPHASE);
}

template <int WGS, bool DROP>
__global__ void __launch_bounds__((WGS + 1) * WG_THREADS, 1)
pairwise_bwd_kernel(const bf16* __restrict__ u, const bf16* __restrict__ v, const bf16* __restrict__ s,
                    const bf16* __restrict__ qa, const bf16* __restrict__ wt_chunks,
                    const bf16* __restrict__ w_chunks, const bf16* __restrict__ bs, const float* __restrict__ g,
                    float* __restrict__ du, float* __restrict__ dv, float* __restrict__ ds,
                    float* __restrict__ dqa, float* __restrict__ dw_part, float* __restrict__ db_part, int B,
                    int ni, int nj, int H, int L, int inject, int nslots, int stages,
                    const int64_t* __restrict__ seed, uint32_t thr, float inv_keep, long long* phases) {
  constexpr int BM = 64 * WGS;
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* slots = reinterpret_cast<bf16*>(smem);
  unsigned char* ring = smem + (size_t)nslots * BM * H * sizeof(bf16);
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + (size_t)stages * CHUNK_BYTES);
  float* rowscale = reinterpret_cast<float*>(bars + 2 * stages);
  bf16* ones = reinterpret_cast<bf16*>(rowscale + BM);  // one 8 x 8 core matrix of 1.0
  Ring r{smem_u32(ring), smem_u32(bars), smem_u32(bars + stages), stages, 0, 0};
  if (threadIdx.x < 64) {
    ones[threadIdx.x] = __float2bfloat16(1.0f);
    fence_proxy_async();
  }
  if (threadIdx.x == 0) {
    for (int k = 0; k < stages; ++k) {
      mbar_init(r.full + 8 * k, 1);
      mbar_init(r.empty + 8 * k, WGS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int npairs = ni * nj;
  const int nblk = (npairs + BM - 1) / BM;
  const int per_layer = (H / NT) * (H / KC);  // W chunks of one layer
  const int role = __shfl_sync(0xffffffffu, (int)threadIdx.x / WG_THREADS, 0);  // warp-uniform
  PhaseClock pc;
  pc.start(PH_A0);
  if (role == WGS) {  // the producer warpgroup: one thread streams W
    if (threadIdx.x == WGS * WG_THREADS) {
      for (int b = blockIdx.x; b < B; b += gridDim.x)
        for (int blk = 0; blk < nblk; ++blk) {
          produce(r, wt_chunks, (L - 1) * per_layer, pc, PH_FEED);
          for (int l = L - 1; l >= 1; --l)
            produce(r, w_chunks + (size_t)(l - 1) * per_layer * (CHUNK_BYTES / 2), per_layer, pc, PH_FEED);
        }
    }
  } else {
    consumer<WGS, DROP>(u, v, s, qa, bs, g, du, dv, ds, dqa, dw_part, db_part, B, ni, nj, H, L, inject,
                            nslots, slots, rowscale, ones, r, pc, seed, thr, inv_keep, phases);
  }
}

// dws[l, m, n] = sum over CTAs c = 0..G-1 (in order) of the partial element
// k holding it. A partial is laid out as the consumers' accumulators: per
// layer, per 64 x NT tile (mt, nt), per group j of 4 registers, per thread t
// of the warpgroup, 4 floats; register 4j + e of thread t holds row
// 16*(t/32) + (t%32)/4 + 8*(e/2) and column 8j + 2*(t%4) + e%2 of the tile.
__global__ void reduce_dw_kernel(const float* __restrict__ part, float* __restrict__ out, int G, int H, long long n) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  float sum = 0.0f;
  for (int c = 0; c < G; ++c) sum += part[(size_t)c * n + k];
  const long long per = (long long)H * H;
  const int l = (int)(k / per);
  const int kk = (int)(k % per);
  const int tile = kk / (64 * NT);
  const int w = kk % (64 * NT);
  const int j = w / (4 * WG_THREADS);
  const int t = (w / 4) % WG_THREADS;
  const int e = w % 4;
  const int row = (tile / (H / NT)) * 64 + (t / 32) * 16 + (t % 32) / 4 + 8 * (e / 2);
  const int col = (tile % (H / NT)) * NT + 8 * j + 2 * (t % 4) + e % 2;
  out[l * per + (long long)row * H + col] = sum;
}

// out[k] = sum over CTAs c = 0..G-1 of part[c, k], in CTA order.
__global__ void reduce_partials_kernel(const float* __restrict__ part, float* __restrict__ out, int G, long long n) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  float sum = 0.0f;
  for (int c = 0; c < G; ++c) sum += part[(size_t)c * n + k];
  out[k] = sum;
}

struct Args {
  const bf16 *u, *v, *s, *qa, *wt, *w, *bs;
  const float* g;
  float *du, *dv, *ds, *dqa, *dw_part, *db_part;
  int B, ni, nj, H, L, inject, slots, stages;
  const int64_t* seed;
  uint32_t thr;
  float inv_keep;
  long long* phases;
};

template <int WGS, bool DROP>
cudaError_t launch(const Args& a, int grid, size_t smem, cudaStream_t st) {
  auto kern = pairwise_bwd_kernel<WGS, DROP>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, (WGS + 1) * WG_THREADS, smem, st>>>(a.u, a.v, a.s, a.qa, a.wt, a.w, a.bs, a.g, a.du, a.dv, a.ds, a.dqa,
                                                   a.dw_part, a.db_part, a.B, a.ni, a.nj, a.H, a.L, a.inject,
                                                   a.slots, a.stages, a.seed, a.thr, a.inv_keep, a.phases);
  return cudaGetLastError();
}

template <bool DROP>
cudaError_t dispatch(const Args& a, int wgs, int grid, size_t smem, cudaStream_t st) {
  return wgs == 2 ? launch<2, DROP>(a, grid, smem, st) : launch<1, DROP>(a, grid, smem, st);
}

}  // namespace

extern "C" {

// Launches the backward on `stream` for the tile plan (wgs, slots,
// stages, grid, smem) of kernels/pairwise.py::tile_plan: the fused kernel,
// then the ordered sums of the dW and db partials; returns
// cudaErrorInvalidValue for a plan it cannot take. Device pointers to
// contiguous tensors: u (B,ni,H), v (B,nj,H), s, qa (B,H), bs (L-1,H) in
// bf16; wt_chunks = pack_weight_chunks(W^T), w_chunks =
// pack_weight_chunks(W); g (B,H) fp32; outputs du (B,ni,H), dv (B,nj,H),
// ds, dqa (B,H), dws (L-1,H,H), dbs (L-1,H) fp32, of which du, dv, ds and
// dqa must be zero; dw_part (grid,L-1,H,H) and db_part (grid,L-1,H) fp32
// zero; phases (grid, 8) int64 or null. Pair dropout as in
// rnet_pairwise_fwd. Returns cudaGetLastError().
int rnet_pairwise_bwd(const void* u, const void* v, const void* s, const void* qa, const void* wt_chunks,
                      const void* w_chunks, const void* bs, const void* g, void* du, void* dv, void* ds, void* dqa,
                      void* dws, void* dbs, void* dw_part, void* db_part, int B, int ni, int nj, int H, int L,
                      int inject, int wgs, int slots, int stages, int grid, long long smem, int drop,
                      const void* seed, unsigned int thr, float inv_keep, void* phases, void* stream) {
  if ((wgs != 1 && wgs != 2) || H % NT != 0 || L < 2 ||
      slots < (L - 1 > 3 ? L - 1 : 3) || stages < 3 || grid < 1 ||
      smem != (long long)smem_bytes(64 * wgs, H, slots, stages))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args a{static_cast<const bf16*>(u), static_cast<const bf16*>(v), static_cast<const bf16*>(s),
         static_cast<const bf16*>(qa), static_cast<const bf16*>(wt_chunks), static_cast<const bf16*>(w_chunks),
         static_cast<const bf16*>(bs), static_cast<const float*>(g), static_cast<float*>(du),
         static_cast<float*>(dv), static_cast<float*>(ds), static_cast<float*>(dqa), static_cast<float*>(dw_part),
         static_cast<float*>(db_part), B, ni, nj, H, L, inject, slots, stages, static_cast<const int64_t*>(seed),
         thr, inv_keep, static_cast<long long*>(phases)};
  cudaError_t err = drop ? dispatch<true>(a, wgs, grid, (size_t)smem, st)
                         : dispatch<false>(a, wgs, grid, (size_t)smem, st);
  if (err != cudaSuccess) return (int)err;
  const long long nw = (long long)(L - 1) * H * H;
  const long long nb = (long long)(L - 1) * H;
  reduce_dw_kernel<<<(unsigned)((nw + 255) / 256), 256, 0, st>>>(a.dw_part, static_cast<float*>(dws), grid, H, nw);
  reduce_partials_kernel<<<(unsigned)((nb + 255) / 256), 256, 0, st>>>(a.db_part, static_cast<float*>(dbs), grid,
                                                                        nb);
  return (int)cudaGetLastError();
}

const char* rnet_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
