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
// The n^2 pair rows reach device memory once, as the bf16 a_{l-1} and
// dpre_l tiles that dW is summed from (below).
//
// What bounds it: tensor-core operations. The recompute, d and dW products
// are each 2*B*ni*nj*(L-1)*H^2 FLOPs, 3x the forward: at original-fp B=512
// (n=64, H=256, L=4) 2.47 TFLOP, 2.50 ms at 989 TFLOP/s bf16 (the H100 SXM
// data sheet's peak at 700 W), against ~20 MB of inputs and outputs; at
// wide-fp's H=512, 9.9 TFLOP, 10.0 ms. Behind them: the W feed (every
// block of rows reads all of W twice) and the stored tiles, 2*(L-1)*H bf16
// per pair row written once and read once (6.44 GB at original-fp B=512).
//
// Design (pairwise_chain.cuh has the layout, the W feed and the products).
// CTAs run in no order, so every output has one fixed writer, and the
// gradients are bitwise the same from run to run:
//   * a persistent grid that walks units u = b*S + k, split k of sample b:
//     the contiguous blocks [k*nblk/S, (k+1)*nblk/S) of BM = 64*WGS pair rows,
//     in order (WGS = 2 up to H=256, 1 at H=384; H=512 runs on clusters of
//     two, below). With B >= #SMs, S = 1 and min(B, #SMs) CTAs, CTA c owning
//     the samples b = c, c+G, ...; with fewer samples than SMs, S = #SMs / B
//     (at most nblk) and one unit a CTA, so that a batch of 8 still runs on
//     128 of the 132 SMs (kernels/pairwise.py::tile_plan, sample_splits).
//     rnet's kernel runs its grid (B, ni/TI) in order on one core and needs
//     no split. db goes to the CTA's own fp32 partial, which
//     reduce_partials_kernel adds over the CTAs in CTA order; du, dv, ds and
//     dqa go to the split's own slice (S > 1; S = 1 writes them directly),
//     added in split order the same way; dW is a GEMM (below);
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
//   * dW. rnet's TPU kernel keeps all of dW in VMEM across its sequential
//     grid (the constant index maps of the dW and db out blocks,
//     rnet/kernels/pairwise.py:501-511, of the kernel at :120). Here no CTA
//     holds dW: per block and layer, one thread of each warpgroup stores its
//     64 rows of a_{l-1} and of dpre_l (the CTA's columns) to device memory
//     as they lie in shared memory (two bulk stores, cp.async.bulk, under an
//     L2 evict-first policy, so that they do not push the W chunks out of
//     L2) while the column sums run; the warpgroup waits only for a_{l-1}'s
//     store to have read it before the d product overwrites it. That is
//     6.44 GB at original-fp B=512 (the buffer `act`, 2 x (L-1) x B x 32
//     blocks x 64 KB; 12.9 GB at wide-fp), written once and read back once
//     by dw_gemm_kernel, which sums a_{l-1}^T dpre_l over all rows in 128 x
//     256 output tiles (128 x 128 where 256 does not divide H), the rows
//     split over dw_splits(...) CTAs per tile; reduce_partials_kernel adds
//     the splits in order (a per-CTA fp32 partial of dW, loaded and stored
//     around every block's product, would move 25.8 GB at original-fp
//     B=512 and spend half the kernel's cycles on it). The
//     buffer grows with B n^2, so kernels/pairwise.py::bwd_groups runs the
//     batch in groups of samples whose tiles fit BWD_STORE_BUDGET: each group
//     one launch of this kernel (its first sample b0 keeps the pair mask of
//     the whole batch) and one of the GEMM, which adds onto the earlier
//     groups' split partials, so the order of adds is fixed.
//   * The serial phases. db_l (and dqa) are one more wgmma, 1^T dpre_l,
//     against a single core matrix of ones read with both strides 0, so the
//     column sums come from the tensor cores. dpre_0 = d * [a_0 > 0] goes in
//     fp32 from the accumulators into a dead slot of shared memory, never to
//     device memory, and the column pass adds it into du, dv, ds with
//     fire-and-forget reductions, four threads per column pair, each du /
//     dv / ds entry by one fixed thread in row order (one thread's
//     reductions to one address apply in program order), so no thread waits
//     on a load from device memory.
//
// H = 512 (wide-fp, the SD models): clusters of two CTAs (CL = 2), one unit
// a sample (S = 1). One CTA's slots of all 512 columns would hold only
// 64-row blocks on one warpgroup, as at H=384; the pair keeps the H=256
// kernel's 128-row blocks on two:
//   * The two CTAs of a cluster, on neighbouring SMs, share each block of
//     BM = 128 rows and split the output columns: rank c computes the
//     columns c*256 .. c*256 + 255 of every product and keeps only those of
//     every activation tile, the layout of the H=256 kernel (3 slots of
//     128 x 256 bf16 = 196,608 B, a 4-stage ring of 32,832 B, row scales
//     512 B, the ones 128 B, two pair mbarriers 16 B: 230,096 B of the
//     232,448).
//   * The depth of every product is all 512: the CTA's own 256 columns of
//     A come from its tile by descriptor, the peer's 256 from the peer's
//     tile through distributed shared memory (mapa + ld.shared::cluster)
//     into registers as wgmma A fragments, two chunks ahead
//     (pairwise_chain.cuh::pair_product_rows).
//     Each CTA streams only its 256 rows of W_l^T and W_l, its own depth
//     first (kernels/pairwise.py::pair_halves).
//   * Each rank stores its 256 columns of a_{l-1} and dpre_l; the peer reads
//     neither again in the layer, so only the rank's own consumers wait for
//     its stores.
//   * The pair meets (PairSync: mbarriers the peer arrives on remotely)
//     after a_0, after each recompute layer and before each backward layer
//     that reads what the peer just wrote; the producer warpgroup hands its
//     registers to the consumers (setmaxnreg 40 / 232).
//   * db, du, dv, ds, dqa keep one writer each (the CTA that owns the
//     column); every dW element is the ordered sum of its GEMM splits' products.
//     Bitwise repeatable as the one-CTA kernel.
// With -DRNET_PHASE_TIMES the first consumer thread of each CTA sums
// clock64() per phase (recompute, column sums, the stores' issue and waits,
// d products, column pass, W feed waits, a_0, barriers, the pair's waits)
// into `phases` (grid, NPHASE).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "pairwise_chain.cuh"
#include "smem_limit.cuh"
#include "philox.cuh"

namespace {

using namespace rnet;

enum { PH_RECOMPUTE, PH_COLSUM, PH_STORE, PH_D, PH_COLUMNS, PH_FEED, PH_A0, PH_SYNC, PH_PAIR };

// Shared memory: the activation slots (bm rows x the CTA's W columns), the W
// ring and its mbarriers, the per-row scale, one core matrix of ones and, in
// a cluster, the two mbarriers of the pair barrier (PairSync).
size_t smem_bytes(int bm, int W, int slots, int stages, int cl) {
  return (size_t)slots * bm * W * sizeof(bf16) + (size_t)stages * (CHUNK_BYTES + 16) + (size_t)bm * sizeof(float) +
         128 + (cl > 1 ? 16 : 0);
}

// Element offset of (r, c) in the fp32 dpre_0 tile of width NT: rows of NT
// floats, 8-float groups swizzled by the row, so that a warp's fragment
// stores spread over the banks.
__device__ __forceinline__ int f32_off(int r, int c) { return r * NT + (c ^ ((r & 7) << 3)); }

// The consumer warpgroups' part of pairwise_bwd_kernel (below), on the B
// samples of a group whose first is sample b0 of the batch (the pair mask's
// b). CL = 1: the CTA owns its samples and every column; CL = 2: a cluster CTA of rank c
// keeps the columns c W .. c W + W - 1 (W = H / 2) of every tile, reads the
// peer's other half through distributed shared memory, and meets its peer
// at `ps` wherever one CTA is about to read what the other wrote, or to
// overwrite what the other reads.
template <int WGS, int CL, bool DROP>
__device__ __forceinline__ void consumer(const bf16* __restrict__ u, const bf16* __restrict__ v,
                                         const bf16* __restrict__ s, const bf16* __restrict__ qa,
                                         const bf16* __restrict__ bs, const float* __restrict__ g,
                                         float* __restrict__ du, float* __restrict__ dv, float* __restrict__ ds,
                                         float* __restrict__ dqa, float* __restrict__ db_part,
                                         bf16* __restrict__ act, int B, int b0, int ni, int nj,
                                         int H, int L, int inject, int splits, long long split_stride,
                                         int nslots, bf16* slots, float* rowscale,
                                         const bf16* ones,
                                         Ring& r, PairSync& ps, PhaseClock& pc, const int64_t* __restrict__ seed,
                                         uint32_t thr, float inv_keep, long long* phases) {
  constexpr int BM = 64 * WGS;
  constexpr int NC = WGS * WG_THREADS;  // consumer threads
  const int W = H / CL;                 // the CTA's columns
  const int rank = CL == 1 ? 0 : (int)cluster_rank();
  const int c0 = rank * W;
  const int npairs = ni * nj;
  const int nblk = (npairs + BM - 1) / BM;
  const int wg = threadIdx.x / WG_THREADS;
  const int tid = threadIdx.x - wg * WG_THREADS;  // thread in the warpgroup
  const int ctid = threadIdx.x;                   // thread among the consumers
  const int r0 = 64 * wg;                         // this warpgroup's rows of a block
  const int fbase = frag_base(tid, r0, W);
  const int frow = r0 + 16 * (tid / 32) + (tid & 31) / 4;  // the thread's first fragment row
  const int dtop = (L - 1 < nslots) ? L - 1 : 0;  // the slot of dpre_{L-1}
  auto slot = [&](int k) { return slots + (size_t)k * BM * W; };
  const uint32_t peer_slots = CL == 1 ? 0u : mapa(smem_u32(slots), rank ^ 1);
  auto peer_slot = [&](int k) { return peer_slots + (uint32_t)(k * BM * W * 2); };
  float* dbp = db_part + (size_t)blockIdx.x * (L - 1) * H;
  const uint64_t key = DROP ? (uint64_t)*seed : 0;
  const uint64_t pol = l2_evict_first();  // the stored tiles, read again only by the next kernel
  // all consumers of both CTAs (CL = 2), or `id` over `n` threads of this CTA
  auto sync = [&](int id, int n) {
    pc.mark(PH_SYNC);
    fence_proxy_async();
    if constexpr (CL == 1)
      bar_sync(id, n);
    else
      ps.sync(NC, ctid == 0, pc, PH_PAIR);
  };
  auto product = [&](float (&acc)[NT / 2], const bf16* A, int k) {  // A = slot(k)
    if constexpr (CL == 1)
      streamed_product(acc, smem_u32(A + r0 * W), 2 * W, r, tid == 0, pc, PH_FEED);
    else
      pair_product_rows<1>(reinterpret_cast<float(&)[1][NT / 2]>(acc), smem_u32(A + r0 * W), peer_slot(k) + 2u * r0 * W,
                           tid, r, tid == 0, pc, PH_FEED);
  };

  for (int unit = blockIdx.x / CL; unit < B * splits; unit += gridDim.x / CL) {
    const int b = unit / splits, k = unit - b * splits;  // split k of sample b
    const float* gb = g + (size_t)b * H + c0;
    // the split's own slices of du, dv, ds, dqa (split_stride 0 with one split)
    float* const du_k = du + (size_t)k * split_stride;
    float* const dv_k = dv + (size_t)k * split_stride;
    float* const ds_k = ds + (size_t)k * split_stride;
    float* const dqa_k = dqa + (size_t)k * split_stride;
    for (int blk = k * nblk / splits; blk < (k + 1) * nblk / splits; ++blk) {
      const int p0 = blk * BM;
      const int valid = min(BM, npairs - p0);
      pc.mark(PH_SYNC);
      bar_sync(1, NC);  // the previous block's column pass is done with the slots
      pc.mark(PH_A0);
      for (int rr = ctid; rr < BM; rr += NC) {
        float sc = rr < valid ? 1.0f : 0.0f;
        if (DROP && rr < valid) sc = pair_kept(key, p0 + rr, b0 + b, thr) ? inv_keep : 0.0f;
        rowscale[rr] = sc;
      }
      make_a0(u, v, s, slot(0), b, p0, r0, 64, valid, ni, nj, H, tid, WG_THREADS, W, c0);
      sync(1, NC);

      // ---- recompute a_1 .. a_{L-2}; the last layer's epilogue forms dpre_{L-1} ----
      for (int l = 1; l < L; ++l) {
        const bf16* A = slot(l - 1);
        bf16* out = slot(l < L - 1 ? l : dtop);
        const bf16* bias = bs + (size_t)(l - 1) * H + c0;
        const bf16* qrow = (l == inject) ? qa + (size_t)b * H + c0 : nullptr;
        for (int nt = 0; nt < W / NT; ++nt) {
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
          product(acc, A, l - 1);
          bf16* o0 = out + fbase + nt * (NT / 8) * 64;
          bf16* o1 = o0 + 8 * W;
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
        sync(2 + wg, WG_THREADS);  // this warpgroup's rows of the layer's output are complete (CL = 2: all rows of both)
      }

      // ---- layers L-1 .. 1 ----
      for (int l = L - 1; l >= 1; --l) {
        const int dk = l == L - 1 ? dtop : l;
        bf16* D = slot(dk);     // dpre_l
        bf16* P = slot(l - 1);  // a_{l-1}
        pc.mark(PH_A0);
        const bool rebuild = l == 1 && dtop == 0;  // slot 0 held dpre_{L-1}, dead since layer L-2's barriers
        if (rebuild) make_a0(u, v, s, slot(0), b, p0, r0, 64, valid, ni, nj, H, tid, WG_THREADS, W, c0);
        if (CL == 1 || l < L - 1 || rebuild) sync(1, NC);  // dpre_l (and a_0) complete in every row

        // One tile per NT columns of 1^T dpre_l: every row of it is the
        // column sums db_l (and dqa at the inject layer).
        auto column_sums = [&](int nt) {
          float acc[NT / 2];
          pc.mark(PH_COLSUM);
          colsum_product(acc, smem_u32(ones), smem_u32(D), nt, W, BM);
          if (tid < 4) {  // row 0 of the tile: registers i with (i / 2) even
#pragma unroll
            for (int i = 0; i < NT / 2; ++i) {
              if ((i >> 1) & 1) continue;
              const int c = c0 + nt * NT + frag_col(tid, i);
              atomicAdd(dbp + (size_t)(l - 1) * H + c, acc[i]);  // one writer: in order
              if (l == inject) atomicAdd(dqa_k + (size_t)b * H + c, acc[i]);
            }
          }
        };
        // The warpgroup's 64 rows of a_{l-1} and of dpre_l (the CTA's
        // columns, 64 x W contiguous in the tile) leave for dw_gemm_kernel as
        // two bulk stores, a group each, while the column sums run. Only the
        // d product's epilogue overwrites them, a_{l-1} in the warpgroup's own
        // rows (no other thread of either CTA reads a_{l-1} again), so the
        // warpgroup waits for that store alone; dpre_l stays until the last
        // layer's dpre_0, before which the stores' thread waits for the rest.
        pc.mark(PH_STORE);
        if (tid == 0) {
          const size_t tile = (size_t)BM * W, nb = (size_t)B * nblk;
          bf16* dst = act + (((size_t)(l - 1) * nb + (size_t)b * nblk + blk) * CL + rank) * tile + (size_t)r0 * W;
          bulk_s2g(dst, smem_u32(P + r0 * W), (uint32_t)(64 * W * sizeof(bf16)), pol);
          bulk_commit();
          bulk_s2g(dst + (size_t)(L - 1) * nb * CL * tile, smem_u32(D + r0 * W), (uint32_t)(64 * W * sizeof(bf16)),
                   pol);
          bulk_commit();
        }
        for (int nt = wg; nt < W / NT; nt += WGS) column_sums(nt);
        pc.mark(PH_STORE);
        if (tid == 0) bulk_wait_read<1>();
        pc.mark(PH_SYNC);
        bar_sync(2 + wg, WG_THREADS);  // the store has read the warpgroup's a_{l-1} before it is overwritten

        // ---- d = dpre_l W_l^T: dpre_{l-1} in place over a_{l-1}, or dpre_0 ----
        for (int nt = 0; nt < W / NT; ++nt) {
          float acc[NT / 2];
#pragma unroll
          for (int i = 0; i < NT / 2; ++i) acc[i] = 0.0f;
          pc.mark(PH_D);
          product(acc, D, dk);
          bf16* p0p = P + fbase + nt * (NT / 8) * 64;  // a_{l-1} at the fragment's rows
          bf16* p1p = p0p + 8 * W;
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
          // when one tile spans W; else slot 2), then the column pass of these NT columns
          float* F = reinterpret_cast<float*>(slot(W / NT == 1 ? 1 : 2));
          pc.mark(PH_STORE);
          if (nt == 0 && tid == 0) bulk_wait_read();  // every store of the block has read its rows
          pc.mark(PH_SYNC);
          bar_sync(1, NC);  // every warpgroup's product has read dpre_1 (slot 1), every store its rows
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
            const int c = c0 + nt * NT + cc;
            const int jlo = h * jq, jhi = min(nj, jlo + jq);
            float2 ssum = make_float2(0.0f, 0.0f);
            for (int i = p0 / nj; i * nj < pend; ++i) {
              float2 run = make_float2(0.0f, 0.0f);
              const int jb = min(jhi, pend - i * nj);
              for (int j = max(jlo, p0 - i * nj); j < jb; ++j) {
                const float2 x = *reinterpret_cast<const float2*>(F + f32_off(i * nj + j - p0, cc));
                atomicAdd(reinterpret_cast<float2*>(dv_k + ((size_t)b * nj + j) * H + c), x);
                run.x += x.x;
                run.y += x.y;
              }
              ssum.x += run.x;
              ssum.y += run.y;
              run.x += __shfl_xor_sync(0xffffffffu, run.x, 8);
              run.y += __shfl_xor_sync(0xffffffffu, run.y, 8);
              run.x += __shfl_xor_sync(0xffffffffu, run.x, 16);
              run.y += __shfl_xor_sync(0xffffffffu, run.y, 16);
              if (h == 0) atomicAdd(reinterpret_cast<float2*>(du_k + ((size_t)b * ni + i) * H + c), run);
            }
            ssum.x += __shfl_xor_sync(0xffffffffu, ssum.x, 8);
            ssum.y += __shfl_xor_sync(0xffffffffu, ssum.y, 8);
            ssum.x += __shfl_xor_sync(0xffffffffu, ssum.x, 16);
            ssum.y += __shfl_xor_sync(0xffffffffu, ssum.y, 16);
            if (h == 0) atomicAdd(reinterpret_cast<float2*>(ds_k + (size_t)b * H + c), ssum);
          }
          if (nt + 1 < W / NT) {
            pc.mark(PH_SYNC);
            bar_sync(1, NC);  // the column pass is done with F before the next tile's dpre_0
          }
        }
      }
    }
  }
  if (tid == 0) bulk_wait_all();  // the stored tiles are in device memory for dw_gemm_kernel
  if constexpr (CL == 2) sync(1, NC);  // the peer has read the last of this CTA's tiles: it may exit
  pc.mark(PH_A0);
  if (ctid == 0 && phases) pc.store(phases + (size_t)blockIdx.x * NPHASE);
}

template <int WGS, int CL, bool DROP>
__global__ void __launch_bounds__((WGS + 1) * WG_THREADS, 1)
pairwise_bwd_kernel(const bf16* __restrict__ u, const bf16* __restrict__ v, const bf16* __restrict__ s,
                    const bf16* __restrict__ qa, const bf16* __restrict__ wt_chunks,
                    const bf16* __restrict__ w_chunks, const bf16* __restrict__ bs, const float* __restrict__ g,
                    float* __restrict__ du, float* __restrict__ dv, float* __restrict__ ds,
                    float* __restrict__ dqa, float* __restrict__ db_part, bf16* __restrict__ act, int B, int b0,
                    int ni, int nj, int H, int L, int inject, int splits,
                    long long split_stride, int nslots, int stages, const int64_t* __restrict__ seed, uint32_t thr,
                    float inv_keep, long long* phases) {
  constexpr int BM = 64 * WGS;
  const int W = H / CL;
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* slots = reinterpret_cast<bf16*>(smem);
  unsigned char* ring = smem + (size_t)nslots * BM * W * sizeof(bf16);
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + (size_t)stages * CHUNK_BYTES);
  float* rowscale = reinterpret_cast<float*>(bars + 2 * stages);
  bf16* ones = reinterpret_cast<bf16*>(rowscale + BM);  // one 8 x 8 core matrix of 1.0
  uint64_t* pair_bars = reinterpret_cast<uint64_t*>(ones + 64);
  Ring r{smem_u32(ring), smem_u32(bars), smem_u32(bars + stages), stages, 0, 0};
  const uint32_t rank = CL == 1 ? 0u : cluster_rank();
  PairSync ps{smem_u32(pair_bars), CL == 1 ? 0u : mapa(smem_u32(pair_bars), rank ^ 1u), 0};
  if (threadIdx.x < 64) {
    ones[threadIdx.x] = __float2bfloat16(1.0f);
    fence_proxy_async();
  }
  if (threadIdx.x == 0) {
    for (int k = 0; k < stages; ++k) {
      mbar_init(r.full + 8 * k, 1);
      mbar_init(r.empty + 8 * k, WGS);
    }
    if (CL == 2) {
      mbar_init(ps.bar, 1);
      mbar_init(ps.bar + 8, 1);
    }
    mbar_fence_init();
  }
  if constexpr (CL == 2)
    cluster_sync_all();  // both CTAs' mbarriers are initialised before either arrives on the other's
  else
    __syncthreads();

  const int npairs = ni * nj;
  const int nblk = (npairs + BM - 1) / BM;
  const int per_layer = (W / NT) * (H / KC);  // W chunks of one layer
  const int role = __shfl_sync(0xffffffffu, (int)threadIdx.x / WG_THREADS, 0);  // warp-uniform
  PhaseClock pc;
  pc.start(PH_A0);
  if (role == WGS) {  // the producer warpgroup: one thread streams W
    // in a cluster the producer gives its registers to the consumers (40 and 232 a thread)
    if constexpr (CL == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == WGS * WG_THREADS) {
      // a cluster CTA streams its own pair_halves slice
      const size_t own = (size_t)rank * (L - 1) * per_layer * (CHUNK_BYTES / 2);
      for (int unit = blockIdx.x / CL; unit < B * splits; unit += gridDim.x / CL)  // the consumers' units and blocks
        for (int blk = unit % splits * nblk / splits; blk < (unit % splits + 1) * nblk / splits; ++blk) {
          produce(r, wt_chunks + own, (L - 1) * per_layer, pc, PH_FEED);
          for (int l = L - 1; l >= 1; --l)
            produce(r, w_chunks + own + (size_t)(l - 1) * per_layer * (CHUNK_BYTES / 2), per_layer, pc, PH_FEED);
        }
    }
  } else {
    if constexpr (CL == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    consumer<WGS, CL, DROP>(u, v, s, qa, bs, g, du, dv, ds, dqa, db_part, act, B, b0, ni, nj, H, L, inject, splits,
                            split_stride, nslots, slots, rowscale, ones, r, ps, pc, seed, thr, inv_keep, phases);
  }
}

// out[k] = sum over c = 0..G-1 of part[c * stride + k], in order (CTAs,
// GEMM splits or sample splits).
__global__ void reduce_partials_kernel(const float* __restrict__ part, long long stride, float* __restrict__ out,
                                       int G, long long n) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  float sum = 0.0f;
  for (int c = 0; c < G; ++c) sum += part[(size_t)c * stride + k];
  out[k] = sum;
}

void reduce_partials(const float* part, long long stride, float* out, int G, long long n, cudaStream_t st) {
  reduce_partials_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(part, stride, out, G, n);
}

// dW, a GEMM over the tiles the fused kernel stored: act[0][l-1][block]
// [rank] holds a_{l-1} and act[1][l-1][block][rank] dpre_l, the bm rows of a
// block by the W = H / cl columns of a rank (cl = 2 the ranks of a cluster,
// 1 one CTA), in core-matrix order. CTA (split s, tile t) computes the G_M x
// G_N output tile t of one layer (G_N = 128 * NSUB), dW_l[m0.., n0..] = sum
// over the 64-row chunks of split s (the splits cover all rows, in order)
// of a_{l-1}[:, m0..]^T dpre_l[:, n0..], into part[s] (row-major, L-1 x H x
// H), added onto what part[s] holds when `accumulate` (a later sample group;
// the accumulators start at zero: registers loaded before the first wgmma
// would serialize every wgmma, ptxas C7515): two
// consumer warpgroups of 64 x G_N (NSUB m64n128 accumulators each, both
// operands read MN-major), one producer thread streaming a ring of
// G_STAGES chunks: A by one copy per 8-row group, D by one copy where the
// chunk's rows lie contiguous (G_N = W; 8 copies of 4 KB took a quarter
// longer at H=512), else per 8-row group. t varies
// fastest over the grid, so the CTAs of a split run side by side and the M
// tiles of a layer read the same dpre_l rows together (L2 serves all but
// the first read). The splits are then added in order
// (reduce_partials_kernel): every dW element has one writer per split and
// a fixed order of adds.
constexpr int G_ROWS = 64, G_M = 128, G_STAGES = 4;
constexpr int G_A_BYTES = G_ROWS * G_M * 2;

template <int NSUB>
constexpr size_t gemm_smem() {
  return (size_t)G_STAGES * (G_A_BYTES + G_ROWS * NT * NSUB * 2 + 16);
}

template <int NSUB>
__global__ void __launch_bounds__(2 * WG_THREADS + 32, 1)
dw_gemm_kernel(const bf16* __restrict__ act, float* __restrict__ part, int H, int L, int cl, int bm, long long nb,
               int splits, int accumulate) {
  constexpr int G_N = NT * NSUB;
  constexpr int STAGE = G_A_BYTES + G_ROWS * G_N * 2;
  extern __shared__ __align__(1024) unsigned char smem[];
  const int W = H / cl;
  const size_t tile_el = (size_t)bm * W;  // a stored tile: bm rows x W
  const int cpb = bm / G_ROWS;             // 64-row chunks a block
  const int per_layer = (H / G_M) * (H / G_N);
  const int ntiles = (L - 1) * per_layer;
  const int sp = blockIdx.x / ntiles, t = blockIdx.x % ntiles;
  const int li = t / per_layer, m0 = (t % per_layer) / (H / G_N) * G_M, n0 = t % (H / G_N) * G_N;
  const long long nq = cpb * nb;  // 64-row chunks
  const long long q0 = nq * sp / splits, q1 = nq * (sp + 1) / splits;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + (size_t)G_STAGES * STAGE);
  uint64_t* empty = full + G_STAGES;
  if (threadIdx.x == 0) {
    for (int k = 0; k < G_STAGES; ++k) {
      mbar_init(smem_u32(full + k), 1);
      mbar_init(smem_u32(empty + k), 2);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int role = threadIdx.x / WG_THREADS;
  if (role == 2) {  // the producer
    if (threadIdx.x != 2 * WG_THREADS) return;
    // A: a_{l-1}, stored by rank m0 / W, columns m0 % W ..; D: dpre_l, stored by rank n0 / W, columns n0 % W ..
    const bf16* A = act + ((size_t)li * nb * cl + m0 / W) * tile_el + (m0 % W) / 8 * 64;
    const bf16* D = act + (((size_t)(L - 1) + li) * nb * cl + n0 / W) * tile_el + (n0 % W) / 8 * 64;
    int stage = 0;
    uint32_t parity = 0;
    long long blk = q0 / cpb;  // chunk q = blk * cpb + c
    int c = (int)(q0 % cpb);
    for (long long q = q0; q < q1; ++q) {
      mbar_wait(smem_u32(empty + stage), parity ^ 1);
      const uint32_t bar = smem_u32(full + stage);
      mbar_expect_tx(bar, STAGE);
      const uint32_t dst = smem_u32(smem + (size_t)stage * STAGE);
      const size_t off = (size_t)blk * cl * tile_el + (size_t)c * G_ROWS * W;
      for (int rg = 0; rg < G_ROWS / 8; ++rg)
        bulk_g2s(dst + rg * (G_M / 8) * 128, A + off + (size_t)rg * 8 * W, (G_M / 8) * 128, bar);
      if (G_N == W) {  // the chunk's rows of D are contiguous: one copy
        bulk_g2s(dst + G_A_BYTES, D + off, G_ROWS * G_N * 2, bar);
      } else {
        for (int rg = 0; rg < G_ROWS / 8; ++rg)
          bulk_g2s(dst + G_A_BYTES + rg * (G_N / 8) * 128, D + off + (size_t)rg * 8 * W, (G_N / 8) * 128, bar);
      }
      if (++c == cpb) {
        c = 0;
        ++blk;
      }
      if (++stage == G_STAGES) {
        stage = 0;
        parity ^= 1;
      }
    }
    return;
  }
  const int tid = threadIdx.x - role * WG_THREADS;
  float* out = part + (((size_t)sp * (L - 1) + li) * H + m0 + 64 * role + 16 * (tid >> 5) + ((tid & 31) >> 2)) * H +
               n0 + 2 * (tid & 3);
  float acc[NSUB][NT / 2];
#pragma unroll
  for (int n = 0; n < NSUB; ++n)
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) acc[n][i] = 0.0f;
  int stage = 0, prev = 0;
  uint32_t parity = 0;
  for (long long q = q0; q < q1; ++q) {
    mbar_wait(smem_u32(full + stage), parity);
    const uint32_t a = smem_u32(smem + (size_t)stage * STAGE) + role * 8 * 128;  // the warpgroup's 64 m
    const uint32_t d = smem_u32(smem + (size_t)stage * STAGE + G_A_BYTES);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < G_ROWS / 16; ++ks) {
      const uint64_t da = desc(a + ks * 32 * G_M, 16 * G_M, 128);
#pragma unroll
      for (int n = 0; n < NSUB; ++n)
        wgmma_m64n128<1, 1>(acc[n], da, desc(d + n * (NT / 8) * 128 + ks * 32 * G_N, 16 * G_N, 128), 1);
    }
    wgmma_commit();
    if (q > q0) {
      wgmma_wait<1>();
      if (tid == 0) mbar_arrive(smem_u32(empty + prev));
    }
    prev = stage;
    if (++stage == G_STAGES) {
      stage = 0;
      parity ^= 1;
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int n = 0; n < NSUB; ++n)
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) keep(acc[n][i]);
#pragma unroll
  for (int n = 0; n < NSUB; ++n)
#pragma unroll
    for (int j = 0; j < NT / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float2* o = reinterpret_cast<float2*>(out + (size_t)8 * h * H + 8 * j + n * NT);
        float2 v = make_float2(acc[n][4 * j + 2 * h], acc[n][4 * j + 2 * h + 1]);
        if (accumulate) {  // the earlier groups' sum of this split, plus this group's
          const float2 was = *o;
          v.x += was.x;
          v.y += was.y;
        }
        *o = v;
      }
}

// dw_gemm_kernel<NSUB> over `splits` splits of nb stored blocks of bm rows.
template <int NSUB>
cudaError_t launch_gemm(const bf16* act, float* part, int H, int L, int cl, int bm, long long nb, int splits,
                        int accumulate, cudaStream_t st) {
  static size_t allowed = 0;
  cudaError_t err = raise_smem_limit(dw_gemm_kernel<NSUB>, gemm_smem<NSUB>(), allowed);
  if (err != cudaSuccess) return err;
  const int ntiles = (L - 1) * (H / G_M) * (H / (NT * NSUB));
  dw_gemm_kernel<NSUB><<<(unsigned)(splits * ntiles), 2 * WG_THREADS + 32, gemm_smem<NSUB>(), st>>>(
      act, part, H, L, cl, bm, nb, splits, accumulate);
  return cudaGetLastError();
}

struct Args {
  const bf16 *u, *v, *s, *qa, *wt, *w, *bs;
  const float* g;
  float *du, *dv, *ds, *dqa, *db_part;  // du .. dqa: the group's rows of split 0's slice
  bf16* act;
  int B, b0, ni, nj, H, L, inject, splits;  // B: the group's samples, b0 its first in the batch
  long long split_stride;
  int slots, stages;
  const int64_t* seed;
  uint32_t thr;
  float inv_keep;
  long long* phases;
};

template <int WGS, int CL, bool DROP>
cudaError_t launch(const Args& a, int grid, size_t smem, cudaStream_t st) {
  auto kern = pairwise_bwd_kernel<WGS, CL, DROP>;
  static size_t allowed = 0;
  cudaError_t err = raise_smem_limit(kern, smem, allowed);
  if (err != cudaSuccess) return err;
  return launch_cluster(kern, grid, (WGS + 1) * WG_THREADS, smem, st, CL, a.u, a.v, a.s, a.qa, a.wt, a.w, a.bs, a.g,
                        a.du, a.dv, a.ds, a.dqa, a.db_part, a.act, a.B, a.b0, a.ni, a.nj, a.H, a.L, a.inject,
                        a.splits, a.split_stride, a.slots, a.stages, a.seed, a.thr, a.inv_keep, a.phases);
}

template <bool DROP>
cudaError_t dispatch(const Args& a, int wgs, int cl, int grid, size_t smem, cudaStream_t st) {
  if (cl == 2) return launch<2, 2, DROP>(a, grid, smem, st);
  return wgs == 2 ? launch<2, 1, DROP>(a, grid, smem, st) : launch<1, 1, DROP>(a, grid, smem, st);
}

}  // namespace

extern "C" {

// Launches the backward of the samples b0 .. b0 + group - 1 of a batch of B
// (one sample group of kernels/pairwise.py::bwd_groups) on `stream` for
// their tile plan (wgs, slots, stages, grid, cluster, splits, smem) of
// kernels/pairwise.py::tile_plan: the fused kernel, then (splits > 1) the
// ordered sum of the sample splits' slices of du, dv, ds, dqa, then
// dw_gemm_kernel over `dw_splits` splits of the group's rows, each split's
// sum added onto its partial of the groups before (b0 > 0); after the last group (b0 +
// group == B), the ordered sums of the dW and db partials. Returns
// cudaErrorInvalidValue for a plan it cannot take. Device pointers to
// contiguous tensors of the whole batch: u (B,ni,H), v (B,nj,H), s, qa (B,H),
// bs (L-1,H) in bf16; wt_chunks = pack_weight_chunks(W^T), w_chunks =
// pack_weight_chunks(W) (cluster 2: of each CTA's pair_halves slice, rank
// after rank); g (B,H) fp32; outputs grads, fp32 zero, du (B,ni,H) | dv
// (B,nj,H) | ds (B,H) | dqa (B,H) in one buffer, dws (L-1,H,H), dbs (L-1,H)
// fp32; grad_part (splits, the group's du | dv | ds | dqa) fp32 zero when
// splits > 1, else null; db_part (db_rows >= every group's grid, L-1, H)
// fp32 zero before the first group; dw_part (dw_splits, L-1, H, H) fp32;
// act (2, L-1, group * nblk, cluster, 64 * wgs * H / cluster) bf16 for the
// stored tiles; phases (grid, 9) int64 or null. Pair dropout as in
// rnet_pairwise_fwd. Returns cudaGetLastError().
int rnet_pairwise_bwd(const void* u, const void* v, const void* s, const void* qa, const void* wt_chunks,
                      const void* w_chunks, const void* bs, const void* g, void* grads, void* grad_part, void* dws,
                      void* dbs, void* dw_part, void* db_part, void* act, int B, int b0, int group, int ni, int nj,
                      int H, int L, int inject, int wgs, int slots, int stages, int grid, int cluster, int dw_splits,
                      int db_rows, int splits, long long smem, int drop, const void* seed, unsigned int thr,
                      float inv_keep, void* phases, void* stream) {
  // a cluster of 2: two warpgroups on the NT columns each of a CTA's H / 2, one sample a unit
  const bool pair_ok = cluster == 2 && wgs == 2 && H == 2 * NT * 2 && grid % 2 == 0 && splits == 1;
  if ((wgs != 1 && wgs != 2) || H % NT != 0 || L < 2 || (cluster != 1 && !pair_ok) ||
      slots < (L - 1 > 3 ? L - 1 : 3) || stages < 3 || grid < 1 || splits < 1 || act == nullptr || dw_splits < 1 ||
      db_rows < grid || b0 < 0 || group < 1 || b0 + group > B || (splits > 1) != (grad_part != nullptr) ||
      smem != (long long)smem_bytes(64 * wgs, H / cluster, slots, stages, cluster))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the group's rows of du | dv | ds | dqa in grads, and their sizes
  float* const gr = static_cast<float*>(grads);
  float* const rows[4] = {gr + (size_t)b0 * ni * H, gr + ((size_t)B * ni + (size_t)b0 * nj) * H,
                          gr + ((size_t)B * (ni + nj) + b0) * H, gr + ((size_t)B * (ni + nj + 1) + b0) * H};
  const long long n[4] = {(long long)group * ni * H, (long long)group * nj * H, (long long)group * H,
                          (long long)group * H};
  const long long ngrad = n[0] + n[1] + n[2] + n[3];
  float* part = static_cast<float*>(grad_part);  // split slices: the group's du | dv | ds | dqa
  float* du = splits > 1 ? part : rows[0];
  float* dv = splits > 1 ? du + n[0] : rows[1];
  float* ds = splits > 1 ? dv + n[1] : rows[2];
  float* dqa = splits > 1 ? ds + n[2] : rows[3];
  const size_t o = (size_t)b0 * H;
  Args a{static_cast<const bf16*>(u) + o * ni, static_cast<const bf16*>(v) + o * nj, static_cast<const bf16*>(s) + o,
         static_cast<const bf16*>(qa) + o, static_cast<const bf16*>(wt_chunks), static_cast<const bf16*>(w_chunks),
         static_cast<const bf16*>(bs), static_cast<const float*>(g) + o, du, dv, ds, dqa,
         static_cast<float*>(db_part), static_cast<bf16*>(act), group, b0, ni, nj, H, L, inject, splits,
         splits > 1 ? ngrad : 0, slots, stages, static_cast<const int64_t*>(seed), thr, inv_keep,
         static_cast<long long*>(phases)};
  cudaError_t err = drop ? dispatch<true>(a, wgs, cluster, grid, (size_t)smem, st)
                         : dispatch<false>(a, wgs, cluster, grid, (size_t)smem, st);
  if (err != cudaSuccess) return (int)err;
  if (splits > 1) {  // the slices are laid out as the batch's rows when the group is the batch
    if (group == B) {
      reduce_partials(part, ngrad, gr, splits, ngrad, st);
    } else {
      long long at = 0;
      for (int k = 0; k < 4; at += n[k++]) reduce_partials(part + at, ngrad, rows[k], splits, n[k], st);
    }
  }
  const int bm = 64 * wgs;
  const long long blocks = (long long)group * ((ni * nj + bm - 1) / bm);
  float* dwp = static_cast<float*>(dw_part);
  err = H % (2 * NT) == 0 ? launch_gemm<2>(a.act, dwp, H, L, cluster, bm, blocks, dw_splits, b0 > 0, st)
                          : launch_gemm<1>(a.act, dwp, H, L, cluster, bm, blocks, dw_splits, b0 > 0, st);
  if (err != cudaSuccess) return (int)err;
  if (b0 + group == B) {
    const long long nw = (long long)(L - 1) * H * H, nbias = (long long)(L - 1) * H;
    reduce_partials(dwp, nw, static_cast<float*>(dws), dw_splits, nw, st);
    reduce_partials(a.db_part, nbias, static_cast<float*>(dbs), db_rows, nbias, st);
  }
  return (int)cudaGetLastError();
}

const char* rnet_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
