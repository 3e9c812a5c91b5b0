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
// original-fp B=512 at 989 TFLOP/s bf16; 3.34 ms at wide-fp's H=512)
// against a few MB of inputs; at BM=128 rows a CTA also reads 2 B of W
// from L2 per 256 FLOPs. The earlier kernel (one CTA of 64 rows per sample
// and block, W loaded synchronously by every CTA, wmma) spent two fifths
// of its time waiting on W and in its epilogues.
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
//
// H = 512 (wide-fp, the SD models): clusters of two CTAs (CL = 2). One CTA
// on all 512 columns could keep only one warpgroup's 64-row ping-pong
// slots (two warpgroups' would take 256 KB), so every 64-row block read
// all of W (1.5 MB at L=4: 49 GB from L2 at wide-fp B=512) and a_0, the
// epilogues and the pool of one warpgroup ran with nothing beside them
// (together a third of its cycles, as many as its W feed waits).
//   * The two CTAs of a cluster, on neighbouring SMs, take the same tile
//     of BM = 128 rows (64 at serving buckets whose 128-row tiles would
//     not give every cluster one) and split the output columns: rank c
//     computes the columns c*256 .. c*256 + 255 of every layer and keeps
//     only those of each slot. The pair reads half the W bytes per row
//     (25.8 GB at wide-fp B=512).
//   * Inside a CTA the two consumer warpgroups split the CTA's columns:
//     warpgroup w computes the NT columns w*NT .. of all BM rows, two
//     m64n128 products (MH = BM / 64 row halves) on every W chunk, and
//     reads its chunks from a ring of its own (stages / 2 chunks), filled
//     by its own producer thread. So every chunk has one reader and serves
//     BM rows (a first design, two warpgroups on 64 rows each reading
//     every chunk of one ring, ran slower: the slower one gated the feed).
//   * The depth of every product is all 512: the CTA's own 256 columns of
//     A from its slot by descriptor, the peer's 256 from the peer's slot
//     through distributed shared memory into wgmma A fragments, two chunks
//     ahead (pair_product_rows). Each CTA streams only its 256 rows of
//     W_l^T, its own depth first (kernels/pairwise.py::pair_halves).
//   * Syncs (PairSync: mbarriers the peer arrives on remotely), one after
//     a_0 and one after each layer's stores but the last: after it the
//     peer has stored the layer (this CTA may read it) and has finished the
//     products that read the slot this CTA writes next. A tile's a_0 goes
//     to the slot its predecessor's last layer did not read, so no sync is
//     needed between tiles; one more before the CTA exits.
//   * Shared memory at L=4, BM = 128: two slots of 128 x 256 bf16
//     (131,072 B), an 8-chunk ring in two halves (65,664 B), two copies of
//     the row scales (1,024 B), the biases of the CTA's columns (3,072 B),
//     a row of NT column sums per warp (4,096 B), two pair mbarriers (16
//     B): 204,944 B of the 232,448. The consumers take 232 registers, the
//     producer warpgroup 40 (setmaxnreg).
//   * ptxas serializes every wgmma of a kernel (note C7520) if it cannot
//     see that a warpgroup's index is warp-uniform (it comes from a
//     __shfl_sync here), or (the one-CTA kernel) over an integer division
//     or a nested loop in the bias prologue.
// With -DRNET_PHASE_TIMES the first consumer thread of each CTA sums
// clock64() per phase (products, epilogues, pool, feed waits, a_0,
// warpgroup barriers, the pair's waits) into `phases` (grid, NPHASE).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "pairwise_chain.cuh"
#include "smem_limit.cuh"
#include "philox.cuh"

namespace {

using namespace rnet;

enum { PH_PRODUCTS, PH_EPILOGUES, PH_POOL, PH_FEED, PH_A0, PH_SYNC, PH_PAIR };

// Shared memory: two activation slots (bm rows x the CTA's W columns), the
// W ring and its mbarriers, the per-row scale (in a cluster one copy per
// consumer warpgroup), the CTA's biases in fp32, column sums (one row of W
// per warp; in a cluster one row of NT per warp) and, in a cluster, the two
// mbarriers of the pair barrier (PairSync).
size_t smem_bytes(int bm, int W, int L, int stages, int cl) {
  const size_t scales = cl > 1 ? 2 * bm : bm, sums = cl > 1 ? 8 * NT : (size_t)(bm / 16) * W;
  return 2 * (size_t)bm * W * sizeof(bf16) + (size_t)stages * (CHUNK_BYTES + 16) + scales * sizeof(float) +
         (size_t)(L - 1) * W * sizeof(float) + sums * sizeof(float) + (cl > 1 ? 16 : 0);
}

// The consumers of a cluster CTA (CL = 2) of rank c: columns c0 = c W .. c0
// + W - 1 (W = H / 2 = PW) of BM-row blocks. Consumer warpgroup wg owns
// the output columns wg NT .. of every layer for all BM rows (MH = BM / 64
// wgmma row halves on each W chunk; `wg` warp-uniform, as ptxas must see it
// to keep the wgmma asynchronous) and reads their W chunks from its own
// ring `r`, which producer thread wg fills. Both CTAs walk the same tiles
// t = q, q + G / 2, ... (cluster q of G / 2).
template <int BM, bool DROP>
__device__ __forceinline__ void cluster_consumer(const bf16* __restrict__ u, const bf16* __restrict__ v,
                                                 const bf16* __restrict__ s, const bf16* __restrict__ qa,
                                                 float* __restrict__ partial, int B, int ni, int nj, int H, int L,
                                                 int inject, int wg, bf16* slot0, bf16* slot1, float* rowscale,
                                                 const float* biasf, float* colsum, Ring& r, PairSync& ps,
                                                 PhaseClock& pc, const int64_t* __restrict__ seed, uint32_t thr,
                                                 float inv_keep, long long* phases) {
  constexpr int MH = BM / 64, NC = 2 * WG_THREADS, W = PW;
  const uint32_t rank = cluster_rank();
  const int c0 = (int)rank * W;
  const int tid = threadIdx.x - wg * WG_THREADS;
  const int warp = threadIdx.x / 32;
  const int nt = wg;                  // this warpgroup's output column tile of the CTA's W
  float* scale = rowscale + wg * BM;  // this warpgroup's copy of the row scales
  const int frow = 16 * (warp % 4) + (tid & 31) / 4;  // the thread's first fragment row in each row half
  const uint64_t key = DROP ? (uint64_t)*seed : 0;
  const uint32_t peer_slot0 = mapa(smem_u32(slot0), rank ^ 1u);
  const int npairs = ni * nj;
  const int nblk = (npairs + BM - 1) / BM;
  const int ntiles = B * nblk;
  auto sync = [&]() {  // what every consumer of both CTAs stored is complete
    pc.mark(PH_SYNC);
    fence_proxy_async();
    ps.sync(NC, threadIdx.x == 0, pc, PH_PAIR);
  };
  // the slots ping-pong across layers and tiles: a tile's a_0 goes to the
  // slot its predecessor's last layer did not read
  bf16* cur = slot1;
  bf16* nxt = slot0;
  for (int t = blockIdx.x / 2; t < ntiles; t += gridDim.x / 2) {
    const int b = t / nblk;
    const int p0 = (t % nblk) * BM;
    const int valid = min(BM, npairs - p0);
    pc.mark(PH_A0);
    if (tid < BM) {  // 1, or under pair dropout 1/keep or 0; 0 past the valid rows
      float sc = tid < valid ? 1.0f : 0.0f;
      if (DROP && tid < valid) sc = pair_kept(key, p0 + tid, b, thr) ? inv_keep : 0.0f;
      scale[tid] = sc;
    }
    make_a0(u, v, s, nxt, b, p0, wg * (BM / 2), BM / 2, valid, ni, nj, H, tid, WG_THREADS, W, c0);
    bf16* tmp = cur;
    cur = nxt;
    nxt = tmp;
    sync();

    for (int l = 1; l < L; ++l) {
      // register 4j + 2h + e of acc[m]: row 64m + frow + 8h, column nt*NT +
      // 8j + 2q + e; the accumulator starts as b_l (+ qa) in fp32
      float acc[MH][NT / 2];
      const float* bq = biasf + (size_t)(l - 1) * W + nt * NT + 2 * (tid & 3);
      const bf16* qq = (l == inject) ? qa + (size_t)b * H + c0 + nt * NT + 2 * (tid & 3) : nullptr;
#pragma unroll
      for (int j = 0; j < NT / 8; ++j) {
        float2 bb = *reinterpret_cast<const float2*>(bq + 8 * j);
        if (qq) {
          const float2 q = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(qq + 8 * j));
          bb.x += q.x;
          bb.y += q.y;
        }
#pragma unroll
        for (int m = 0; m < MH; ++m) {
          acc[m][4 * j] = acc[m][4 * j + 2] = bb.x;
          acc[m][4 * j + 1] = acc[m][4 * j + 3] = bb.y;
        }
      }
      pc.mark(PH_PRODUCTS);
      const uint32_t peer = peer_slot0 + (cur == slot0 ? 0u : (uint32_t)(BM * W * 2));
      pair_product_rows<MH>(acc, smem_u32(cur), peer, tid, r, tid == 0, pc, PH_FEED);
      pc.mark(PH_EPILOGUES);
      if (l < L - 1) {
#pragma unroll
        for (int m = 0; m < MH; ++m) {
          bf16* o0 = nxt + frag_base(tid, 64 * m, W) + nt * (NT / 8) * 64;
          bf16* o1 = o0 + 8 * W;
#pragma unroll
          for (int j = 0; j < NT / 8; ++j) {
            *reinterpret_cast<__nv_bfloat162*>(o0 + 64 * j) =
                __floats2bfloat162_rn(fmaxf(acc[m][4 * j], 0.0f), fmaxf(acc[m][4 * j + 1], 0.0f));
            *reinterpret_cast<__nv_bfloat162*>(o1 + 64 * j) =
                __floats2bfloat162_rn(fmaxf(acc[m][4 * j + 2], 0.0f), fmaxf(acc[m][4 * j + 3], 0.0f));
          }
        }
        sync();  // layer l is stored in both CTAs, which are done reading the slot written next
        bf16* tmp2 = cur;
        cur = nxt;
        nxt = tmp2;
        continue;
      }
      // the last layer: the thread's rows of each column times their
      // scales, then the 8 row lanes of each column by a fixed shuffle tree:
      // the column sums of the warp's 16 MH rows
      pc.mark(PH_POOL);
      float pool[NT / 4];
#pragma unroll
      for (int j = 0; j < NT / 4; ++j) pool[j] = 0.0f;
#pragma unroll
      for (int m = 0; m < MH; ++m) {
        const float sc0 = scale[64 * m + frow], sc1 = scale[64 * m + frow + 8];
#pragma unroll
        for (int j = 0; j < NT / 8; ++j) {
          const float2 f0 = __bfloat1622float2(
              __floats2bfloat162_rn(fmaxf(acc[m][4 * j], 0.0f), fmaxf(acc[m][4 * j + 1], 0.0f)));
          const float2 f1 = __bfloat1622float2(
              __floats2bfloat162_rn(fmaxf(acc[m][4 * j + 2], 0.0f), fmaxf(acc[m][4 * j + 3], 0.0f)));
          pool[2 * j] += f0.x * sc0 + f1.x * sc1;
          pool[2 * j + 1] += f0.y * sc0 + f1.y * sc1;
        }
      }
#pragma unroll
      for (int k = 0; k < NT / 4; ++k) {
        float x = pool[k];
        x += __shfl_xor_sync(0xffffffffu, x, 4);
        x += __shfl_xor_sync(0xffffffffu, x, 8);
        x += __shfl_xor_sync(0xffffffffu, x, 16);
        if ((tid & 31) < 4) colsum[(size_t)warp * NT + 8 * (k >> 1) + 2 * (tid & 3) + (k & 1)] = x;
      }
    }

    // ---- the block's pooled rows of this warpgroup's columns: its 4 warps' sums in warp order ----
    pc.mark(PH_SYNC);
    bar_sync(2 + wg, WG_THREADS);
    pc.mark(PH_POOL);
    const float* cs = colsum + (size_t)(4 * wg) * NT + tid;
    partial[(size_t)t * H + c0 + nt * NT + tid] = ((cs[0] + cs[NT]) + cs[2 * NT]) + cs[3 * NT];
    bar_sync(2 + wg, WG_THREADS);  // the sums are read before the next tile's pool writes them
  }
  sync();  // the peer has read the last of this CTA's slots: it may exit
  pc.mark(PH_A0);
  if (threadIdx.x == 0 && phases) pc.store(phases + (size_t)blockIdx.x * NPHASE);
}

// CL = 1: the CTA on all H columns, WGS = BM / 64 consumer warpgroups each
// on its own 64 rows of the block. CL = 2: a cluster CTA on half the columns
// (cluster_consumer), two consumer warpgroups on BM-row blocks.
template <int BM, int CL, bool DROP>
__global__ void __launch_bounds__(((CL == 1 ? BM / 64 : 2) + 1) * WG_THREADS, 1)
pairwise_fwd_kernel(const bf16* __restrict__ u, const bf16* __restrict__ v, const bf16* __restrict__ s,
                    const bf16* __restrict__ qa, const bf16* __restrict__ chunks, const bf16* __restrict__ bs,
                    float* __restrict__ partial, int B, int ni, int nj, int H, int L, int inject, int stages,
                    const int64_t* __restrict__ seed, uint32_t thr, float inv_keep, long long* phases) {
  constexpr int WGS = CL == 1 ? BM / 64 : 2;  // consumer warpgroups
  const int W = H / CL;                       // the CTA's columns
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* slot0 = reinterpret_cast<bf16*>(smem);
  bf16* slot1 = slot0 + BM * W;
  unsigned char* ring = smem + 2 * (size_t)BM * W * sizeof(bf16);
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + (size_t)stages * CHUNK_BYTES);
  float* rowscale = reinterpret_cast<float*>(bars + 2 * stages);
  float* biasf = rowscale + (CL == 1 ? BM : 2 * BM);  // (L-1, W)
  float* colsum = biasf + (size_t)(L - 1) * W;         // (warps, W), or in a cluster (warps, NT)
  uint64_t* pair_bars = reinterpret_cast<uint64_t*>(colsum + (size_t)(CL == 1 ? (BM / 16) * W : 8 * NT));
  // CL = 1: one ring of `stages` chunks that every consumer warpgroup reads.
  // CL = 2: a ring of stages / 2 chunks per consumer warpgroup (its column
  // tile's chunks), each filled by its own producer thread.
  const int role = __shfl_sync(0xffffffffu, (int)threadIdx.x / WG_THREADS, 0);  // warp-uniform
  const int nring = CL == 1 ? stages : stages / 2;
  const int wr = CL == 1 || role == WGS ? 0 : role;  // the consumer warpgroup's ring (the producer's: below)
  Ring r{smem_u32(ring + (size_t)wr * nring * CHUNK_BYTES), smem_u32(bars + wr * nring),
         smem_u32(bars + stages + wr * nring), nring, 0, 0};
  const uint32_t rank = CL == 1 ? 0u : cluster_rank();
  PairSync ps{smem_u32(pair_bars), CL == 1 ? 0u : mapa(smem_u32(pair_bars), rank ^ 1u), 0};
  if (threadIdx.x == 0) {
    for (int k = 0; k < stages; ++k) {
      mbar_init(smem_u32(bars + k), 1);
      mbar_init(smem_u32(bars + stages + k), CL == 1 ? WGS : 1);  // a cluster CTA's chunks have one reader
    }
    if (CL == 2) {
      mbar_init(ps.bar, 1);
      mbar_init(ps.bar + 8, 1);
    }
    mbar_fence_init();
  }
  // The biases of the CTA's columns. Written so that ptxas keeps the wgmma
  // products asynchronous: an integer division here, or this nested loop
  // at CL = 1, makes it serialize every wgmma of the kernel (note C7520).
  if constexpr (CL == 1) {
    for (int k = threadIdx.x; k < (L - 1) * H; k += blockDim.x) biasf[k] = __bfloat162float(bs[k]);
  } else {
    for (int c = threadIdx.x; c < W; c += blockDim.x)
      for (int l = 0; l < L - 1; ++l) biasf[(size_t)l * W + c] = __bfloat162float(bs[(size_t)l * H + rank * W + c]);
  }
  if constexpr (CL == 2)
    cluster_sync_all();  // both CTAs' mbarriers are initialised before either arrives on the other's
  else
    __syncthreads();

  const int npairs = ni * nj;
  const int nblk = (npairs + BM - 1) / BM;
  const int ntiles = B * nblk;
  PhaseClock pc;
  pc.start(PH_A0);
  if (role == WGS) {  // the producer warpgroup: one thread streams W (in a cluster, one a ring)
    // in a cluster the producer gives its registers to the consumers (40 and 232 a thread)
    if constexpr (CL == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    const int per_tile = (L - 1) * (W / NT) * (H / KC);
    const bf16* own = chunks + (size_t)rank * per_tile * (CHUNK_BYTES / 2);  // a cluster CTA's pair_halves slice
    if constexpr (CL == 1) {
      if (threadIdx.x == WGS * WG_THREADS)
        for (int t = blockIdx.x; t < ntiles; t += gridDim.x) produce(r, own, per_tile, pc, PH_FEED);
    } else {
      const int p = __shfl_sync(0xffffffffu, (int)threadIdx.x / 32, 0) - 4 * WGS;  // warp p's first thread fills ring p
      if (threadIdx.x % 32 == 0 && p < 2) {
        Ring rp{smem_u32(ring + (size_t)p * nring * CHUNK_BYTES), smem_u32(bars + p * nring),
                smem_u32(bars + stages + p * nring), nring, 0, 0};
        const int nk = H / KC;  // chunks of one column tile of a layer: each layer holds tile 0's, then tile 1's
        for (int t = blockIdx.x / 2; t < ntiles; t += gridDim.x / 2)
          for (int l = 0; l < L - 1; ++l)
            produce(rp, own + (size_t)(2 * l + p) * nk * (CHUNK_BYTES / 2), nk, pc, PH_FEED);
      }
    }
  } else if constexpr (CL == 2) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    cluster_consumer<BM, DROP>(u, v, s, qa, partial, B, ni, nj, H, L, inject, role, slot0, slot1, rowscale, biasf,
                               colsum, r, ps, pc, seed, thr, inv_keep, phases);
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
          streamed_product(acc, smem_u32(cur + r0 * H), 2 * H, r, tid == 0, pc, PH_FEED);
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

template <int BM, int CL, bool DROP>
cudaError_t launch(const Args& a, int grid, size_t smem, cudaStream_t st) {
  auto kern = pairwise_fwd_kernel<BM, CL, DROP>;
  static size_t allowed = 0;
  cudaError_t err = raise_smem_limit(kern, smem, allowed);
  if (err != cudaSuccess) return err;
  const int threads = ((CL == 1 ? BM / 64 : 2) + 1) * WG_THREADS;
  return launch_cluster(kern, grid, threads, smem, st, CL, a.u, a.v, a.s, a.qa, a.chunks, a.bs, a.partial, a.B, a.ni,
                        a.nj, a.H, a.L, a.inject, a.stages, a.seed, a.thr, a.inv_keep, a.phases);
}

template <bool DROP>
cudaError_t dispatch(const Args& a, int bm, int cl, int grid, size_t smem, cudaStream_t st) {
  if (cl == 2) return bm == 128 ? launch<128, 2, DROP>(a, grid, smem, st) : launch<64, 2, DROP>(a, grid, smem, st);
  return bm == 128 ? launch<128, 1, DROP>(a, grid, smem, st) : launch<64, 1, DROP>(a, grid, smem, st);
}

}  // namespace

extern "C" {

// Launches the fused kernel and the ordered pool on `stream`, for the tile
// plan (wgs, bm, stages, grid, cluster, smem) of
// kernels/pairwise.py::tile_plan; returns cudaErrorInvalidValue for a plan
// it cannot take: one CTA of wgs warpgroups on blocks of bm = 64 wgs rows,
// or (cluster 2, only at H = 512, an even grid) two CTAs of two warpgroups
// on blocks of bm = 64 or 128 rows, each warpgroup with a ring of stages / 2
// chunks. Device pointers to contiguous tensors:
// u (B,ni,H), v (B,nj,H), s (B,H), qa (B,H), bs (L-1,H) in bf16; chunks =
// pack_weight_chunks(W^T) (cluster 2: of each CTA's pair_halves slice, rank
// after rank); partial (B, nblk*wgs, H) (cluster 2: (B, nblk, H)) and out
// (B,H) fp32; seed (1,) int64, read only when drop != 0 (pair dropout with
// threshold thr and scale inv_keep, philox.cuh); phases (grid, 9) int64 or
// null (read only by a build with -DRNET_PHASE_TIMES). Returns
// cudaGetLastError().
int rnet_pairwise_fwd(const void* u, const void* v, const void* s, const void* qa, const void* chunks,
                      const void* bs, void* partial, void* out, int B, int ni, int nj, int H, int L, int inject,
                      int wgs, int bm, int stages, int grid, int cluster, long long smem, int drop, const void* seed,
                      unsigned int thr, float inv_keep, void* phases, void* stream) {
  const bool one_ok = cluster == 1 && (wgs == 1 || wgs == 2) && bm == 64 * wgs;
  const bool pair_ok = cluster == 2 && wgs == 2 && (bm == 64 || bm == 128) && H == 2 * NT * 2 && grid % 2 == 0 &&
                       stages % 2 == 0 && stages >= 4;
  if (!(one_ok || pair_ok) || H % NT != 0 || L < 2 || stages < 3 || grid < 1 ||
      smem != (long long)smem_bytes(bm, H / cluster, L, stages, cluster))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args a{static_cast<const bf16*>(u), static_cast<const bf16*>(v), static_cast<const bf16*>(s),
         static_cast<const bf16*>(qa), static_cast<const bf16*>(chunks), static_cast<const bf16*>(bs),
         static_cast<float*>(partial), B, ni, nj, H, L, inject, stages, static_cast<const int64_t*>(seed), thr,
         inv_keep, static_cast<long long*>(phases)};
  cudaError_t err = drop ? dispatch<true>(a, bm, cluster, grid, (size_t)smem, st)
                         : dispatch<false>(a, bm, cluster, grid, (size_t)smem, st);
  if (err != cudaSuccess) return (int)err;
  const int nparts = (ni * nj + bm - 1) / bm * (cluster == 2 ? 1 : wgs);
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
