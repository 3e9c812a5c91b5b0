// Fused pairwise g_theta forward and backward in fp32 for Hopper (sm_90a).
//
// Replaces the TPU kernels rnet/kernels/pairwise.py::_fwd_kernel (:83,
// launched by _fwd_pallas, :454) and ::_bwd_kernel (:120, _bwd_pallas, :485)
// for the compute dtype float32 (rnet's kernels compute in their input
// dtype, cdt = u_ref.dtype, :94), pair mask included. The same function as
// pairwise_fwd.cu / pairwise_bwd.cu with no rounding between layers: for
// every pair row p = i*nj + j of sample b
//     a_0 = relu(u_i + v_j + s),  a_l = relu(a_{l-1} W_l + b_l [+ qa at l == inject])
//     out[b] = sum_p m_bp a_{L-1}         (m_bp = 1, or philox.cuh's 1/keep or 0)
// and the backward of that pool for the upstream gradient g[b]:
//     dpre_{L-1} = [a_{L-1} > 0] g m_bp,  dpre_{l-1} = [a_{l-1} > 0] (dpre_l W_l^T)
//     dW_l = sum_p a_{l-1}^T dpre_l,  db_l = sum_p dpre_l,  dqa[b] = sum_p dpre_inject
//     ds[b] = sum_p dpre_0,  du[b,i] = sum_j dpre_0,  dv[b,j] = sum_i dpre_0
// all in fp32. The pair mask is philox.cuh's, keyed by (seed, b, i, j), so
// at equal seeds the fp32 and bf16 kernels drop the same pairs.
//
// Precision. "float32" means fp32, as in rnet's interpret run and the
// port's fp32 xla path (cuBLAS with TF32 off). Every product runs as 3xTF32
// on the tensor cores: x = hi + lo, and a.b = a_lo.b_hi + a_hi.b_lo +
// a_hi.b_hi. W is split by the wrapper (hi = tf32(W) and lo = tf32(W - hi),
// cvt.rna's rounding); activations in registers (split_tf32: hi rounded as
// cvt.rna, lo = x - hi exact, of which the tensor cores read the tf32
// bits). The dropped a_lo.b_lo term and the rounding of lo are below 2^-21
// of |a.b|. The tensor cores' fp32 accumulation truncates, so no long sum
// stays inside them: a chain or d product sums one ring stage of depth (KD
// = 2048 / H = 8) from zero and adds it to its running sum in fp32; a dW
// product sums one block of rows from zero and is added onto the fp32
// partial; db, ds, dqa and the pool add in fp64. Single-pass TF32 is not
// used.
//
// What bounds it: tensor-core operations, three TF32 products per fp32
// product. At original-fp B=512 (n=64, H=256, L=4) the forward's 0.82
// TFLOP are 2.47 TFLOP of TF32, 5.0 ms at 495 TFLOP/s (dense TF32); the
// backward (recompute, d and dW products) three times that. Behind it, the
// W feed: W_l as tf32 hi + lo is 512 KB at H=256, streamed from L2 once per
// block of rows, 48 TF32 FLOPs a byte at 64 rows (at 495 TFLOP/s, 10 TB/s:
// more than L2 gives); and the backward's dW partial, (L-1) H^2 fp32 read
// and written once per block.
//
// Design, for H = 256 (the "ring" kernels: every model of config.json but
// the H=512 ones):
//   * W is split once per call. The wrapper (kernels/pairwise.py::
//     pack_f32_weights) packs each W_l^T (the chain's B operand) and W_l (the
//     d products') as tf32 hi and lo, in 16 KB stages of KD rows of depth x
//     all H output columns (hi, then lo), each in wgmma's K-major
//     no-swizzle core-matrix order. One producer thread streams the stages
//     by cp.async.bulk through an mbarrier ring (pairwise_chain.cuh's Ring
//     and barriers) that runs ahead across layers and blocks.
//   * CTA: two consumer warpgroups and a producer warpgroup, 384 threads;
//     the producer gives up its registers (setmaxnreg: 40 a thread), the
//     consumers take 232.
//   * Chain and d products: tf32 wgmma m64n128k8, A from registers (loaded
//     by ld.shared from the activation tile and split in registers), B = the
//     ring stage's hi or lo (tf32 wgmma reads B K-major only, which the
//     packed W is). A warpgroup keeps a 64-float fp32 running sum per 128
//     output columns and one 64-float stage sum.
//   * Activation tiles: BM x H fp32 in shared memory, core matrices of 8
//     columns x 4 rows (16-byte rows of 4 consecutive pair rows; toff): 4
//     rows of a column are one float4 for the column passes, the dW operands
//     are ldmatrix rows, and the A fragments' M rows are taken in the order
//     2g, 2g + 1 (g = lane / 4), so that each pair is one float2.
//   * Forward: blocks of 128 rows, one tile (128 KB at H=256), each
//     warpgroup on its own 64 rows and all H columns; a warp reads and writes
//     only its own 16 rows, so every layer runs in place with no barrier. A
//     block's column sums (scaled by the row's mask) go to its own partial
//     row, and pool_kernel adds a sample's partials in block order in fp64.
//     The 128-row block halves the W bytes per row of a 64-row one: the
//     forward is bound by the W feed from L2 as much as by the tensor cores.
//   * Backward: blocks of 64 rows, warpgroup w on output columns 128w ..
//     128w + 127 of all 64 rows. A persistent grid walks units u = b*S + k,
//     split k of sample b: its contiguous blocks [k*nblk/S, (k+1)*nblk/S),
//     in order. S = 1 when B >= SMs (min(B, SMs) CTAs, each owning whole
//     samples), else S = SMs / B (at most nblk) and one unit a CTA, so that
//     a small batch still fills the card (kernels/pairwise.py::
//     sample_splits). Tiles hold a_0 ..
//     a_{L-2}; dpre_{L-1} goes to tile 0 (a_0 is rebuilt from u, v, s for
//     layer 1) or, at L = 2, to tile 1; dpre_{l-1} overwrites a_{l-1} in
//     place once dW_l has read it.
//   * dW = a^T dpre reads both activation tiles, and wgmma needs its smem
//     operand as tf32 hi and lo, twice its fp32 size; the backward's three
//     64 KB tiles and two W stages already fill 224 KB of the 227 KB. dW
//     runs on wgmma m64n128k8 all the same: the hi part of B is the
//     dpre tile itself (the tensor cores read the top 19 bits of an fp32
//     value: trunc(x)), and lo = tf32(x - trunc(x)) of 128 dpre columns at a
//     time is staged in the ring's 32 KB, which is free then: the producer
//     waits on an mbarrier (dw_done) before it streams the d product's W.
//     A = a^T from registers (ldmatrix, split in registers). The block's
//     product is summed from zero on the tensor cores and
//     added onto the CTA's fp32 partial, kept in accumulator order
//     (coalesced 16-byte loads and stores, L2 evict-first), its loads
//     issued before the products (the partials of all CTAs, 104 MB at
//     H=256, exceed L2, so they come from device memory every block).
//   * One fixed thread per column adds db_l onto the CTA's fp64 row and ds /
//     dqa onto the split's fp64 sums of the sample, and the block's du / dv
//     contributions into the split's slices by fire-and-forget reductions
//     in row order (one thread's reductions to one address apply in program
//     order). sum_partials and reduce_dw_ring add the partials over the CTAs
//     in CTA order, and (S > 1) the splits' du / dv slices and fp64 ds / dqa
//     sums in split order (fp64 to the end). Every output has one fixed
//     writer and a fixed order of adds: the gradients are bitwise
//     repeatable.
//   * Shared memory (bytes, L=4): forward 1 tile (131,072) + 6 ring stages
//     of 16,400 + the row scales (512) = 229,984; backward 3 tiles (196,608)
//     + 2 stages (32,800) + dw_done (8) + row scales (256) = 229,672; within
//     the 232,448 a CTA may use.
//   * Measured, not kept: CTA pairs (clusters of two) that multicast each W
//     stage into both CTAs, halving the L2 reads, ran slower in both
//     kernels: each stage then waits for the slower CTA of the pair.
//   With -DRNET_PHASE_TIMES the first consumer thread of each CTA sums
//   clock64() cycles per phase into `phases` (grid, 9): kernels/pairwise.py
//   FWD_PHASES / BWD_PHASES.
//
// The backward at H = 512 (wide-fp, the SD models): the ring backward on
// clusters of two CTAs. One fp32 tile of 64 rows x 512 columns is 128 KB,
// so a CTA holding all columns fits neither the ring's tiles nor its dW
// partial flush (rnet's TPU kernel, rnet/kernels/pairwise.py:120, keeps all
// of dW in VMEM). The two CTAs of a cluster share each block of 64 rows
// and split the columns: rank c
// computes columns c*256 .. c*256 + 255 and keeps those of every tile, the
// H = 256 layout above (3 tiles of 64 x 256 fp32 = 196,608 B, 2 stages of
// 16,400, dw_done 8, two pair mbarriers 16, row scales 256: 229,688 B).
// Every product's depth is all 512: its own 256 columns of A from its tile
// (ld.shared), the peer's 256 from the peer's tile through distributed
// shared memory (ld.shared::cluster), one ring stage ahead
// (chain_product_pair); each CTA streams only its 256 columns of W^T and W,
// split into tf32 hi / lo once per call, its own depth first
// (pack_f32_weights of pair_halves). dW_l[:, own columns] takes the rows
// of dW from the peer's a_{l-1} with the words ldmatrix would give
// (dw_wgmma). Its partial, (L-1) x 512 x 256 fp32, is flushed once per 64
// rows: 197 GB at wide-fp B=512. The pair meets (PairSync) where one CTA
// reads what the other wrote or overwrites what it reads; the sums over
// the clusters run in cluster
// order (reduce_dw_ring), db / ds / dqa stay in fp64 with one writer.
//
// The forward at H = 512: the ring forward on clusters of two CTAs. The two
// CTAs of a cluster take the same 128-row block and split the columns:
// rank c computes columns c*256 .. c*256 + 255 and
// keeps those of the block, the H = 256 forward's tile (128 x 256 fp32 =
// 131,072 B), beside 6 ring stages of 16,400 B, two pair mbarriers (16 B)
// and the row scales (512 B): 230,000 B of the 232,448. Each warpgroup
// holds its 64 rows x 256 columns of the layer in registers (two 64-float
// running sums a thread), its depth all 512: its own 256 columns from the
// tile, the peer's 256 through distributed shared memory, one stage ahead
// (chain_product_pair); each CTA streams only its 256 rows of W^T, split
// once per call (pack_f32_weights of pair_halves), its own depth first.
// The tile is updated in place, but the peer's warps read this CTA's
// columns of the same rows, so a layer takes two pair syncs: after the
// products (both CTAs are done reading both tiles; the layer may be
// stored) and after the stores (the layer is complete in both). With one
// tile there is no room for a second (ping-pong would take 128-row tiles
// to 64 and double the W bytes per row). a_0 takes one sync, the next
// block's a_0 waits for the last layer's first one.
//
// The fp32 kernels take H in {256, 512} with L <= 4 (deeper, the
// backward's tiles and two ring stages do not fit); every other shape has
// no plan (kernels/pairwise.py::tile_plan raises).

#include <cuda_runtime.h>
#include <stdint.h>

#include "pairwise_chain.cuh"
#include "smem_limit.cuh"
#include "philox.cuh"

namespace {

// out[b, c] = sum over the blocks k = 0 .. nblk-1 (in order) of partial[b, k, c],
// added in fp64: the addends have one sign, and 16,384 of them (n = 1024)
// added in fp32 would bias the sum by their correlated roundings.
__global__ void pool_kernel(const float* __restrict__ partial, float* __restrict__ out, int nblk, int H, int n) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  const float* p = partial + (size_t)(k / H) * nblk * H + k % H;
  double sum = 0.0;
  for (int q = 0; q < nblk; ++q) sum += p[(size_t)q * H];
  out[k] = (float)sum;
}

// out[k] = sum over c = 0 .. G-1 (in order: CTAs, or sample splits) of part[c, k].
template <typename T>
__global__ void sum_partials_kernel(const T* __restrict__ part, float* __restrict__ out, int G, long long n) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  T sum = 0;
  for (int c = 0; c < G; ++c) sum += part[(size_t)c * n + k];
  out[k] = (float)sum;
}

// ===========================================================================
// The ring kernels (H = 256)
// ===========================================================================

constexpr int STAGE_BYTES = 16384;  // one W stage: KD rows x H columns, hi then lo
constexpr int RING_THREADS = 384;   // two consumer warpgroups and the producer warpgroup
constexpr int CONSUMERS = 256;

// The ring kernels run at H = 256. Rows of a block: the forward keeps one
// tile, 64 rows per warpgroup over all H columns; the backward's max(2, L-1)
// tiles fit 64 rows.
constexpr int RING_H = 256, FWD_BM = 128, BWD_BM = 64;
__host__ __device__ constexpr int ring_kd(int H) { return STAGE_BYTES / 2 / 4 / H; }

// Shared memory of a ring kernel: the tiles, the ring and its barriers, the
// backward's dW barrier, the row scales.
size_t ring_smem_bytes(bool bwd, int bm, int H, int slots, int stages) {
  return (size_t)slots * bm * H * 4 + (size_t)stages * (STAGE_BYTES + 16) + (bwd ? 8 : 0) + (size_t)bm * 4;
}

enum { FP_PRODUCTS, FP_EPILOGUES, FP_POOL, FP_FEED, FP_A0, FP_SYNC, FP_PAIR };
enum { BP_RECOMPUTE, BP_DW, BP_FLUSH, BP_D, BP_COLUMNS, BP_FEED, BP_A0, BP_SYNC, BP_PAIR };

// Offset of (r, c) in a tile of bm rows: core matrices of 8 columns x 4 rows
// (16-byte rows of 4 consecutive pair rows), 4-row groups of a column group
// contiguous.
__device__ __forceinline__ int toff(int r, int c, int bm) {
  return (c >> 3) * (bm * 8) + (r >> 2) * 32 + ((c & 7) << 2) + (r & 3);
}

// x = hi + lo: hi = x rounded to tf32 to nearest, ties away from zero
// (cvt.rna.tf32.f32's rounding, done in integer ops: the conversion runs on
// a quarter-rate pipe), lo = x - hi exactly in fp32, of which the tensor
// cores read the tf32 part.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

using rnet::keep;  // pairwise_chain.cuh: a register live until a wgmma wait

// Register budget of the warpgroups (65,536 a CTA): the producer gives its
// registers up, the consumers take them (2 x 128 x 232 + 128 x 40).
__device__ __forceinline__ void setmaxnreg_dec() { asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n"); }
__device__ __forceinline__ void setmaxnreg_inc() { asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n"); }

// Four 8 x 8 b16 matrices (8 rows of 16 bytes: 8 x 4 fp32) from shared
// memory; lane L gives the address of row L % 8 of matrix L / 8.
__device__ __forceinline__ void ldsm4(uint32_t (&x)[4], const float* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(x[0]), "=r"(x[1]), "=r"(x[2]), "=r"(x[3])
               : "r"(rnet::smem_u32(p)));
}

// d (+)= A . B, m64n128k8 tf32: A (64 x 8) from four registers a thread, B
// (8 x 128) K-major in shared memory. scale_d = 0 starts from zero.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// The producer (one thread): `n` consecutive STAGE_BYTES stages from src.
__device__ __forceinline__ void produce_stages(rnet::Ring& r, const float* __restrict__ src, int n,
                                               rnet::PhaseClock& pc, int wait_phase) {
  const char* p = reinterpret_cast<const char*>(src);
  for (int k = 0; k < n; ++k) {
    const int was = pc.mark(wait_phase);
    rnet::mbar_wait(r.empty + 8 * r.stage, r.parity ^ 1);
    pc.mark(was);
    rnet::mbar_expect_tx(r.full + 8 * r.stage, STAGE_BYTES);
    rnet::bulk_g2s(r.buf + r.stage * STAGE_BYTES, p + (size_t)k * STAGE_BYTES, STAGE_BYTES, r.full + 8 * r.stage);
    r.advance();
  }
}

// total += A . W over all H of depth, for the warpgroup's 64 rows from `row`
// (warp w: rows row + 16w + 2g + h) of the activation tile A, and NTW
// output column tiles of 128, column tiles ct0 .. ct0 + NTW - 1 of every
// ring stage. Each stage (KD of depth) is summed from zero on the tensor
// cores, one column tile at a time, and added onto `total` in fp32; `lead`
// releases each stage once the warpgroup's products have read it. A warp
// reads only its own 16 rows of A.
template <int H, int BM, int NTW>
__device__ __forceinline__ void chain_product(float (&total)[NTW][64], const float* A, int row, int ct0,
                                              rnet::Ring& r, bool lead, rnet::PhaseClock& pc, int wait_phase) {
  constexpr int KD = ring_kd(H), KS = KD / 8;
  constexpr uint32_t LO = (uint32_t)H * KD * 4, SBO = KD / 4 * 128;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = row + 16 * ((threadIdx.x >> 5) & 3) + 2 * g;
  for (int k0 = 0; k0 < H; k0 += KD) {
    uint32_t ah[KS][4], al[KS][4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const float2 x = *reinterpret_cast<const float2*>(A + toff(r0, k0 + 8 * ks + t, BM));
      const float2 y = *reinterpret_cast<const float2*>(A + toff(r0, k0 + 8 * ks + t + 4, BM));
      split_tf32(x.x, ah[ks][0], al[ks][0]);
      split_tf32(x.y, ah[ks][1], al[ks][1]);
      split_tf32(y.x, ah[ks][2], al[ks][2]);
      split_tf32(y.y, ah[ks][3], al[ks][3]);
    }
    const int was = pc.mark(wait_phase);
    rnet::mbar_wait(r.full + 8 * r.stage, r.parity);
    pc.mark(was);
#pragma unroll
    for (int ct = 0; ct < NTW; ++ct) {
      const uint32_t bh = r.buf + r.stage * STAGE_BYTES + (ct0 + ct) * (128 * KD * 4);
      float acc[64];
      rnet::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        wgmma_tf32(acc, al[ks], rnet::desc(bh + ks * 256, 128, SBO), ks);
        wgmma_tf32(acc, ah[ks], rnet::desc(bh + LO + ks * 256, 128, SBO), 1);
        wgmma_tf32(acc, ah[ks], rnet::desc(bh + ks * 256, 128, SBO), 1);
      }
      rnet::wgmma_commit();
#pragma unroll
      for (int i = 0; i < 64; ++i) keep(acc[i]);
      rnet::wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        keep(acc[i]);
        total[ct][i] += acc[i];
      }
    }
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        keep(ah[ks][e]);
        keep(al[ks][e]);
      }
    if (lead) rnet::mbar_arrive(r.empty + 8 * r.stage);
    r.advance();
  }
}

// chain_product for a cluster CTA (NTW column tiles of 128 from ct0 of the
// stage's W): total += A . W over the depth 2W, the first W from the CTA's
// own tile A, the last W from the peer's tile at the shared::cluster address
// peerA (the same rows); the ring's stages come in that order (pair_halves).
// Each stage's fragments load (from shared or distributed shared memory)
// while the previous stage's products run.
template <int W, int BM, int NTW>
__device__ __forceinline__ void chain_product_pair(float (&total)[NTW][64], const float* A, uint32_t peerA, int row,
                                                   int ct0, rnet::Ring& r, bool lead, rnet::PhaseClock& pc,
                                                   int wait_phase) {
  constexpr int KD = ring_kd(W), KS = KD / 8, NS = W / KD;  // NS stages of each half
  constexpr uint32_t LO = (uint32_t)W * KD * 4, SBO = KD / 4 * 128;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = row + 16 * ((threadIdx.x >> 5) & 3) + 2 * g;
  auto load = [&](float2 (&x)[KS][2], int q) {
    const int k0 = (q % NS) * KD;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int o0 = toff(r0, k0 + 8 * ks + t, BM), o1 = toff(r0, k0 + 8 * ks + t + 4, BM);
      if (q < NS) {
        x[ks][0] = *reinterpret_cast<const float2*>(A + o0);
        x[ks][1] = *reinterpret_cast<const float2*>(A + o1);
      } else {
        x[ks][0] = rnet::ld_cluster_f2(peerA + 4u * o0);
        x[ks][1] = rnet::ld_cluster_f2(peerA + 4u * o1);
      }
    }
  };
  float2 cur[KS][2], nxt[KS][2];
  load(cur, 0);
  for (int q = 0; q < 2 * NS; ++q) {
    uint32_t ah[KS][4], al[KS][4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      split_tf32(cur[ks][0].x, ah[ks][0], al[ks][0]);
      split_tf32(cur[ks][0].y, ah[ks][1], al[ks][1]);
      split_tf32(cur[ks][1].x, ah[ks][2], al[ks][2]);
      split_tf32(cur[ks][1].y, ah[ks][3], al[ks][3]);
    }
    if (q + 1 < 2 * NS) load(nxt, q + 1);
    const int was = pc.mark(wait_phase);
    rnet::mbar_wait(r.full + 8 * r.stage, r.parity);
    pc.mark(was);
#pragma unroll
    for (int ct = 0; ct < NTW; ++ct) {
      const uint32_t bh = r.buf + r.stage * STAGE_BYTES + (ct0 + ct) * (128 * KD * 4);
      float acc[64];
      rnet::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        wgmma_tf32(acc, al[ks], rnet::desc(bh + ks * 256, 128, SBO), ks);
        wgmma_tf32(acc, ah[ks], rnet::desc(bh + LO + ks * 256, 128, SBO), 1);
        wgmma_tf32(acc, ah[ks], rnet::desc(bh + ks * 256, 128, SBO), 1);
      }
      rnet::wgmma_commit();
#pragma unroll
      for (int i = 0; i < 64; ++i) keep(acc[i]);
      rnet::wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        keep(acc[i]);
        total[ct][i] += acc[i];
      }
    }
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        keep(ah[ks][e]);
        keep(al[ks][e]);
      }
    if (lead) rnet::mbar_arrive(r.empty + 8 * r.stage);
    r.advance();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      cur[ks][0] = nxt[ks][0];
      cur[ks][1] = nxt[ks][1];
    }
  }
}

// a_0 of rows p0 .. p0 + bm - 1 of sample b into tile X (rows past `valid`
// zero: finite, so that their products are exact zeros downstream). A
// thread takes 4 rows x 4 columns: 16-byte loads of u, v and s, all in
// flight together, and one float4 store per column (4 rows of a column are
// contiguous in the tile). The tile holds the W columns c0 .. c0 + W - 1
// of u, v and s (rows of H).
template <int W, int BM>
__device__ __forceinline__ void ring_a0(float* X, const float* __restrict__ u, const float* __restrict__ v,
                                        const float* __restrict__ s, int b, int ni, int nj, int p0, int valid,
                                        int tid, int H = W, int c0 = 0) {
  constexpr int Q = W / 4;
  u += c0;
  v += c0;
  s += c0;
  for (int q = tid; q < BM / 4 * Q; q += CONSUMERS) {
    const int c = 4 * (q % Q), r = 4 * (q / Q);
    const float4 sv = *reinterpret_cast<const float4*>(s + (size_t)b * H + c);
    int i = (p0 + r) / nj, j = p0 + r - i * nj;
    float4 uu[4], vv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uu[e] = vv[e] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (r + e < valid) {
        uu[e] = *reinterpret_cast<const float4*>(u + ((size_t)b * ni + i) * H + c);
        vv[e] = *reinterpret_cast<const float4*>(v + ((size_t)b * nj + j) * H + c);
      }
      if (++j == nj) {
        j = 0;
        ++i;
      }
    }
    float o[4][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool on = r + e < valid;
      o[0][e] = on ? fmaxf(uu[e].x + vv[e].x + sv.x, 0.0f) : 0.0f;
      o[1][e] = on ? fmaxf(uu[e].y + vv[e].y + sv.y, 0.0f) : 0.0f;
      o[2][e] = on ? fmaxf(uu[e].z + vv[e].z + sv.z, 0.0f) : 0.0f;
      o[3][e] = on ? fmaxf(uu[e].w + vv[e].w + sv.w, 0.0f) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      *reinterpret_cast<float4*>(X + toff(r, c + k, BM)) = make_float4(o[k][0], o[k][1], o[k][2], o[k][3]);
  }
}

template <int BM, bool DROP>
__device__ __forceinline__ void ring_row_scales(float* rowscale, int valid, int p0, int b, uint64_t key,
                                                uint32_t thr, float inv_keep, int tid) {
  for (int r = tid; r < BM; r += CONSUMERS) {
    float m = r < valid ? 1.0f : 0.0f;
    if (DROP && r < valid) m = rnet::pair_kept(key, (uint32_t)(p0 + r), (uint32_t)b, thr) ? inv_keep : 0.0f;
    rowscale[r] = m;
  }
}

// Column c's sum over the tile's bm rows, each times scale[r] (or 1).
template <int BM>
__device__ __forceinline__ float column_sum(const float* T, int c, const float* scale) {
  float sum = 0.0f;
  for (int r = 0; r < BM; r += 4) {
    const float4 x = *reinterpret_cast<const float4*>(T + toff(r, c, BM));
    if (scale)
      sum += x.x * scale[r] + x.y * scale[r + 1] + x.z * scale[r + 2] + x.w * scale[r + 3];
    else
      sum += (x.x + x.y) + (x.z + x.w);
  }
  return sum;
}

// Stores the warpgroup's m64n128 accumulator fragment `x` (transformed by f)
// into tile T at its rows wrow, wrow + 1 (registers 4j + 2h + e: row wrow +
// h, column col0 + 8j + 2t + e): one float2 per column.
template <int BM, typename F>
__device__ __forceinline__ void store_fragment(float* T, int wrow, int col0, const float (&x)[64], F f) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = col0 + 8 * j + 2 * t;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float2* p = reinterpret_cast<float2*>(T + toff(wrow, c + e, BM));
      *p = f(*p, c + e, x[4 * j + e], x[4 * j + 2 + e]);
    }
  }
}

// total = b_l (+ qa at the inject layer) at the thread's columns.
__device__ __forceinline__ void init_bias(float (&total)[64], const float* __restrict__ bias,
                                          const float* __restrict__ q, int col0) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = col0 + 8 * j + 2 * t + e;
      const float x = bias[c] + (q ? q[c] : 0.0f);
      total[4 * j + e] = total[4 * j + 2 + e] = x;
    }
}

// The ring forward. CL = 1: H = 256, the CTA on all columns. CL = 2: H =
// 512, a cluster CTA of rank c on the columns c W .. c W + W - 1 (W = 256)
// of the same 128-row tile as its peer, the peer's half of every product's
// depth read through distributed shared memory.
template <int H, int CL, bool DROP>
__global__ void __launch_bounds__(RING_THREADS, 1)
    pairwise_fwd_f32_ring(const float* __restrict__ u, const float* __restrict__ v, const float* __restrict__ s,
                          const float* __restrict__ qa, const float* __restrict__ chain,
                          const float* __restrict__ bs, float* __restrict__ partial, int B, int ni, int nj, int L,
                          int inject, int stages, const int64_t* __restrict__ seed, uint32_t thr, float inv_keep,
                          long long* phases) {
  constexpr int W = H / CL, BM = FWD_BM, NTW = W / 128, PER_LAYER = H / ring_kd(W);
  constexpr int STAGE_FLOATS = STAGE_BYTES / 4;
  static_assert(W == RING_H, "a CTA keeps the H = 256 kernel's tile");
  extern __shared__ __align__(128) unsigned char smem[];
  float* X = reinterpret_cast<float*>(smem);
  unsigned char* ring = smem + (size_t)BM * W * 4;
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + (size_t)stages * STAGE_BYTES);
  uint64_t* pair_bars = bars + 2 * stages;
  float* rowscale = reinterpret_cast<float*>(pair_bars + (CL > 1 ? 2 : 0));
  rnet::Ring r{rnet::smem_u32(ring), rnet::smem_u32(bars), rnet::smem_u32(bars + stages), stages, 0, 0};
  const uint32_t rank = CL == 1 ? 0u : rnet::cluster_rank();
  rnet::PairSync ps{rnet::smem_u32(pair_bars), CL == 1 ? 0u : rnet::mapa(rnet::smem_u32(pair_bars), rank ^ 1u), 0};
  if (threadIdx.x == 0) {
    for (int k = 0; k < stages; ++k) {
      rnet::mbar_init(r.full + 8 * k, 1);
      rnet::mbar_init(r.empty + 8 * k, 2);
    }
    if (CL == 2) {
      rnet::mbar_init(ps.bar, 1);
      rnet::mbar_init(ps.bar + 8, 1);
    }
    rnet::mbar_fence_init();
  }
  if constexpr (CL == 2)
    rnet::cluster_sync_all();  // both CTAs' mbarriers are initialised before either arrives on the other's
  else
    __syncthreads();
  const int npairs = ni * nj, nblk = (npairs + BM - 1) / BM;
  const long long ntiles = (long long)B * nblk;
  rnet::PhaseClock pc;
  pc.start(FP_A0);
  const int warp = threadIdx.x >> 5;
  if (warp >= CONSUMERS / 32) {  // the producer warpgroup: one thread streams W
    setmaxnreg_dec();
    if (threadIdx.x == CONSUMERS) {
      const size_t own = (size_t)rank * (L - 1) * PER_LAYER * STAGE_FLOATS;  // a cluster CTA's pair_halves slice
      for (long long tile = blockIdx.x / CL; tile < ntiles; tile += gridDim.x / CL)
        produce_stages(r, chain + own, (L - 1) * PER_LAYER, pc, FP_FEED);
    }
    return;
  }
  setmaxnreg_inc();
  const int tid = threadIdx.x, wg = tid >> 7, g = (tid & 31) >> 2;
  const int row = 64 * wg;  // the warpgroup's rows: all W columns of them
  const int wrow = row + 16 * (warp & 3) + 2 * g;
  const int c0 = (int)rank * W;
  const uint32_t peerX = CL == 1 ? 0u : rnet::mapa(rnet::smem_u32(X), rank ^ 1u);
  const uint64_t key = DROP ? (uint64_t)*seed : 0;
  // every consumer of both CTAs has reached this point (CL = 2)
  auto pair_sync = [&]() {
    pc.mark(FP_SYNC);
    ps.sync(CONSUMERS, tid == 0, pc, FP_PAIR);
  };
  for (long long tile = blockIdx.x / CL; tile < ntiles; tile += gridDim.x / CL) {
    const int b = (int)(tile / nblk), blk = (int)(tile % nblk);
    const int p0 = blk * BM, valid = min(BM, npairs - p0);
    pc.mark(FP_SYNC);
    rnet::bar_sync(1, CONSUMERS);  // the previous tile's pool is done with the tile
    pc.mark(FP_A0);
    ring_row_scales<BM, DROP>(rowscale, valid, p0, b, key, thr, inv_keep, tid);
    ring_a0<W, BM>(X, u, v, s, b, ni, nj, p0, valid, tid, H, c0);
    if constexpr (CL == 2) {
      pair_sync();  // a_0 of both CTAs' columns is complete
    } else {
      pc.mark(FP_SYNC);
      rnet::bar_sync(1, CONSUMERS);
    }
    // Layer by layer in place. CL = 1: a warp reads and writes only its own
    // 16 rows, and its products have read them (the wgmma waits) before it
    // writes. CL = 2: the peer's warps read this CTA's columns of the same
    // rows, so the layer stays in registers until both CTAs' products are
    // done, and is complete in both before either reads it.
    for (int l = 1; l < L; ++l) {
      float total[NTW][64];
#pragma unroll
      for (int ct = 0; ct < NTW; ++ct)
        init_bias(total[ct], bs + (size_t)(l - 1) * H + c0, l == inject ? qa + (size_t)b * H + c0 : nullptr,
                  128 * ct);
      pc.mark(FP_PRODUCTS);
      if constexpr (CL == 1)
        chain_product<H, BM, NTW>(total, X, row, 0, r, (tid & 127) == 0, pc, FP_FEED);
      else
        chain_product_pair<W, BM, NTW>(total, X, peerX, row, 0, r, (tid & 127) == 0, pc, FP_FEED);
      if constexpr (CL == 2) pair_sync();  // both CTAs' products have read both tiles
      pc.mark(FP_EPILOGUES);
#pragma unroll
      for (int ct = 0; ct < NTW; ++ct)
        store_fragment<BM>(X, wrow, 128 * ct, total[ct], [](float2, int, float x0, float x1) {
          return make_float2(fmaxf(x0, 0.0f), fmaxf(x1, 0.0f));
        });
      if constexpr (CL == 2)
        if (l < L - 1) pair_sync();  // layer l is stored in both CTAs
    }
    pc.mark(FP_SYNC);
    rnet::bar_sync(1, CONSUMERS);
    pc.mark(FP_POOL);
    for (int c = tid; c < W; c += CONSUMERS)
      partial[((size_t)b * nblk + blk) * H + c0 + c] = column_sum<BM>(X, c, rowscale);
  }
  pc.mark(FP_A0);
  if (tid == 0 && phases) pc.store(phases + (size_t)blockIdx.x * rnet::NPHASE);
}

// lo = tf32(x - trunc(x)) of dpre's columns 128 sl .. 128 sl + 127 (a
// contiguous 128 BM floats of the tile, core-matrix order) into `dst`, in
// the same order: with the tile itself read as tf32 (its top bits: trunc),
// the dW products' B operand in two parts, x = trunc(x) + lo up to 2^-21 |x|.
template <int BM>
__device__ __forceinline__ void stage_lo(float* dst, const float* D, int sl) {
  const float4* src = reinterpret_cast<const float4*>(D + (size_t)sl * 128 * BM);
  float4* out = reinterpret_cast<float4*>(dst);
  auto lo = [](float x) {
    const float d = x - __uint_as_float(__float_as_uint(x) & 0xFFFFE000u);
    return __uint_as_float((__float_as_uint(d) + 0x1000u) & 0xFFFFE000u);
  };
  for (int q = threadIdx.x; q < 32 * BM; q += CONSUMERS) {
    const float4 x = src[q];
    out[q] = make_float4(lo(x.x), lo(x.y), lo(x.z), lo(x.w));
  }
}

// part (the CTA's dW_l partial) += P^T . D for dpre columns 128 sl .. 128 sl
// + 127, on wgmma m64n128k8: warpgroup w takes the 64-row tiles mt = w, w +
// 2, ... of dW (columns 64 mt .. of a_{l-1}); A = P^T from registers
// (ldmatrix, split in registers), B = the tile D itself (its tf32 top bits)
// and the staged lo at `lo_addr`, both K-major (K = the block's rows). The
// block's product is summed from zero on the tensor cores and added onto
// the partial in fp32; the partial tile, in accumulator order (16-byte
// loads and stores, evict-first), loads before the fragments and while the
// products run. A CTA of a cluster (CL = 2) keeps W = H / 2 columns of each
// tile: its dW rows 64 mt .. come from its own tile P where mt falls in its
// rank's half, else from the peer's at the shared::cluster address peerP,
// each lane loading the word ldmatrix would give it; its partial is H x W.
template <int H, int W, int BM>
__device__ __forceinline__ void dw_wgmma(float* __restrict__ part, const float* P, uint32_t peerP, int rank,
                                         const float* D, uint32_t lo_addr, int sl, uint64_t pol,
                                         rnet::PhaseClock& pc) {
  constexpr int KS = BM / 8;
  constexpr uint32_t SBO = BM * 8 * 4;  // bytes between column groups of a tile
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int mat = lane >> 3, rr = lane & 7;
  const uint32_t bh = rnet::smem_u32(D) + sl * 128 * BM * 4;
  for (int mt = wg; mt < H / 64; mt += 2) {
    float4* pt = reinterpret_cast<float4*>(part + (size_t)(mt * (W / 128) + sl) * 8192) + tid;
    float4 old[16];
    pc.mark(BP_FLUSH);
#pragma unroll
    for (int q = 0; q < 16; ++q) old[q] = rnet::ld_stream(pt + 128 * q, pol);
    pc.mark(BP_DW);
    const int mc = 64 * (mt % (W / 64));  // the 64 columns in the tile that holds them
    const bool own = H == W || mt / (W / 64) == rank;
    uint32_t ah[KS][4], al[KS][4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t x[4];
      if (own) {
        ldsm4(x, P + ((mc + 16 * warp) / 8 + (mat & 1)) * (BM * 8) + (2 * ks + (mat >> 1)) * 32 + rr * 4);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          x[i] = rnet::ld_cluster_u32(peerP + 4u * (((mc + 16 * warp) / 8 + (i & 1)) * (BM * 8) +
                                                    (2 * ks + (i >> 1)) * 32 + lane));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(x[e]), ah[ks][e], al[ks][e]);
    }
    float acc[64];
    rnet::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      wgmma_tf32(acc, al[ks], rnet::desc(bh + ks * 256, 128, SBO), ks);
      wgmma_tf32(acc, ah[ks], rnet::desc(lo_addr + ks * 256, 128, SBO), 1);
      wgmma_tf32(acc, ah[ks], rnet::desc(bh + ks * 256, 128, SBO), 1);
    }
    rnet::wgmma_commit();
#pragma unroll
    for (int i = 0; i < 64; ++i) keep(acc[i]);
    rnet::wgmma_wait<0>();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        keep(ah[ks][e]);
        keep(al[ks][e]);
      }
#pragma unroll
    for (int i = 0; i < 64; ++i) keep(acc[i]);
    pc.mark(BP_FLUSH);
#pragma unroll
    for (int q = 0; q < 16; ++q)
      rnet::st_stream(pt + 128 * q,
                      make_float4(old[q].x + acc[4 * q], old[q].y + acc[4 * q + 1], old[q].z + acc[4 * q + 2],
                                  old[q].w + acc[4 * q + 3]),
                      pol);
    pc.mark(BP_DW);
  }
}

template <int H, int CL, bool DROP>
__global__ void __launch_bounds__(RING_THREADS, 1)
    pairwise_bwd_f32_ring(const float* __restrict__ u, const float* __restrict__ v, const float* __restrict__ s,
                          const float* __restrict__ qa, const float* __restrict__ chain,
                          const float* __restrict__ dstages, const float* __restrict__ bs,
                          const float* __restrict__ gup, float* __restrict__ du, float* __restrict__ dv,
                          float* __restrict__ ds, float* __restrict__ dqa, float* __restrict__ dw_part,
                          double* __restrict__ db_part, double* __restrict__ sums, int B, int ni, int nj, int L,
                          int inject, int splits, long long split_stride, int nslots, int stages,
                          const int64_t* __restrict__ seed, uint32_t thr, float inv_keep, long long* phases) {
  // A cluster CTA (CL = 2) keeps W = H / 2 of the columns; the depth of every
  // product is all H, the peer's half read through distributed shared memory.
  constexpr int W = H / CL, BM = BWD_BM, PER_LAYER = H / ring_kd(W), STAGE_FLOATS = STAGE_BYTES / 4;
  static_assert(W / 128 == 2, "two warpgroups, each on 128 of the columns");
  extern __shared__ __align__(128) unsigned char smem[];
  auto slot = [&](int k) { return reinterpret_cast<float*>(smem) + (size_t)k * BM * W; };
  unsigned char* ring = smem + (size_t)nslots * BM * W * 4;
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + (size_t)stages * STAGE_BYTES);
  const uint32_t dw_done = rnet::smem_u32(bars + 2 * stages);  // the dW products are done with the ring's memory
  uint64_t* pair_bars = bars + 2 * stages + 1;
  float* rowscale = reinterpret_cast<float*>(pair_bars + (CL > 1 ? 2 : 0));
  rnet::Ring r{rnet::smem_u32(ring), rnet::smem_u32(bars), rnet::smem_u32(bars + stages), stages, 0, 0};
  const uint32_t rank = CL == 1 ? 0u : rnet::cluster_rank();
  rnet::PairSync ps{rnet::smem_u32(pair_bars), CL == 1 ? 0u : rnet::mapa(rnet::smem_u32(pair_bars), rank ^ 1u), 0};
  if (threadIdx.x == 0) {
    for (int k = 0; k < stages; ++k) {
      rnet::mbar_init(r.full + 8 * k, 1);
      rnet::mbar_init(r.empty + 8 * k, 2);
    }
    rnet::mbar_init(dw_done, 1);
    if (CL == 2) {
      rnet::mbar_init(ps.bar, 1);
      rnet::mbar_init(ps.bar + 8, 1);
    }
    rnet::mbar_fence_init();
  }
  if constexpr (CL == 2)
    rnet::cluster_sync_all();  // both CTAs' mbarriers are initialised before either arrives on the other's
  else
    __syncthreads();
  const int npairs = ni * nj, nblk = (npairs + BM - 1) / BM;
  rnet::PhaseClock pc;
  pc.start(BP_A0);
  const int warp = threadIdx.x >> 5;
  if (warp >= CONSUMERS / 32) {  // the producer warpgroup: the chain's W^T, then the d products' W, per block
    setmaxnreg_dec();
    if (threadIdx.x == CONSUMERS) {
      const size_t own = (size_t)rank * (L - 1) * PER_LAYER * STAGE_FLOATS;  // a cluster CTA's pair_halves slice
      uint32_t dw_parity = 0;
      for (int unit = blockIdx.x / CL; unit < B * splits; unit += gridDim.x / CL)  // the consumers' units and blocks
        for (int blk = unit % splits * nblk / splits; blk < (unit % splits + 1) * nblk / splits; ++blk) {
          produce_stages(r, chain + own, (L - 1) * PER_LAYER, pc, BP_FEED);
          for (int l = L - 1; l >= 1; --l) {
            // the dW products stage their operand in the ring's memory
            const int was = pc.mark(BP_FEED);
            rnet::mbar_wait(dw_done, dw_parity);
            pc.mark(was);
            dw_parity ^= 1;
            produce_stages(r, dstages + own + (size_t)(l - 1) * PER_LAYER * STAGE_FLOATS, PER_LAYER, pc, BP_FEED);
          }
        }
    }
    return;
  }
  setmaxnreg_inc();
  const int tid = threadIdx.x, wg = tid >> 7, g = (tid & 31) >> 2;
  const int row = 0, ct = wg, col0 = 128 * ct;  // all 64 rows, 128 of the columns
  const int wrow = row + 16 * (warp & 3) + 2 * g;
  const bool lead = (tid & 127) == 0;
  const int dtop = (L - 1 < nslots) ? L - 1 : 0;  // the slot of dpre_{L-1}
  const int c0 = (int)rank * W;
  const uint32_t peer_slots = CL == 1 ? 0u : rnet::mapa(rnet::smem_u32(smem), rank ^ 1u);
  auto peer_slot = [&](int k) { return peer_slots + (uint32_t)(k * BM * W * 4); };
  float* dwp = dw_part + (size_t)blockIdx.x * (L - 1) * H * W;
  double* dbp = db_part + (size_t)blockIdx.x * (L - 1) * H;
  const uint64_t key = DROP ? (uint64_t)*seed : 0;
  const uint64_t pol = rnet::l2_evict_first();
  // all consumers of this CTA, and in a cluster of both CTAs
  auto sync = [&](bool pair) {
    pc.mark(BP_SYNC);
    if (CL == 2 && pair)
      ps.sync(CONSUMERS, tid == 0, pc, BP_PAIR);
    else
      rnet::bar_sync(1, CONSUMERS);
  };
  auto product = [&](float (&total)[1][64], const float* A, int k) {  // A = slot(k)
    if constexpr (CL == 1)
      chain_product<H, BM, 1>(total, A, row, ct, r, lead, pc, BP_FEED);
    else
      chain_product_pair<W, BM, 1>(total, A, peer_slot(k), row, ct, r, lead, pc, BP_FEED);
  };
  for (int unit = blockIdx.x / CL; unit < B * splits; unit += gridDim.x / CL) {
    const int b = unit / splits, k = unit - b * splits;  // split k of sample b: its blocks, its slices
    const float* gb = gup + (size_t)b * H + c0;
    float* const du_k = du + (size_t)k * split_stride;
    float* const dv_k = dv + (size_t)k * split_stride;
    double* const sums_k = sums + (size_t)k * 2 * B * H;  // (2, B, H): ds, then dqa
    const int blk1 = (k + 1) * nblk / splits;
    for (int blk = k * nblk / splits; blk < blk1; ++blk) {
      const int p0 = blk * BM, valid = min(BM, npairs - p0);
      const bool last = splits == 1 && blk == blk1 - 1;  // splits > 1: ds, dqa from the sum of the splits' sums
      sync(false);  // the previous block's column pass is done with slot 0
      pc.mark(BP_A0);
      ring_row_scales<BM, DROP>(rowscale, valid, p0, b, key, thr, inv_keep, tid);
      ring_a0<W, BM>(slot(0), u, v, s, b, ni, nj, p0, valid, tid, H, c0);
      sync(true);
      // recompute a_1 .. a_{L-2}; the last layer's epilogue forms dpre_{L-1}
      for (int l = 1; l < L; ++l) {
        float total[1][64];
        init_bias(total[0], bs + (size_t)(l - 1) * H + c0, l == inject ? qa + (size_t)b * H + c0 : nullptr, col0);
        pc.mark(BP_RECOMPUTE);
        product(total, slot(l - 1), l - 1);
        if (l < L - 1) {
          store_fragment<BM>(slot(l), wrow, col0, total[0], [](float2, int, float x0, float x1) {
            return make_float2(fmaxf(x0, 0.0f), fmaxf(x1, 0.0f));
          });
        } else {
          const float sc0 = rowscale[wrow], sc1 = rowscale[wrow + 1];
          store_fragment<BM>(slot(dtop), wrow, col0, total[0], [&](float2, int c, float x0, float x1) {
            return make_float2(x0 > 0.0f ? gb[c] * sc0 : 0.0f, x1 > 0.0f ? gb[c] * sc1 : 0.0f);
          });
        }
        sync(true);
      }
      // backprop: dpre_l in D, a_{l-1} in P
      for (int l = L - 1; l >= 1; --l) {
        const int dk = l == L - 1 ? dtop : l;
        const float* D = slot(dk);
        float* P = slot(l - 1);
        if (l == 1 && dtop == 0) {  // slot 0 held dpre_{L-1}, read for the last time at layer L-1: rebuild a_0
          pc.mark(BP_A0);
          ring_a0<W, BM>(slot(0), u, v, s, b, ni, nj, p0, valid, tid, H, c0);
          sync(true);
        }
        // the ring's memory is free: the producer waits on dw_done before the
        // d product's stages, and every earlier stage has been read
        for (int sl = 0; sl < W / 128; ++sl) {
          pc.mark(BP_SYNC);
          rnet::bar_sync(1, CONSUMERS);  // every product has read the ring's memory (and slice sl - 1's lo)
          pc.mark(BP_DW);
          stage_lo<BM>(reinterpret_cast<float*>(ring), D, sl);
          rnet::fence_proxy_async();
          pc.mark(BP_SYNC);
          rnet::bar_sync(1, CONSUMERS);
          pc.mark(BP_DW);
          dw_wgmma<H, W, BM>(dwp + (size_t)(l - 1) * H * W, P, peer_slot(l - 1), (int)rank, D, rnet::smem_u32(ring),
                             sl, pol, pc);
        }
        pc.mark(BP_FLUSH);
        for (int c = tid; c < W; c += CONSUMERS) {
          const float sum = column_sum<BM>(D, c, nullptr);  // rows past `valid` are 0
          dbp[(size_t)(l - 1) * H + c0 + c] += sum;
          if (l == inject) {
            const double q = sums_k[((size_t)B + b) * H + c0 + c] += sum;
            if (last) dqa[(size_t)b * H + c0 + c] = (float)q;
          }
        }
        sync(true);  // dW_l (both CTAs') has read a_{l-1}: dpre_{l-1} may replace it
        if (tid == 0) rnet::mbar_arrive(dw_done);  // and the ring's memory: the d product's W may come
        float total[1][64];
#pragma unroll
        for (int i = 0; i < 64; ++i) total[0][i] = 0.0f;
        pc.mark(BP_D);
        product(total, D, dk);
        store_fragment<BM>(P, wrow, col0, total[0], [](float2 a, int, float x0, float x1) {
          return make_float2(a.x > 0.0f ? x0 : 0.0f, a.y > 0.0f ? x1 : 0.0f);
        });
        sync(l > 1);  // dpre_{l-1} complete (for the peer's next d product)
      }
      // dpre_0 (slot 0) into ds, du (over j) and dv (over i), one thread a column, row by row
      pc.mark(BP_COLUMNS);
      const float* d0 = slot(0);
      for (int c = tid; c < W; c += CONSUMERS) {
        const int cg = c0 + c;  // the column of du, dv, ds
        float dsum = 0.0f, dui = 0.0f;
        int i = p0 / nj, j = p0 - i * nj, i_cur = i;
        for (int r0 = 0; r0 < valid; r0 += 4) {
          const float4 x4 = *reinterpret_cast<const float4*>(d0 + toff(r0, c, BM));
          const float xs[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (r0 + e >= valid) break;
            if (i != i_cur) {
              atomicAdd(du_k + ((size_t)b * ni + i_cur) * H + cg, dui);
              dui = 0.0f;
              i_cur = i;
            }
            dui += xs[e];
            dsum += xs[e];
            atomicAdd(dv_k + ((size_t)b * nj + j) * H + cg, xs[e]);
            if (++j == nj) {
              j = 0;
              ++i;
            }
          }
        }
        atomicAdd(du_k + ((size_t)b * ni + i_cur) * H + cg, dui);
        const double sd = sums_k[(size_t)b * H + cg] += dsum;
        if (last) ds[(size_t)b * H + cg] = (float)sd;
      }
    }
  }
  if constexpr (CL == 2) sync(true);  // the peer has read the last of this CTA's tiles: it may exit
  pc.mark(BP_A0);
  if (tid == 0 && phases) pc.store(phases + (size_t)blockIdx.x * rnet::NPHASE);
}
// dws[l, m, n] = sum over the clusters q = 0 .. G/CL - 1 (in order) of the
// partial element holding it in CTA q CL + c, c = n / W its rank (W = H /
// CL; dw_wgmma's order): per layer, per 64 x 128 tile (mt, nt) of the CTA's
// H x W, per register group q of 4, per thread t of the warpgroup, 4
// floats; register 4q + e of thread t holds row 64 mt + 16 (t / 32) + (t %
// 32) / 4 + 8 (e / 2), column 128 nt + 8q + 2 (t % 4) + e % 2 of its W. n
// counts the elements of all CL ranks.
__global__ void reduce_dw_ring(const float* __restrict__ part, float* __restrict__ out, int G, int CL, int H,
                               long long n) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  const long long nc = n / CL;
  const int c = (int)(k / nc);
  const long long kc = k % nc;
  float sum = 0.0f;
  for (int p = 0; p < G / CL; ++p) sum += part[((size_t)p * CL + c) * nc + kc];
  const int W = H / CL;
  const long long per = (long long)H * W;
  const int l = (int)(kc / per), kk = (int)(kc % per);
  const int tile = kk / 8192, w = kk % 8192, q = w / 512, t = (w / 4) % 128, e = w % 4;
  const int row = 64 * (tile / (W / 128)) + 16 * (t / 32) + (t % 32) / 4 + 8 * (e / 2);
  const int col = c * W + 128 * (tile % (W / 128)) + 8 * q + 2 * (t % 4) + e % 2;
  out[l * (long long)H * H + (long long)row * H + col] = sum;
}

// ===========================================================================
// Launchers
// ===========================================================================

struct Args {
  const float *u, *v, *s, *qa, *chain, *dst, *bs, *g;
  float *partial, *du, *dv, *ds, *dqa, *dw_part;
  double *db_part, *sums;
  int B, ni, nj, L, inject, slots, stages, cluster, splits;
  long long split_stride;  // between the sample splits' slices of du and dv
  const int64_t* seed;
  uint32_t thr;
  float inv_keep;
  long long* phases;
};

// The ring forward at H = 256 and, on clusters of two CTAs (CL = H / 256),
// at H = 512.
template <int H, bool DROP>
cudaError_t launch_fwd(const Args& a, int grid, size_t smem, cudaStream_t st) {
  constexpr int CL = H / RING_H;
  auto kern = pairwise_fwd_f32_ring<H, CL, DROP>;
  static size_t allowed = 0;
  cudaError_t err = raise_smem_limit(kern, smem, allowed);
  if (err != cudaSuccess) return err;
  return launch_cluster(kern, grid, RING_THREADS, smem, st, CL, a.u, a.v, a.s, a.qa, a.chain, a.bs, a.partial, a.B,
                        a.ni, a.nj, a.L, a.inject, a.stages, a.seed, a.thr, a.inv_keep, a.phases);
}

template <int H, bool DROP>
cudaError_t launch_bwd(const Args& a, int grid, size_t smem, cudaStream_t st) {
  constexpr int CL = H / RING_H;  // H = 512: a cluster of two CTAs
  auto kern = pairwise_bwd_f32_ring<H, CL, DROP>;
  static size_t allowed = 0;
  cudaError_t err = raise_smem_limit(kern, smem, allowed);
  if (err != cudaSuccess) return err;
  return launch_cluster(kern, grid, RING_THREADS, smem, st, CL, a.u, a.v, a.s, a.qa, a.chain, a.dst, a.bs, a.g,
                        a.du, a.dv, a.ds, a.dqa, a.dw_part, a.db_part, a.sums, a.B, a.ni, a.nj, a.L, a.inject,
                        a.splits, a.split_stride, a.slots, a.stages, a.seed, a.thr, a.inv_keep, a.phases);
}

template <bool BWD, int H>
cudaError_t launch(const Args& a, bool drop, int grid, size_t smem, cudaStream_t st) {
  if constexpr (BWD) return drop ? launch_bwd<H, true>(a, grid, smem, st) : launch_bwd<H, false>(a, grid, smem, st);
  else return drop ? launch_fwd<H, true>(a, grid, smem, st) : launch_fwd<H, false>(a, grid, smem, st);
}

template <bool BWD>
cudaError_t dispatch(const Args& a, int H, bool drop, int grid, size_t smem, cudaStream_t st) {
  switch (H) {
    case 256: return launch<BWD, 256>(a, drop, grid, smem, st);
    case 512: return launch<BWD, 512>(a, drop, grid, smem, st);
    default: return cudaErrorInvalidValue;
  }
}

// The plan checks both launchers share: H = 256, blocks of FWD_BM / BWD_BM
// rows, `slots` tiles (1 in the forward, max(2, L-1) in the backward) and
// `stages` >= 2 ring stages; also at H = 512 on clusters of two CTAs (grid
// even), each with the tiles of H = 256 and two more mbarriers.
bool plan_ok(bool bwd, int H, int L, int bm, int slots, int stages, int grid, int cluster, long long smem) {
  if (L < 2 || grid < 1) return false;
  const bool pair = cluster == 2 && H == 2 * RING_H && grid % 2 == 0;
  return (pair || (cluster == 1 && H == RING_H)) && bm == (bwd ? BWD_BM : FWD_BM) && stages >= 2 &&
         slots == (bwd ? (L - 1 > 2 ? L - 1 : 2) : 1) &&
         smem == (long long)ring_smem_bytes(bwd, bm, RING_H, slots, stages) + (pair ? 16 : 0);
}

}  // namespace

extern "C" {

// Launches the fp32 forward on `stream` for the plan (bm, slots, stages,
// grid, cluster, smem) of kernels/pairwise.py::tile_plan("fwd", ...,
// esize=4), then the ordered pool of the per-block partials;
// cudaErrorInvalidValue for a plan it cannot take. Device pointers to
// contiguous fp32 tensors, 16-byte aligned: u (B,ni,H), v (B,nj,H), s, qa
// (B,H), chain = pack_f32_weights(W^T) (with cluster 2, of each CTA's
// pair_halves slice, rank after rank), bs (L-1,H); partial (B, nblk, H)
// scratch; out (B,H). drop != 0 turns on the pair mask of philox.cuh with
// the int64 seed at `seed` (device) and the threshold thr, kept rows scaled
// by inv_keep. phases (grid, 9) int64 or null: the phase-timing build
// writes there. Returns cudaGetLastError().
int rnet_pairwise_fwd_f32(const void* u, const void* v, const void* s, const void* qa, const void* chain,
                          const void* bs, void* partial, void* out, int B, int ni, int nj, int H, int L, int inject,
                          int bm, int slots, int stages, int grid, int cluster, long long smem, int drop,
                          const void* seed, unsigned int thr, float inv_keep, void* phases, void* stream) {
  if (!plan_ok(false, H, L, bm, slots, stages, grid, cluster, smem)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args a{};
  a.u = static_cast<const float*>(u), a.v = static_cast<const float*>(v), a.s = static_cast<const float*>(s);
  a.qa = static_cast<const float*>(qa), a.chain = static_cast<const float*>(chain);
  a.bs = static_cast<const float*>(bs), a.partial = static_cast<float*>(partial);
  a.B = B, a.ni = ni, a.nj = nj, a.L = L, a.inject = inject, a.slots = slots, a.stages = stages;
  a.seed = static_cast<const int64_t*>(seed), a.thr = thr, a.inv_keep = inv_keep;
  a.phases = static_cast<long long*>(phases);
  cudaError_t err = dispatch<false>(a, H, drop != 0, grid, (size_t)smem, st);
  if (err != cudaSuccess) return (int)err;
  const int nblk = (ni * nj + bm - 1) / bm, n = B * H;
  pool_kernel<<<(n + 255) / 256, 256, 0, st>>>(a.partial, static_cast<float*>(out), nblk, H, n);
  return (int)cudaGetLastError();
}

// Launches the fp32 backward on `stream` for the plan of tile_plan("bwd",
// ..., esize=4): the fused kernel, then (splits > 1) the ordered sums of
// the sample splits' du, dv slices and fp64 ds, dqa sums, then those of
// the dW and db partials. Inputs as rnet_pairwise_fwd_f32's, plus dstages
// = pack_f32_weights(W) (the d products' B operand; with cluster 2, chain
// and dstages pack each CTA's pair_halves slice, rank after rank), and g
// (B,H) the upstream gradient; outputs grads, fp32 zero, du (B,ni,H) | dv
// (B,nj,H) | ds (B,H) | dqa (B,H) in one buffer, dws (L-1,H,H), dbs
// (L-1,H) fp32; scratch, zero: grad_part (splits, B*(ni+nj)*H) fp32, the
// splits' du | dv, when splits > 1 (cluster 1 only; else null), dw_part
// (grid,L-1,H,H/cluster) fp32, and in fp64 (the sums over a split's or a
// CTA's blocks: thousands of addends of one sign at n = 1024) db_part
// (grid,L-1,H) and sums (splits,2,B,H), ds and dqa of each split and
// sample. phases as the forward's. Returns cudaGetLastError().
int rnet_pairwise_bwd_f32(const void* u, const void* v, const void* s, const void* qa, const void* chain,
                          const void* dstages, const void* bs, const void* g, void* grads, void* grad_part, void* dws,
                          void* dbs, void* dw_part, void* db_part, void* sums, int B, int ni, int nj, int H, int L,
                          int inject, int bm, int slots, int stages, int grid, int cluster, int splits,
                          long long smem, int drop, const void* seed, unsigned int thr, float inv_keep, void* phases,
                          void* stream) {
  if (!plan_ok(true, H, L, bm, slots, stages, grid, cluster, smem) || splits < 1 || (splits > 1 && cluster != 1) ||
      (splits > 1) != (grad_part != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long nuv = (long long)B * (ni + nj) * H;  // du | dv
  float* du = static_cast<float*>(splits > 1 ? grad_part : grads);
  float* ds = static_cast<float*>(grads) + nuv;
  Args a{};
  a.u = static_cast<const float*>(u), a.v = static_cast<const float*>(v), a.s = static_cast<const float*>(s);
  a.qa = static_cast<const float*>(qa);
  a.chain = static_cast<const float*>(chain), a.dst = static_cast<const float*>(dstages);
  a.bs = static_cast<const float*>(bs), a.g = static_cast<const float*>(g);
  a.du = du, a.dv = du + (size_t)B * ni * H, a.ds = ds, a.dqa = ds + (size_t)B * H;
  a.dw_part = static_cast<float*>(dw_part);
  a.db_part = static_cast<double*>(db_part), a.sums = static_cast<double*>(sums);
  a.B = B, a.ni = ni, a.nj = nj, a.L = L, a.inject = inject, a.slots = slots, a.stages = stages;
  a.cluster = cluster, a.splits = splits, a.split_stride = splits > 1 ? nuv : 0;
  a.seed = static_cast<const int64_t*>(seed), a.thr = thr, a.inv_keep = inv_keep;
  a.phases = static_cast<long long*>(phases);
  cudaError_t err = dispatch<true>(a, H, drop != 0, grid, (size_t)smem, st);
  if (err != cudaSuccess) return (int)err;
  if (splits > 1) {  // with one split the kernel wrote du, dv and, from its last block's fp64 sums, ds and dqa
    const long long nsd = 2LL * B * H;
    sum_partials_kernel<float><<<(unsigned)((nuv + 255) / 256), 256, 0, st>>>(static_cast<const float*>(grad_part),
                                                                             static_cast<float*>(grads), splits, nuv);
    sum_partials_kernel<double><<<(unsigned)((nsd + 255) / 256), 256, 0, st>>>(a.sums, ds, splits, nsd);
  }
  const long long nw = (long long)(L - 1) * H * H, nb = (long long)(L - 1) * H;
  reduce_dw_ring<<<(unsigned)((nw + 255) / 256), 256, 0, st>>>(a.dw_part, static_cast<float*>(dws), grid, cluster, H,
                                                               nw);
  sum_partials_kernel<double><<<(unsigned)((nb + 255) / 256), 256, 0, st>>>(a.db_part, static_cast<float*>(dbs), grid,
                                                                           nb);
  return (int)cudaGetLastError();
}

const char* rnet_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
