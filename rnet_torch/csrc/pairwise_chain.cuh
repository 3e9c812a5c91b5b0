// Device code shared by the pairwise g_theta kernels for Hopper (sm_90a):
// pairwise_fwd.cu (replaces rnet/kernels/pairwise.py::_fwd_kernel, :83),
// pairwise_bwd.cu (replaces ::_bwd_kernel, :120) and, for the W feed and the
// products in int8, pairwise_fwd_int8.cu (::_fwd_kernel_int8, :190). The
// bf16 kernels run the chain
//     a_l = bf16(relu(a_{l-1} W_l + b_l [+ qa]))
// over tiles of 64 pair rows per consumer warpgroup; the backward adds
// dpre_{l-1} = bf16((dpre_l W_l^T) * [a_{l-1} > 0]) and dW_l += a_{l-1}^T dpre_l.
//
// What bounds both kernels on this card is the tensor cores (989 TFLOP/s
// bf16) and, right behind them, feeding W: every 64-row warpgroup tile
// multiplies by all of W_l (128 KB at H=256), so a CTA of two warpgroups
// reads 2 B of W per 256 FLOPs, ~58 GB/s per SM at the bf16 peak, near what
// L2 can give all 132 SMs at once. The pieces here:
//
// * Layout. Every bf16 tile in shared memory is stored in wgmma's
//   no-swizzle "core matrix" layout: 8 rows x 8 columns (128 B) contiguous,
//   core matrices of one 8-row group side by side along the columns
//   (core_off). The same bytes are then a K-major operand (rows = M or N,
//   columns = K: a . W_l, dpre . W_l^T) and an MN-major one (rows = K:
//   a^T . dpre for dW), so no product needs an explicit transpose; only the
//   descriptor's strides and wgmma's transpose bits change.
// * The W feed. The wrapper packs each W_l once per call (W_l^T for the
//   chain, W_l for dpre W_l^T) into 8 KB chunks of (128 output columns x
//   32 depth), each already in core-matrix order, so one 1-D cp.async.bulk
//   moves a chunk (no tensor map). One producer thread keeps a ring of
//   >= 3 chunk stages full; "full" mbarriers complete on the
//   bytes, "empty" ones on one arrival per consumer warpgroup once its
//   wgmma has read the stage. The ring runs on across layers and row
//   tiles, so the next layer's (or tile's) first chunks load during the
//   current epilogue.
//   An int8 core matrix is 8 rows x 16 bytes, the same 128 bytes at twice
//   the depth, so the byte offsets of the feed and the products hold for
//   both element types.
// * Products. wgmma m64n128k16 from shared memory, fp32 accumulators in
//   registers (64 a thread); one commit group per chunk, the previous chunk
//   released as soon as wait_group<1> says it was read. The chain's
//   accumulators start at the bias (+ qa), so the epilogue is relu, round,
//   store.
// * Epilogues run on the accumulator fragment (frag_base, frag_col) at the
//   reference's rounding points and write bf16 pairs straight into the
//   core-matrix tile, two row pointers and immediate offsets a thread.
// * Clusters (the forward and backward at H = 512, bf16 and fp32): the two
//   CTAs of a cluster read each other's activation tiles through
//   distributed shared memory (mapa + ld.shared::cluster) and order their
//   phases with PairSync, mbarriers on which the peer arrives remotely.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace rnet {

using bf16 = __nv_bfloat16;

constexpr int CHUNK_BYTES = 8192;  // one streamed W chunk
constexpr int WG_THREADS = 128;
// Output columns of one wgmma tile (m64n128k16): 64 fp32 accumulators a
// thread. 256-column tiles (128 accumulators) spilled under the 168
// registers a thread of a 384-thread CTA gets.
constexpr int NT = 128;
constexpr int KC = CHUNK_BYTES / 2 / NT;  // depth of a W chunk

// ---------------------------------------------------------------------------
// Phase clock: with -DRNET_PHASE_TIMES, a thread sums clock64() cycles per
// phase (mark(k) closes the current phase and opens k); otherwise nothing.
// ---------------------------------------------------------------------------
constexpr int NPHASE = 9;

struct PhaseClock {
#ifdef RNET_PHASE_TIMES
  long long t[NPHASE];
  long long last;
  int cur;
  __device__ void start(int k) {
#pragma unroll
    for (int i = 0; i < NPHASE; ++i) t[i] = 0;
    last = clock64();
    cur = k;
  }
  __device__ int mark(int k) {
    const long long now = clock64();
    const int was = cur;
    t[was] += now - last;
    last = now;
    cur = k;
    return was;
  }
  __device__ void store(long long* out) const {
    if (out)
      for (int i = 0; i < NPHASE; ++i) out[i] = t[i];
  }
#else
  __device__ void start(int) {}
  __device__ int mark(int) { return 0; }
  __device__ void store(long long*) const {}
#endif
};

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

// Spins until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// 1-D bulk copy global -> shared, completing `bytes` on the mbarrier.
__device__ __forceinline__ void bulk_g2s(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// 1-D bulk copy shared -> global under the L2 policy `pol`, in the issuing
// thread's current bulk group (bulk_commit closes it; bulk_wait_read<N>
// waits until all but the N newest committed groups have read their shared
// memory, bulk_wait_all until every one is written).
__device__ __forceinline__ void bulk_s2g(void* dst, uint32_t src, uint32_t bytes, uint64_t pol) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint [%0], [%1], %2, %3;\n" ::"l"(dst),
               "r"(src), "r"(bytes), "l"(pol)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
template <int N = 0>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void bulk_wait_all() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

// An L2 policy that evicts the lines it touches first: for data streamed
// once per pass (the fp32 dW partials, the bf16 backward's stored tiles),
// so that it does not push out what is reused (the packed W chunks, du / dv
// of the sample in hand).
__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(pol));
  return pol;
}

__device__ __forceinline__ float4 ld_stream(const float4* p, uint64_t pol) {
  float4 v;
  asm volatile("ld.global.L1::no_allocate.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p), "l"(pol));
  return v;
}

__device__ __forceinline__ void st_stream(float4* p, float4 v, uint64_t pol) {
  asm volatile("st.global.L1::no_allocate.L2::cache_hint.v4.f32 [%0], {%1, %2, %3, %4}, %5;\n" ::"l"(p), "f"(v.x),
               "f"(v.y), "f"(v.z), "f"(v.w), "l"(pol)
               : "memory");
}

// Generic-proxy writes to shared memory become visible to wgmma reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Named barrier `id` over `n` threads (the consumer warpgroups only).
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// Clusters of two CTAs: distributed shared memory and the pair barrier
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of the cluster (all threads of both CTAs) meets here.
__device__ __forceinline__ void cluster_sync_all() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The shared::cluster address of shared address `addr` in CTA `rank` of the cluster.
__device__ __forceinline__ uint32_t mapa(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ uint32_t ld_cluster_u32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared::cluster.b32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ float2 ld_cluster_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr) : "memory");
  return v;
}

// Spins until phase `parity` of the local mbarrier has completed, acquiring
// at cluster scope what the remote arrivals released.
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// The pair barrier of a cluster of two CTAs. Each CTA keeps two mbarriers
// (count 1) that its peer arrives on; sync() lets no consumer thread of
// either CTA past until every consumer thread of both has reached it, so
// that what one CTA wrote to its shared memory before sync() is complete
// for the peer's ld.shared::cluster after it, and what the peer read before
// it may be overwritten after it. The two mbarriers alternate, so a peer
// running ahead cannot complete a phase twice before a slow thread sees it.
struct PairSync {
  uint32_t bar;       // this CTA's two mbarriers
  uint32_t peer_bar;  // the peer's (shared::cluster address)
  uint32_t k;         // syncs so far
  // every consumer thread of both CTAs (`nthreads` of each, named barrier 1); `lead`: one of them
  __device__ __forceinline__ void sync(int nthreads, bool lead, PhaseClock& pc, int wait_phase) {
    bar_sync(1, nthreads);
    if (lead) {
      asm volatile("fence.acq_rel.cluster;\n" ::: "memory");
      asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(peer_bar + 8 * (k & 1))
                   : "memory");
    }
    const int was = pc.mark(wait_phase);
    mbar_wait_cluster(bar + 8 * (k & 1), (k >> 1) & 1);
    pc.mark(was);
    ++k;
  }
};

// Shared-memory matrix descriptor, no swizzle: start address, the byte
// stride between core matrices along K (lbo) and along M/N (sbo).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}

// wgmma_m64n128<TA, TB>(d, da, db, scale_d): d (+)= A . B on a 64 x 128 x 16
// step; TA / TB = 1 read A / B MN-major (transposed) from shared memory.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// wgmma_m64n128_ra<TB>(d, a, db, scale_d): d (+)= A . B on a 64 x 128 x 16
// step with A from registers: the warp's 16 rows of the warpgroup's 64, a
// thread (g = lane / 4, t = lane % 4) holding the bf16 pairs at (row, depth)
// (g, 2t), (g + 8, 2t), (g, 2t + 8), (g + 8, 2t + 8); B from shared memory,
// MN-major when TB = 1.
template <int TB>
__device__ __forceinline__ void wgmma_m64n128_ra(float (&d)[64], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
}

// Keeps a register's value live (and in place) up to this point: after a
// wgmma wait, so that the compiler neither reuses an operand register nor
// reads an accumulator before the asynchronous product is done.
__device__ __forceinline__ void keep(float& x) { asm volatile("" : "+f"(x)::"memory"); }
__device__ __forceinline__ void keep(uint32_t& x) { asm volatile("" : "+r"(x)::"memory"); }

// ---------------------------------------------------------------------------
// Layout
// ---------------------------------------------------------------------------

// Element offset of (r, c) in a core-matrix tile of width H.
__device__ __forceinline__ int core_off(int r, int c, int H) {
  return (((r >> 3) * (H >> 3) + (c >> 3)) << 6) + ((r & 7) << 3) + (c & 7);
}

// Column within the 64 x N accumulator tile of register i of thread t
// (0..127) of a warpgroup: registers 4j + 2h + e hold row 16*(t/32) + (t%32)/4
// + 8h and column 8j + 2*(t%4) + e.
__device__ __forceinline__ int frag_col(int t, int i) { return ((i >> 2) << 3) + ((t & 3) << 1) + (i & 1); }

// Element offset, in a core-matrix tile of width H, of register 4j + 2h + e
// of thread t's accumulator fragment for the 64 rows from r0 and the NT
// columns from n0: frag_base(t, r0, H) + h * 8H + (n0 / 8 + j) * 64 + e.
// Epilogues walk j with two row pointers and immediate offsets.
__device__ __forceinline__ int frag_base(int t, int r0, int H) {
  const int row = r0 + ((t >> 5) << 4) + ((t & 31) >> 2);
  return (row >> 3) * (H >> 3) * 64 + (row & 7) * 8 + ((t & 3) << 1);
}

// a_0 = bf16(relu(u_i + v_j + s)) in fp32 for `nrows` rows from pair p0 of
// sample b (rows past `valid` zero), into core-matrix tile rows r0.. of
// `tile`, by `nthr` threads numbered `tid`; the tile holds the W columns
// c0 .. c0 + W - 1 of the H (all of them when W = 0). A thread keeps one 16-byte
// column chunk (s loaded once) and walks rows `step` apart, stepping (i, j)
// without a division; it starts the u and v loads of A0_BATCH rows before
// it computes any of them, since each is an L2 round trip.
constexpr int A0_BATCH = 4;

__device__ __forceinline__ void make_a0(const bf16* __restrict__ u, const bf16* __restrict__ v,
                                        const bf16* __restrict__ s, bf16* tile, int b, int p0, int r0,
                                        int nrows, int valid, int ni, int nj, int H, int tid, int nthr, int W = 0,
                                        int c0 = 0) {
  if (W == 0) W = H;
  const int vec = W / 8;
  const int step = nthr / vec;
  if (tid >= step * vec) return;
  const int c8 = (tid % vec) * 8;
  u += c0;
  v += c0;
  const uint4 ss = *reinterpret_cast<const uint4*>(s + (size_t)b * H + c0 + c8);
  const bf16* ps = reinterpret_cast<const bf16*>(&ss);
  int r = r0 + tid / vec;
  int i = (p0 + r) / nj;
  int j = p0 + r - i * nj;
  for (; r < r0 + nrows; r += A0_BATCH * step) {
    uint4 uu[A0_BATCH], vv[A0_BATCH];
#pragma unroll
    for (int k = 0; k < A0_BATCH; ++k) {
      uu[k] = vv[k] = make_uint4(0u, 0u, 0u, 0u);
      if (r + k * step < min(r0 + nrows, valid)) {
        uu[k] = *reinterpret_cast<const uint4*>(u + ((size_t)b * ni + i) * H + c8);
        vv[k] = *reinterpret_cast<const uint4*>(v + ((size_t)b * nj + j) * H + c8);
      }
      for (j += step; j >= nj; j -= nj) ++i;
    }
#pragma unroll
    for (int k = 0; k < A0_BATCH; ++k) {
      const int rk = r + k * step;
      if (rk >= r0 + nrows) break;
      uint4 packed = make_uint4(0u, 0u, 0u, 0u);
      if (rk < valid) {
        const bf16* pu = reinterpret_cast<const bf16*>(&uu[k]);
        const bf16* pv = reinterpret_cast<const bf16*>(&vv[k]);
        bf16* po = reinterpret_cast<bf16*>(&packed);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float x = __bfloat162float(pu[e]) + __bfloat162float(pv[e]) + __bfloat162float(ps[e]);
          po[e] = __float2bfloat16(fmaxf(x, 0.0f));
        }
      }
      *reinterpret_cast<uint4*>(tile + core_off(rk, c8, W)) = packed;
    }
  }
}

// ---------------------------------------------------------------------------
// The W feed
// ---------------------------------------------------------------------------

// A ring of `stages` chunk buffers with their full / empty mbarriers. The
// producer and every consumer warpgroup walk the same chunk sequence; each
// keeps its own position: the stage and the parity of the stage's use.
struct Ring {
  uint32_t buf;    // shared address of stage 0
  uint32_t full;   // shared address of full[0] (8 B each)
  uint32_t empty;  // shared address of empty[0]
  int stages;
  int stage;
  uint32_t parity;
  __device__ __forceinline__ void advance() {
    if (++stage == stages) {
      stage = 0;
      parity ^= 1;
    }
  }
};

// Producer (one thread): copy `n` consecutive chunks from `src` into the ring.
__device__ __forceinline__ void produce(Ring& r, const void* __restrict__ src, int n, PhaseClock& pc,
                                        int wait_phase) {
  const char* p = static_cast<const char*>(src);
  for (int k = 0; k < n; ++k) {
    const int was = pc.mark(wait_phase);
    mbar_wait(r.empty + 8 * r.stage, r.parity ^ 1);
    pc.mark(was);
    mbar_expect_tx(r.full + 8 * r.stage, CHUNK_BYTES);
    bulk_g2s(r.buf + r.stage * CHUNK_BYTES, p + (size_t)k * CHUNK_BYTES, CHUNK_BYTES, r.full + 8 * r.stage);
    r.advance();
  }
}

// Walk `n` chunks of the ring without reading them: wait for each to land
// and release it (a warpgroup with no tile in a round of the persistent
// loop, so that the stream stays shared).
__device__ __forceinline__ void skip_chunks(Ring& r, int n, bool lead) {
  for (int k = 0; k < n; ++k) {
    if (lead) {
      mbar_wait(r.full + 8 * r.stage, r.parity);
      mbar_arrive(r.empty + 8 * r.stage);
    }
    r.advance();
  }
}

// One 32-byte-deep step of a product from shared memory: bf16 (m64n128k16,
// fp32 accumulators) or int8 (m64n128k32, int32 accumulators; int8 wgmma
// reads both operands K-major only).
__device__ __forceinline__ void wgmma_step(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  wgmma_m64n128<0, 0>(d, da, db, scale_d);
}

__device__ __forceinline__ void wgmma_step(int (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// acc (+)= A . B for one NT-column output tile, where A is the warpgroup's
// 64-row core-matrix tile at shared address a_addr (`row_bytes` bytes of
// depth a row: 2H in bf16, H in int8) and B streams through the ring as
// row_bytes / DEPTH_BYTES chunks (packed K-major: NT rows of B^T). Every
// chunk holds DEPTH_BYTES = 64 bytes of depth a row, four core matrices,
// read as two 32-byte steps, so the byte offsets are the same for both
// element types. The accumulators come in initialised (bf16: the bias;
// int8: 0). `lead` (one thread of the warpgroup) releases each stage once
// the warpgroup's wgmma has read it.
constexpr int DEPTH_BYTES = CHUNK_BYTES / NT;

template <typename Acc>
__device__ __forceinline__ void streamed_product(Acc (&acc)[NT / 2], uint32_t a_addr, int row_bytes, Ring& r,
                                                 bool lead, PhaseClock& pc, int wait_phase) {
  const int nk = row_bytes / DEPTH_BYTES;
  int prev = 0;
  wgmma_fence();
  for (int kc = 0; kc < nk; ++kc) {
    const int was = pc.mark(wait_phase);
    mbar_wait(r.full + 8 * r.stage, r.parity);
    pc.mark(was);
    const uint32_t b = r.buf + r.stage * CHUNK_BYTES;
#pragma unroll
    for (int ks = 0; ks < DEPTH_BYTES / 32; ++ks)
      wgmma_step(acc, desc(a_addr + (kc * (DEPTH_BYTES / 16) + 2 * ks) * 128, 128, 8 * row_bytes),
                 desc(b + ks * 256, 128, 8 * DEPTH_BYTES), 1);
    wgmma_commit();
    if (kc > 0) {
      wgmma_wait<1>();
      if (lead) mbar_arrive(r.empty + 8 * prev);
    }
    prev = r.stage;
    r.advance();
  }
  wgmma_wait<0>();
  if (lead) mbar_arrive(r.empty + 8 * prev);
}

// The width of a cluster CTA (H = 512, clusters of two): its share of the
// columns and of every product's depth.
constexpr int PW = 2 * NT;

// acc[m] (+)= A . B for one NT-column output tile of a cluster CTA and the
// MH 64-row halves m of its block, over the depth 2 PW: the first PW from
// the CTA's own core-matrix tile (the block's rows from a_addr, rows of PW),
// the last PW from the peer's tile at the shared::cluster address `peer`
// (the same rows), read into registers as wgmma A fragments two chunks
// ahead. B streams through the ring as 2 PW / KC chunks in that order
// (pair_halves); every chunk feeds the MH products, so a chunk serves 64 MH
// rows. The peer's chunk c + 2 loads while chunk c's products run.
template <int MH>
__device__ __forceinline__ void pair_product_rows(float (&acc)[MH][NT / 2], uint32_t a_addr, uint32_t peer, int tid,
                                                  Ring& r, bool lead, PhaseClock& pc, int wait_phase) {
  constexpr int NK = PW / KC;  // chunks of each half
  const int warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  constexpr uint32_t HALF = 2u * 64 * PW, ROW8 = 16u * PW;             // bytes: 64 and 8 rows down
  const uint32_t fr = peer + 2u * core_off(16 * warp + g, 2 * t, PW);  // (row g, depth 2t) of the warp's 16 rows
  uint32_t f[3][MH][2][4];  // [chunk % 3][row half][k-step of the chunk][register]
  auto load = [&](uint32_t (&x)[MH][2][4], int c) {  // chunk c of the peer's depth
#pragma unroll
    for (int m = 0; m < MH; ++m)
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const uint32_t a = fr + m * HALF + (uint32_t)(2 * c + ks) * 256;  // 16 of depth: two core matrices
        x[m][ks][0] = ld_cluster_u32(a);
        x[m][ks][1] = ld_cluster_u32(a + ROW8);
        x[m][ks][2] = ld_cluster_u32(a + 128);
        x[m][ks][3] = ld_cluster_u32(a + ROW8 + 128);
      }
  };
  load(f[0], 0);
  load(f[1], 1);
  int prev = 0;
  wgmma_fence();
#pragma unroll 1
  for (int kc = 0; kc < NK; ++kc) {  // the own half: A from shared memory
    const int was = pc.mark(wait_phase);
    mbar_wait(r.full + 8 * r.stage, r.parity);
    pc.mark(was);
    const uint32_t b = r.buf + r.stage * CHUNK_BYTES;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int m = 0; m < MH; ++m)
        wgmma_step(acc[m], desc(a_addr + m * HALF + (kc * (DEPTH_BYTES / 16) + 2 * ks) * 128, 128, 16 * PW),
                   desc(b + ks * 256, 128, 8 * DEPTH_BYTES), 1);
    wgmma_commit();
    if (kc > 0) {
      wgmma_wait<1>();
      if (lead) mbar_arrive(r.empty + 8 * prev);
    }
    prev = r.stage;
    r.advance();
  }
  // the peer's half: chunk c reads f[c % 3]; once its products are issued
  // and chunk c - 1's (which read f[(c + 2) % 3]) are done, chunk c + 2 loads there
#pragma unroll
  for (int c = 0; c < NK; ++c) {
    const int was = pc.mark(wait_phase);
    mbar_wait(r.full + 8 * r.stage, r.parity);
    pc.mark(was);
    const uint32_t b = r.buf + r.stage * CHUNK_BYTES;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int m = 0; m < MH; ++m)
        wgmma_m64n128_ra<0>(acc[m], f[c % 3][m][ks], desc(b + ks * 256, 128, 8 * DEPTH_BYTES), 1);
    wgmma_commit();
    wgmma_wait<1>();
    if (lead) mbar_arrive(r.empty + 8 * prev);
    prev = r.stage;
    r.advance();
    if (c + 2 < NK) {
#pragma unroll
      for (int i = 0; i < 8 * MH; ++i) keep(f[(c + 2) % 3][i / 8][(i / 4) & 1][i & 3]);
      load(f[(c + 2) % 3], c + 2);
    }
  }
  wgmma_wait<0>();
  if (lead) mbar_arrive(r.empty + 8 * prev);
#pragma unroll
  for (int i = 0; i < 24 * MH; ++i) keep(f[i / (8 * MH)][(i / 8) % MH][(i / 4) & 1][i & 3]);
#pragma unroll
  for (int m = 0; m < MH; ++m)
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) keep(acc[m][i]);
}

// acc = 1^T . D over `rows` tile rows for the NT columns from NT*nt of D:
// 64 equal rows of column sums. The all-ones A operand is one 8 x 8 core
// matrix at `ones`, read with both strides 0.
__device__ __forceinline__ void colsum_product(float (&acc)[NT / 2], uint32_t ones, uint32_t d_tile, int nt, int H,
                                               int rows) {
  const uint32_t d0 = d_tile + nt * (NT / 8) * 128;
  const uint32_t kstep = 2 * 16 * H;
  wgmma_fence();
  for (int ks = 0; ks < rows / 16; ++ks)
    wgmma_m64n128<1, 1>(acc, desc(ones, 0, 0), desc(d0 + ks * kstep, 16 * H, 128), ks != 0);
  wgmma_commit();
  wgmma_wait<0>();
}

}  // namespace rnet
