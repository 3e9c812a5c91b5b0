// Device code shared by the pairwise g_theta kernels for Hopper (sm_90a):
// pairwise_fwd.cu (replaces rnet/kernels/pairwise.py::_fwd_kernel, :83) and
// pairwise_bwd.cu (replaces ::_bwd_kernel, :120). Both run the chain
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
// * Products. wgmma m64n128k16 from shared memory, fp32 accumulators in
//   registers (64 a thread); one commit group per chunk, the previous chunk
//   released as soon as wait_group<1> says it was read. The chain's
//   accumulators start at the bias (+ qa), so the epilogue is relu, round,
//   store.
// * Epilogues run on the accumulator fragment (frag_base, frag_col) at the
//   reference's rounding points and write bf16 pairs straight into the
//   core-matrix tile, two row pointers and immediate offsets a thread.
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
constexpr int NPHASE = 8;

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

// An L2 policy that evicts the lines it touches first: for data streamed
// once per pass (the dW partials), so that it does not push out what is
// reused (the packed W chunks, du / dv of the sample in hand).
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
// `tile`, by `nthr` threads numbered `tid`. A thread keeps one 16-byte
// column chunk (s loaded once) and walks rows `step` apart, stepping (i, j)
// without a division; it starts the u and v loads of A0_BATCH rows before
// it computes any of them, since each is an L2 round trip.
constexpr int A0_BATCH = 4;

__device__ __forceinline__ void make_a0(const bf16* __restrict__ u, const bf16* __restrict__ v,
                                        const bf16* __restrict__ s, bf16* tile, int b, int p0, int r0,
                                        int nrows, int valid, int ni, int nj, int H, int tid, int nthr) {
  const int vec = H / 8;
  const int step = nthr / vec;
  if (tid >= step * vec) return;
  const int c8 = (tid % vec) * 8;
  const uint4 ss = *reinterpret_cast<const uint4*>(s + (size_t)b * H + c8);
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
      *reinterpret_cast<uint4*>(tile + core_off(rk, c8, H)) = packed;
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
__device__ __forceinline__ void produce(Ring& r, const bf16* __restrict__ src, int n, PhaseClock& pc,
                                        int wait_phase) {
  for (int k = 0; k < n; ++k) {
    const int was = pc.mark(wait_phase);
    mbar_wait(r.empty + 8 * r.stage, r.parity ^ 1);
    pc.mark(was);
    mbar_expect_tx(r.full + 8 * r.stage, CHUNK_BYTES);
    bulk_g2s(r.buf + r.stage * CHUNK_BYTES, src + (size_t)k * (CHUNK_BYTES / 2), CHUNK_BYTES,
             r.full + 8 * r.stage);
    r.advance();
  }
}

// acc += A . B over depth H for one NT-column output tile (acc comes in
// holding the bias, so that the epilogue has less to do), where A is the
// warpgroup's 64-row core-matrix tile at shared address a_addr (width H)
// and B streams through the ring as H / KC chunks (packed K-major: NT rows
// of B^T, KC columns). `lead` (one thread of the warpgroup) releases each
// stage once the warpgroup's wgmma has read it.
__device__ __forceinline__ void streamed_product(float (&acc)[NT / 2], uint32_t a_addr, int H, Ring& r, bool lead,
                                                 PhaseClock& pc, int wait_phase) {
  const int nk = H / KC;
  int prev = 0;
  wgmma_fence();
  for (int kc = 0; kc < nk; ++kc) {
    const int was = pc.mark(wait_phase);
    mbar_wait(r.full + 8 * r.stage, r.parity);
    pc.mark(was);
    const uint32_t b = r.buf + r.stage * CHUNK_BYTES;
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks)
      wgmma_m64n128<0, 0>(acc, desc(a_addr + (kc * (KC / 8) + 2 * ks) * 128, 128, 16 * H),
                          desc(b + ks * 256, 128, 16 * KC), 1);
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

// acc += A^T . D over `rows` (a multiple of 16) tile rows: the 64 x NT block
// of dW = a_{l-1}^T dpre_l whose rows start at column 64*mt of a_{l-1} and
// whose columns start at column NT*nt of dpre_l. Both operands are read
// MN-major from core-matrix tiles of width H.
__device__ __forceinline__ void dw_product(float (&acc)[NT / 2], uint32_t a_tile, uint32_t d_tile, int mt, int nt,
                                           int H, int rows) {
  const uint32_t a0 = a_tile + mt * 8 * 128;
  const uint32_t d0 = d_tile + nt * (NT / 8) * 128;
  const uint32_t kstep = 2 * 16 * H;  // 16 rows = two 8-row groups of 16*H bytes
  wgmma_fence();
  for (int ks = 0; ks < rows / 16; ++ks)
    wgmma_m64n128<1, 1>(acc, desc(a0 + ks * kstep, 16 * H, 128), desc(d0 + ks * kstep, 16 * H, 128), 1);
  wgmma_commit();
  wgmma_wait<0>();
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
