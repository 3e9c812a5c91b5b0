// Int8 pairwise g_theta forward for Hopper (sm_90a): the int8 inference path.
//
// Replaces the TPU kernel rnet/kernels/pairwise.py::_fwd_kernel_int8
// (launched by _fwd_pallas_int8). Every scale is folded outside the kernel
// (rnet_torch/kernels/pairwise.py::quantize_int8): u, v and s arrive in
// layer 0's x127/c0 domain as bf16 or fp32 (rnet's kernel reads either),
// W_l as symmetric int8 codes, and each layer's dequantize-requantize is one
// fp32 multiply m_l. For every sample b
//
//     a_0  = int8(min(relu((u_i + v_j) + s) + 0.5, 127))             (fp32 math)
//     pre  = fma(float(a_{l-1} . W8_l), m_l, b_l) [+ qa if l == inject]
//     a_l  = int8(min(relu(pre) + 0.5, 127))      for l < L-1
//     out[b] = sum_{i<ni, j<nj} relu(pre_{L-1})                      (fp32)
//
// with the same rounding points as _fwd_kernel_int8 (:216-237) as XLA
// compiles it (interpret mode on the CPU): the int8 products are exact int32
// sums, float(acc) * m_l + b_l is one fused multiply-add (__fmaf_rn: XLA
// contracts it so, and two roundings would move a few codes), the inject
// and layer-0 adds round on their own (__fadd_rn), and the requantization
// truncates toward zero as astype(int8) does. So every int8 code equals the
// plain version's, and only the order of the pooled fp32 sum differs (it is
// fixed, so outputs repeat bitwise). The n^2 pair rows never reach device
// memory.
//
// What bounds it: 2*B*ni*nj*(L-1)*H^2 int8 operations on the tensor cores.
// At original-fp's B=512 (n=64, H=256, L=4) that is 824 G ops, 0.417 ms at
// the 1,979 TOPS dense int8 peak of the H100 SXM, against 33.6 MB of u + v
// (0.010 ms at 3.35 TB/s); at wide-fp's H=512 (B=512) 3.30 T ops, 1.667 ms,
// against 67 MB. Both are bound by operations. At that rate the products
// of a 64-row tile take about as long as its CUDA-core work (a_0: two adds,
// a round and a pack per element; the epilogues: a convert, an fma, a round
// and a pack per accumulator; the pool), so the design is about overlapping
// the two, and on the card the CUDA-core work is what the kernel waits on
// (PERF.md §6). A lone warpgroup's stream of m64n128k32 products, two a
// commit group with one group in flight, reaches about a third of the peak;
// three warpgroups issuing at once reach 85 % (scripts/bench_wgmma_int8.cu).
//
// Design (pairwise_chain.cuh has the layout, the W feed and the products):
//   * int8 tiles in shared memory use wgmma's no-swizzle core matrices of 8
//     rows x 16 bytes, the bf16 kernels' 128-byte core matrix at twice the
//     depth; W_l^T is packed once per call into 8 KB chunks of 128 output
//     columns x 64 depth (pack_weight_chunks) and streamed by one producer
//     thread through the mbarrier ring with cp.async.bulk;
//   * products are wgmma m64n128k32 s8 x s8 -> s32 from shared memory, both
//     operands K-major (int8 wgmma has no transpose); the int32
//     accumulators start at 0, so the epilogue applies the fma by m_l and
//     b_l, the inject add, relu and the requantize into the next tile;
//   * WGS consumer warpgroups per CTA each own a tile of 64 consecutive pair
//     rows p = i*nj + j of one sample, and the tiles are independent: while
//     one warpgroup builds a_0 or runs an epilogue, another's wgmma runs on
//     the tensor cores. They share the W stream, since every tile reads the
//     same chunk sequence: each chunk is released once every warpgroup has
//     read it, so a warpgroup may run ahead of the others by up to the ring's
//     depth. Each CTA of the persistent grid takes a contiguous range of
//     tiles, WGS consecutive ones a round (a warpgroup with no tile in the
//     last round skips its chunks). Small batches (serving buckets) take
//     WGS = 1, so that 64-row tiles give every SM work;
//   * a_0 is built by the warpgroup for its own tile, 16 columns (one core
//     matrix row) a thread, s held in registers, the u and v loads of four
//     rows in flight before any is used;
//   * the last layer pools its valid rows in fp32 from registers (a
//     thread's two rows, a fixed shuffle tree over the warp's 16 rows, the 4
//     warps in order) into partial[tile, :], and a second kernel adds a
//     sample's tiles in a fixed order (no atomics: served answers repeat).
// This one-CTA kernel runs every width but 512. ptxas serializes its wgmma
// (note C7520: a compiler-inserted warpgroup.arrive in a divergent path).
//
// H = 512 (wide-fp): clusters of two CTAs (pairwise_fwd_int8_pair). The
// one-CTA kernel fit only two warpgroups there (three 64 x 512 tiles of
// two slots leave no room for the ring), with every product serialized
// (C7520); on the card (NVIDIA H100 80GB HBM3, 700 W; PERF.md) it took
// 5.49 ms at wide-fp B=512, 3.3x its bound, its first warpgroup's cycles
// 0.44 products, 0.24 epilogues, 0.15 a_0, 0.10 W feed waits, and served
// bucket 1 on 64 of the 132 SMs.
//   * The two CTAs of a cluster take the same 64-row tiles, CTA rank c the
//     output columns c*256 .. c*256 + 255 of every layer: half the
//     products, epilogues, a_0 and pool of a tile each, so bucket 1 runs
//     128 CTAs. Each CTA streams only its 256 rows of W_l^T, its own half
//     of the depth first (kernels/pairwise.py::pair_halves), through a ring
//     that three warpgroups share (each on its own tile, as above): 8.6 GB
//     of W from L2 at wide-fp B=512 instead of 12.9.
//   * Every warpgroup keeps two slots of all 512 columns. It writes its
//     half of a layer's codes into its slot, then copies that half into the
//     peer's copy of the slot (cp.async.bulk shared::cta -> shared::cluster,
//     eight 2 KB row groups), completing bytes on the peer's `in_full`
//     mbarrier; the next layer multiplies its own half of the depth first
//     and waits for the peer's half only before the rest. A slot is written
//     again only after the peer arrives on its `free` mbarrier (its products
//     have read the slot, so this CTA's last copy out of it has landed too).
//   * Codes without a float-to-integer convert (code_bits: F2I issues at a
//     quarter of the adds' rate). The biases are read from global memory and
//     the column sums kept in the slot the last layer does not read, which
//     leaves room for four ring stages beside three warpgroups' slots
//     (229,536 B). The tile loop has no branch around the products and the
//     prologue no division: ptxas keeps the wgmma asynchronous (no C7520).
//   * The pool's order is the one-CTA kernel's, column by column, so the
//     two kernels give bitwise the same outputs.
// What still bounds it (PERF.md §6, row 4w): each warpgroup spends about
// half its cycles on a_0, epilogues, pool and barriers, so on average 1.3
// of the three are in their products, whose wgmma then runs at about a
// third of the peak.
// With -DRNET_PHASE_TIMES the first consumer thread of each CTA sums
// clock64() per phase (products, epilogues, pool, feed waits, a_0,
// warpgroup barriers; the cluster kernel's waits for its peer) into
// `phases` (grid, NPHASE).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "pairwise_chain.cuh"
#include "smem_limit.cuh"

namespace {

using namespace rnet;

enum { PH_PRODUCTS, PH_EPILOGUES, PH_POOL, PH_FEED, PH_A0, PH_SYNC, PH_PAIR };

constexpr int ROWS = 64;  // pair rows of one warpgroup's tile
constexpr int PRODUCER_THREADS = 32;

// Shared memory: two int8 activation tiles per consumer warpgroup, the W
// ring and its mbarriers, the biases in fp32 and one row of column sums
// per consumer warp.
size_t smem_bytes(int wgs, int H, int L, int stages) {
  return 2 * (size_t)wgs * ROWS * H + (size_t)stages * (CHUNK_BYTES + 16) + (size_t)(L - 1) * H * sizeof(float) +
         (size_t)wgs * 4 * H * sizeof(float);
}

// The int8 code of relu(x), trunc(min(relu(x) + 0.5, 127)): the unsigned
// convert sends x + 0.5 < 1 (so every x <= 0, and NaN) to 0, relu's code.
__device__ __forceinline__ uint32_t code(float x) { return min(__float2uint_rz(__fadd_rn(x, 0.5f)), 127u); }

// Four codes (each < 128) as the bytes of one word, a first.
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// Element e of 16 consecutive values held as raw 16-byte vectors.
template <typename T>
__device__ __forceinline__ float elem(const uint4* raw, int e);
template <>
__device__ __forceinline__ float elem<bf16>(const uint4* raw, int e) {
  const uint32_t w = reinterpret_cast<const uint32_t*>(raw)[e >> 1];
  return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
}
template <>
__device__ __forceinline__ float elem<float>(const uint4* raw, int e) {
  return reinterpret_cast<const float*>(raw)[e];
}

// a_0 codes of the ROWS rows from pair p0 of sample b (rows past `valid`
// zero) into the int8 core-matrix tile `tile` (width H), by the 128 threads
// of one warpgroup. A thread keeps one 16-column group (s loaded once per
// tile) and walks rows `step` apart, stepping (i, j) without a division.
template <typename T>
__device__ __forceinline__ void make_a0(const T* __restrict__ u, const T* __restrict__ v, const T* __restrict__ s,
                                        uint8_t* tile, int b, int p0, int valid, int ni, int nj, int H, int tid) {
  constexpr int NV = sizeof(T);           // 16-byte vectors per 16 values
  constexpr int BATCH = 8 / sizeof(T);    // rows whose loads are in flight together
  const int groups = H / 16;
  const int step = WG_THREADS / groups;
  const int c16 = (tid % groups) * 16;
  float sv[16];
  {
    uint4 raw[NV];
#pragma unroll
    for (int k = 0; k < NV; ++k) raw[k] = reinterpret_cast<const uint4*>(s + (size_t)b * H + c16)[k];
#pragma unroll
    for (int e = 0; e < 16; ++e) sv[e] = elem<T>(raw, e);
  }
  int r = tid < step * groups ? tid / groups : ROWS;  // threads past step * groups idle
  int i = (p0 + r) / nj;
  int j = p0 + r - i * nj;
  for (; r < ROWS; r += BATCH * step) {
    uint4 uu[BATCH][NV], vv[BATCH][NV];
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const bool live = r + k * step < valid;
#pragma unroll
      for (int q = 0; q < NV; ++q) {
        uu[k][q] = vv[k][q] = make_uint4(0u, 0u, 0u, 0u);
        if (live) {
          uu[k][q] = reinterpret_cast<const uint4*>(u + ((size_t)b * ni + i) * H + c16)[q];
          vv[k][q] = reinterpret_cast<const uint4*>(v + ((size_t)b * nj + j) * H + c16)[q];
        }
      }
      for (j += step; j >= nj; j -= nj) ++i;
    }
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int rk = r + k * step;
      if (rk >= ROWS) break;
      uint4 packed = make_uint4(0u, 0u, 0u, 0u);
      if (rk < valid) {
        uint32_t w[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          uint32_t c[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int x = 4 * g + e;
            c[e] = code(__fadd_rn(__fadd_rn(elem<T>(uu[k], x), elem<T>(vv[k], x)), sv[x]));
          }
          w[g] = pack4(c[0], c[1], c[2], c[3]);
        }
        packed = make_uint4(w[0], w[1], w[2], w[3]);
      }
      *reinterpret_cast<uint4*>(tile + ((rk >> 3) * groups + (c16 >> 4)) * 128 + (rk & 7) * 16) = packed;
    }
  }
}

template <int WGS, typename T>
__global__ void __launch_bounds__(WGS * WG_THREADS + PRODUCER_THREADS, 1)
pairwise_fwd_int8_kernel(const T* __restrict__ u, const T* __restrict__ v, const T* __restrict__ s,
                         const float* __restrict__ qa, const int8_t* __restrict__ chunks,
                         const float* __restrict__ m, const float* __restrict__ bs, float* __restrict__ partial,
                         int B, int ni, int nj, int H, int L, int inject, int stages, long long* phases) {
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* ring = smem + 2 * (size_t)WGS * ROWS * H;
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + (size_t)stages * CHUNK_BYTES);
  float* biasf = reinterpret_cast<float*>(bars + 2 * stages);  // (L-1, H)
  float* colsum = biasf + (size_t)(L - 1) * H;                   // (4 * WGS warps, H)
  Ring r{smem_u32(ring), smem_u32(bars), smem_u32(bars + stages), stages, 0, 0};
  if (threadIdx.x == 0) {
    for (int k = 0; k < stages; ++k) {
      mbar_init(r.full + 8 * k, 1);
      mbar_init(r.empty + 8 * k, WGS);
    }
    mbar_fence_init();
  }
  for (int k = threadIdx.x; k < (L - 1) * H; k += blockDim.x) biasf[k] = bs[k];
  __syncthreads();

  const int npairs = ni * nj;
  const int nblk = (npairs + ROWS - 1) / ROWS;
  const int ntiles = B * nblk;
  const int per_tile = (L - 1) * (H / NT) * (H / DEPTH_BYTES);  // W chunks of one tile's chain
  const int role = __shfl_sync(0xffffffffu, (int)threadIdx.x / WG_THREADS, 0);  // warp-uniform
  PhaseClock pc;
  pc.start(PH_A0);
  // this CTA's tiles [t_begin, t_end)
  const int t_begin = (int)((long long)blockIdx.x * ntiles / gridDim.x);
  const int t_end = (int)((long long)(blockIdx.x + 1) * ntiles / gridDim.x);
  if (role == WGS) {  // the producer warp: one thread streams W, one tile's chunks a round
    if (threadIdx.x == WGS * WG_THREADS)
      for (int t0 = t_begin; t0 < t_end; t0 += WGS) produce(r, chunks, per_tile, pc, PH_FEED);
  } else {
    const int wg = role;
    const int tid = threadIdx.x - wg * WG_THREADS;
    const int warp = threadIdx.x / 32;  // 0 .. 4*WGS-1
    uint8_t* slot0 = smem + (size_t)wg * 2 * ROWS * H;
    uint8_t* slot1 = slot0 + ROWS * H;
    // the thread's first fragment row (the second is 8 below) and its byte
    // offset in a core-matrix tile: register 4j + 2h + e holds row frow + 8h
    // and column nt*NT + 8j + 2q + e, q = tid % 4
    const int frow = 16 * (warp % 4) + (tid & 31) / 4;
    const int fbase = (frow >> 3) * 8 * H + (frow & 7) * 16 + 2 * (tid & 3);

    for (int t0 = t_begin; t0 < t_end; t0 += WGS) {
      const int t = t0 + wg;
      if (t >= t_end) {  // the last round has no tile for this warpgroup
        skip_chunks(r, per_tile, tid == 0);
      } else {
        const int b = t / nblk;
        const int p0 = (t % nblk) * ROWS;
        const int valid = min(ROWS, npairs - p0);
        pc.mark(PH_A0);
        make_a0(u, v, s, slot0, b, p0, valid, ni, nj, H, tid);
        pc.mark(PH_SYNC);
        fence_proxy_async();
        bar_sync(1 + wg, WG_THREADS);

        uint8_t* cur = slot0;
        uint8_t* nxt = slot1;
        for (int l = 1; l < L; ++l) {
          const float ml = m[l - 1];
          const float* bias = biasf + (size_t)(l - 1) * H;
          const float* qrow = (l == inject) ? qa + (size_t)b * H : nullptr;
          for (int nt = 0; nt < H / NT; ++nt) {
            int acc[NT / 2];
#pragma unroll
            for (int z = 0; z < NT / 2; ++z) acc[z] = 0;
            pc.mark(PH_PRODUCTS);
            streamed_product(acc, smem_u32(cur), H, r, tid == 0, pc, PH_FEED);
            pc.mark(PH_EPILOGUES);
            const float* bq = bias + nt * NT + 2 * (tid & 3);
            const float* qq = qrow ? qrow + nt * NT + 2 * (tid & 3) : nullptr;
            // pre of registers 4j .. 4j+3: fma(float(acc), m_l, b_l) [+ qa]
            auto pre = [&](int j, float (&p)[4]) {
              const float2 bb = *reinterpret_cast<const float2*>(bq + 8 * j);
              const float2 q = qq ? *reinterpret_cast<const float2*>(qq + 8 * j) : make_float2(0.0f, 0.0f);
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                p[e] = __fmaf_rn((float)acc[4 * j + e], ml, (e & 1) ? bb.y : bb.x);
                if (qq) p[e] = __fadd_rn(p[e], (e & 1) ? q.y : q.x);
              }
            };
            if (l < L - 1) {
              uint8_t* o0 = nxt + fbase + nt * (NT / 16) * 128;
              uint8_t* o1 = o0 + 8 * H;
#pragma unroll
              for (int j = 0; j < NT / 8; ++j) {
                float p[4];
                pre(j, p);
                const int off = (j >> 1) * 128 + (j & 1) * 8;
                *reinterpret_cast<uint16_t*>(o0 + off) = (uint16_t)__byte_perm(code(p[0]), code(p[1]), 0x0040);
                *reinterpret_cast<uint16_t*>(o1 + off) = (uint16_t)__byte_perm(code(p[2]), code(p[3]), 0x0040);
              }
            } else {  // relu in fp32; the thread's two rows of each column summed, row frow first
              const bool v0 = frow < valid, v1 = frow + 8 < valid;
              float pool[NT / 4];
#pragma unroll
              for (int j = 0; j < NT / 8; ++j) {
                float p[4];
                pre(j, p);
                pool[2 * j] = (v0 ? fmaxf(p[0], 0.0f) : 0.0f) + (v1 ? fmaxf(p[2], 0.0f) : 0.0f);
                pool[2 * j + 1] = (v0 ? fmaxf(p[1], 0.0f) : 0.0f) + (v1 ? fmaxf(p[3], 0.0f) : 0.0f);
              }
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
            bar_sync(1 + wg, WG_THREADS);  // a_l complete before the next layer's wgmma reads it
            uint8_t* tmp = cur;
            cur = nxt;
            nxt = tmp;
          }
        }

        // ---- the tile's pooled rows: its 4 warps' column sums in warp order ----
        // (the next tile's a_0 barrier orders these reads before the next writes)
        pc.mark(PH_SYNC);
        bar_sync(1 + wg, WG_THREADS);
        pc.mark(PH_POOL);
        float* out = partial + (size_t)t * H;
        for (int c = tid; c < H; c += WG_THREADS) {
          const float* cs = colsum + (size_t)(4 * wg) * H + c;
          out[c] = ((cs[0] + cs[H]) + cs[2 * H]) + cs[3 * H];
        }
      }
    }
    pc.mark(PH_A0);
    if (tid == 0 && wg == 0 && phases) pc.store(phases + (size_t)blockIdx.x * NPHASE);
  }
}

// ===========================================================================
// H = 512 (wide-fp): clusters of two CTAs, each on half of every layer's
// output columns of a shared 64-row tile (see the design notes at the top)
// ===========================================================================

constexpr int PAIR_H = 512;          // the width the cluster kernel takes
constexpr int PAIR_W = PAIR_H / 2;   // output columns of one CTA of the pair
constexpr int SLOT = ROWS * PAIR_H;  // bytes of one activation tile (all 512 columns)
constexpr int HALF_BYTES = ROWS * PAIR_W;  // a CTA's half of a tile: what it sends its peer

// The code of relu(x) as the low byte of the result (the high bytes are
// those of 1.5 * 2^23): trunc(min(relu(x) + 0.5, 127)) without a float to
// integer conversion. z = relu(x) + 0.5 rounds as code() does; adding 1.5 *
// 2^23 toward zero leaves floor(z) (= trunc(z), z >= 0.5) in the mantissa
// for z < 2^22, and the unsigned minimum clamps every larger z (and +inf)
// to the bits of 127; NaN goes to 0 through fmaxf. code() converts with
// F2I, which issues at a quarter of the rate of the adds.
__device__ __forceinline__ uint32_t code_bits(float x) {
  const float z = __fadd_rn(fmaxf(x, 0.0f), 0.5f);
  return min(__float_as_uint(__fadd_rz(z, 12582912.0f)), 0x4B40007Fu);
}

// 1-D bulk copy from this CTA's shared memory to `dst` in another CTA of
// the cluster, completing `bytes` on the mbarrier `bar` there (both
// shared::cluster addresses).
__device__ __forceinline__ void bulk_s2peer(uint32_t dst, uint32_t src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   dst),
               "r"(src), "r"(bytes), "r"(bar)
               : "memory");
}

// Arrive on an mbarrier of the peer CTA (a shared::cluster address),
// releasing at cluster scope what this thread did before.
__device__ __forceinline__ void mbar_arrive_peer(uint32_t bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// a_0 codes of the CTA's PAIR_W columns from c0 of the ROWS rows from pair
// p0 of sample b (rows past `valid` zero) into the core-matrix tile `tile`
// (all PAIR_H columns wide), by the 128 threads of one warpgroup: make_a0
// on half the columns, converting with code_bits.
template <typename T>
__device__ __forceinline__ void make_a0_half(const T* __restrict__ u, const T* __restrict__ v,
                                             const T* __restrict__ s, uint8_t* tile, int b, int p0, int valid,
                                             int ni, int nj, int c0, int tid) {
  constexpr int NV = sizeof(T);
  constexpr int BATCH = 8 / sizeof(T);
  constexpr int GROUPS = PAIR_W / 16;
  constexpr int STEP = WG_THREADS / GROUPS;  // rows a pass; STEP * BATCH divides ROWS
  const int c16 = c0 + (tid % GROUPS) * 16;
  float sv[16];
  {
    uint4 raw[NV];
#pragma unroll
    for (int k = 0; k < NV; ++k) raw[k] = reinterpret_cast<const uint4*>(s + (size_t)b * PAIR_H + c16)[k];
#pragma unroll
    for (int e = 0; e < 16; ++e) sv[e] = elem<T>(raw, e);
  }
  int r = tid / GROUPS;
  int i = (p0 + r) / nj;
  int j = p0 + r - i * nj;
#pragma unroll 1
  for (; r < ROWS; r += BATCH * STEP) {
    uint4 uu[BATCH][NV], vv[BATCH][NV];
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const bool live = r + k * STEP < valid;
#pragma unroll
      for (int q = 0; q < NV; ++q) {
        uu[k][q] = vv[k][q] = make_uint4(0u, 0u, 0u, 0u);
        if (live) {
          uu[k][q] = reinterpret_cast<const uint4*>(u + ((size_t)b * ni + i) * PAIR_H + c16)[q];
          vv[k][q] = reinterpret_cast<const uint4*>(v + ((size_t)b * nj + j) * PAIR_H + c16)[q];
        }
      }
      for (j += STEP; j >= nj; j -= nj) ++i;
    }
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int rk = r + k * STEP;
      uint4 packed = make_uint4(0u, 0u, 0u, 0u);
      if (rk < valid) {
        uint32_t w[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          uint32_t c[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int x = 4 * g + e;
            c[e] = code_bits(__fadd_rn(__fadd_rn(elem<T>(uu[k], x), elem<T>(vv[k], x)), sv[x]));
          }
          w[g] = pack4(c[0], c[1], c[2], c[3]);
        }
        packed = make_uint4(w[0], w[1], w[2], w[3]);
      }
      *reinterpret_cast<uint4*>(tile + ((rk >> 3) * (PAIR_H / 16) + (c16 >> 4)) * 128 + (rk & 7) * 16) = packed;
    }
  }
}

// acc = A . B for one NT-column output tile of a cluster CTA: A the 64-row
// core-matrix tile at a_addr (rows of PAIR_H bytes), its depth taken in the
// order of the CTA's W stream (kernels/pairwise.py::pair_halves): first the
// CTA's own PAIR_W columns (from byte column `own`), then the peer's. B
// streams through the ring as 2 * NK chunks in that order. `peer_ready`
// runs before the first chunk of the peer's depth is multiplied (the
// peer's half of A may still be arriving while the own half's products
// run). `lead` releases each stage once the warpgroup's wgmma has read it.
// (Committing two chunks a group, or keeping two groups in flight, ran
// slower on the card: the shared ring then holds too few chunks ahead.)
template <typename F>
__device__ __forceinline__ void pair_product(int (&acc)[NT / 2], uint32_t a_addr, int own, Ring& r, bool lead,
                                             PhaseClock& pc, F&& peer_ready) {
  constexpr int NK = PAIR_W / DEPTH_BYTES;  // chunks of each half
  int prev = 0;
  wgmma_fence();
#pragma unroll 1
  for (int kc = 0; kc < 2 * NK; ++kc) {
    if (kc == NK) peer_ready();
    const int col = (kc < NK ? own : own ^ PAIR_W) + (kc % NK) * DEPTH_BYTES;  // byte column of A
    const int was = pc.mark(PH_FEED);
    mbar_wait(r.full + 8 * r.stage, r.parity);
    pc.mark(was);
    const uint32_t b = r.buf + r.stage * CHUNK_BYTES;
#pragma unroll
    for (int ks = 0; ks < DEPTH_BYTES / 32; ++ks)
      wgmma_step(acc, desc(a_addr + (col / 16 + 2 * ks) * 128, 128, 8 * PAIR_H),
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

// The kernel at H = PAIR_H on clusters of two CTAs. Cluster q of Q takes
// the contiguous tiles [q * tq + min(q, tr), ...) (tq = tiles / Q, tr =
// tiles % Q, one more tile for q < tr), WGS consecutive ones a round; both
// CTAs walk the same tiles, CTA `rank` on the output columns rank * PAIR_W
// .. of every layer, consumer warpgroup wg on tile t0 + wg of a round with
// the peer's warpgroup wg. Each warpgroup keeps two activation slots of all
// PAIR_H columns. It writes its half of a_0 or of a layer's codes into a
// slot, then sends that half into the peer's copy of the slot with bulk
// copies (8 row groups of 2 KB), whose bytes complete the peer's `in_full`
// mbarrier of the slot; the next layer multiplies its own half of the depth
// first and waits on `in_full` only before the peer's half. Before writing a
// slot again it waits on the slot's `free` mbarrier, on which the peer
// arrives once its products have read its copy of the slot: after it the
// peer is done with the slot and this CTA's last copy out of it has landed.
// The slots alternate as in the one-CTA kernel (a tile's a_0 goes to the
// slot its predecessor's last layer did not read), so each slot sees write,
// read, write, read: write k (k > 0) waits on phase k - 1 of `free`, read k
// on phase k of `in_full`.
template <int WGS, typename T>
__global__ void __launch_bounds__(WGS * WG_THREADS + PRODUCER_THREADS, 1)
pairwise_fwd_int8_pair(const T* __restrict__ u, const T* __restrict__ v, const T* __restrict__ s,
                       const float* __restrict__ qa, const int8_t* __restrict__ chunks, const float* __restrict__ m,
                       const float* __restrict__ bs, float* __restrict__ partial, int B, int ni, int nj, int L,
                       int inject, int stages, int tq, int tr, long long* phases) {
  constexpr int H = PAIR_H, W = PAIR_W;
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* ring = smem + 2 * (size_t)WGS * SLOT;
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + (size_t)stages * CHUNK_BYTES);
  uint64_t* pbars = bars + 2 * stages;  // (WGS, slot, {in_full, free})
  const uint32_t rank = cluster_rank();
  const int c0 = (int)rank * W;
  Ring r{smem_u32(ring), smem_u32(bars), smem_u32(bars + stages), stages, 0, 0};
  if (threadIdx.x == 0) {
    for (int k = 0; k < stages; ++k) {
      mbar_init(r.full + 8 * k, 1);
      mbar_init(r.empty + 8 * k, WGS);
    }
    for (int k = 0; k < 4 * WGS; ++k) mbar_init(smem_u32(pbars + k), 1);
    mbar_fence_init();
  }
  cluster_sync_all();  // both CTAs' mbarriers are initialised before either arrives on the other's

  const int npairs = ni * nj;
  const int nblk = (npairs + ROWS - 1) / ROWS;
  const int per_tile = (L - 1) * (W / NT) * (H / DEPTH_BYTES);  // the CTA's W chunks of one tile's chain
  const int q = (int)(blockIdx.x >> 1);
  const int t_begin = q * tq + min(q, tr);
  const int t_end = t_begin + tq + (q < tr ? 1 : 0);
  const int role = __shfl_sync(0xffffffffu, (int)threadIdx.x / WG_THREADS, 0);  // warp-uniform
  PhaseClock pc;
  pc.start(PH_A0);
  if (role == WGS) {  // the producer warp: one thread streams the CTA's half of W, one tile's chunks a round
    if (threadIdx.x == WGS * WG_THREADS) {
      const int8_t* own = chunks + (size_t)rank * per_tile * CHUNK_BYTES;  // the CTA's pair_halves slice
      for (int t0 = t_begin; t0 < t_end; t0 += WGS) produce(r, own, per_tile, pc, PH_FEED);
    }
  } else {
    const int wg = role;
    const int tid = threadIdx.x - wg * WG_THREADS;
    const int warp = threadIdx.x / 32;  // 0 .. 4*WGS-1
    const bool lead = tid == 0;
    uint8_t* slots = smem + (size_t)wg * 2 * SLOT;
    const uint32_t slots_addr = smem_u32(slots);
    const uint32_t peer_slots = mapa(slots_addr, rank ^ 1u);
    const uint32_t my_bars = smem_u32(pbars + 4 * wg);  // slot k: in_full at + 16k, free at + 16k + 8
    const uint32_t peer_bars = mapa(my_bars, rank ^ 1u);
    const int frow = 16 * (warp % 4) + (tid & 31) / 4;
    const int fbase = (frow >> 3) * 8 * H + (frow & 7) * 16 + 2 * (tid & 3);
    int writes[2] = {0, 0};  // writes of each slot so far (the same count in both CTAs)

    // before writing slot k: the peer has read its copy of the slot's last write
    auto acquire = [&](int k) {
      if (writes[k] > 0) {
        pc.mark(PH_PAIR);
        mbar_wait(my_bars + 16 * k + 8, (writes[k] - 1) & 1);
      }
    };
    // after writing this CTA's half of slot k: it goes to the peer
    auto publish = [&](int k) {
      pc.mark(PH_SYNC);
      fence_proxy_async();
      bar_sync(1 + wg, WG_THREADS);
      if (lead) {
        mbar_expect_tx(my_bars + 16 * k, HALF_BYTES);  // the peer's half arriving here
        const uint32_t off = (uint32_t)k * SLOT + (uint32_t)(c0 / 16) * 128;
#pragma unroll 1
        for (int g = 0; g < ROWS / 8; ++g)
          bulk_s2peer(peer_slots + off + g * 8 * H, slots_addr + off + g * 8 * H, 8 * W, peer_bars + 16 * k);
      }
      ++writes[k];
    };

    int cur = 1;  // the slot the last layer read: a tile's a_0 goes to the other
    int rounds = 0;
    // tiles t_begin + wg, + WGS, ...: the warpgroup's tile of each round (a
    // loop without a branch around the products, so that ptxas keeps the
    // wgmma asynchronous); a last round without a tile for it (nor for the
    // peer's) is skipped after the loop
    for (int t = t_begin + wg; t < t_end; t += WGS, ++rounds) {
      const int b = t / nblk;
      const int p0 = (t - b * nblk) * ROWS;
      const int valid = min(ROWS, npairs - p0);
      cur ^= 1;
      acquire(cur);
      pc.mark(PH_A0);
      make_a0_half(u, v, s, slots + (size_t)cur * SLOT, b, p0, valid, ni, nj, c0, tid);
      publish(cur);

      for (int l = 1; l < L; ++l) {
        const float ml = m[l - 1];
        const float* bias = bs + (size_t)(l - 1) * H + c0;  // the CTA's columns of b_l (L1-cached)
        const float* qrow = (l == inject) ? qa + (size_t)b * H + c0 : nullptr;
        const int nxt = cur ^ 1;
        for (int nt = 0; nt < W / NT; ++nt) {
          int acc[NT / 2];
#pragma unroll
          for (int z = 0; z < NT / 2; ++z) acc[z] = 0;
          pc.mark(PH_PRODUCTS);
          pair_product(acc, slots_addr + (uint32_t)cur * SLOT, c0, r, lead, pc, [&]() {
            if (nt == 0) {  // the peer's half of the slot has arrived
              const int was = pc.mark(PH_PAIR);
              mbar_wait(my_bars + 16 * cur, (writes[cur] - 1) & 1);
              pc.mark(was);
            }
          });
          if (nt == W / NT - 1 && lead) mbar_arrive_peer(peer_bars + 16 * cur + 8);  // done reading slot cur
          pc.mark(PH_EPILOGUES);
          const float* bq = bias + nt * NT + 2 * (tid & 3);
          const float* qq = qrow ? qrow + nt * NT + 2 * (tid & 3) : nullptr;
          auto pre = [&](int j, float (&p)[4]) {
            const float2 bb = *reinterpret_cast<const float2*>(bq + 8 * j);
            const float2 qv = qq ? *reinterpret_cast<const float2*>(qq + 8 * j) : make_float2(0.0f, 0.0f);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              p[e] = __fmaf_rn((float)acc[4 * j + e], ml, (e & 1) ? bb.y : bb.x);
              if (qq) p[e] = __fadd_rn(p[e], (e & 1) ? qv.y : qv.x);
            }
          };
          if (nt == 0) acquire(nxt);  // the last layer keeps its column sums in its own half of slot nxt
          pc.mark(PH_EPILOGUES);
          if (l < L - 1) {
            uint8_t* o0 = slots + (size_t)nxt * SLOT + fbase + (c0 / NT + nt) * (NT / 16) * 128;
            uint8_t* o1 = o0 + 8 * H;
#pragma unroll
            for (int j = 0; j < NT / 8; ++j) {
              float p[4];
              pre(j, p);
              const int off = (j >> 1) * 128 + (j & 1) * 8;
              *reinterpret_cast<uint16_t*>(o0 + off) = (uint16_t)__byte_perm(code_bits(p[0]), code_bits(p[1]), 0x0040);
              *reinterpret_cast<uint16_t*>(o1 + off) = (uint16_t)__byte_perm(code_bits(p[2]), code_bits(p[3]), 0x0040);
            }
          } else {  // relu in fp32; the thread's two rows of each column summed, row frow first
            const bool v0 = frow < valid, v1 = frow + 8 < valid;
            float pool[NT / 4];
#pragma unroll
            for (int j = 0; j < NT / 8; ++j) {
              float p[4];
              pre(j, p);
              pool[2 * j] = (v0 ? fmaxf(p[0], 0.0f) : 0.0f) + (v1 ? fmaxf(p[2], 0.0f) : 0.0f);
              pool[2 * j + 1] = (v0 ? fmaxf(p[1], 0.0f) : 0.0f) + (v1 ? fmaxf(p[3], 0.0f) : 0.0f);
            }
            pc.mark(PH_POOL);
            // the 8 row lanes of each column by a fixed shuffle tree: the
            // column sums of the warp's 16 rows, as (4 warps, NT) sums in
            // the CTA's half of row group nt of slot nxt (the peer writes
            // only its own half there, and this CTA's last copy out of the
            // slot has landed: acquire)
            float* colsum = reinterpret_cast<float*>(slots + (size_t)nxt * SLOT + nt * 8 * H + (c0 / 16) * 128);
#pragma unroll
            for (int k = 0; k < NT / 4; ++k) {
              float x = pool[k];
              x += __shfl_xor_sync(0xffffffffu, x, 4);
              x += __shfl_xor_sync(0xffffffffu, x, 8);
              x += __shfl_xor_sync(0xffffffffu, x, 16);
              if ((tid & 31) < 4) colsum[(warp % 4) * NT + 8 * (k >> 1) + 2 * (tid & 3) + (k & 1)] = x;
            }
          }
        }
        if (l < L - 1) {
          publish(nxt);
          cur = nxt;
        }
      }

      // ---- the tile's pooled rows of the CTA's columns: the 4 warps' sums in warp order ----
      pc.mark(PH_SYNC);
      bar_sync(1 + wg, WG_THREADS);
      pc.mark(PH_POOL);
#pragma unroll
      for (int nt = 0; nt < W / NT; ++nt) {
        const float* cs = reinterpret_cast<const float*>(slots + (size_t)(cur ^ 1) * SLOT + nt * 8 * H +
                                                         (c0 / 16) * 128) + tid;
        partial[(size_t)t * H + c0 + nt * NT + tid] = ((cs[0] + cs[NT]) + cs[2 * NT]) + cs[3 * NT];
      }
      pc.mark(PH_SYNC);
      bar_sync(1 + wg, WG_THREADS);  // the sums are read before the next tile's a_0 overwrites them
    }
    skip_chunks(r, ((t_end - t_begin + WGS - 1) / WGS - rounds) * per_tile, lead);
    pc.mark(PH_A0);
    if (tid == 0 && wg == 0 && phases) pc.store(phases + (size_t)blockIdx.x * NPHASE);
  }
  cluster_sync_all();  // no copy or arrival of either CTA is still in flight to the other
}

// out[b, c] = sum over blocks of partial[b, blk, c], in block order.
__global__ void pool_partials_kernel(const float* __restrict__ partial, float* __restrict__ out, int nblk, int H) {
  const int b = blockIdx.y;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= H) return;
  const float* src = partial + (size_t)b * nblk * H + c;
  float sum = 0.0f;
  for (int k = 0; k < nblk; ++k) sum += src[(size_t)k * H];
  out[(size_t)b * H + c] = sum;
}

struct Args {
  const void *u, *v, *s;
  const float* qa;
  const int8_t* chunks;
  const float *m, *bs;
  float* partial;
  int B, ni, nj, H, L, inject, stages;
  long long* phases;
  int tq, tr;  // the cluster kernel: tiles per cluster and the clusters that take one more
};

template <int WGS, typename T>
cudaError_t launch(const Args& a, int grid, size_t smem, cudaStream_t st) {
  auto kern = pairwise_fwd_int8_kernel<WGS, T>;
  static size_t allowed = 0;
  cudaError_t err = raise_smem_limit(kern, smem, allowed);
  if (err != cudaSuccess) return err;
  kern<<<grid, WGS * WG_THREADS + PRODUCER_THREADS, smem, st>>>(
      static_cast<const T*>(a.u), static_cast<const T*>(a.v), static_cast<const T*>(a.s), a.qa, a.chunks, a.m, a.bs,
      a.partial, a.B, a.ni, a.nj, a.H, a.L, a.inject, a.stages, a.phases);
  return cudaGetLastError();
}

// Shared memory of a cluster CTA: two activation slots of all PAIR_H
// columns per consumer warpgroup, the W ring and its mbarriers, four
// mbarriers per warpgroup (in_full and free of each slot), the biases of the
// CTA's columns in fp32 and one row of NT column sums per consumer warp.
size_t smem_bytes_pair(int wgs, int stages) {
  return 2 * (size_t)wgs * SLOT + (size_t)stages * (CHUNK_BYTES + 16) + (size_t)wgs * 4 * 8;
}

template <int WGS, typename T>
cudaError_t launch_pair(const Args& a, int grid, size_t smem, cudaStream_t st) {
  auto kern = pairwise_fwd_int8_pair<WGS, T>;
  static size_t allowed = 0;
  cudaError_t err = raise_smem_limit(kern, smem, allowed);
  if (err != cudaSuccess) return err;
  return launch_cluster(kern, grid, WGS * WG_THREADS + PRODUCER_THREADS, smem, st, 2, static_cast<const T*>(a.u),
                        static_cast<const T*>(a.v), static_cast<const T*>(a.s), a.qa, a.chunks, a.m, a.bs, a.partial,
                        a.B, a.ni, a.nj, a.L, a.inject, a.stages, a.tq, a.tr, a.phases);
}

template <typename T>
cudaError_t dispatch(const Args& a, int wgs, int cluster, int grid, size_t smem, cudaStream_t st) {
  if (cluster == 2) {
    if (wgs == 3) return launch_pair<3, T>(a, grid, smem, st);
    if (wgs == 2) return launch_pair<2, T>(a, grid, smem, st);
    return launch_pair<1, T>(a, grid, smem, st);
  }
  if (wgs == 3) return launch<3, T>(a, grid, smem, st);
  if (wgs == 2) return launch<2, T>(a, grid, smem, st);
  return launch<1, T>(a, grid, smem, st);
}

}  // namespace

extern "C" {

// Launches the fused kernel and the ordered pool on `stream`, for the tile
// plan (wgs, stages, grid, cluster, smem) of
// kernels/pairwise.py::tile_plan("int8", ...); returns cudaErrorInvalidValue
// for a plan it cannot take: one CTA of wgs warpgroups, each on its own
// 64-row tiles, or (cluster 2, only at H = 512, an even grid) clusters of
// two CTAs of wgs warpgroups, each CTA on half of every layer's columns.
// Device pointers to contiguous tensors: u (B,ni,H), v (B,nj,H), s (B,H) in
// bf16 (in_f32 = 0) or fp32 (in_f32 = 1), already in layer 0's int8 domain;
// qa (B,H) fp32; chunks = pack_weight_chunks(W8^T) int8 (cluster 2: of each
// CTA's pair_halves slice, rank after rank); m (L-1,) and bias (L-1,H) fp32;
// partial (B, ceil(ni*nj / 64), H) and out (B,H) fp32; phases (grid, 9)
// int64 or null (read only by a build with -DRNET_PHASE_TIMES). Returns
// cudaGetLastError().
int rnet_pairwise_fwd_int8(const void* u, const void* v, const void* s, const void* qa, const void* chunks,
                           const void* m, const void* bias, void* partial, void* out, int B, int ni, int nj, int H,
                           int L, int inject, int wgs, int stages, int grid, int cluster, long long smem, int in_f32,
                           void* phases, void* stream) {
  const int nblk = (ni * nj + ROWS - 1) / ROWS;
  const bool one_ok = cluster == 1 && smem == (long long)smem_bytes(wgs, H, L, stages);
  const bool pair_ok = cluster == 2 && H == PAIR_H && grid % 2 == 0 && grid / 2 <= B * nblk &&
                       smem == (long long)smem_bytes_pair(wgs, stages);
  if (!(one_ok || pair_ok) || wgs < 1 || wgs > 3 || H % NT != 0 || L < 2 || stages < 3 || grid < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int q = grid / 2;
  Args a{u, v, s, static_cast<const float*>(qa), static_cast<const int8_t*>(chunks), static_cast<const float*>(m),
         static_cast<const float*>(bias), static_cast<float*>(partial), B, ni, nj, H, L, inject, stages,
         static_cast<long long*>(phases), B * nblk / q, B * nblk % q};
  cudaError_t err = in_f32 ? dispatch<float>(a, wgs, cluster, grid, (size_t)smem, st)
                           : dispatch<bf16>(a, wgs, cluster, grid, (size_t)smem, st);
  if (err != cudaSuccess) return (int)err;
  pool_partials_kernel<<<dim3((H + 127) / 128, B), 128, 0, st>>>(static_cast<const float*>(partial),
                                                                  static_cast<float*>(out), nblk, H);
  return (int)cudaGetLastError();
}

const char* rnet_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
