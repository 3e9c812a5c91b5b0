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
// (0.010 ms at 3.35 TB/s): the kernel is bound by operations. At that rate
// the products of a 64-row tile take less time than its CUDA-core work
// (a_0: two adds, a round and a pack per element; the epilogues: a convert,
// an fma, a round and a pack per accumulator; the pool), so the design is
// about overlapping the two; on the card the CUDA-core work is what the
// kernel waits on (PERF.md §6).
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
//     WGS = 1, so that 64-row tiles give every SM work. ptxas serializes
//     the int8 wgmma of a product (its note C7520: a compiler-inserted
//     warpgroup.arrive in a divergent path), which the other warpgroups'
//     work covers;
//   * a_0 is built by the warpgroup for its own tile, 16 columns (one core
//     matrix row) a thread, s held in registers, the u and v loads of four
//     rows in flight before any is used;
//   * the last layer pools its valid rows in fp32 from registers (a
//     thread's two rows, a fixed shuffle tree over the warp's 16 rows, the 4
//     warps in order) into partial[tile, :], and a second kernel adds a
//     sample's tiles in a fixed order (no atomics: served answers repeat).
// With -DRNET_PHASE_TIMES the first consumer thread of each CTA sums
// clock64() per phase (products, epilogues, pool, feed waits, a_0,
// warpgroup barriers) into `phases` (grid, NPHASE).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "pairwise_chain.cuh"
#include "smem_limit.cuh"

namespace {

using namespace rnet;

enum { PH_PRODUCTS, PH_EPILOGUES, PH_POOL, PH_FEED, PH_A0, PH_SYNC };

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

template <typename T>
cudaError_t dispatch(const Args& a, int wgs, int grid, size_t smem, cudaStream_t st) {
  if (wgs == 3) return launch<3, T>(a, grid, smem, st);
  if (wgs == 2) return launch<2, T>(a, grid, smem, st);
  return launch<1, T>(a, grid, smem, st);
}

}  // namespace

extern "C" {

// Launches the fused kernel and the ordered pool on `stream`, for the tile
// plan (wgs, stages, grid, smem) of kernels/pairwise.py::tile_plan("int8",
// ...); returns cudaErrorInvalidValue for a plan it cannot take. Device
// pointers to contiguous tensors: u (B,ni,H), v (B,nj,H), s (B,H) in bf16
// (in_f32 = 0) or fp32 (in_f32 = 1), already in layer 0's int8 domain; qa
// (B,H) fp32; chunks = pack_weight_chunks(W8^T) int8; m (L-1,) and bias
// (L-1,H) fp32; partial (B, ceil(ni*nj / 64), H) and out (B,H) fp32; phases
// (grid, 8) int64 or null (read only by a build with -DRNET_PHASE_TIMES).
// Returns cudaGetLastError().
int rnet_pairwise_fwd_int8(const void* u, const void* v, const void* s, const void* qa, const void* chunks,
                           const void* m, const void* bias, void* partial, void* out, int B, int ni, int nj, int H,
                           int L, int inject, int wgs, int stages, int grid, long long smem, int in_f32, void* phases,
                           void* stream) {
  if (wgs < 1 || wgs > 3 || H % NT != 0 || L < 2 || stages < 3 || grid < 1 ||
      smem != (long long)smem_bytes(wgs, H, L, stages))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args a{u, v, s, static_cast<const float*>(qa), static_cast<const int8_t*>(chunks), static_cast<const float*>(m),
         static_cast<const float*>(bias), static_cast<float*>(partial), B, ni, nj, H, L, inject, stages,
         static_cast<long long*>(phases)};
  cudaError_t err = in_f32 ? dispatch<float>(a, wgs, grid, (size_t)smem, st)
                           : dispatch<bf16>(a, wgs, grid, (size_t)smem, st);
  if (err != cudaSuccess) return (int)err;
  const int nblk = (ni * nj + ROWS - 1) / ROWS;
  pool_partials_kernel<<<dim3((H + 127) / 128, B), 128, 0, st>>>(static_cast<const float*>(partial),
                                                                  static_cast<float*>(out), nblk, H);
  return (int)cudaGetLastError();
}

const char* rnet_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
