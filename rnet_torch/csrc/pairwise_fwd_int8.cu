// Int8 pairwise g_theta forward for Hopper (sm_90a): the int8 inference path.
//
// Replaces the TPU kernel rnet/kernels/pairwise.py::_fwd_kernel_int8
// (launched by _fwd_pallas_int8). Every scale is folded outside the kernel
// (rnet_torch/kernels/pairwise.py::quantize_int8): u, v and s arrive in
// layer 0's x127/c0 domain as bf16, W_l as symmetric int8 codes, and each
// layer's dequantize-requantize is one fp32 multiply m_l. For every sample b
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
// truncates toward zero as astype(int8) does (a >= 0). So every int8 code
// equals the plain version's, and only the order of the pooled fp32 sum
// differs. The n^2 pair rows never reach device memory.
//
// What bounds it: 2*B*ni*nj*(L-1)*H^2 int8 operations on the tensor cores.
// At original-fp's B=512 (n=64, H=256, L=4) that is 824 G ops, 0.417 ms at
// the 1,979 TOPS dense int8 peak of the H100 SXM, against 33.6 MB of u + v
// (0.010 ms at 3.35 TB/s): the kernel is bound by operations.
//
// Design (simple first, the structure of pairwise_fwd.cu). One CTA (8 warps)
// takes one sample b and a block of BM = 128 consecutive pair rows
// p = i*nj + j of it; warp w owns rows 16w..16w+15. The int8 activations of
// its rows stay in shared memory, ping-ponging two (BM, H) buffers. int8
// W_l is 64 KB at H=256 and 256 KB at H=512 (wide-fp), so each layer's
// transposed weights W_l^T stream through shared memory in (NC, KC) chunks.
// Products use mma.sync.m16n8k32 s8 x s8 -> s32 with the fragments read as
// 32-bit words (rows padded by 16 bytes: conflict-free); each warp holds a
// 16 x NC int32 accumulator tile. The last layer's epilogue sums its valid
// rows per column (registers, then a shuffle tree over the warp's rows, then
// the warps in order); each CTA writes fp32 column sums to
// partial[b, blk, :] and a second kernel adds the blocks in a fixed order.
// No atomics: served answers repeat from run to run.
//
// Simple first: the weight chunks are loaded synchronously, every CTA reads
// all of W from L2, and fragments come from plain shared-memory loads.
// ldmatrix, cp.async/TMA pipelining and wgmma are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 128;             // pair rows per CTA
constexpr int WARPS = BM / 16;      // one 16-row tile per warp
constexpr int THREADS = WARPS * 32;
constexpr int NC = 128;             // output columns per pass
constexpr int KC = 128;             // input rows of W_l per streamed chunk
constexpr int PAD = 16;             // bytes of row padding in shared memory
constexpr int NT = NC / 8;          // n8 tiles per warp and pass
constexpr int LDW = KC + PAD;

size_t smem_bytes(int H) {
  return 2 * (size_t)BM * (H + PAD)             // int8 activations, ping-pong
         + (size_t)NC * LDW                      // W_l^T chunk
         + (size_t)WARPS * H * sizeof(float);    // per-warp column sums
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// min(a + 0.5, 127) truncated to int8, as jnp.minimum(a + 0.5, 127).astype(int8)
__device__ __forceinline__ int8_t requant(float a) {
  return (int8_t)__float2int_rz(fminf(__fadd_rn(a, 0.5f), 127.0f));
}

__global__ void __launch_bounds__(THREADS)
pairwise_fwd_int8_kernel(const bf16* __restrict__ u, const bf16* __restrict__ v,
                         const bf16* __restrict__ s, const float* __restrict__ qa,
                         const int8_t* __restrict__ w8t, const float* __restrict__ m,
                         const float* __restrict__ bias, float* __restrict__ partial,
                         int ni, int nj, int H, int L, int inject) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int LDA = H + PAD;
  int8_t* cur = reinterpret_cast<int8_t*>(smem);
  int8_t* nxt = cur + BM * LDA;
  int8_t* wbuf = nxt + BM * LDA;
  float* colsum = reinterpret_cast<float*>(wbuf + NC * LDW);  // (WARPS, H)

  const int b = blockIdx.y;
  const int p0 = blockIdx.x * BM;
  const int rows = min(BM, ni * nj - p0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // fragment row group
  const int t = lane % 4;  // thread in group
  const int r0 = warp * 16;
  const bool valid_lo = r0 + g < rows;
  const bool valid_hi = r0 + g + 8 < rows;

  // ---- layer 0: a0 = relu((u_i + v_j) + s) in fp32, requantized ----
  const int vec = H / 8;  // 8 bf16 (16 bytes) per load
  for (int idx = threadIdx.x; idx < BM * vec; idx += THREADS) {
    const int r = idx / vec;
    const int c8 = (idx % vec) * 8;
    uint2 packed = make_uint2(0u, 0u);
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
      int8_t* po = reinterpret_cast<int8_t*>(&packed);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float x = __fadd_rn(__fadd_rn(__bfloat162float(pu[k]), __bfloat162float(pv[k])),
                                  __bfloat162float(ps[k]));
        po[k] = requant(fmaxf(x, 0.0f));
      }
    }
    *reinterpret_cast<uint2*>(cur + r * LDA + c8) = packed;
  }

  // ---- layers 1..L-1 ----
  for (int l = 1; l < L; ++l) {
    const int8_t* Wt = w8t + (size_t)(l - 1) * H * H;  // W_l^T: row n holds column n of W_l
    const float* bl = bias + (size_t)(l - 1) * H;
    const float ml = m[l - 1];
    const bool inj = (l == inject);
    const bool last = (l == L - 1);
    for (int n0 = 0; n0 < H; n0 += NC) {
      int acc[NT][4];
#pragma unroll
      for (int jt = 0; jt < NT; ++jt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[jt][e] = 0;

      for (int k0 = 0; k0 < H; k0 += KC) {
        __syncthreads();  // wbuf free; cur complete
        constexpr int VPR = KC / 16;  // 16-byte vectors per chunk row
        for (int idx = threadIdx.x; idx < NC * VPR; idx += THREADS) {
          const int r = idx / VPR;
          const int c16 = (idx % VPR) * 16;
          *reinterpret_cast<uint4*>(wbuf + r * LDW + c16) =
              *reinterpret_cast<const uint4*>(Wt + (size_t)(n0 + r) * H + k0 + c16);
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < KC; kk += 32) {
          const int8_t* arow = cur + (r0 + g) * LDA + k0 + kk + t * 4;
          const uint32_t a[4] = {ld32(arow), ld32(arow + 8 * LDA), ld32(arow + 16), ld32(arow + 8 * LDA + 16)};
#pragma unroll
          for (int jt = 0; jt < NT; ++jt) {
            const int8_t* brow = wbuf + (jt * 8 + g) * LDW + kk + t * 4;
            mma_s8(acc[jt], a, ld32(brow), ld32(brow + 16));
          }
        }
      }

      // epilogue: fma(float(acc), m, b) [+ qa], relu; requantize into nxt,
      // or (last layer) sum the valid rows of each column
#pragma unroll
      for (int jt = 0; jt < NT; ++jt) {
        const int c = n0 + jt * 8 + 2 * t;
        float x[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c + (e & 1);
          float pre = __fmaf_rn((float)acc[jt][e], ml, bl[col]);
          if (inj) pre = __fadd_rn(pre, qa[(size_t)b * H + col]);
          x[e] = fmaxf(pre, 0.0f);
        }
        if (!last) {
          const uint16_t lo = (uint8_t)requant(x[0]) | ((uint16_t)(uint8_t)requant(x[1]) << 8);
          const uint16_t hi = (uint8_t)requant(x[2]) | ((uint16_t)(uint8_t)requant(x[3]) << 8);
          *reinterpret_cast<uint16_t*>(nxt + (r0 + g) * LDA + c) = lo;
          *reinterpret_cast<uint16_t*>(nxt + (r0 + g + 8) * LDA + c) = hi;
        } else {
          float s0 = (valid_lo ? x[0] : 0.0f) + (valid_hi ? x[2] : 0.0f);
          float s1 = (valid_lo ? x[1] : 0.0f) + (valid_hi ? x[3] : 0.0f);
#pragma unroll
          for (int off = 4; off < 32; off *= 2) {  // over the 8 row groups
            s0 += __shfl_xor_sync(0xffffffffu, s0, off);
            s1 += __shfl_xor_sync(0xffffffffu, s1, off);
          }
          if (g == 0) {
            colsum[warp * H + c] = s0;
            colsum[warp * H + c + 1] = s1;
          }
        }
      }
    }
    __syncthreads();  // nxt complete before it is read
    int8_t* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }

  // ---- this block's column sums, the warps added in order ----
  for (int c = threadIdx.x; c < H; c += THREADS) {
    float sum = 0.0f;
    for (int w = 0; w < WARPS; ++w) sum += colsum[w * H + c];
    partial[((size_t)b * gridDim.x + blockIdx.x) * H + c] = sum;
  }
}

// out[b, c] = sum over blocks of partial[b, blk, c], in block order.
__global__ void pool_partials_kernel(const float* __restrict__ partial,
                                     float* __restrict__ out, int nblk, int H) {
  const int b = blockIdx.y;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= H) return;
  const float* src = partial + (size_t)b * nblk * H + c;
  float sum = 0.0f;
  for (int k = 0; k < nblk; ++k) sum += src[(size_t)k * H];
  out[(size_t)b * H + c] = sum;
}

}  // namespace

extern "C" {

// Rows of pair activations per CTA; the wrapper sizes `partial` as
// (B, ceil(ni*nj / BM), H) fp32.
int rnet_pairwise_fwd_int8_block_rows() { return BM; }

// Shared memory one CTA needs at width H (the wrapper checks it fits).
long long rnet_pairwise_fwd_int8_smem_bytes(int H) { return (long long)smem_bytes(H); }

// Launches the fused kernel and the block reduction on `stream`. All pointers
// are device pointers to contiguous tensors: u (B,ni,H), v (B,nj,H), s (B,H)
// in bf16 (already in layer 0's int8 domain); qa (B,H) fp32; w8t (L-1,H,H)
// int8, the transposed int8 weights (w8t[l][n][k] = W8_l[k][n]); m (L-1,) and
// bias (L-1,H) fp32; partial (B,nblk,H) and out (B,H) fp32. Requires
// H % 128 == 0 and L >= 2. Returns cudaGetLastError().
int rnet_pairwise_fwd_int8(const void* u, const void* v, const void* s, const void* qa,
                           const void* w8t, const void* m, const void* bias, void* partial,
                           void* out, int B, int ni, int nj, int H, int L, int inject,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nblk = (ni * nj + BM - 1) / BM;
  const size_t smem = smem_bytes(H);
  cudaError_t err = cudaFuncSetAttribute(pairwise_fwd_int8_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  pairwise_fwd_int8_kernel<<<dim3(nblk, B), THREADS, smem, st>>>(
      static_cast<const bf16*>(u), static_cast<const bf16*>(v), static_cast<const bf16*>(s),
      static_cast<const float*>(qa), static_cast<const int8_t*>(w8t), static_cast<const float*>(m),
      static_cast<const float*>(bias), static_cast<float*>(partial), ni, nj, H, L, inject);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  pool_partials_kernel<<<dim3((H + 127) / 128, B), 128, 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), nblk, H);
  return (int)cudaGetLastError();
}

const char* rnet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
