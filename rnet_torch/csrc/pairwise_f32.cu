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
// on the tensor cores (mma.sync.m16n8k8.tf32): x = hi + lo with hi =
// tf32(x), lo = tf32(x - hi), and a.b = a_lo.b_hi + a_hi.b_lo + a_hi.b_hi;
// each k-step's three products sum from zero on the tensor cores and reach
// the running sum by a rounded fp32 add (mma3). The dropped a_lo.b_lo term
// and the rounding of lo are below 2^-21 of |a.b|, so a dot product is as
// exact as an fp32 FFMA sum to within a few ulps. Single-pass TF32 (10-bit
// mantissa) is not used.
//
// What bounds it: tensor-core operations, three TF32 products per fp32
// product. At original-fp B=512 (n=64, H=256, L=4) the forward's 0.82
// TFLOP are 2.47 TFLOP of TF32, 5.0 ms at 495 TFLOP/s (dense TF32); the
// backward (recompute, d and dW products) three times that.
//
// Design: the simple kernel; no TMA and no wgmma (wgmma reads tf32 operands
// K-major only, and the backward reads the activation tiles both ways;
// mma.sync fragments loaded by plain ld.shared have no layout constraint).
//   * 256 threads, 8 warps. A block of BM pair rows (64, 32 or 16: the plan
//     of kernels/pairwise.py::tile_plan(..., esize=4)) keeps its activation
//     tiles in shared memory as BM rows of H + 4 floats (conflict-free
//     fragment reads).
//   * W_l (W_l^T in the backward's d products) streams through two 32 KB
//     chunks (8192 / H rows of H + 8 floats) by cp.async, the next chunk
//     loading while the current one is used.
//   * Each warp owns up to two 16 x 64 output tiles of a layer, with the
//     same 64 columns (H / 64 divides 8), so the B fragments are shared; the
//     accumulators stay in registers, and fragments are split into hi / lo
//     as they are read.
//   * Forward: a grid-stride walk over (sample, block) tiles; a block's
//     column sums go to its own partial row, and pool_kernel adds a
//     sample's partials in block order.
//   * Backward: one owner CTA per sample (a persistent grid of min(B, SMs))
//     walks the sample's blocks in order, keeping a_0 .. a_{L-2} and
//     dpre_{L-1} (L tiles); dpre_{l-1} overwrites a_{l-1} in place once dW_l
//     has read it. dW_l is added onto the CTA's own fp32 partial (each 16 x
//     64 register tile of the block's rows added with fp32 adds), db_l onto
//     its own fp64 row; one fixed thread per column adds a block's du / dv
//     rows in row order, and its ds / dqa sums onto the sample's fp64
//     running sums. sum_partials_kernel adds the dW and db partials over the
//     CTAs in CTA order. Every output has one fixed writer and a fixed order
//     of adds: the gradients are bitwise repeatable.

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int WN = 64;             // columns of a warp's output tile
constexpr int NTL = WN / 8;        // mma n-tiles of 8 columns in it
constexpr int CHUNK_FLOATS = 8192;  // one streamed W chunk: CHUNK_FLOATS / H rows

__host__ __device__ constexpr int act_stride(int H) { return H + 4; }
__host__ __device__ constexpr int w_stride(int H) { return H + 8; }
__host__ __device__ constexpr int chunk_rows(int H) { return CHUNK_FLOATS / H; }

// Shared memory: `slots` activation tiles, two W chunks, the row scales.
size_t smem_bytes(int bm, int H, int slots) {
  return ((size_t)slots * bm * act_stride(H) + 2 * (size_t)chunk_rows(H) * w_stride(H) + bm) * sizeof(float);
}

// ---------------------------------------------------------------------------
// 3xTF32 products on mma.sync.m16n8k8 (fragments: g = lane / 4, t = lane % 4;
// A (16 x 8): {(g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)}; B (8 x 8):
// {(t, g), (t + 4, g)}; C (16 x 8): {(g, 2t), (g, 2t + 1), (g + 8, 2t),
// (g + 8, 2t + 1)})
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a . b (one k-step of 8) in 3xTF32, the small terms first. The
// tensor cores' fp32 accumulation truncates, so the step's three products
// sum from zero and reach c by one rounded fp32 add: over the 32-64 steps of
// a layer (and the thousands of blocks of a dW partial) truncation would
// bias a sum by up to ~1e-5 relative (and ~1e-2).
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2], const uint32_t (&bl)[2]) {
  float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += d[e];
}

// The A fragment at rows r0.., columns k.. of a row-major tile (stride sa).
__device__ __forceinline__ void a_frag(const float* A, int sa, int r0, int k, int g, int t, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  const float* p = A + (r0 + g) * sa + k + t;
  split(p[0], hi[0], lo[0]);
  split(p[8 * sa], hi[1], lo[1]);
  split(p[4], hi[2], lo[2]);
  split(p[8 * sa + 4], hi[3], lo[3]);
}

// The A fragment at rows m0.., columns k.. of T^T, T a row-major tile (stride st).
__device__ __forceinline__ void at_frag(const float* T, int st, int m0, int k, int g, int t, uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
  const float* p = T + (k + t) * st + m0 + g;
  split(p[0], hi[0], lo[0]);
  split(p[8], hi[1], lo[1]);
  split(p[4 * st], hi[2], lo[2]);
  split(p[4 * st + 8], hi[3], lo[3]);
}

// The B fragment at rows k.., columns n.. of a row-major matrix (stride sb).
__device__ __forceinline__ void b_frag(const float* Bm, int sb, int k, int n, int g, int t, uint32_t (&hi)[2],
                                       uint32_t (&lo)[2]) {
  const float* p = Bm + (k + t) * sb + n + g;
  split(p[0], hi[0], lo[0]);
  split(p[4 * sb], hi[1], lo[1]);
}

// A warp's share of an M x H product: output tiles u = first + 8 s (s = 0,
// 1) of 16 rows x 64 columns, tile u at rows 16 (u / nch) and columns 64 (u
// % nch), nch = H / 64. first = warp (mod 8) and nch divides 8, so both
// tiles have the warp's columns.
struct Tiles {
  int row[2];
  bool on[2];
  int col;
};

template <int H>
__device__ __forceinline__ Tiles tiles_of(int first, int ntiles) {
  constexpr int NCH = H / WN;
  Tiles tl;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int u = first + WARPS * s;
    tl.on[s] = u < ntiles;
    tl.row[s] = 16 * (u / NCH);
  }
  tl.col = WN * (first % NCH);
  return tl;
}

// ---------------------------------------------------------------------------
// The W stream and the products
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows k0 .. k0 + chunk_rows(H) - 1 of the row-major H x H matrix W into buf
// (rows of H + 8 floats), 16 bytes a thread at a time; one commit group.
template <int H>
__device__ __forceinline__ void load_chunk(const float* __restrict__ W, int k0, float* buf) {
  constexpr int PER_ROW = H / 4, N = chunk_rows(H) * PER_ROW, SW = w_stride(H);
  for (int q = threadIdx.x; q < N; q += THREADS) {
    const int r = q / PER_ROW, c = 4 * (q - r * PER_ROW);
    cp_async16(buf + r * SW + c, W + (size_t)(k0 + r) * H + c);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// acc = A . W on the warp's tiles `tl` of the BM x H product of the
// activation tile A (rows of H + 4 floats) and the row-major H x H matrix W
// in device memory, streamed through wbuf. Every thread of the CTA calls it;
// it ends with a barrier, after which A and wbuf are free.
template <int H>
__device__ __forceinline__ void streamed_product(float (&acc)[2][NTL][4], const Tiles& tl, const float* A,
                                                 const float* __restrict__ W, float* wbuf) {
  constexpr int SA = act_stride(H), SW = w_stride(H), KC = chunk_rows(H), NCHUNK = H / KC;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int j = 0; j < NTL; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[s][j][e] = 0.0f;
  load_chunk<H>(W, 0, wbuf);
  for (int c = 0; c < NCHUNK; ++c) {
    const float* cur = wbuf + (c & 1) * KC * SW;
    if (c + 1 < NCHUNK) {
      load_chunk<H>(W, (c + 1) * KC, wbuf + ((c + 1) & 1) * KC * SW);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
#pragma unroll 2
    for (int kk = 0; kk < KC; kk += 8) {
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int s = 0; s < 2; ++s)
        if (tl.on[s]) a_frag(A, SA, tl.row[s], c * KC + kk, g, t, ah[s], al[s]);
#pragma unroll
      for (int j = 0; j < NTL; ++j) {
        uint32_t bh[2], bl[2];
        b_frag(cur, SW, kk, tl.col + 8 * j, g, t, bh, bl);
#pragma unroll
        for (int s = 0; s < 2; ++s)
          if (tl.on[s]) mma3(acc[s][j], ah[s], al[s], bh, bl);
      }
    }
    __syncthreads();  // chunk c's buffer is refilled at c + 2
  }
}

// part (H x H, row-major, device memory) += T^T . D over the bm rows of the
// block, T and D activation tiles (rows of H + 4 floats): 16 x 64 tiles of
// part, two a warp per round, each added by the same threads in every block
// (the block's product from zero, then one fp32 add onto the partial).
template <int H>
__device__ __forceinline__ void dw_accumulate(float* __restrict__ part, const float* T, const float* D, int bm) {
  constexpr int SA = act_stride(H), NT = (H / 16) * (H / WN);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int first = warp; first < NT; first += 2 * WARPS) {
    const Tiles tl = tiles_of<H>(first, NT);
    float acc[2][NTL][4];
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int j = 0; j < NTL; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[s][j][e] = 0.0f;
    for (int k = 0; k < bm; k += 8) {
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int s = 0; s < 2; ++s) at_frag(T, SA, tl.row[s], k, g, t, ah[s], al[s]);
#pragma unroll
      for (int j = 0; j < NTL; ++j) {
        uint32_t bh[2], bl[2];
        b_frag(D, SA, k, tl.col + 8 * j, g, t, bh, bl);
#pragma unroll
        for (int s = 0; s < 2; ++s) mma3(acc[s][j], ah[s], al[s], bh, bl);
      }
    }
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int j = 0; j < NTL; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float2* p = reinterpret_cast<float2*>(part + (size_t)(tl.row[s] + g + 8 * h) * H + tl.col + 8 * j + 2 * t);
          const float2 x = *p;
          *p = make_float2(x.x + acc[s][j][2 * h], x.y + acc[s][j][2 * h + 1]);
        }
  }
}

// ---------------------------------------------------------------------------
// Block set-up and epilogues
// ---------------------------------------------------------------------------

// a_0 of rows p0 .. p0 + valid - 1 of sample b into X; rows valid .. bm - 1
// are zero (finite, so that their products are exact zeros downstream).
template <int H>
__device__ __forceinline__ void fill_a0(float* X, const float* __restrict__ u, const float* __restrict__ v,
                                        const float* __restrict__ s, int b, int ni, int nj, int p0, int valid,
                                        int bm) {
  constexpr int SA = act_stride(H), Q = H / 4;
  for (int q = threadIdx.x; q < bm * Q; q += THREADS) {
    const int r = q / Q, c = 4 * (q - r * Q);
    float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r < valid) {
      const int p = p0 + r, i = p / nj, j = p - i * nj;
      const float4 x = *reinterpret_cast<const float4*>(u + ((size_t)b * ni + i) * H + c);
      const float4 y = *reinterpret_cast<const float4*>(v + ((size_t)b * nj + j) * H + c);
      const float4 z = *reinterpret_cast<const float4*>(s + (size_t)b * H + c);
      a = make_float4(fmaxf(x.x + y.x + z.x, 0.0f), fmaxf(x.y + y.y + z.y, 0.0f), fmaxf(x.z + y.z + z.z, 0.0f),
                      fmaxf(x.w + y.w + z.w, 0.0f));
    }
    *reinterpret_cast<float4*>(X + r * SA + c) = a;
  }
}

// Row r's pool / upstream-gradient scale: 0 past the valid rows, else 1, or
// under pair dropout 1/keep for a kept pair and 0 for a dropped one.
template <bool DROP>
__device__ __forceinline__ void fill_row_scales(float* rowscale, int bm, int valid, int p0, int b, uint64_t key,
                                                uint32_t thr, float inv_keep) {
  for (int r = threadIdx.x; r < bm; r += THREADS) {
    float m = r < valid ? 1.0f : 0.0f;
    if (DROP && r < valid) m = rnet::pair_kept(key, (uint32_t)(p0 + r), (uint32_t)b, thr) ? inv_keep : 0.0f;
    rowscale[r] = m;
  }
}

// The epilogues, on the accumulator element of row r, columns c, c + 1:
// EPI_RELU stores relu((acc + b) [+ qa]); EPI_DTOP stores dpre_{L-1} =
// [pre > 0] g m_r of pre = (acc + b) [+ qa]; EPI_MASK overwrites the tile's
// a with [a > 0] acc.
enum { EPI_RELU, EPI_DTOP, EPI_MASK };

template <int H, int EPI>
__device__ __forceinline__ void epilogue(const float (&acc)[2][NTL][4], const Tiles& tl, float* out,
                                         const float* __restrict__ bias, const float* __restrict__ q,
                                         const float* __restrict__ gup, const float* rowscale) {
  constexpr int SA = act_stride(H);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    if (!tl.on[s]) continue;
#pragma unroll
    for (int j = 0; j < NTL; ++j) {
      const int c = tl.col + 8 * j + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = tl.row[s] + g + 8 * h;
        float2* dst = reinterpret_cast<float2*>(out + r * SA + c);
        float x0 = acc[s][j][2 * h], x1 = acc[s][j][2 * h + 1];
        if (EPI == EPI_MASK) {
          const float2 a = *dst;
          *dst = make_float2(a.x > 0.0f ? x0 : 0.0f, a.y > 0.0f ? x1 : 0.0f);
          continue;
        }
        x0 += bias[c];
        x1 += bias[c + 1];
        if (q != nullptr) {
          x0 += q[c];
          x1 += q[c + 1];
        }
        if (EPI == EPI_RELU) {
          *dst = make_float2(fmaxf(x0, 0.0f), fmaxf(x1, 0.0f));
        } else {
          const float m = rowscale[r];
          *dst = make_float2(x0 > 0.0f ? gup[c] * m : 0.0f, x1 > 0.0f ? gup[c + 1] * m : 0.0f);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Kernels
// ---------------------------------------------------------------------------

template <int H, bool DROP>
__global__ void __launch_bounds__(THREADS, 1)
    pairwise_fwd_f32_kernel(const float* __restrict__ u, const float* __restrict__ v, const float* __restrict__ s,
                            const float* __restrict__ qa, const float* __restrict__ ws,
                            const float* __restrict__ bs, float* __restrict__ partial, int B, int ni, int nj, int L,
                            int inject, int bm, const int64_t* __restrict__ seed, uint32_t thr, float inv_keep) {
  extern __shared__ __align__(16) float smem[];
  constexpr int SA = act_stride(H), SW = w_stride(H), KC = chunk_rows(H);
  float* X = smem;
  float* Y = X + bm * SA;
  float* wbuf = Y + bm * SA;
  float* rowscale = wbuf + 2 * KC * SW;
  const int npairs = ni * nj, nblk = (npairs + bm - 1) / bm;
  const Tiles tl = tiles_of<H>(threadIdx.x >> 5, (bm / 16) * (H / WN));
  const uint64_t key = DROP ? (uint64_t)*seed : 0;
  for (long long tile = blockIdx.x; tile < (long long)B * nblk; tile += gridDim.x) {
    const int b = (int)(tile / nblk), blk = (int)(tile % nblk);
    const int p0 = blk * bm, valid = min(bm, npairs - p0);
    fill_a0<H>(X, u, v, s, b, ni, nj, p0, valid, bm);
    fill_row_scales<DROP>(rowscale, bm, valid, p0, b, key, thr, inv_keep);
    __syncthreads();
    float* in = X;
    float* out = Y;
    for (int l = 1; l < L; ++l) {
      float acc[2][NTL][4];
      streamed_product<H>(acc, tl, in, ws + (size_t)(l - 1) * H * H, wbuf);
      epilogue<H, EPI_RELU>(acc, tl, out, bs + (l - 1) * H, l == inject ? qa + (size_t)b * H : nullptr, nullptr,
                            nullptr);
      __syncthreads();
      float* tmp = in;
      in = out;
      out = tmp;
    }
    for (int c = threadIdx.x; c < H; c += THREADS) {
      float sum = 0.0f;
      for (int r = 0; r < valid; ++r) sum += in[r * SA + c] * rowscale[r];
      partial[((size_t)b * nblk + blk) * H + c] = sum;
    }
    __syncthreads();
  }
}

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

template <int H, bool DROP>
__global__ void __launch_bounds__(THREADS, 1)
    pairwise_bwd_f32_kernel(const float* __restrict__ u, const float* __restrict__ v, const float* __restrict__ s,
                            const float* __restrict__ qa, const float* __restrict__ ws,
                            const float* __restrict__ wt, const float* __restrict__ bs,
                            const float* __restrict__ gup, float* __restrict__ du, float* __restrict__ dv,
                            float* __restrict__ ds, float* __restrict__ dqa, float* __restrict__ dw_part,
                            double* __restrict__ db_part, double* __restrict__ sums, int B, int ni, int nj,
                            int L, int inject, int bm, const int64_t* __restrict__ seed, uint32_t thr,
                            float inv_keep) {
  extern __shared__ __align__(16) float smem[];
  constexpr int SA = act_stride(H), SW = w_stride(H), KC = chunk_rows(H);
  // slot k < L-1 holds a_k, then dpre_k; slot L-1 holds dpre_{L-1}
  auto slot = [&](int k) { return smem + (size_t)k * bm * SA; };
  float* wbuf = smem + (size_t)L * bm * SA;
  float* rowscale = wbuf + 2 * KC * SW;
  const int npairs = ni * nj, nblk = (npairs + bm - 1) / bm;
  const Tiles tl = tiles_of<H>(threadIdx.x >> 5, (bm / 16) * (H / WN));
  float* dwp = dw_part + (size_t)blockIdx.x * (L - 1) * H * H;
  double* dbp = db_part + (size_t)blockIdx.x * (L - 1) * H;
  const uint64_t key = DROP ? (uint64_t)*seed : 0;
  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    for (int blk = 0; blk < nblk; ++blk) {
      const int p0 = blk * bm, valid = min(bm, npairs - p0);
      const bool last = blk == nblk - 1;
      fill_a0<H>(slot(0), u, v, s, b, ni, nj, p0, valid, bm);
      fill_row_scales<DROP>(rowscale, bm, valid, p0, b, key, thr, inv_keep);
      __syncthreads();
      // recompute a_1 .. a_{L-2}, and dpre_{L-1} from the last layer's pre-activation
      for (int l = 1; l < L; ++l) {
        float acc[2][NTL][4];
        streamed_product<H>(acc, tl, slot(l - 1), ws + (size_t)(l - 1) * H * H, wbuf);
        const float* q = l == inject ? qa + (size_t)b * H : nullptr;
        if (l < L - 1)
          epilogue<H, EPI_RELU>(acc, tl, slot(l), bs + (l - 1) * H, q, nullptr, nullptr);
        else
          epilogue<H, EPI_DTOP>(acc, tl, slot(l), bs + (l - 1) * H, q, gup + (size_t)b * H, rowscale);
        __syncthreads();
      }
      // backprop: dpre_l is in slot l
      for (int l = L - 1; l >= 1; --l) {
        const float* dcur = slot(l);
        dw_accumulate<H>(dwp + (size_t)(l - 1) * H * H, slot(l - 1), dcur, bm);
        for (int c = threadIdx.x; c < H; c += THREADS) {
          float sum = 0.0f;
          for (int r = 0; r < valid; ++r) sum += dcur[r * SA + c];
          dbp[(l - 1) * H + c] += sum;
          if (l == inject) {
            const double q = sums[((size_t)b * 2 + 1) * H + c] += sum;
            if (last) dqa[(size_t)b * H + c] = (float)q;
          }
        }
        __syncthreads();  // dW_l has read a_{l-1}: dpre_{l-1} may replace it
        float acc[2][NTL][4];
        streamed_product<H>(acc, tl, dcur, wt + (size_t)(l - 1) * H * H, wbuf);
        epilogue<H, EPI_MASK>(acc, tl, slot(l - 1), nullptr, nullptr, nullptr, nullptr);
        __syncthreads();
      }
      // dpre_0 (slot 0) into ds, du (over j) and dv (over i), row by row
      const float* d0 = slot(0);
      for (int c = threadIdx.x; c < H; c += THREADS) {
        float dsum = 0.0f, dui = 0.0f;
        int i_cur = p0 / nj;
        for (int r = 0; r < valid; ++r) {
          const int p = p0 + r, i = p / nj, j = p - i * nj;
          const float x = d0[r * SA + c];
          if (i != i_cur) {
            du[((size_t)b * ni + i_cur) * H + c] += dui;
            dui = 0.0f;
            i_cur = i;
          }
          dui += x;
          dsum += x;
          dv[((size_t)b * nj + j) * H + c] += x;
        }
        du[((size_t)b * ni + i_cur) * H + c] += dui;
        const double sd = sums[(size_t)b * 2 * H + c] += dsum;
        if (last) ds[(size_t)b * H + c] = (float)sd;
      }
      __syncthreads();
    }
  }
}

// out[k] = sum over CTAs c = 0 .. G-1 (in order) of part[c, k].
template <typename T>
__global__ void sum_partials_kernel(const T* __restrict__ part, float* __restrict__ out, int G, long long n) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  T sum = 0;
  for (int c = 0; c < G; ++c) sum += part[(size_t)c * n + k];
  out[k] = (float)sum;
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

struct Args {
  const float *u, *v, *s, *qa, *ws, *wt, *bs, *g;
  float *partial, *du, *dv, *ds, *dqa, *dw_part;
  double *db_part, *sums;
  int B, ni, nj, L, inject, bm;
  const int64_t* seed;
  uint32_t thr;
  float inv_keep;
};

template <int H, bool DROP>
cudaError_t launch_fwd(const Args& a, int grid, size_t smem, cudaStream_t st) {
  auto kern = pairwise_fwd_f32_kernel<H, DROP>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, THREADS, smem, st>>>(a.u, a.v, a.s, a.qa, a.ws, a.bs, a.partial, a.B, a.ni, a.nj, a.L, a.inject,
                                    a.bm, a.seed, a.thr, a.inv_keep);
  return cudaGetLastError();
}

template <int H, bool DROP>
cudaError_t launch_bwd(const Args& a, int grid, size_t smem, cudaStream_t st) {
  auto kern = pairwise_bwd_f32_kernel<H, DROP>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, THREADS, smem, st>>>(a.u, a.v, a.s, a.qa, a.ws, a.wt, a.bs, a.g, a.du, a.dv, a.ds, a.dqa, a.dw_part,
                                    a.db_part, a.sums, a.B, a.ni, a.nj, a.L, a.inject, a.bm, a.seed, a.thr,
                                    a.inv_keep);
  return cudaGetLastError();
}

template <bool BWD, int H>
cudaError_t launch(const Args& a, bool drop, int grid, size_t smem, cudaStream_t st) {
  if constexpr (BWD) return drop ? launch_bwd<H, true>(a, grid, smem, st) : launch_bwd<H, false>(a, grid, smem, st);
  else return drop ? launch_fwd<H, true>(a, grid, smem, st) : launch_fwd<H, false>(a, grid, smem, st);
}

template <bool BWD>
cudaError_t dispatch(const Args& a, int H, bool drop, int grid, size_t smem, cudaStream_t st) {
  switch (H) {
    case 128: return launch<BWD, 128>(a, drop, grid, smem, st);
    case 256: return launch<BWD, 256>(a, drop, grid, smem, st);
    case 512: return launch<BWD, 512>(a, drop, grid, smem, st);
    default: return cudaErrorInvalidValue;
  }
}

// The plan checks both launchers share: H in {128, 256, 512} (H / 64
// divides the 8 warps), bm in {16, 32, 64} with at most two 16 x 64 output
// tiles a warp, and the plan's shared memory.
bool plan_ok(int H, int L, int bm, int grid, long long smem, int slots) {
  return (H == 128 || H == 256 || H == 512) && L >= 2 && (bm == 16 || bm == 32 || bm == 64) &&
         bm * H <= 2 * WARPS * 16 * WN && grid >= 1 && smem == (long long)smem_bytes(bm, H, slots);
}

}  // namespace

extern "C" {

// Launches the fp32 forward on `stream` for the plan (bm, grid, smem) of
// kernels/pairwise.py::tile_plan("fwd", ..., esize=4), then the ordered
// pool of the per-block partials; cudaErrorInvalidValue for a plan it
// cannot take. Device pointers to contiguous fp32 tensors, u, v, s and ws
// 16-byte aligned: u (B,ni,H), v (B,nj,H), s, qa (B,H), ws (L-1,H,H), bs
// (L-1,H); partial (B, nblk, H) scratch; out (B,H). drop != 0 turns on the
// pair mask of philox.cuh with the int64 seed at `seed` (device) and the
// threshold thr, kept rows scaled by inv_keep. Returns cudaGetLastError().
int rnet_pairwise_fwd_f32(const void* u, const void* v, const void* s, const void* qa, const void* ws,
                          const void* bs, void* partial, void* out, int B, int ni, int nj, int H, int L,
                          int inject, int bm, int grid, long long smem, int drop, const void* seed,
                          unsigned int thr, float inv_keep, void* stream) {
  if (!plan_ok(H, L, bm, grid, smem, 2)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args a{};
  a.u = static_cast<const float*>(u);
  a.v = static_cast<const float*>(v);
  a.s = static_cast<const float*>(s);
  a.qa = static_cast<const float*>(qa);
  a.ws = static_cast<const float*>(ws);
  a.bs = static_cast<const float*>(bs);
  a.partial = static_cast<float*>(partial);
  a.B = B, a.ni = ni, a.nj = nj, a.L = L, a.inject = inject, a.bm = bm;
  a.seed = static_cast<const int64_t*>(seed), a.thr = thr, a.inv_keep = inv_keep;
  cudaError_t err = dispatch<false>(a, H, drop != 0, grid, (size_t)smem, st);
  if (err != cudaSuccess) return (int)err;
  const int nblk = (ni * nj + bm - 1) / bm, n = B * H;
  pool_kernel<<<(n + 255) / 256, 256, 0, st>>>(a.partial, static_cast<float*>(out), nblk, H, n);
  return (int)cudaGetLastError();
}

// Launches the fp32 backward on `stream` for the plan (bm, grid, smem) of
// tile_plan("bwd", ..., esize=4): the fused kernel, then the ordered sums of
// the dW and db partials. Inputs as rnet_pairwise_fwd_f32's, plus wt (L-1,H,H)
// = W_l^T of every layer (16-byte aligned) and g (B,H) the upstream
// gradient; outputs du (B,ni,H), dv (B,nj,H), ds, dqa (B,H), dws (L-1,H,H),
// dbs (L-1,H) fp32, of which du, dv and dqa must be zero; scratch, zero:
// dw_part (grid,L-1,H,H) fp32, and in fp64 (the sums over a sample's or a
// CTA's blocks: thousands of addends of one sign at n = 1024) db_part
// (grid,L-1,H) and sums (B,2,H), ds and dqa of each sample. Returns
// cudaGetLastError().
int rnet_pairwise_bwd_f32(const void* u, const void* v, const void* s, const void* qa, const void* ws,
                          const void* wt, const void* bs, const void* g, void* du, void* dv, void* ds, void* dqa,
                          void* dws, void* dbs, void* dw_part, void* db_part, void* sums, int B, int ni, int nj,
                          int H, int L,
                          int inject, int bm, int grid, long long smem, int drop, const void* seed,
                          unsigned int thr, float inv_keep, void* stream) {
  if (!plan_ok(H, L, bm, grid, smem, L)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args a{};
  a.u = static_cast<const float*>(u);
  a.v = static_cast<const float*>(v);
  a.s = static_cast<const float*>(s);
  a.qa = static_cast<const float*>(qa);
  a.ws = static_cast<const float*>(ws);
  a.wt = static_cast<const float*>(wt);
  a.bs = static_cast<const float*>(bs);
  a.g = static_cast<const float*>(g);
  a.du = static_cast<float*>(du), a.dv = static_cast<float*>(dv), a.ds = static_cast<float*>(ds);
  a.dqa = static_cast<float*>(dqa), a.dw_part = static_cast<float*>(dw_part);
  a.db_part = static_cast<double*>(db_part), a.sums = static_cast<double*>(sums);
  a.B = B, a.ni = ni, a.nj = nj, a.L = L, a.inject = inject, a.bm = bm;
  a.seed = static_cast<const int64_t*>(seed), a.thr = thr, a.inv_keep = inv_keep;
  cudaError_t err = dispatch<true>(a, H, drop != 0, grid, (size_t)smem, st);
  if (err != cudaSuccess) return (int)err;
  const long long nw = (long long)(L - 1) * H * H, nb = (long long)(L - 1) * H;
  sum_partials_kernel<float><<<(unsigned)((nw + 255) / 256), 256, 0, st>>>(a.dw_part, static_cast<float*>(dws), grid,
                                                                           nw);
  sum_partials_kernel<double><<<(unsigned)((nb + 255) / 256), 256, 0, st>>>(a.db_part, static_cast<float*>(dbs),
                                                                            grid, nb);
  return (int)cudaGetLastError();
}

const char* rnet_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
