// Fused gather + rotate + crop + normalize for Hopper (sm_90a): the train-time
// image augmentation of the device data pipeline.
//
// Replaces the TPU kernels rnet/kernels/augment.py::_augment_kernel and
// _augment_kernel_dma (both launched by _fused_pallas; one function, two DMA
// schemes). For every sample b, with img = cache[idx[b]] * (1/255) in fp32
// (an (S, S, C) uint8 canvas, S = 144 for 128-pixel crops):
//
//     x1[r, c] = sum_{k=-KX..KX} hat(sx[r] - k) * img[r, (c - k) mod S]
//     x2[r, c] = sum_{k=-KY..KY} hat(sy[c] - k) * x1[(r - k) mod S, c]
//     x3[r, c] = sum_{k=-KX..KX} hat(sx[r] - k) * x2[r, (c - k) mod S]
//     out[b, y, x] = x3[oy + y, ox + x]          (y, x < OUT)
//
// hat(t) = max(0, 1 - |t|), sx[r] = tan(a/2) * (r - cy), sy[c] = -sin(a) *
// (c - cx), a = angles[b], (cy, cx) = (offs[b] + (OUT - 1)/2) the crop
// centre in canvas coordinates. This is gather_augment_reference (:298) and
// _augment_one (:90): the three-shear rotation about the crop centre on the
// whole canvas, the rolls wrapping mod S (a crop at offset 0 or S - OUT reads
// rows and columns from the opposite edge), then the crop. The start of the
// crop is clamped to [0, S - OUT] as jax.lax.dynamic_slice clamps; the
// centres use offs as given. Every intermediate is fp32; the output is rounded
// once, to fp32 or bf16 (round to nearest even, as torch's .to()). An idx
// outside [0, N) gives NaN rows (the callers validate indices on the host).
//
// Two taps a shear. hat(t - k) is non-zero only at k = floor(t) and
// floor(t) + 1, and a tap of weight 0 adds exactly +0 to the (finite,
// non-negative) sum. So the 2K+1-tap sum in ascending k equals the sum of
// the taps k0 and k0 + 1, k0 = floor(t) clamped to [-K, K-1] (the taps
// stay inside the reference's [-K, K]; past it the clamped pair holds the
// one tap that can be non-zero), each weight computed as hat(t - k): 19
// taps become 6 (tests/test_torch_augment.py holds the two-tap sum to the
// 2K+1-tap one bit for bit; FMA contraction may differ, as it always did).
//
// What bounds it: bytes. A crop reaches canvas rows oy - KY .. oy + OUT - 1 +
// KY and columns ox - 2*KX .. ox + OUT - 1 + 2*KX, 136 x 136 x 3 = 55,488 B
// of the 62,208 B canvas at S = 144, OUT = 128, (KX, KY) = (2, 4). At B = 512
// that read, one 98,304 B bf16 crop written and 16 B of idx/angle/offsets
// per sample are 78.7 MB: 23.5 us at 3.35 TB/s. The two-tap arithmetic is a
// small fraction of that at 67 TFLOP/s.
//
// Design. A block takes a band of RB = 32 output rows of one sample (grid
// (bands, B): a sample's bands are neighbouring blocks, so the 2*KY halo rows
// they share come from L2). It copies the RB + 2*KY canvas rows the band
// reaches into shared memory with 16-byte cp.async, each row padded on both
// sides with PADPX pixels of the other edge, so that no tap computes a
// column mod S. Then, per group of G = 16 output rows:
//   * x2 (the y shear, fused with the first x shear: x1 is never stored):
//     one thread per channel column c of x2; a row's x2 is the sum of two
//     x1 values of that column (the two taps of the column's y shift), and
//     each x1 the sum of two canvas pixels (the two taps of its row's x
//     shift). The y taps of a column are fixed, so a group's G rows of x2
//     need G + 1 x1 values of the column, computed independently (their
//     loads overlap);
//   * x3: two x2 values of the same row (the row's x taps), the crop written
//     two elements at a time (bf16 x 2 or float2).
// x2 is double-buffered, one barrier a group. A band needs ~72 KB of shared
// memory, three blocks an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "smem_limit.cuh"

namespace {

constexpr int RB = 32;         // output rows per block
constexpr int G = 16;          // output rows per x2 group
constexpr int C = 3;           // RGB, as the cache stores it
constexpr int THREADS = 416;   // 13 warps: one x2 channel column each at OUT + 2*KX = 132

struct Smem {
  int padpx, row_bytes;  // pad pixels on each side of a staged row; bytes of a staged row
  size_t img, tab, x2, total;
};

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// Pad pixels: a multiple of 16 (48 bytes, so rows stay 16-byte aligned) of at
// least the 2*KX columns the crop reaches past either canvas edge.
__host__ __device__ inline Smem smem_layout(int S, int OUT, int KX, int KY) {
  Smem s;
  s.padpx = (2 * KX + 15) / 16 * 16;
  s.row_bytes = (S + 2 * s.padpx) * C;
  const int nrows = RB + 2 * KY;
  s.img = 0;
  s.tab = align16((size_t)nrows * s.row_bytes);
  s.x2 = align16(s.tab + (size_t)nrows * sizeof(float4));
  s.total = align16(s.x2 + 2 * (size_t)G * (OUT + 2 * KX) * C * sizeof(float));
  return s;
}

__device__ inline int wrap(int i, int S) {
  i %= S;
  return i < 0 ? i + S : i;
}

__device__ inline float hat(float t) { return fmaxf(0.0f, 1.0f - fabsf(t)); }

// The two taps of shift t: (hat(t - k0), hat(t - k0 - 1), k0), k0 = floor(t)
// clamped to [-K, K-1]; the fourth slot is the caller's.
__device__ inline float4 taps(float t, int K) {
  const int k0 = min(max((int)floorf(t), -K), K - 1);
  return make_float4(hat(t - (float)k0), hat(t - (float)(k0 + 1)), __int_as_float(k0), 0.0f);
}

// fp32(b) * fp32(1/255) for a byte b, as the reference normalizes, without a
// conversion instruction (they run at an eighth of the fp32 rate): the bits
// 0x4B000000 + b are the float 2^23 + b.
__device__ inline float unit(uint32_t b) {
  return __fmul_rn(__fsub_rn(__uint_as_float(0x4B000000u | b), 8388608.0f), 1.0f / 255.0f);
}

__device__ inline void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"((uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ inline void store1(float* p, float v) { *p = v; }
__device__ inline void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ inline void store2(float* p, float a, float b) { *reinterpret_cast<float2*>(p) = make_float2(a, b); }
__device__ inline void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename OutT>
__global__ void __launch_bounds__(THREADS)
augment_kernel(const uint8_t* __restrict__ cache, long long N, int S, const int* __restrict__ idx,
               const float* __restrict__ angles, const int* __restrict__ offs, OutT* __restrict__ out,
               int OUT, int KX, int KY) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem L = smem_layout(S, OUT, KX, KY);
  uint8_t* img = smem + L.img;
  float4* tab = reinterpret_cast<float4*>(smem + L.tab);
  float* x2buf = reinterpret_cast<float*>(smem + L.x2);

  const int b = blockIdx.y;
  const int y0 = blockIdx.x * RB;
  const int rows = min(RB, OUT - y0);  // output rows of this band
  const int nrows = rows + 2 * KY;     // canvas rows of this band
  const int w2 = (OUT + 2 * KX) * C;   // x2 floats a row
  const int wo = OUT * C;              // output elements a row
  const int tid = threadIdx.x;

  const long long src_i = idx[b];
  const float ang = angles[b];
  const int oy_raw = offs[2 * b], ox_raw = offs[2 * b + 1];
  const float cy = (float)oy_raw + (float)(OUT - 1) / 2.0f;
  const float cx = (float)ox_raw + (float)(OUT - 1) / 2.0f;
  const int oy = min(max(oy_raw, 0), S - OUT);  // dynamic_slice clamps the start
  const int ox = min(max(ox_raw, 0), S - OUT);
  OutT* dst = out + ((size_t)b * OUT + y0) * wo;

  if (src_i < 0 || src_i >= N) {
    for (int e = tid; e < rows * wo; e += THREADS) store1(dst + e, __int_as_float(0x7fc00000));
    return;
  }
  // 64-bit: idx * S*S*C passes 2^31 beyond ~34,500 canvases of 144^2 x 3.
  const uint8_t* src = cache + (size_t)src_i * S * S * C;
  const int r_first = oy + y0 - KY;  // canvas row of band row 0 (before wrap)

  // 1. the band's canvas rows (wrapped mod S), each staged as [the last
  //    padpx pixels | the row | the first padpx pixels], in 16-byte copies:
  //    the wrapper takes only a 16-byte-aligned cache with S*C a multiple
  //    of 16, so every canvas row starts on a 16-byte boundary.
  {
    const int per_row = L.row_bytes / 16, pad16 = L.padpx * C / 16, body16 = S * C / 16;
    for (int e = tid; e < nrows * per_row; e += THREADS) {
      const int j = e / per_row, q = e - j * per_row;
      const int qs = q < pad16 ? body16 - pad16 + q : (q < pad16 + body16 ? q - pad16 : q - pad16 - body16);
      cp_async16(img + (size_t)j * L.row_bytes + 16 * q, src + (size_t)wrap(r_first + j, S) * S * C + 16 * qs);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  // 2. the x taps of every band row (x1 and x3 shear the same row by sx),
  //    with the byte offset in the staged rows of the row's tap k0
  const float tx = tanf(ang / 2.0f);
  for (int j = tid; j < nrows; j += THREADS) {
    float4 t = taps(tx * ((float)wrap(r_first + j, S) - cy), KX);
    t.w = __int_as_float(j * L.row_bytes - __float_as_int(t.z) * C);
    tab[j] = t;
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  const float sy = -sinf(ang);
  // x3 takes the output two elements at a time: pp pairs of a row and rp
  // rows at once
  const int pp = min((wo + 1) / 2, THREADS);
  const int rp = THREADS / pp;
  for (int g0 = 0; g0 < rows; g0 += G) {
    float* x2 = x2buf + ((g0 / G) & 1) * G * w2;
    const int gr = min(G, rows - g0);
    // x2 rows g0 .. g0 + gr - 1 of channel column f = p*C + ch: column p is
    // canvas column ox - KX + p; the y taps (k0, k0+1) read x1 at band rows
    // i + KY - k0 and one above, each x1 the x taps of its row's pixels.
    for (int f = tid; f < w2; f += THREADS) {
      const int p = f / C, ch = f - p * C;
      const float4 ty = taps(sy * ((float)wrap(ox - KX + p, S) - cx), KY);
      const uint8_t* col = img + (L.padpx + ox - KX + p) * C + ch;
      const int q0 = g0 + KY - __float_as_int(ty.z) - 1;  // x1 row of tap k0 + 1 at row g0
      float x1[G + 1];
#pragma unroll
      for (int k = 0; k <= G; ++k) {
        if (k <= gr) {
          const float4 t = tab[q0 + k];
          const uint8_t* px = col + __float_as_int(t.w);
          x1[k] = t.x * unit(px[0]) + t.y * unit(px[-C]);
        }
      }
#pragma unroll
      for (int i = 0; i < G; ++i)
        if (i < gr) x2[i * w2 + f] = ty.x * x1[i + 1] + ty.y * x1[i];
    }
    __syncthreads();  // x2 of this group complete; the other buffer was read before
    // x3 of the group: output column x reads x2 columns x + KX - k0 and one
    // left of it, k0 the row's x tap. A thread takes the element pairs e0,
    // e0 + 2 pp, ... of rows tid / pp, + rp, ...
    if (tid < rp * pp) {
      for (int e0 = 2 * (tid % pp); e0 < wo; e0 += 2 * pp) {
        for (int i = tid / pp; i < gr; i += rp) {
          const float4 t = tab[g0 + i + KY];
          // output element e = x*C + ch reads x2 element e + (KX - k) * C for tap k
          const float* row = x2 + i * w2 + (KX - __float_as_int(t.z)) * C + e0;
          const float va = t.x * row[0] + t.y * row[-C];
          OutT* o = dst + (size_t)(g0 + i) * wo + e0;
          if (wo % 2 == 0) {
            store2(o, va, t.x * row[1] + t.y * row[1 - C]);
          } else {
            store1(o, va);
            if (e0 + 1 < wo) store1(o + 1, t.x * row[1] + t.y * row[1 - C]);
          }
        }
      }
    }
  }
}

template <typename OutT>
cudaError_t launch(const void* cache, long long N, int S, const void* idx, const void* angles,
                   const void* offs, void* out, int B, int OUT, int KX, int KY, cudaStream_t stream) {
  if (KX < 1 || KY < 1 || 2 * KX > S) return cudaErrorInvalidValue;
  const size_t smem = smem_layout(S, OUT, KX, KY).total;
  static size_t allowed = 0;
  cudaError_t err = raise_smem_limit(augment_kernel<OutT>, smem, allowed);
  if (err != cudaSuccess) return err;
  dim3 grid((OUT + RB - 1) / RB, B);
  augment_kernel<OutT><<<grid, THREADS, smem, stream>>>(
      static_cast<const uint8_t*>(cache), N, S, static_cast<const int*>(idx),
      static_cast<const float*>(angles), static_cast<const int*>(offs), static_cast<OutT*>(out), OUT,
      KX, KY);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// cache (N, S, S, C) uint8 with C = 3, 16-byte aligned, S*C a multiple of
// 16; idx (B,) int32, angles (B,) fp32 radians, offs (B, 2) int32 (row,
// col), out (B, OUT, OUT, C) fp32 (out_bf16 = 0) or bf16 (out_bf16 = 1); all
// contiguous on one device. Launches on `stream` and returns the error of
// raise_smem_limit (a band that needs more shared memory than a block
// may have) or cudaGetLastError().
int rnet_augment(const void* cache, long long N, int S, const void* idx, const void* angles,
                 const void* offs, void* out, int B, int OUT, int KX, int KY, int out_bf16,
                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    return (int)launch<__nv_bfloat16>(cache, N, S, idx, angles, offs, out, B, OUT, KX, KY, st);
  return (int)launch<float>(cache, N, S, idx, angles, offs, out, B, OUT, KX, KY, st);
}

const char* rnet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
