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
// What bounds it: bytes. A crop reaches canvas rows oy - KY .. oy + OUT - 1 +
// KY and columns ox - 2*KX .. ox + OUT - 1 + 2*KX, 136 x 136 x 3 = 55,488 B
// of the 62,208 B canvas at S = 144, OUT = 128, (KX, KY) = (2, 4). At B = 512
// that read, one 98,304 B bf16 crop written and 16 B of idx/angle/offsets
// per sample are 78.7 MB: 23.5 us at 3.35 TB/s. The fp32 shear arithmetic
// over the same region (2*(2K+1) flops per element of x1, x2, x3), 0.99
// GFLOP, is 14.8 us at 67 TFLOP/s.
//
// Design (staged shears). The TPU processed a whole canvas per grid step in
// VMEM; a 144x144x3 fp32 canvas is 249 KB, more than a block's 227 KB of
// shared memory, so the output is tiled in row bands: grid (B, ceil(OUT/R)),
// R = 16 output rows per block. Each block loads only the R + 2*KY canvas
// rows its band needs (uint8, 16-byte loads), builds the hat weights of its
// rows and columns, and stages x1 (R + 2*KY rows) and x2 (R rows) in shared
// memory over the OUT + 2*KX columns the crop reaches, channel-interleaved
// as the canvas is, so a horizontal shift of k pixels is a shift of C*k
// floats. No intermediate leaves the SM: device memory sees each canvas
// band once (plus the 2*KY halo rows the neighbouring bands also read, and
// whole rows of S pixels) and each output element once: 82,944 B read per
// sample at R = 16, 1.5x what the crop reaches. Each thread owns one channel
// column of the band and walks down its rows, so the index arithmetic
// (division by C, the wrap mod S) is done once per column and not per tap;
// a first version that redid it per tap ran 0.71 ms at B = 512 (PERF.md).
// Every tap of the sums is evaluated (5 + 9 + 5), weights of zero included,
// in the reference's order. Left for later: two taps per shear instead of
// 2K+1, wider bands (less halo), packed bf16 stores, and more blocks per SM
// than the 79 KB of shared memory leave (2).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int R = 16;          // output rows per block
constexpr int C = 3;           // RGB, as the cache stores it
constexpr int THREADS = 416;   // 13 warps: one pass over a band row of (OUT + 2*KX) * C = 396 floats

struct Smem {
  size_t img, x1, x2, wx, wy, total;
};

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// Byte offsets of the shared-memory regions for a band of R output rows.
__host__ __device__ inline Smem smem_layout(int S, int OUT, int KX, int KY) {
  const int rows1 = R + 2 * KY;               // canvas rows of the band's x1
  const int w1 = (OUT + 2 * KX) * C;          // floats per x1/x2 row
  Smem s;
  s.img = 0;
  s.x1 = align16(s.img + (size_t)rows1 * S * C);
  s.x2 = align16(s.x1 + (size_t)rows1 * w1 * sizeof(float));
  s.wx = align16(s.x2 + (size_t)R * w1 * sizeof(float));
  s.wy = align16(s.wx + (size_t)rows1 * (2 * KX + 1) * sizeof(float));
  s.total = align16(s.wy + (size_t)(OUT + 2 * KX) * (2 * KY + 1) * sizeof(float));
  return s;
}

__device__ inline int wrap(int i, int S) {
  i %= S;
  return i < 0 ? i + S : i;
}

__device__ inline float hat(float t) { return fmaxf(0.0f, 1.0f - fabsf(t)); }

__device__ inline void store(float* p, float v) { *p = v; }
__device__ inline void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename OutT>
__global__ void __launch_bounds__(THREADS)
augment_kernel(const uint8_t* __restrict__ cache, long long N, int S, const int* __restrict__ idx,
               const float* __restrict__ angles, const int* __restrict__ offs, OutT* __restrict__ out,
               int OUT, int KX, int KY) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem L = smem_layout(S, OUT, KX, KY);
  uint8_t* img = smem + L.img;
  float* x1 = reinterpret_cast<float*>(smem + L.x1);
  float* x2 = reinterpret_cast<float*>(smem + L.x2);
  float* wx = reinterpret_cast<float*>(smem + L.wx);
  float* wy = reinterpret_cast<float*>(smem + L.wy);

  const int b = blockIdx.x;
  const int y0 = blockIdx.y * R;
  const int rows = min(R, OUT - y0);          // output rows of this band
  const int rows1 = rows + 2 * KY;            // x1 / canvas rows of this band
  const int cols = OUT + 2 * KX;              // x1 / x2 columns (pixels)
  const int w1 = cols * C;
  const int row_bytes = S * C;
  const int nkx = 2 * KX + 1, nky = 2 * KY + 1;
  const int tid = threadIdx.x;

  const long long src_i = idx[b];
  const float ang = angles[b];
  const int oy_raw = offs[2 * b], ox_raw = offs[2 * b + 1];
  const float cy = (float)oy_raw + (float)(OUT - 1) / 2.0f;
  const float cx = (float)ox_raw + (float)(OUT - 1) / 2.0f;
  const int oy = min(max(oy_raw, 0), S - OUT);  // dynamic_slice clamps the start
  const int ox = min(max(ox_raw, 0), S - OUT);
  OutT* dst = out + ((size_t)b * OUT + y0) * OUT * C;

  if (src_i < 0 || src_i >= N) {
    for (int e = tid; e < rows * OUT * C; e += THREADS) store(dst + e, __int_as_float(0x7fc00000));
    return;
  }
  // 64-bit: idx * S*S*C passes 2^31 beyond ~34,500 canvases of 144^2 x 3.
  const uint8_t* src = cache + (size_t)src_i * S * S * C;
  const int r_first = oy + y0 - KY;           // canvas row of band row 0 (before wrap)

  // 1. the band's canvas rows, full width (columns wrap mod S), in 16-byte
  //    loads: the wrapper takes only a 16-byte-aligned cache with S*C a
  //    multiple of 16, so every canvas row starts on a 16-byte boundary.
  const int per_row = row_bytes / 16;
  for (int e = tid; e < rows1 * per_row; e += THREADS) {
    const int j = e / per_row, q = e - j * per_row;
    const uint4* s4 = reinterpret_cast<const uint4*>(src + (size_t)wrap(r_first + j, S) * row_bytes);
    reinterpret_cast<uint4*>(img + (size_t)j * row_bytes)[q] = __ldg(s4 + q);
  }
  // 2. hat weights: per canvas row for the x shears, per canvas column for y.
  const float t = tanf(ang / 2.0f);
  const float s = -sinf(ang);
  for (int e = tid; e < rows1 * nkx; e += THREADS) {
    const int j = e / nkx, k = e - j * nkx - KX;
    const float sx = t * ((float)wrap(r_first + j, S) - cy);
    wx[e] = hat(sx - (float)k);
  }
  for (int e = tid; e < cols * nky; e += THREADS) {
    const int p = e / nky, k = e - p * nky - KY;
    const float sy = s * ((float)wrap(ox - KX + p, S) - cx);
    wy[e] = hat(sy - (float)k);
  }
  __syncthreads();

  // Each thread owns one column f = p*C + ch of the band (the index math is
  // done once per column) and walks down the rows; taps run k = -K..K in
  // the reference's order.
  // 3. x1 = shear_x(img / 255) on rows1 x cols; column p is canvas column
  //    ox - KX + p and tap k reads canvas column (ox - KX + p - k) mod S,
  //    which starts at (ox + p) mod S and steps down by one, wrapping.
  const float inv255 = 1.0f / 255.0f;
  for (int f = tid; f < w1; f += THREADS) {
    const int p = f / C, ch = f - p * C;
    const int col0 = wrap(ox + p, S);
    for (int j = 0; j < rows1; ++j) {
      const uint8_t* row = img + (size_t)j * row_bytes + ch;
      const float* w = wx + j * nkx;
      float acc = 0.0f;
      int col = col0;
      for (int q = 0; q < nkx; ++q) {
        acc += w[q] * ((float)row[col * C] * inv255);
        col = col == 0 ? S - 1 : col - 1;
      }
      x1[j * w1 + f] = acc;
    }
  }
  __syncthreads();

  // 4. x2 = shear_y(x1) on the band's rows: output row i (canvas row
  //    oy + y0 + i) reads x1 row i + KY - k.
  for (int f = tid; f < w1; f += THREADS) {
    const float* w = wy + (f / C) * nky;
    for (int i = 0; i < rows; ++i) {
      const float* col = x1 + (i + 2 * KY) * w1 + f;  // tap k = -KY
      float acc = 0.0f;
      for (int q = 0; q < nky; ++q) acc += w[q] * col[-q * w1];
      x2[i * w1 + f] = acc;
    }
  }
  __syncthreads();

  // 5. x3 = shear_x(x2), cropped: output column x reads x2 column
  //    x + KX - k; row i uses the weights of canvas row oy + y0 + i.
  const int wo = OUT * C;
  for (int f = tid; f < wo; f += THREADS) {
    const int x = f / C, ch = f - x * C;
    for (int i = 0; i < rows; ++i) {
      const float* w = wx + (i + KY) * nkx;
      const float* row = x2 + i * w1 + (x + 2 * KX) * C + ch;  // tap k = -KX
      float acc = 0.0f;
      for (int q = 0; q < nkx; ++q) acc += w[q] * row[-q * C];
      store(dst + i * wo + f, acc);
    }
  }
}

template <typename OutT>
cudaError_t launch(const void* cache, long long N, int S, const void* idx, const void* angles,
                   const void* offs, void* out, int B, int OUT, int KX, int KY, cudaStream_t stream) {
  const size_t smem = smem_layout(S, OUT, KX, KY).total;
  cudaError_t err = cudaFuncSetAttribute(augment_kernel<OutT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B, (OUT + R - 1) / R);
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
// cudaFuncSetAttribute (a band that needs more shared memory than a block
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
