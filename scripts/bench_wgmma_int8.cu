// Throughput of the int8 wgmma that rnet_torch/csrc/pairwise_fwd_int8.cu
// issues (m64n128k32 s8 x s8 -> s32, operands in wgmma's no-swizzle
// core-matrix layout), on every SM of the card: 1, 2 or 3 warpgroups a CTA,
// each looping over commit groups of 2 or 4 products with one group in
// flight behind the newest (wgmma.wait_group 1), as the kernel's W stream
// does; A from shared memory (SS, the kernel's form; with the kernel's row
// strides and with padded ones) or from registers (RS). Prints the rate in
// TOPS against the 1,979 TOPS dense int8 peak and the cycles per product of
// one warpgroup. Needs one Hopper card:
//
//     nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//         -o /tmp/bench_wgmma_int8 scripts/bench_wgmma_int8.cu && /tmp/bench_wgmma_int8
#include <cstdio>
#include <cstdint>
#include <cuda_runtime.h>
#include "../rnet_torch/csrc/pairwise_chain.cuh"
using namespace rnet;

__device__ __forceinline__ void wgmma_rs(int (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, 1;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// MODE 0: SS, MODE 1: RS. Each warpgroup: iters x (per_group products, commit, wait_group 1), A and B
// cycling over a few chunks of shared memory filled with small codes.
template <int MODE>
__global__ void __launch_bounds__(384, 1)
    bench(long long* out, int* sink, int iters, int a_sbo, int b_sbo, int per_group) {
  extern __shared__ __align__(1024) unsigned char smem[];
  for (int i = threadIdx.x; i < 200 * 1024 / 4; i += blockDim.x)
    reinterpret_cast<int*>(smem)[i] = (i * 7) & 0x03030303;
  __syncthreads();
  const int wg = threadIdx.x / 128;
  const uint32_t a = smem_u32(smem) + wg * 65536, b = smem_u32(smem) + 196608 - 32768;
  int acc[64];
#pragma unroll
  for (int z = 0; z < 64; ++z) acc[z] = 0;
  uint32_t fr[4] = {0x01010101u, 0x01010101u, 0x01010101u, 0x01010101u};
  __syncthreads();
  long long t0 = clock64();
  wgmma_fence();
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    const int kc = it & 3;
    for (int ks = 0; ks < per_group; ++ks) {
      if (MODE == 0)
        wgmma_step(acc, desc(a + (kc * 4 + 2 * (ks & 1)) * 128, 128, a_sbo),
                   desc(b + (kc * 2 + (ks & 1)) * 256, 128, b_sbo), 1);
      else
        wgmma_rs(acc, fr, desc(b + (kc * 2 + (ks & 1)) * 256, 128, b_sbo));
    }
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  long long t1 = clock64();
  int s = 0;
#pragma unroll
  for (int z = 0; z < 64; ++z) s += acc[z];
  if ((threadIdx.x & 127) == 0) out[blockIdx.x * 4 + wg] = t1 - t0;  // clock64() cycles of the loop
  if (s == 123456789) sink[0] = s;
}

int main() {
  cudaDeviceProp prop;
  cudaGetDeviceProperties(&prop, 0);
  const int sms = prop.multiProcessorCount;
  printf("device: %s, %d SMs\n", prop.name, sms);
  long long* out;
  int* sink;
  cudaMalloc(&out, sms * 4 * 8);
  cudaMalloc(&sink, 4);
  const int smem = 200 * 1024;
  cudaFuncSetAttribute(bench<0>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaFuncSetAttribute(bench<1>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const int iters = 4000;
  // (mode, warpgroups a CTA, A's and B's byte strides between 8-row groups, products a commit group);
  // the kernel's strides: 4096 (A: rows of 512 bytes) and 512 (B: W chunks of 64 bytes of depth)
  struct V { int mode, wgs, asbo, bsbo, pg; } vs[] = {
      {0, 1, 4096, 512, 2}, {0, 1, 4112, 528, 2}, {1, 1, 4096, 512, 2}, {0, 1, 4096, 512, 4},
      {0, 2, 4096, 512, 2}, {1, 2, 4096, 512, 2}, {0, 3, 4096, 512, 2}, {1, 3, 4096, 512, 2},
  };
  for (const V& v : vs) {
    float best = 1e30f;
    for (int rep = 0; rep < 3; ++rep) {
      cudaEvent_t e0, e1;
      cudaEventCreate(&e0);
      cudaEventCreate(&e1);
      cudaEventRecord(e0);
      if (v.mode == 0)
        bench<0><<<sms, 128 * v.wgs, smem>>>(out, sink, iters, v.asbo, v.bsbo, v.pg);
      else
        bench<1><<<sms, 128 * v.wgs, smem>>>(out, sink, iters, v.asbo, v.bsbo, v.pg);
      cudaEventRecord(e1);
      cudaEventSynchronize(e1);
      float ms;
      cudaEventElapsedTime(&ms, e0, e1);
      if (ms < best) best = ms;
    }
    const cudaError_t err = cudaGetLastError();
    long long first = 0;
    cudaMemcpy(&first, out, sizeof(first), cudaMemcpyDeviceToHost);
    const double ops = 2.0 * 64 * 128 * 32 * (double)iters * v.pg * v.wgs * sms;
    printf("%s warpgroups %d a_stride %d b_stride %d products/group %d: %.3f ms, %.1f TOPS (%.1f%% of 1979), "
           "cycles/product of one warpgroup %.1f, %s\n",
           v.mode ? "RS" : "SS", v.wgs, v.asbo, v.bsbo, v.pg, best, ops / (best * 1e-3) / 1e12,
           100.0 * ops / (best * 1e-3) / 1979e12, (double)first / (iters * v.pg), cudaGetErrorString(err));
    if (err != cudaSuccess) return 1;
  }
  return 0;
}
