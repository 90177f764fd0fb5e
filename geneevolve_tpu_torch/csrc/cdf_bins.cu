// Inverse-CDF bins: out[i] = min(#{j : cum[j] <= u[i]}, K - 1).
//
// Replaces geneevolve_tpu/ops/cdf_bins_pallas.py `searchsorted_right`
// (kernel `_kernel`), which kept the CDF in VMEM as a two-level
// (block-last, block-entries) table. Here the chromosome's whole f32 CDF
// (K <= ~5,000 at 50 kb bins, ~20 KB) sits in shared memory, and each
// thread runs a branchless binary search (log2 K shared-memory loads) for
// its probes in a grid-stride loop.
//
// Bound: each block copies the CDF once from L2/HBM into shared memory and
// then does ~13 shared loads per probe; the probe stream itself is 8 bytes
// (f32 in, int32 out). Fewer, longer-lived blocks (grid capped below)
// amortize the CDF copy across many probes.
//
// Padding that repeats the last CDF value counts exactly like
// searchsorted-right: the search is over the padded array as given.
#include "common.cuh"

__global__ void cdf_bins_kernel(const float* __restrict__ u,
                                const float* __restrict__ cum,
                                int32_t* __restrict__ out, int64_t P, int K) {
  extern __shared__ float s_cum[];
  for (int j = threadIdx.x; j < K; j += blockDim.x) s_cum[j] = cum[j];
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < P;
       i += stride) {
    const float x = u[i];
    // invariant: every entry before `base` is <= x, and the count lies in
    // [base, base + len]
    int base = 0;
    int len = K;
    while (len > 1) {
      const int half = len >> 1;
      base = (s_cum[base + half - 1] <= x) ? base + half : base;
      len -= half;
    }
    const int cnt = base + (s_cum[base] <= x ? 1 : 0);
    out[i] = cnt < K - 1 ? cnt : K - 1;
  }
}

GE_API int ge_cdf_bins(const void* u, const void* cum, void* out, int64_t P,
                       int K, void* stream) {
  const int threads = 256;
  const size_t smem = (size_t)K * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        cdf_bins_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cdf_bins_kernel<<<ge_blocks(P, threads, 132 * 8), threads, smem,
                    (cudaStream_t)stream>>>((const float*)u, (const float*)cum,
                                            (int32_t*)out, P, K);
  return (int)cudaGetLastError();
}
