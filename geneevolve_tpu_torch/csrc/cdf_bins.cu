// Inverse-CDF bins: out[c, i] = min(#{j : cum[c, j] <= u[c, i]}, K - 1),
// for C stacked CDFs (one per chromosome) and their probes in one launch.
//
// Replaces geneevolve_tpu/ops/cdf_bins_pallas.py `searchsorted_right`
// (kernel `_kernel`), which kept the CDF in VMEM as a two-level
// (block-last, block-entries) table to suit the TPU's lane gathers. On
// Hopper a chromosome's whole f32 CDF (K ~5,000 at 50 kb bins, ~20 KB)
// fits a block's shared memory, and each probe is a branchless binary
// search there: log2 K shared-memory steps, no global reads but the
// probe's own.
//
// Bound: the probe stream, 8 bytes a probe (f32 in, int32 out), through
// HBM; ~124 MB for a generation's crossover probes at the segment slice's
// shape (22 chromosomes x 30,708 rows x 23 slots), ~37 us. The first
// design of this port ran one launch per chromosome and draw (66 a
// generation, each shorter than its launch) and copied the CDF into 1,056
// blocks that served ~670 probes each (~21 MB of copies for 5.7 MB of
// probes). Here one launch serves every chromosome (grid y = the CDF
// row), the grid is sized to what the card holds at once, so each block
// copies its row once and then serves thousands of probes, and each thread
// runs 4 probes' searches side by side, so that their probe reads are in
// flight together. A second design, which kept only every 32nd entry in
// shared memory and searched the rest through L1/L2, stalled on those
// dependent reads (PERF.md, Findings).
//
// Exactness: an entry counts unless it is > x (not "if it is <= x"), as
// in torch.searchsorted, so a NaN probe counts every entry there too;
// padding that repeats the last value counts like searchsorted, as the
// search runs over the padded row as given.
#include "common.cuh"

#define GE_THREADS 256
#define GE_PROBES_PER_THREAD 4
#define GE_MAX_SMEM (227 * 1024)

// an entry counts unless it is > x
__device__ __forceinline__ int ge_le(float v, float x) { return !(v > x); }

__global__ void __launch_bounds__(GE_THREADS)
    cdf_bins_kernel(const float* __restrict__ u, const float* __restrict__ cum,
                    int32_t* __restrict__ out, int64_t P, int K) {
  extern __shared__ float s_cum[];
  const int64_t row = blockIdx.y;
  const float* cr = cum + row * (int64_t)K;
  for (int j = threadIdx.x; j < K; j += blockDim.x) s_cum[j] = cr[j];
  __syncthreads();
  const float* ur = u + row * P;
  int32_t* orow = out + row * P;
  const int64_t span = (int64_t)blockDim.x * GE_PROBES_PER_THREAD;
  for (int64_t i0 = (int64_t)blockIdx.x * span + threadIdx.x; i0 < P;
       i0 += (int64_t)gridDim.x * span) {
    // probes blockDim.x apart: each load and store coalesced
    float x[GE_PROBES_PER_THREAD];
    int base[GE_PROBES_PER_THREAD];
#pragma unroll
    for (int k = 0; k < GE_PROBES_PER_THREAD; ++k) {
      const int64_t i = i0 + (int64_t)k * blockDim.x;
      x[k] = i < P ? ur[i] : 0.0f;
      base[k] = 0;
    }
    // invariant: the count lies in [base, base + len]
    for (int len = K; len > 1;) {
      const int half = len >> 1;
#pragma unroll
      for (int k = 0; k < GE_PROBES_PER_THREAD; ++k)
        base[k] += ge_le(s_cum[base[k] + half - 1], x[k]) ? half : 0;
      len -= half;
    }
#pragma unroll
    for (int k = 0; k < GE_PROBES_PER_THREAD; ++k) {
      const int64_t i = i0 + (int64_t)k * blockDim.x;
      const int cnt = base[k] + ge_le(s_cum[base[k]], x[k]);
      if (i < P) orow[i] = cnt < K - 1 ? cnt : K - 1;
    }
  }
}

GE_API int ge_cdf_bins(const void* u, const void* cum, void* out, int64_t C,
                       int64_t P, int K, void* stream) {
  const size_t smem = (size_t)K * sizeof(float);
  if (C <= 0 || P <= 0) return (int)cudaGetLastError();
  if (C > 65535 || K < 1 || smem > GE_MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(cdf_bins_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  // as many blocks as the card holds at once, shared among the rows, and
  // no more than the probes need
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, cdf_bins_kernel, GE_THREADS, smem)) != cudaSuccess)
    return (int)e;
  const int64_t span = (int64_t)GE_THREADS * GE_PROBES_PER_THREAD;
  const int64_t need = (P + span - 1) / span;
  int64_t per_row = ((int64_t)sms * (per_sm > 0 ? per_sm : 1) + C - 1) / C;
  if (per_row > need) per_row = need;
  const dim3 grid((unsigned)per_row, (unsigned)C);
  cdf_bins_kernel<<<grid, GE_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)u, (const float*)cum, (int32_t*)out, P, K);
  return (int)cudaGetLastError();
}
