// Capacity probe's merge-valid count, one thread per gamete:
//   out[i] = 1 + #{valid xo} + #{slots s > 0 of chromatid 0 the gamete
//            copies} + #{slots s > 0 of chromatid 1 it copies}
// where slot position q is copied from chromatid (start + #{xo <= q}) & 1.
//
// Replaces geneevolve_tpu/ops/merge_count_pallas.py
// `count_merge_valid_pallas` (kernel `_kernel`). The TPU kernel took one
// packed, pre-gathered (n, 2S+K+1) operand and wrote a (n/64, 64) tile to
// dodge lane padding; here the thread reads its parent's row
// `par_st[idx[i]]` by index, so the parent ledger is never copied.
//
// Bound: integer compares, (2S) x K per gamete at worst; the valid-prefix
// invariant of the ledger (BIG after the last boundary) stops each
// chromatid's walk at its first padding slot, so the work is
// (live slots) x K. Reads are one parent row (2S int32) and one xo row.
// The count does not depend on the order of the crossovers in a row.
#include "common.cuh"

__global__ void merge_count_kernel(const int32_t* __restrict__ par_st,
                                   const int32_t* __restrict__ idx,
                                   const int32_t* __restrict__ xo,
                                   const int32_t* __restrict__ start,
                                   int32_t* __restrict__ out, int64_t nc,
                                   int S, int K, int32_t big) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nc) return;
  const int32_t* x = xo + i * K;
  const int32_t* row = par_st + (int64_t)idx[i] * 2 * S;
  const int st0 = start[i];
  int n = 1;
  for (int k = 0; k < K; ++k) n += x[k] < big ? 1 : 0;
  for (int c = 0; c < 2; ++c) {
    const int32_t* p = row + c * S;
    for (int s = 1; s < S; ++s) {
      const int32_t q = p[s];
      if (q >= big) break;  // valid prefix ends
      int cnt = 0;
      for (int k = 0; k < K; ++k) cnt += x[k] <= q ? 1 : 0;
      n += (((st0 + cnt) & 1) == c) ? 1 : 0;
    }
  }
  out[i] = n;
}

GE_API int ge_merge_count(const void* par_st, const void* idx, const void* xo,
                          const void* start, void* out, int64_t nc, int S,
                          int K, int big, void* stream) {
  const int threads = 128;
  const int64_t blocks = (nc + threads - 1) / threads;
  if (blocks > 0) {
    merge_count_kernel<<<(unsigned)blocks, threads, 0,
                         (cudaStream_t)stream>>>(
        (const int32_t*)par_st, (const int32_t*)idx, (const int32_t*)xo,
        (const int32_t*)start, (int32_t*)out, nc, S, K, (int32_t)big);
  }
  return (int)cudaGetLastError();
}
