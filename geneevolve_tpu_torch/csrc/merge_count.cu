// Capacity probe's merge-valid count, one warp per gamete, every chromosome
// and both parents in one launch:
//   out[ci, i, g] = 1 + #{valid xo} + #{slots s > 0 of chromatid 0 the
//                   gamete copies} + #{slots s > 0 of chromatid 1 it copies}
// where slot position q is copied from chromatid (start + #{xo <= q}) & 1.
//
// Replaces geneevolve_tpu/ops/merge_count_pallas.py
// `count_merge_valid_pallas` (kernel `_kernel`). The TPU kernel took one
// packed, pre-gathered (n, 2S+K+1) operand per parent and chromosome and
// compared every slot with every crossover; here a warp reads its parent's
// row `seg_st[ci, parents[g, i]]` by index (lanes on consecutive slots), so
// the ledger is never copied, sorts the crossover row once by ranks
// (`ge_sort_crossovers`) and gives each slot a binary search and each
// 32-slot word one ballot (`ge_copied_word`, the code the merge counts its
// copied slots with).
//
// Bound: the parent rows (2S int32 per gamete, each distinct row read once)
// and the crossover rows, on HBM; the compares are ~log2(K) per slot.
#include "common.cuh"

#define GE_WARPS 8  // gametes a block

__global__ void __launch_bounds__(GE_WARPS * 32) merge_count_kernel(
    const int32_t* __restrict__ seg_st, const int32_t* __restrict__ parents,
    const int32_t* __restrict__ xo_f, const int32_t* __restrict__ xo_m,
    const int32_t* __restrict__ sh, int32_t* __restrict__ out, int64_t rows,
    int64_t nc, int64_t total, int S, int K, int32_t big) {
  __shared__ int32_t xs_all[GE_WARPS][GE_MAXK];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t t = (int64_t)blockIdx.x * GE_WARPS + warp;
  if (t >= total) return;  // whole warps only
  const int32_t* row = seg_st + ge_parent_row(parents, t, rows, nc, S);
  int32_t* xs = xs_all[warp];
  const int nxo =
      ge_sort_crossovers((t & 1 ? xo_m : xo_f) + (t >> 1) * K, K, big, xs,
                         lane);
  const int st0 = sh[t];
  const int W = (S + 31) >> 5;
  int n = 1 + nxo;
  for (int c = 0; c < 2; ++c)
    for (int w = 0; w < W; ++w)
      n += __popc(
          ge_copied_word(row + c * S, S, w, c, st0, xs, nxo, big, lane));
  if (lane == 0) out[t] = n;
}

GE_API int ge_merge_count(const void* seg_st, const void* parents,
                          const void* xo_f, const void* xo_m, const void* sh,
                          void* out, int64_t nchr, int64_t rows, int64_t nc,
                          int S, int K, int big, void* stream) {
  if (K > GE_MAXK) return (int)cudaErrorInvalidValue;
  const int64_t total = nchr * nc * 2;
  const int64_t blocks = (total + GE_WARPS - 1) / GE_WARPS;
  if (blocks > 0) {
    merge_count_kernel<<<(unsigned)blocks, GE_WARPS * 32, 0,
                         (cudaStream_t)stream>>>(
        (const int32_t*)seg_st, (const int32_t*)parents,
        (const int32_t*)xo_f, (const int32_t*)xo_m, (const int32_t*)sh,
        (int32_t*)out, rows, nc, total, S, K, (int32_t)big);
  }
  return (int)cudaGetLastError();
}
