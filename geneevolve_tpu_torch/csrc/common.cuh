// Shared declarations for the segment engine's Hopper kernels.
//
// Every entry point is a plain C function (loaded with ctypes): pointers and
// the stream arrive as void*, the kernel is launched on that stream, and the
// function returns cudaGetLastError() so a refused launch is reported to the
// Python wrapper, which raises on any non-zero code.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define GE_API extern "C" __attribute__((visibility("default")))

// grid size for a grid-stride loop over `n` items: enough blocks to fill the
// card several times over, never more than the items need
static inline int ge_blocks(int64_t n, int threads, int max_blocks) {
  int64_t want = (n + threads - 1) / threads;
  if (want < 1) want = 1;
  return (int)(want < max_blocks ? want : max_blocks);
}

// ---------------------------------------------------------------------------
// The ledger merge's first phase, one warp per gamete: shared by the capacity
// probe's count (merge_count.cu) and the merge itself (meiose_merge.cu), so
// that both count a gamete's copied parent slots with the same code (the
// engine's tripwire requires the probe's count to equal the merge's).

#define GE_MAXK 64  // crossover slots a row may have: two per lane
#define GE_FULL 0xffffffffu

// #{a[j] <= v} of the sorted a[0..n)
__device__ __forceinline__ int ge_upper_bound(const int32_t* a, int n,
                                              int32_t v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= v) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// #{a[j] < v} of the sorted a[0..n)
__device__ __forceinline__ int ge_lower_bound(const int32_t* a, int n,
                                              int32_t v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// The valid crossovers of row x (K <= GE_MAXK slots, BIG padded, in any
// order) sorted into xs by (value, slot): the lane holding slot k writes it
// at its stable rank #{x_j < x_k} + #{x_j == x_k, j < k}, counted over the
// row's values passed round by shuffles. Returns the valid count; xs is
// visible to the whole warp on return.
__device__ __forceinline__ int ge_sort_crossovers(const int32_t* x, int K,
                                                  int32_t big, int32_t* xs,
                                                  int lane) {
  const int32_t v0 = lane < K ? x[lane] : big;
  const int32_t v1 = lane + 32 < K ? x[lane + 32] : big;
  int r0 = 0, r1 = 0;
  if (K > 32) {
    for (int j = 0; j < 32; ++j) {
      const int32_t a = __shfl_sync(GE_FULL, v0, j);  // slot j
      const int32_t b = __shfl_sync(GE_FULL, v1, j);  // slot j + 32
      r0 += (a < v0 || (a == v0 && j < lane)) + (b < v0);
      r1 += (a <= v1) + (b < v1 || (b == v1 && j < lane));
    }
  } else {
    for (int j = 0; j < K; ++j) {
      const int32_t a = __shfl_sync(GE_FULL, v0, j);
      r0 += a < v0 || (a == v0 && j < lane);
    }
  }
  if (v0 < big) xs[r0] = v0;
  if (v1 < big) xs[r1] = v1;
  const int n = __popc(__ballot_sync(GE_FULL, v0 < big)) +
                __popc(__ballot_sync(GE_FULL, v1 < big));
  __syncwarp();
  return n;
}

// Bit `lane` of the result: whether the gamete copies slot s = 32 w + lane
// of chromatid c, whose row is P[0..S): s > 0, P[s] valid, and chromatid
// (st0 + #{xo <= P[s]}) & 1 == c, with xs the nxo sorted crossovers.
__device__ __forceinline__ uint32_t ge_copied_word(const int32_t* P, int S,
                                                   int w, int c, int st0,
                                                   const int32_t* xs, int nxo,
                                                   int32_t big, int lane) {
  const int s = (w << 5) + lane;
  bool copied = false;
  if (s > 0 && s < S) {
    const int32_t q = P[s];
    copied = q < big && ((st0 + ge_upper_bound(xs, nxo, q)) & 1) == c;
  }
  return __ballot_sync(GE_FULL, copied);
}

// Gamete t of a stacked launch: t = (chromosome * nc + child) * 2 + parent,
// so consecutive warps write consecutive rows of the (nchr, nc, 2, cap)
// child planes. The parent's two chromatid rows start at the returned offset
// of the (nchr, rows, 2, S) ledger.
__device__ __forceinline__ int64_t ge_parent_row(const int32_t* parents,
                                                 int64_t t, int64_t rows,
                                                 int64_t nc, int S) {
  const int64_t gi = t >> 1;
  const int64_t ci = gi / nc;
  const int64_t i = gi - ci * nc;
  return ((ci * rows + (int64_t)parents[(t & 1) * nc + i]) * 2) * S;
}
