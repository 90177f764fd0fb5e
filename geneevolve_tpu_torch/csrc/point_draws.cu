// The segment sampler's points from its random draws: for C stacked
// chromosomes of n gametes each, one launch turns each gamete's Poisson
// count, its cap + 1 uniforms and its cap within-bin uniforms into its
// (cap) int32 positions, BIG-padded. It ports no TPU kernel: it fuses the
// plain-torch chain that followed the draws in the port's sampler
// (`core/segments.py`: `-log1p`, `torch.cumsum`, the gather of the
// denominator, the divide and scale, `cdf_bins`'s inverse-CDF search, and
// `_place`), ~26 launches a chromosome and kind of draw, into one launch a
// kind.
//
// Row (c, i), with R = cap + 1 and k = min(counts[c, i], cap):
//   x_j  = -log1pf(-unif[c, i, j])                         j < R
//   s    = the inclusive scan of x, in torch.cumsum's association order
//   u_j  = (s_j / max(s_k, 1e-30)) * cum[c, K - 1]          j < cap
//   b_j  = min(#{e : cum[c, e] <= u_j}, K - 1)              (ge_cdf_search)
//   w_j  = min(v[c, i, j], 0.9999999)
//   hi, lo = the anchors of bin b_j and of b_j - 1: bp0 + b * step and hi -
//            step (affine), or bp[c, b] and bp[c, max(b - 1, 0)]
//   out  = lo + floor(w_j * (hi - lo + 1)) (inclusive: mutations) or
//          hi + floor(w_j * width[c]) (crossovers), for j < k; BIG after,
//          and BIG everywhere on a chromosome that is not live (rate 0).
// Every step is the float32 arithmetic the chain does, in its order, with
// IEEE division and no contraction, so the positions equal the plain
// chain's (`ops/point_draws.point_draws_plain`) bit for bit. They must:
// the benchmark's check draws the plan again with that torch chain and
// compares every child's ledger exactly, and one ulp of a u_j moves a
// point across a bin edge about once in a few thousand draws.
//
// The scan's order. torch scans a row of a (n, R) tensor with
// `tensor_kernel_scan_innermost_dim` (ATen/native/cuda/ScanUtils.cuh):
// chunks of 2T slots, T threads on a row from
// `get_log_num_threads_x_inner_scan<uint32_t>(n, R)` (at least 16), each
// chunk a Sklansky tree over its 2T slots after the previous chunks' total
// was added to its slot 0. In the tree a slot only ever adds slots below
// it, so slot j of a chunk ends up as the Sklansky prefix of the chunk's
// first j + 1 slots, whatever 2T is: a row of R <= 32 slots is one chunk
// and one 32-slot tree however torch launches; a longer row follows the
// chunk width `chunk` = 2T that the wrapper mirrors from torch's
// heuristic, unsigned wrap and all.
//
// Design. Rows of at most 32 slots (every row of the segment cells: cap 23
// and 11) take `point_draws_rows_kernel`, a thread a row: the row's slots
// up to its count in registers, the 32-slot tree unrolled, its k points'
// searches one after the other; the block's positions are staged in
// shared memory and written out row-major, coalesced. A warp of 32 rows
// thus issues each step once for 32 rows, where a warp a row would issue
// it for the row's few points. Longer rows take `point_draws_long_kernel`,
// a warp a row in torch's chunks, its slots up to the count scanned in
// shared memory a tree step at a time. In both the chromosome's CDF is
// copied once into each block's shared memory, and the grid is what the
// card holds at once, shared among the chromosomes (grid y), as cdf_bins.cu
// does, so that a block copies its CDF once and serves thousands of rows.
//
// Bound: bytes, on HBM: a row's count, its uniforms up to slot k, its
// within-bin uniforms up to slot k - 1 and its cap positions; the CDFs (and
// anchor tables) once: ~110 bytes a crossover row at the segment cells'
// rates, ~60 a mutation row; 284 and 140 with every uniform read.
#include "common.cuh"

#define PD_THREADS 256
#define PD_WARPS (PD_THREADS / 32)
#define PD_CHR 64  // chromosomes a launch (the per-chromosome parameters)
#define PD_MAX_SMEM (227 * 1024)

struct PdChroms {  // per chromosome of the launch, passed by value
  int32_t bp0[PD_CHR];
  int32_t step[PD_CHR];
  float width[PD_CHR];
  int32_t live[PD_CHR];
};

// What both kernels share of a block's work on chromosome c: BIG in every
// slot of a chromosome with no draws (returns false), else its CDF copied
// into shared memory (returns true).
__device__ __forceinline__ bool pd_begin(const PdChroms& ch, int c,
                                         const float* cum, int K,
                                         float* s_cum, int32_t* orow,
                                         int64_t slots, int32_t big) {
  if (!ch.live[c]) {
    for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
         e < slots; e += (int64_t)gridDim.x * blockDim.x)
      orow[e] = big;
    return false;
  }
  const float* cr = cum + (int64_t)c * K;
  for (int j = threadIdx.x; j < K; j += blockDim.x) s_cum[j] = cr[j];
  __syncthreads();
  return true;
}

// The point's uniform on [0, total) from s_j and the denominator s_k,
// clamped as torch.clamp(min=1e-30) clamps it (NaN stays NaN)
__device__ __forceinline__ float pd_u(float sj, float sk, float total) {
  const float lo = (float)1e-30;
  return (sj / (sk < lo ? lo : sk)) * total;
}

// The position of a point in bin b from its within-bin uniform w: `_place`'s
// int32 and float32 arithmetic (the int32 sums wrap, as torch's do)
__device__ __forceinline__ int32_t pd_place(int b, float w,
                                            const PdChroms& ch, int c,
                                            const int32_t* bpr, int affine,
                                            int inclusive) {
  const float hi_v = (float)(1.0 - 1e-7);  // torch.clamp(max=1 - 1e-7)
  w = w > hi_v ? hi_v : w;
  uint32_t hi, lo;
  if (affine) {
    hi = (uint32_t)ch.bp0[c] + (uint32_t)b * (uint32_t)ch.step[c];
    lo = hi - (uint32_t)ch.step[c];
  } else {
    hi = (uint32_t)bpr[b];
    lo = (uint32_t)bpr[b > 0 ? b - 1 : 0];
  }
  if (inclusive)
    return (int32_t)(lo + (uint32_t)(int32_t)floorf(
                              w * (float)(int32_t)(hi - lo + 1u)));
  return (int32_t)(hi + (uint32_t)(int32_t)floorf(w * ch.width[c]));
}

// Rows of at most 32 slots, a thread a row.
__global__ void __launch_bounds__(PD_THREADS)
    point_draws_rows_kernel(const float* __restrict__ counts,
                            const float* __restrict__ unif,
                            const float* __restrict__ v,
                            const float* __restrict__ cum,
                            const int32_t* __restrict__ bp,
                            int32_t* __restrict__ out, const PdChroms ch,
                            int64_t n, int cap, int K, int affine,
                            int inclusive, int32_t big) {
  extern __shared__ float smem[];
  const int c = blockIdx.y;
  const int R = cap + 1;
  const int64_t first = (int64_t)c * n;  // the chromosome's first row
  int32_t* orow = out + first * cap;
  float* s_cum = smem;
  // the block's positions, row-major (PD_THREADS rows of cap)
  int32_t* stage = (int32_t*)(smem + ((K + 3) & ~3));
  if (!pd_begin(ch, c, cum, K, s_cum, orow, n * cap, big)) return;
  const float total = s_cum[K - 1];
  const int32_t* bpr = affine ? bp : bp + (int64_t)c * K;
  const int t = threadIdx.x;
  for (int64_t r0 = (int64_t)blockIdx.x * PD_THREADS; r0 < n;
       r0 += (int64_t)gridDim.x * PD_THREADS) {
    const int64_t row = r0 + t;
    const bool ok = row < n;
    int k = 0;
    if (ok) {  // torch: counts.clamp_max(cap).long()
      const float f = counts[first + row];
      k = (int)(f < (float)cap ? f : (float)cap);
    }
    // the warp works on the slots up to its largest count
    const int kw = __reduce_max_sync(GE_FULL, k);
    const float* ur = unif + (first + row) * R;
    float x[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      x[j] = 0.0f;
      if (j <= kw && ok && j <= k) x[j] = -log1pf(-ur[j]);
    }
    // torch's tree: slot 0 adds `init` (0.0f), then a slot with bit m set
    // adds the last slot below its 2^m-aligned half, m = 0..4
    x[0] = x[0] + 0.0f;
#pragma unroll
    for (int m = 0; m < 5; ++m) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (i & (1 << m)) x[i] = x[i] + x[(i & ~((1 << m) - 1)) - 1];
    }
    float sk = x[0];
#pragma unroll
    for (int j = 1; j < 32; ++j) sk = j == k ? x[j] : sk;
    int32_t* srow = stage + t * cap;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      if (j >= cap) break;
      int32_t p = big;
      if (j < kw && j < k) {
        float u[1] = {pd_u(x[j], sk, total)};
        int bin[1];
        ge_cdf_search(s_cum, K, u, bin);
        p = pd_place(bin[0], v[(first + row) * cap + j], ch, c, bpr, affine,
                     inclusive);
      }
      srow[j] = p;
    }
    __syncthreads();
    const int64_t slots = (n - r0 < PD_THREADS ? n - r0 : PD_THREADS) * cap;
    int32_t* o = orow + r0 * cap;
    for (int e = t; e < slots; e += PD_THREADS) o[e] = stage[e];
    __syncthreads();
  }
}

// Rows past 32 slots, a warp a row, in torch's chunks of `chunk` slots.
__global__ void __launch_bounds__(PD_THREADS)
    point_draws_long_kernel(const float* __restrict__ counts,
                            const float* __restrict__ unif,
                            const float* __restrict__ v,
                            const float* __restrict__ cum,
                            const int32_t* __restrict__ bp,
                            int32_t* __restrict__ out, const PdChroms ch,
                            int64_t n, int cap, int K, int chunk, int affine,
                            int inclusive, int32_t big) {
  extern __shared__ float smem[];
  const int c = blockIdx.y;
  const int R = cap + 1;
  const int64_t first = (int64_t)c * n;
  int32_t* orow = out + first * cap;
  float* s_cum = smem;
  if (!pd_begin(ch, c, cum, K, s_cum, orow, n * cap, big)) return;
  const float total = s_cum[K - 1];
  const int32_t* bpr = affine ? bp : bp + (int64_t)c * K;
  const int warp = threadIdx.x >> 5, li = threadIdx.x & 31;
  float* sc = smem + ((K + 3) & ~3) + warp * R;  // the warp's row
  const int64_t warps = (int64_t)gridDim.x * PD_WARPS;
  for (int64_t row = (int64_t)blockIdx.x * PD_WARPS + warp; row < n;
       row += warps) {
    const float f = counts[first + row];
    const int k = (int)(f < (float)cap ? f : (float)cap);
    const float* ur = unif + (first + row) * R;
    for (int j = li; j <= k; j += 32) sc[j] = -log1pf(-ur[j]);
    __syncwarp();
    for (int b = 0; b <= k; b += chunk) {
      // slot 0 of the chunk adds the total before it (0.0f for the first,
      // as torch's `init`)
      if (li == 0) sc[b] = sc[b] + (b == 0 ? 0.0f : sc[b - 1]);
      __syncwarp();
      const int len = min(chunk, k + 1 - b);
      for (int s = 1; s < len; s <<= 1) {  // the tree's steps: 1, 2, 4, ...
        for (int i = li; i < len; i += 32)
          if (i & s) sc[b + i] = sc[b + i] + sc[b + (i & ~(s - 1)) - 1];
        __syncwarp();
      }
    }
    for (int j = li; j < cap; j += 32) {
      int32_t p = big;
      if (j < k) {
        float u[1] = {pd_u(sc[j], sc[k], total)};
        int bin[1];
        ge_cdf_search(s_cum, K, u, bin);
        p = pd_place(bin[0], v[(first + row) * cap + j], ch, c, bpr, affine,
                     inclusive);
      }
      orow[row * cap + j] = p;
    }
    __syncwarp();
  }
}

GE_API int ge_point_draws(const void* counts, const void* unif, const void* v,
                          const void* cum, const void* bp, void* out,
                          const void* bp0, const void* step,
                          const void* width, const void* live, int64_t C,
                          int64_t n, int cap, int K, int chunk, int affine,
                          int inclusive, int big, void* stream) {
  if (C <= 0 || n <= 0) return (int)cudaGetLastError();
  const int R = cap + 1;
  if (cap < 1 || K < 1 || chunk < 32 || (chunk & (chunk - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const bool rows = R <= 32;  // a thread a row, else a warp a row
  const void* kernel = rows ? (const void*)point_draws_rows_kernel
                            : (const void*)point_draws_long_kernel;
  const size_t smem = ((size_t)(K + 3) & ~(size_t)3) * sizeof(float) +
                      (rows ? (size_t)PD_THREADS * cap * sizeof(int32_t)
                            : (size_t)PD_WARPS * R * sizeof(float));
  if (smem > PD_MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024 &&
      (e = cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem)) != cudaSuccess)
    return (int)e;
  // as many blocks as the card holds at once, shared among the
  // chromosomes, and no more than the rows need
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, PD_THREADS, smem)) != cudaSuccess)
    return (int)e;
  const int64_t rows_block = rows ? PD_THREADS : PD_WARPS;
  const int64_t need = (n + rows_block - 1) / rows_block;
  const int32_t* b0 = (const int32_t*)bp0;
  const int32_t* st = (const int32_t*)step;
  const float* wd = (const float*)width;
  const int32_t* lv = (const int32_t*)live;
  for (int64_t c0 = 0; c0 < C; c0 += PD_CHR) {
    const int cc = (int)(C - c0 < PD_CHR ? C - c0 : PD_CHR);
    PdChroms ch = {};
    for (int c = 0; c < cc; ++c) {
      ch.bp0[c] = b0[c0 + c];
      ch.step[c] = st[c0 + c];
      ch.width[c] = wd[c0 + c];
      ch.live[c] = lv[c0 + c];
    }
    int64_t per_chr = ((int64_t)sms * (per_sm > 0 ? per_sm : 1) + cc - 1) /
                      cc;
    if (per_chr > need) per_chr = need;
    const dim3 grid((unsigned)per_chr, (unsigned)cc);
    const float* cn = (const float*)counts + c0 * n;
    const float* un = (const float*)unif + c0 * n * R;
    const float* vn = (const float*)v + c0 * n * cap;
    const float* cm = (const float*)cum + c0 * K;
    const int32_t* bt = affine ? (const int32_t*)bp
                               : (const int32_t*)bp + c0 * K;
    int32_t* o = (int32_t*)out + c0 * n * cap;
    if (rows)
      point_draws_rows_kernel<<<grid, PD_THREADS, smem,
                                (cudaStream_t)stream>>>(
          cn, un, vn, cm, bt, o, ch, n, cap, K, affine, inclusive,
          (int32_t)big);
    else
      point_draws_long_kernel<<<grid, PD_THREADS, smem,
                                (cudaStream_t)stream>>>(
          cn, un, vn, cm, bt, o, ch, n, cap, K, chunk, affine, inclusive,
          (int32_t)big);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}
