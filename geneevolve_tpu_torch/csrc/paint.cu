// Genotype painting: the founder allele under each (row, chromatid, locus)
// of C stacked chromosomes, flipped where the chromatid carries a mutation
// at that locus:
//   out[c, r, h, j] = flip ? 1 - f : f,   f = founder[c, hap, j],
//   hap  = seg_hap[c, r, h, #{seg_st[c, r, h, :] <= pos[c, j]} - 1]  (0 if
//          no start is <= pos),
//   flip = pos[c, j] < BIG and pos[c, j] in mut[c, r, h, :].
//
// Replaces the XLA functions geneevolve_tpu/core/output.py `_paint_chunk`
// and core/engine.py `_ad_all`, both built on core/segments.py `hap_at` (a
// compare-reduce over the ledger's S slots that XLA fuses) and
// `mutation_flip_mask`. Eager PyTorch cannot fuse them: the plain version
// materializes a (rows, 2, Q, S) compare, ~44 GB a chromosome at 30,708
// rows x 14,588 loci x S 49.
//
// Bound: bytes. Each output byte is written once, and the founder panel
// (H x Q bytes a chromosome) must be read at least once; the ledgers,
// mutation rows and positions are small beside them. The design keeps the
// panel's reads near once and both streams coalesced:
// - a warp paints one chromatid row over a span of GE_SPAN loci, staging
//   that row's S starts and haps and M mutations in shared memory once;
//   the block's 8 warps share the span's positions, staged once;
// - blocks are ordered row group fastest, then span, then chromosome, so
//   the blocks in flight read one span's slab of the panel (H x GE_SPAN
//   bytes, ~41 MB at 20,000 haplotypes), most of which L2 (50 MB) holds;
// - a lane paints units of W loci, W the widest of 16, 8, 4, 2, 1 bytes
//   that divides Q and both base addresses: one W-byte founder load when
//   the W loci lie in one segment (almost always), one W-byte store; the
//   warp's lanes take consecutive units, so each load and store of the
//   warp covers consecutive bytes;
// - the slot covering a locus and the mutation pointer are walked forward:
//   a lane keeps its current slot and re-searches (binary search over the
//   sorted starts) only when the locus leaves it, so a row costs about one
//   search per segment boundary, not per locus.
// At the full-width shape this runs at ~16% of its bound (PERF.md). In
// runs in turns, spans of 2,048 loci beat 512 and 1,024 (fewer, longer
// blocks, less staging); deciding a unit by two compares, and issuing 4
// units' loads before their stores, gained little at 14,588 loci, lost at
// odd widths and at the gather path's 100 CVs, and were not kept.
// Preconditions: each ledger row ascending (BIG padded), each mutation row
// ascending (BIG padded); positions in any order (an unsorted position
// only costs a search). Hap indices are clamped into the panel, as the
// JAX gather clamps them.
#include <limits.h>

#include "common.cuh"

#define GE_WARPS 8                 // chromatid rows a block
#define GE_SPAN 2048               // loci a block paints of each row
#define GE_THREADS (32 * GE_WARPS)

// #{a[j] <= v} and #{a[j] < v} of the sorted a[0..n), from common.cuh:
// ge_upper_bound, ge_lower_bound.

template <typename V, typename HapT>
__global__ void __launch_bounds__(GE_THREADS)
    paint_kernel(const int32_t* __restrict__ seg_st,
                 const HapT* __restrict__ seg_hap,
                 const int32_t* __restrict__ mut,
                 const uint8_t* __restrict__ founder,
                 const int32_t* __restrict__ pos, uint8_t* __restrict__ out,
                 int64_t rows2, int S, int M, int64_t H, int64_t Q,
                 int32_t big) {
  constexpr int W = (int)sizeof(V);
  extern __shared__ int32_t smem[];
  __shared__ int32_t spos[GE_SPAN];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t c = blockIdx.z;
  const int64_t j0 = (int64_t)blockIdx.y * GE_SPAN;
  const int span = (int)(Q - j0 < GE_SPAN ? Q - j0 : GE_SPAN);
  const int64_t g = (int64_t)blockIdx.x * GE_WARPS + warp;  // row in chr
  const bool live = g < rows2;
  const int64_t row = c * rows2 + g;  // chromatid row of every plane

  // per warp: sst[0..S+1] = (INT_MIN, starts, INT_MAX), shap[0..S),
  // smu[0..M+1] = (INT_MIN, mutations, INT_MAX)
  int32_t* sst = smem + warp * (2 * S + M + 4);
  int32_t* shap = sst + S + 2;
  int32_t* smu = shap + S;
  for (int i = threadIdx.x; i < span; i += GE_THREADS)
    spos[i] = pos[c * Q + j0 + i];
  if (live) {
    const int32_t* st = seg_st + row * S;
    const HapT* hp = seg_hap + row * S;
    const int32_t* mu = mut + row * M;
    for (int s = lane; s < S; s += 32) {
      sst[s + 1] = st[s];
      shap[s] = (int32_t)hp[s];
    }
    for (int s = lane; s < M; s += 32) smu[s + 1] = mu[s];
    if (lane == 0) {
      sst[0] = INT_MIN;
      sst[S + 1] = INT_MAX;
      smu[0] = INT_MIN;
      smu[M + 1] = INT_MAX;
    }
  }
  __syncthreads();
  if (!live) return;

  const uint8_t* fc = founder + c * H * Q;
  uint8_t* orow = out + row * Q;
  int k = 0;  // #{st <= q}: sst[k] <= q < sst[k + 1]
  int m = 0;  // #{mu < q}:  smu[m] < q <= smu[m + 1]
  for (int u = lane; u * W < span; u += 32) {
    const int64_t j = j0 + (int64_t)u * W;
    union {
      V v;
      uint8_t b[W];
    } f;
    int32_t hap[W];
    bool flip[W];
    bool same = true;
#pragma unroll
    for (int b = 0; b < W; ++b) {
      const int32_t q = spos[u * W + b];
      if (!(sst[k] <= q && q < sst[k + 1])) k = ge_upper_bound(sst + 1, S, q);
      if (!(smu[m] < q && q <= smu[m + 1])) m = ge_lower_bound(smu + 1, M, q);
      int32_t h = k > 0 ? shap[k - 1] : 0;
      h = h < 0 ? 0 : (h >= H ? (int32_t)(H - 1) : h);
      hap[b] = h;
      flip[b] = q < big && smu[m + 1] == q;
      same = same && h == hap[0];
    }
    if (same) {
      f.v = *(const V*)(fc + (int64_t)hap[0] * Q + j);
    } else {
#pragma unroll
      for (int b = 0; b < W; ++b) f.b[b] = fc[(int64_t)hap[b] * Q + j + b];
    }
#pragma unroll
    for (int b = 0; b < W; ++b)
      if (flip[b]) f.b[b] = (uint8_t)(1 - f.b[b]);
    *(V*)(orow + j) = f.v;
  }
}

template <typename V, typename HapT>
static int launch(const void* seg_st, const void* seg_hap, const void* mut,
                  const void* founder, const void* pos, void* out, int64_t C,
                  int64_t rows2, int S, int M, int64_t H, int64_t Q,
                  int32_t big, cudaStream_t stream) {
  const size_t smem = (size_t)GE_WARPS * (2 * S + M + 4) * sizeof(int32_t);
  auto kern = &paint_kernel<V, HapT>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)((rows2 + GE_WARPS - 1) / GE_WARPS),
                  (unsigned)((Q + GE_SPAN - 1) / GE_SPAN), (unsigned)C);
  kern<<<grid, GE_THREADS, smem, stream>>>(
      (const int32_t*)seg_st, (const HapT*)seg_hap, (const int32_t*)mut,
      (const uint8_t*)founder, (const int32_t*)pos, (uint8_t*)out, rows2, S,
      M, H, Q, big);
  return (int)cudaGetLastError();
}

template <typename HapT>
static int dispatch(int width, const void* seg_st, const void* seg_hap,
                    const void* mut, const void* founder, const void* pos,
                    void* out, int64_t C, int64_t rows2, int S, int M,
                    int64_t H, int64_t Q, int32_t big, cudaStream_t stream) {
  const auto f = width == 16  ? &launch<uint4, HapT>
                 : width == 8 ? &launch<uint2, HapT>
                 : width == 4 ? &launch<uint32_t, HapT>
                 : width == 2 ? &launch<uint16_t, HapT>
                              : &launch<uint8_t, HapT>;
  return f(seg_st, seg_hap, mut, founder, pos, out, C, rows2, S, M, H, Q, big,
           stream);
}

// seg_st, seg_hap: (C, rows, 2, S); mut: (C, rows, 2, M); founder: (C, H,
// Q) uint8; pos: (C, Q) int32; out: (C, rows, 2, Q) uint8; all contiguous.
// hap_bytes: 2 (int16 haps) or 4 (int32).
GE_API int ge_paint(const void* seg_st, const void* seg_hap, int hap_bytes,
                    const void* mut, const void* founder, const void* pos,
                    void* out, int64_t C, int64_t rows, int64_t S, int64_t M,
                    int64_t H, int64_t Q, int big, void* stream) {
  if (C == 0 || rows == 0 || Q == 0) return (int)cudaGetLastError();
  // grid limits (y: spans, z: chromosomes), int32 slot counts, a panel
  const int64_t per_warp = 2 * S + M + 4;
  if (C > 65535 || (Q + GE_SPAN - 1) / GE_SPAN > 65535 || H < 1 ||
      S >= (1LL << 20) || M >= (1LL << 20) ||
      GE_WARPS * per_warp * 4 > 227 * 1024 - GE_SPAN * 4 ||
      (hap_bytes != 2 && hap_bytes != 4))
    return (int)cudaErrorInvalidValue;
  const uintptr_t a =
      (uintptr_t)founder | (uintptr_t)out | (uintptr_t)Q;
  const int width = a % 16 == 0 ? 16
                    : a % 8 == 0 ? 8
                    : a % 4 == 0 ? 4
                    : a % 2 == 0 ? 2
                                 : 1;
  const cudaStream_t s = (cudaStream_t)stream;
  return hap_bytes == 2
             ? dispatch<int16_t>(width, seg_st, seg_hap, mut, founder, pos,
                                 out, C, 2 * rows, (int)S, (int)M, H, Q,
                                 (int32_t)big, s)
             : dispatch<int32_t>(width, seg_st, seg_hap, mut, founder, pos,
                                 out, C, 2 * rows, (int)S, (int)M, H, Q,
                                 (int32_t)big, s);
}
