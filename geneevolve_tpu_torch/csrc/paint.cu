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
// Bound: bytes, at both of the port's shapes, but not the same bytes.
// - Genotype output (Q ~15,000 loci a chromosome, positions from the
//   legend, ascending): the painted bytes, written once, and the founder
//   panel (H x Q), read at least once. A row's ledger (~400 bytes) is small
//   beside its ~15 KB of output.
// - The gather A/D path (Q = 100 CV columns a chromosome): a row's ledger
//   (S 49 starts and haps, M 27 mutations, ~400 bytes) outweighs its 100
//   painted bytes, and most of its slots are BIG padding.
// Both stay well above their bound (PERF.md, paint). At full width the
// copy holds most of the time (a variant without the ledger staging was
// timed in turns): the panel under each run is read again for each row
// that uses it, mostly from HBM. At the gather shape each row is a short
// chain of dependent steps and a few hundred warp instructions. So the
// design spends as few instructions and dependent loads as it can.
// - Runs, not per-locus decisions, where a span's positions ascend (the
//   block checks, no host sync) and the span is longer than
//   GE_PAINT_LOCUS_SPAN: the loci of ledger slot s are the index range
//   [#{q < st[s]}, #{q < st[s + 1]}), and the loci of a mutation at v are
//   [#{q < v}, #{q <= v}). A warp stages a row's run boundaries (a binary
//   search over the staged positions per slot, a lane a slot) and its
//   mutation ranges in shared memory; painting is then a copy of
//   founder[hap, lo:hi] into out[row, lo:hi] for each run, with flips on
//   the few bytes inside a mutation's range. A 16-byte chunk that spans
//   several runs merges each run's 16 bytes under a byte mask.
// - 16-byte stores at every width. The output row starts wherever row * Q
//   puts it (4-byte aligned at both real shapes): a lane paints chunks
//   aligned to 16 bytes of the output, and reads the founder bytes under
//   them as two aligned 16-byte loads shifted into place (funnel shifts;
//   the shift is constant along a run). The bytes before the first chunk
//   and after the last (at most 30) take one pass, a lane a byte.
// - Short spans (the gather path's 100 CVs) and spans whose positions do
//   not ascend: a lane paints 4 consecutive loci, walking a slot pointer
//   and a mutation pointer (their bounds and founder row in registers)
//   over the staged starts and mutations, searching again only where a
//   locus leaves them, and stores the 4 bytes as one word where the row's
//   alignment allows.
// - Positions staged once per block and span of 4,096 loci; a block covers
//   many rows (a warp loops over its rows, `ops/paint.launch_plan` sizes
//   the group) and has no block barrier after the positions are staged.
//   Blocks are ordered row group fastest, then span, then chromosome.
//   Spans of 4,096 loci beat 2,048, 1,024 and 8,192 in turns on the card,
//   though their panel slab (H x span bytes) outgrows L2: a row's staging
//   per span costs more than the slab's L2 misses.
// - The next row's first 32 starts, haps and mutations are loaded into
//   registers while the current row paints. A row's ledger is read only up
//   to its first start (and mutation) past the span's largest position: at
//   BIG padding, no further than the first BIG slot, in 32-slot chunks.
// Exactness (each has a card test): the slot is #{st <= q} - 1 with
// duplicate starts (their runs are empty); hap 0, not slot 0, before the
// first start (run 0); BIG queries count BIG slots (the last run reaches
// the span's end); a flip needs q < BIG and exact membership, once for
// repeated mutations; haps are clamped into the panel, so a whole run
// reads the clamped row; 1 - f wraps in uint8.
// Preconditions: each ledger row ascending (BIG padded), each mutation row
// ascending (BIG padded); positions in any order.
#include <limits.h>

#include "common.cuh"

#define GE_PAINT_MAX_THREADS 256
#define GE_PAINT_LOCUS_SPAN 256  // spans this short: a lane 4 loci

// bytes d .. d + 15 of the 32 bytes w0, w1 (0 < d < 16)
__device__ __forceinline__ uint4 ge_shift16(uint4 w0, uint4 w1, int d) {
  uint32_t t0, t1, t2, t3, t4;
  switch (d >> 2) {
    case 0: t0 = w0.x; t1 = w0.y; t2 = w0.z; t3 = w0.w; t4 = w1.x; break;
    case 1: t0 = w0.y; t1 = w0.z; t2 = w0.w; t3 = w1.x; t4 = w1.y; break;
    case 2: t0 = w0.z; t1 = w0.w; t2 = w1.x; t3 = w1.y; t4 = w1.z; break;
    default: t0 = w0.w; t1 = w1.x; t2 = w1.y; t3 = w1.z; t4 = w1.w; break;
  }
  const unsigned sh = (unsigned)(d & 3) * 8;
  return make_uint4(__funnelshift_r(t0, t1, sh), __funnelshift_r(t1, t2, sh),
                    __funnelshift_r(t2, t3, sh), __funnelshift_r(t3, t4, sh));
}

// The 16 founder bytes at p, any alignment, from the aligned 16-byte
// blocks that hold them. The block holding p + 15 lies in the same page
// as that byte, so the second load never leaves the panel's mapping.
__device__ __forceinline__ uint4 ge_load16(const uint8_t* p) {
  const uintptr_t a = (uintptr_t)p;
  const uint4* q = (const uint4*)(a & ~(uintptr_t)15);
  const int d = (int)(a & 15);
  const uint4 w0 = __ldg(q);
  return d == 0 ? w0 : ge_shift16(w0, __ldg(q + 1), d);
}

union GeChunk {
  uint4 v;
  uint8_t b[16];
};

// bytes [a, e) of a 16-byte chunk that fall in its 32-bit word w
__device__ __forceinline__ uint32_t ge_bytemask(int a, int e, int w) {
  const int lo = min(max(a - 4 * w, 0), 4), hi = min(max(e - 4 * w, 0), 4);
  const uint32_t below_lo = lo == 4 ? 0xffffffffu : (1u << (8 * lo)) - 1u;
  const uint32_t below_hi = hi == 4 ? 0xffffffffu : (1u << (8 * hi)) - 1u;
  return below_hi & ~below_lo;
}

// A row staged in a warp's shared memory, one slot of 2 S + 2 M + 8
// words. Runs: B[0..R] the runs' first loci (B[0] = 0, B[R] = n, R = kst +
// 1), HP[0..R) their clamped haps (HP[0] = 0: before the first start), and
// [ML[i], MH[i]) the loci of mutation i, ML[nm] = MH[nm] = INT_MAX. Lanes
// of 4 loci: B[1..kst] the starts and ML[1..nm] the mutations, between
// INT_MIN and INT_MAX sentinels, HP[k] the hap of k starts <= q.
struct GeRow {
  int32_t *B, *HP, *ML, *MH;
  int kst, nm;
};

__device__ __forceinline__ GeRow ge_slot(int32_t* base, int S, int M) {
  GeRow w;
  w.B = base;
  w.HP = base + S + 2;
  w.ML = w.HP + S + 2;
  w.MH = w.ML + M + 2;
  w.kst = w.nm = 0;
  return w;
}

// lane's slot of a row's first 32 starts, haps and mutations
template <typename HapT>
__device__ __forceinline__ void ge_prefetch(
    int32_t& st, int32_t& hp, int32_t& mu, const int32_t* seg_st,
    const HapT* seg_hap, const int32_t* mut, int64_t row, int S, int M,
    int lane) {
  if (lane < S) st = __ldg(seg_st + row * S + lane);
  if (lane < S) hp = (int32_t)__ldg(seg_hap + row * S + lane);
  if (lane < M) mu = __ldg(mut + row * M + lane);
}

// Stages row `row` into w: its starts up to the first one past qmax (kst
// of them) and its mutations likewise (nm), the first 32 of each from the
// prefetched registers.
template <typename HapT>
__device__ __forceinline__ void ge_stage(
    GeRow& w, const int32_t* seg_st, const HapT* seg_hap, const int32_t* mut,
    int64_t row, int32_t st0, int32_t hp0, int32_t mu0, int S, int M,
    int64_t H, int32_t qmax, int32_t big, bool runs, const int32_t* spos,
    int n, int lane) {
  const int32_t* st = seg_st + row * S;
  const HapT* hp = seg_hap + row * S;
  const int32_t* mu = mut + row * M;
  int kst = 0;
  for (int base = 0; base < S; base += 32) {
    const int s = base + lane;
    const int32_t v = base == 0 ? st0 : (s < S ? __ldg(st + s) : 0);
    const bool in = s < S && v <= qmax;
    const int cnt = __popc(__ballot_sync(GE_FULL, in));
    if (in) {
      const int32_t h = base == 0 ? hp0 : (int32_t)__ldg(hp + s);
      w.B[s + 1] = runs ? ge_lower_bound(spos, n, v) : v;
      w.HP[s + 1] = h < 0 ? 0 : (h >= H ? (int32_t)(H - 1) : h);
    }
    kst += cnt;
    if (cnt < 32) break;
  }
  int nm = 0;
  int32_t carry = 0;
  for (int base = 0; base < M; base += 32) {
    const int i = base + lane;
    const int32_t v = base == 0 ? mu0 : (i < M ? __ldg(mu + i) : 0);
    const bool in = i < M && v <= qmax;
    const int cnt = __popc(__ballot_sync(GE_FULL, in));
    int32_t prev = __shfl_up_sync(GE_FULL, v, 1);
    if (lane == 0) prev = carry;
    if (in) {
      if (runs) {
        // the loci at v follow lo: few, often none. A repeated mutation
        // flips once: its repeats, and mutations at BIG, get empty ranges
        // at hi, so both ends stay in order for the searches that read them
        const int lo = ge_lower_bound(spos, n, v);
        int hi = lo;
        while (hi < n && spos[hi] == v) ++hi;
        w.ML[i] = v < big && !(i > 0 && prev == v) ? lo : hi;
        w.MH[i] = hi;
      } else {
        w.ML[i + 1] = v;
      }
    }
    carry = __shfl_sync(GE_FULL, v, 31);
    nm += cnt;
    if (cnt < 32) break;
  }
  if (lane == 0) {
    w.HP[0] = 0;
    if (runs) {
      w.B[0] = 0;
      w.B[kst + 1] = n;
      w.ML[nm] = w.MH[nm] = INT_MAX;
    } else {
      w.B[0] = INT_MIN;
      w.B[kst + 1] = INT_MAX;
      w.ML[0] = INT_MIN;
      w.ML[nm + 1] = INT_MAX;
    }
  }
  w.kst = kst;
  w.nm = nm;
}

// A row painted as runs: the 16-byte-aligned chunks of the output row a
// lane a chunk, then the bytes before the first chunk and after the last
// (at most 30) a lane a byte.
__device__ __forceinline__ void ge_paint_runs(const GeRow& w, uint8_t* orow,
                                              const uint8_t* fc, int64_t Q,
                                              int n, int lane) {
  const int32_t *B = w.B, *HP = w.HP, *ML = w.ML, *MH = w.MH;
  const int R = w.kst + 1;
  const int a0 = (int)((uintptr_t)orow & 15);
  const int head = min((16 - a0) & 15, n);
  const int nfull = (n - head) >> 4;
  int r = 0, mi = 0;
  for (int t = lane; t < nfull; t += 32) {
    const int lo = head + (t << 4), hi = lo + 16;
    if (lo >= B[r + 1]) r = ge_upper_bound(B + 1, R - 1, lo);
    uint4 v;
    if (hi <= B[r + 1]) {
      v = ge_load16(fc + (int64_t)HP[r] * Q + lo);
    } else {
      // runs shorter than the chunk: each run's 16 bytes, masked
      v = make_uint4(0, 0, 0, 0);
      for (int a = lo; a < hi; ++r) {
        const int e = B[r + 1] < hi ? B[r + 1] : hi;
        if (e <= a) continue;  // an empty run (duplicate starts)
        const uint4 x = ge_load16(fc + (int64_t)HP[r] * Q + lo);
        v.x |= x.x & ge_bytemask(a - lo, e - lo, 0);
        v.y |= x.y & ge_bytemask(a - lo, e - lo, 1);
        v.z |= x.z & ge_bytemask(a - lo, e - lo, 2);
        v.w |= x.w & ge_bytemask(a - lo, e - lo, 3);
        a = e;
      }
      --r;  // the run of byte hi - 1
    }
    // flips: the mutation ranges that meet [lo, hi)
    while (MH[mi] <= lo) ++mi;
    uint32_t fm = 0;
    for (int k = mi; ML[k] < hi; ++k) {
      const int fa = (ML[k] > lo ? ML[k] : lo) - lo;
      const int fe = (MH[k] < hi ? MH[k] : hi) - lo;
      if (fe > fa) fm |= ((1u << (fe - fa)) - 1u) << fa;
    }
    if (fm) {
      GeChunk u;
      u.v = v;
#pragma unroll
      for (int b = 0; b < 16; ++b)
        if ((fm >> b) & 1u) u.b[b] = (uint8_t)(1 - u.b[b]);
      v = u.v;
    }
    *(uint4*)(orow + lo) = v;
  }
  const int tail = head + (nfull << 4);
  const int j = lane < 16 ? lane : tail + lane - 16;
  if (lane < 16 ? j < head : j < n) {
    const int rj = ge_upper_bound(B + 1, R - 1, j);
    const uint8_t f = fc[(int64_t)HP[rj] * Q + j];
    const int k = ge_upper_bound(MH, w.nm, j);  // the first range past j
    orow[j] = ML[k] <= j ? (uint8_t)(1 - f) : f;
  }
}

// A lane's walk over its loci in a row painted 4 loci a lane: the slot
// (klo <= q < khi, its founder row frow) and the mutation pointer (mlo <
// q <= mhi) of its last locus, searched again where a locus leaves them.
struct GeWalk {
  int32_t klo, khi, mlo, mhi;
  const uint8_t* frow;
};

__device__ __forceinline__ GeWalk ge_walk(const uint8_t* fc) {
  GeWalk p;
  p.klo = p.khi = p.mlo = p.mhi = INT_MIN;
  p.frow = fc;
  return p;
}

// The 4 painted bytes of loci 4u .. 4u + 3 (those below n), as a word.
__device__ __forceinline__ uint32_t ge_unit(GeWalk& p, const GeRow& w,
                                            const int32_t* spos, int n, int u,
                                            const uint8_t* fc, int64_t Q,
                                            int32_t big) {
  uint32_t x = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int j = 4 * u + b;
    if (j < n) {
      const int32_t q = spos[j];
      if (!(p.klo <= q && q < p.khi)) {
        const int k = ge_upper_bound(w.B + 1, w.kst, q);
        p.klo = w.B[k];
        p.khi = w.B[k + 1];
        p.frow = fc + (int64_t)w.HP[k] * Q;
      }
      if (!(p.mlo < q && q <= p.mhi)) {
        const int m = 1 + ge_lower_bound(w.ML + 1, w.nm, q);
        p.mlo = w.ML[m - 1];
        p.mhi = w.ML[m];
      }
      const uint8_t f = p.frow[j];
      x |= (uint32_t)(q < big && p.mhi == q ? (uint8_t)(1 - f) : f) << (8 * b);
    }
  }
  return x;
}

__device__ __forceinline__ void ge_store_unit(uint8_t* orow, int u, int n,
                                              uint32_t x) {
  if (((uintptr_t)(orow + 4 * u) & 3) == 0 && 4 * u + 4 <= n) {
    *(uint32_t*)(orow + 4 * u) = x;
  } else {
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (4 * u + b < n) orow[4 * u + b] = (uint8_t)(x >> (8 * b));
  }
}

// grid: (row groups, spans, chromosomes); a block of `warps` warps paints
// rows [g0, g0 + rows_per_block) of chromosome blockIdx.z over the span's
// loci [j0, j0 + n); warp w takes rows g0 + w, g0 + w + warps, ...
template <typename HapT>
__global__ void __launch_bounds__(GE_PAINT_MAX_THREADS)
    paint_kernel(const int32_t* __restrict__ seg_st,
                 const HapT* __restrict__ seg_hap,
                 const int32_t* __restrict__ mut,
                 const uint8_t* __restrict__ founder,
                 const int32_t* __restrict__ pos, uint8_t* __restrict__ out,
                 int64_t rows2, int S, int M, int64_t H, int64_t Q,
                 int span_len, int rows_per_block, int warp_words,
                 int32_t big) {
  extern __shared__ int32_t smem[];
  __shared__ int32_t s_qmax;
  __shared__ int s_unsorted;
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t c = blockIdx.z;
  const int64_t j0 = (int64_t)blockIdx.y * span_len;
  const int n = (int)(Q - j0 < span_len ? Q - j0 : span_len);

  // the span's positions, the largest of them, and whether they ascend
  int32_t* spos = smem;
  if (threadIdx.x == 0) {
    s_qmax = INT_MIN;
    s_unsorted = 0;
  }
  __syncthreads();
  {
    const int32_t* pc = pos + c * Q + j0;
    int32_t hi = INT_MIN;
    bool down = false;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int32_t q = pc[i];
      spos[i] = q;
      hi = max(hi, q);
      down = down || (i + 1 < n && q > pc[i + 1]);
    }
    hi = __reduce_max_sync(GE_FULL, hi);
    down = __any_sync(GE_FULL, down);
    if (lane == 0) {
      atomicMax(&s_qmax, hi);
      if (down) s_unsorted = 1;
    }
  }
  __syncthreads();
  const int32_t qmax = s_qmax;
  // runs where the positions ascend and the span is long enough to pay
  // for the run boundaries' searches; else a lane 4 loci
  const bool runs = !s_unsorted && n > GE_PAINT_LOCUS_SPAN;

  // each warp: one staged row, `warp_words` words after the positions
  int32_t* wsm = smem + ((span_len + 3) & ~3) + warp * warp_words;
  GeRow A = ge_slot(wsm, S, M);

  const int64_t g0 = (int64_t)blockIdx.x * rows_per_block;
  const int64_t g1 =
      g0 + rows_per_block < rows2 ? g0 + rows_per_block : rows2;
  const uint8_t* fc = founder + c * H * Q + j0;
  const int64_t r0 = c * rows2;  // the chromosome's first chromatid row

  int64_t g = g0 + warp;
  if (g >= g1) return;
  // a row an iteration; the next row's first slots in flight
  int32_t nst = 0, nhp = 0, nmu = 0;
  ge_prefetch(nst, nhp, nmu, seg_st, seg_hap, mut, r0 + g, S, M, lane);
  for (; g < g1; g += warps) {
    const int32_t st0 = nst, hp0 = nhp, mu0 = nmu;
    if (g + warps < g1)
      ge_prefetch(nst, nhp, nmu, seg_st, seg_hap, mut, r0 + g + warps, S, M,
                  lane);
    ge_stage(A, seg_st, seg_hap, mut, r0 + g, st0, hp0, mu0, S, M, H, qmax,
             big, runs, spos, n, lane);
    __syncwarp();
    uint8_t* orow = out + (r0 + g) * Q + j0;
    if (runs) {
      ge_paint_runs(A, orow, fc, Q, n, lane);
    } else {
      GeWalk p = ge_walk(fc);
      for (int u = lane; 4 * u < n; u += 32)
        ge_store_unit(orow, u, n, ge_unit(p, A, spos, n, u, fc, Q, big));
    }
    __syncwarp();
  }
}

// seg_st, seg_hap: (C, rows, 2, S); mut: (C, rows, 2, M); founder: (C, H,
// Q) uint8; pos: (C, Q) int32; out: (C, rows, 2, Q) uint8; all contiguous.
// hap_bytes: 2 (int16 haps) or 4 (int32). The launch shape comes from
// ops/paint.launch_plan: `span` loci a block, `warps` warps a block,
// `rows_per_block` rows a block, `blocks` row groups, `warp_words` words
// of shared memory a warp and `smem` bytes in all; the limits are checked
// again here.
GE_API int ge_paint(const void* seg_st, const void* seg_hap, int hap_bytes,
                    const void* mut, const void* founder, const void* pos,
                    void* out, int64_t C, int64_t rows, int64_t S, int64_t M,
                    int64_t H, int64_t Q, int big, int span, int warps,
                    int rows_per_block, int64_t blocks, int warp_words,
                    int smem, void* stream) {
  if (C == 0 || rows == 0 || Q == 0) return (int)cudaGetLastError();
  const int64_t spans = (Q + span - 1) / span;
  // one span when Q is shorter: the staged positions take Q entries
  const int sl = span < Q ? span : (int)Q;
  const int64_t need = 4 * (((sl + 3) & ~3) + (int64_t)warps * warp_words);
  if (C > 65535 || spans > 65535 || H < 1 || S >= (1LL << 20) ||
      M >= (1LL << 20) || span < 1 || warps < 1 ||
      32 * warps > GE_PAINT_MAX_THREADS || rows_per_block < warps ||
      warp_words % 4 != 0 || warp_words < 2 * S + 2 * M + 8 ||
      smem < need || smem > 227 * 1024 - 64 ||
      blocks * rows_per_block < 2 * rows || blocks > INT_MAX ||
      (hap_bytes != 2 && hap_bytes != 4))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)spans, (unsigned)C);
  const cudaStream_t s = (cudaStream_t)stream;
#define GE_PAINT_LAUNCH(T)                                                  \
  do {                                                                      \
    auto kern = &paint_kernel<T>;                                           \
    if (smem > 48 * 1024) {                                                 \
      const cudaError_t e = cudaFuncSetAttribute(                           \
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);         \
      if (e != cudaSuccess) return (int)e;                                  \
    }                                                                       \
    kern<<<grid, 32 * warps, smem, s>>>(                                    \
        (const int32_t*)seg_st, (const T*)seg_hap, (const int32_t*)mut,     \
        (const uint8_t*)founder, (const int32_t*)pos, (uint8_t*)out,        \
        2 * rows, (int)S, (int)M, H, Q, sl, rows_per_block, warp_words,     \
        (int32_t)big);                                                      \
  } while (0)
  if (hap_bytes == 2)
    GE_PAINT_LAUNCH(int16_t);
  else
    GE_PAINT_LAUNCH(int32_t);
#undef GE_PAINT_LAUNCH
  return (int)cudaGetLastError();
}
