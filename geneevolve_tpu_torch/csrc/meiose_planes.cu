// Byte-plane meiosis: one child's two gametes, one byte per locus.
//
// Replaces geneevolve_tpu/ops/meiosis_pallas.py `meiose_planes_pallas`. Per
// child c, gamete g (0 = childA from the father, 1 = childB from the mother)
// and locus l of chromosome k:
//
//   parity = (start[k] + #{crossovers x of chromosome k with x <= l}) & 1,
//   child[c, l] = a ^ ((parity ? 0xFF : 0) & (a ^ b)),
//
// with a, b the parent's hapA / hapB bytes. A crossover counts in the
// chromosome its locus lies in, whatever slot row holds it (pad slots = m
// and loci outside [0, m) drop out), as the plain version's scatter +
// per-chromosome cumsum counts it: the `cdf` sampler can put a slot of
// chromosome k at chromosome k-1's last column.
//
// Bound: memory, 6 bytes per locus per child (two planes read per gamete,
// one written). Design: one block per (child, chunk of 1,024 16-byte
// pieces, 16,384 loci); the block stages the child's real crossovers,
// bucketed by the chromosome of their locus (a shared-memory counting
// sort), and starts in shared memory. Each child row is cut where its own
// addresses cross 16 bytes: a head of at most 15 bytes, a body of 16-byte
// pieces (one 16-byte store each) and a tail of at most 15 bytes; the
// first block of a row writes its head, the last its tail, a thread a
// byte. A thread moves body pieces tid, tid + 256, ... of its block: where
// a parent row lies at the child row's 16-byte phase, one 16-byte load a
// plane; at another phase (a row stride off 16 bytes, as whole planes of
// m % 16 != 0 have, or a window at another offset than the child's), the
// two aligned 16-byte loads that cover the piece (the second an L1 hit of
// the neighbour's first), funnel-shifted into place. The launch plan
// (ops/meiose_planes.py `launch_plan`) says whether any shift can be
// non-zero and how many blocks a row takes. The 16 phases of a piece
// come from one 16-bit mask built like the packed kernel's word mask (~0
// past a crossover, a shifted mask at it), and are spread to bytes with a
// multiply. No m % 8192 restriction: the TPU block size is not carried
// over.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPiecesPerBlock = 1024;  // 16-byte pieces of a row a block

// Bit j set: locus col0 + j takes chromatid B (j < nb; one chromosome's
// crossovers when all nb loci lie in it, else looked up per locus).
// Chromosome r = g * n_chr + c holds xcnt[r] crossovers from xs[xend[r] -
// xcnt[r]].
__device__ __forceinline__ uint32_t phase_bits(int col0, int nb, int g,
                                               int n_chr, int chr_len,
                                               const int32_t* xs,
                                               const int32_t* xend,
                                               const int32_t* xcnt,
                                               const int32_t* st) {
  const int c0 = col0 / chr_len;
  const int c1 = (col0 + nb - 1) / chr_len;
  const uint32_t full = (nb == 32) ? 0xFFFFFFFFu : ((1u << nb) - 1u);
  if (c0 == c1) {
    const int r = g * n_chr + c0;
    uint32_t bits = (st[r] & 1) ? full : 0u;
    const int32_t* x = xs + xend[r] - xcnt[r];
    for (int k = 0; k < xcnt[r]; ++k) {
      const int d = x[k] - col0;
      if (d <= 0) {
        bits ^= full;
      } else if (d < nb) {
        bits ^= (full << d) & full;
      }
    }
    return bits;
  }
  uint32_t bits = 0;  // the loci span a chromosome boundary
  for (int j = 0; j < nb; ++j) {
    const int col = col0 + j;
    const int r = g * n_chr + col / chr_len;
    int par = st[r] & 1;
    const int32_t* x = xs + xend[r] - xcnt[r];
    for (int k = 0; k < xcnt[r]; ++k) par ^= (x[k] <= col);
    bits |= (uint32_t)par << j;
  }
  return bits;
}

// the 16-byte vector holding byte `b`, and b's place in it
__device__ __forceinline__ const uint4* vec_of(const uint8_t* b) {
  return reinterpret_cast<const uint4*>((uintptr_t)b & ~(uintptr_t)15);
}
__device__ __forceinline__ int shift_of(const uint8_t* b) {
  return (int)((uintptr_t)b & 15);
}

// The 16 bytes that start `shift` bytes into the aligned vector v[0]:
// v[0] itself at shift 0, else v[0] and v[1] funnel-shifted
template <bool kShift>
__device__ __forceinline__ uint4 load16(const uint4* v, int shift) {
  const uint4 lo = v[0];
  if (!kShift || shift == 0) return lo;
  const uint4 hi = v[1];
  const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const int q = shift >> 2;  // whole words
  const uint32_t r = 8u * (shift & 3);  // and bits
  uint32_t x[5];
#pragma unroll
  for (int c = 0; c < 5; ++c)
    x[c] = q == 0 ? w[c] : (q == 1 ? w[c + 1] : (q == 2 ? w[c + 2] : w[c + 3]));
  return make_uint4(
      __funnelshift_r(x[0], x[1], r), __funnelshift_r(x[1], x[2], r),
      __funnelshift_r(x[2], x[3], r), __funnelshift_r(x[3], x[4], r));
}

// 0xFF in byte i of the result where bit i of the 4-bit `nib` is set
__device__ __forceinline__ uint32_t byte_mask(uint32_t nib) {
  return ((nib * 0x00204081u) & 0x01010101u) * 0xFFu;
}

__device__ __forceinline__ uint32_t select4(uint32_t a, uint32_t b,
                                            uint32_t nib) {
  return a ^ (byte_mask(nib) & (a ^ b));
}

template <bool kShift>
__global__ void __launch_bounds__(kThreads)
    meiose_planes_kernel(const uint8_t* __restrict__ hapA,
                         const uint8_t* __restrict__ hapB,
                         int64_t par_stride,
                         uint8_t* __restrict__ outA,
                         uint8_t* __restrict__ outB, int64_t out_stride,
                         const int32_t* __restrict__ fathers,
                         const int32_t* __restrict__ mothers,
                         const int32_t* __restrict__ xo_p,
                         const int32_t* __restrict__ st_p,
                         const int32_t* __restrict__ xo_m,
                         const int32_t* __restrict__ st_m, int m, int n_chr,
                         int K, int chr_len, int nchunks) {
  extern __shared__ int32_t smem[];
  const int slots = n_chr * K;           // crossover slots per gamete
  int32_t* xs = smem;                    // [2 * slots] real crossovers,
                                         // bucketed by (gamete, chromosome)
  int32_t* xcnt = xs + 2 * slots;        // [2][n_chr] bucket sizes
  int32_t* xend = xcnt + 2 * n_chr;      // [2][n_chr] bucket ends
  int32_t* st = xend + 2 * n_chr;        // [2][n_chr]
  const int64_t child = blockIdx.x / nchunks;
  const int chunk = blockIdx.x - (int)(child * nchunks);

  for (int r = threadIdx.x; r < 2 * n_chr; r += blockDim.x) {
    const int g = r / n_chr;
    xcnt[r] = 0;
    st[r] = (g ? st_m : st_p)[child * n_chr + (r - g * n_chr)];
  }
  __syncthreads();
  // counting sort of the real crossovers by the chromosome of their locus
  for (int i = threadIdx.x; i < 2 * slots; i += blockDim.x) {
    const int g = i / slots;
    const int x = (g ? xo_m : xo_p)[child * slots + (i - g * slots)];
    if (x >= 0 && x < m) atomicAdd(&xcnt[g * n_chr + x / chr_len], 1);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int acc = 0;  // xend holds each bucket's start until the placement
    for (int r = 0; r < 2 * n_chr; ++r) {
      xend[r] = acc;
      acc += xcnt[r];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * slots; i += blockDim.x) {
    const int g = i / slots;
    const int x = (g ? xo_m : xo_p)[child * slots + (i - g * slots)];
    if (x >= 0 && x < m) xs[atomicAdd(&xend[g * n_chr + x / chr_len], 1)] = x;
  }
  __syncthreads();

  const int k_lo = chunk * kPiecesPerBlock;
  for (int g = 0; g < 2; ++g) {
    const int64_t par = (g ? mothers : fathers)[child];
    const uint8_t* pa = hapA + par * par_stride;
    const uint8_t* pb = hapB + par * par_stride;
    uint8_t* po = (g ? outB : outA) + child * out_stride;
    // the child row's cut: head bytes up to its first 16-byte boundary,
    // then body pieces, then the tail
    const int hd = min((int)((16 - ((uintptr_t)po & 15)) & 15), m);
    const int nbody = (m - hd) >> 4;
    const uint4* va = vec_of(pa + hd);
    const uint4* vb = vec_of(pb + hd);
    const int sa = kShift ? shift_of(pa + hd) : 0;
    const int sb = kShift ? shift_of(pb + hd) : 0;
    uint4* vo = reinterpret_cast<uint4*>(po + hd);
    const int k_hi = min(nbody, k_lo + kPiecesPerBlock);
    for (int k = k_lo + threadIdx.x; k < k_hi; k += kThreads) {
      const uint32_t bits =
          phase_bits(hd + 16 * k, 16, g, n_chr, chr_len, xs, xend, xcnt, st);
      const uint4 a = load16<kShift>(va + k, sa);
      const uint4 b = load16<kShift>(vb + k, sb);
      uint4 o;
      o.x = select4(a.x, b.x, bits & 0xF);
      o.y = select4(a.y, b.y, (bits >> 4) & 0xF);
      o.z = select4(a.z, b.z, (bits >> 8) & 0xF);
      o.w = select4(a.w, b.w, (bits >> 12) & 0xF);
      vo[k] = o;
    }
    const int n_head = chunk == 0 ? hd : 0;
    const int n_tail = chunk == nchunks - 1 ? m - hd - 16 * nbody : 0;
    for (int e = threadIdx.x; e < n_head + n_tail; e += kThreads) {
      const int col = e < n_head ? e : m - n_tail + (e - n_head);
      const uint32_t bit =
          phase_bits(col, 1, g, n_chr, chr_len, xs, xend, xcnt, st);
      po[col] = bit ? pb[col] : pa[col];
    }
  }
}

}  // namespace

// hapA/hapB: locus 0 of parent row 0 of (N, m) uint8 planes whose rows lie
// par_stride bytes apart; outA/outB: locus 0 of child row 0, rows
// out_stride bytes apart (a window of wider planes, or whole ones);
// fathers/mothers (n,) int32; xo_p/xo_m (n, n_chr, K) int32 loci of the
// window (pad = m); st_p/st_m (n, n_chr) int32. The launch plan (shifted,
// nchunks blocks a child, smem) is the host's `launch_plan` for these
// shapes, strides and pointer offsets.
GE_API int ge_meiose_planes(const void* hapA, const void* hapB,
                            int64_t par_stride, void* outA, void* outB,
                            int64_t out_stride, const void* fathers,
                            const void* mothers, const void* xo_p,
                            const void* st_p, const void* xo_m,
                            const void* st_m, int64_t n, int m, int n_chr,
                            int K, int chr_len, int shifted, int nchunks,
                            int smem, void* stream) {
  if (n == 0 || m == 0) return (int)cudaGetLastError();
  const dim3 grid((unsigned)(n * nchunks));
  cudaStream_t s = (cudaStream_t)stream;
#define GE_LAUNCH(V)                                                        \
  meiose_planes_kernel<V><<<grid, kThreads, smem, s>>>(                     \
      (const uint8_t*)hapA, (const uint8_t*)hapB, par_stride,               \
      (uint8_t*)outA, (uint8_t*)outB, out_stride, (const int32_t*)fathers,  \
      (const int32_t*)mothers,                                              \
      (const int32_t*)xo_p, (const int32_t*)st_p, (const int32_t*)xo_m,     \
      (const int32_t*)st_m, m, n_chr, K, chr_len, nchunks)
  if (shifted) {
    GE_LAUNCH(true);
  } else {
    GE_LAUNCH(false);
  }
#undef GE_LAUNCH
  return (int)cudaGetLastError();
}
