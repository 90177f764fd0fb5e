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
// one written). Design: one block per (child, chunk of 16,384 loci); the
// block stages the child's real crossovers, bucketed by the chromosome of
// their locus (a shared-memory counting sort), and starts in shared memory;
// each thread takes 16 loci as one 16-byte load per plane and one store
// (when m % 16 == 0 and the rows are 16-byte aligned; otherwise byte by
// byte). The 16 phases come from one 16-bit mask built like the packed
// kernel's word mask (~0 past a crossover, a shifted mask at it), and are
// spread to bytes with a multiply. No m % 8192 restriction: the TPU block
// size is not carried over.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLociPerBlock = 16384;

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

// 0xFF in byte i of the result where bit i of the 4-bit `nib` is set
__device__ __forceinline__ uint32_t byte_mask(uint32_t nib) {
  return ((nib * 0x00204081u) & 0x01010101u) * 0xFFu;
}

__device__ __forceinline__ uint32_t select4(uint32_t a, uint32_t b,
                                            uint32_t nib) {
  return a ^ (byte_mask(nib) & (a ^ b));
}

template <bool kVec>
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

  const int l_lo = chunk * kLociPerBlock;
  const int l_hi = min(m, l_lo + kLociPerBlock);
  for (int g = 0; g < 2; ++g) {
    const int64_t par = (g ? mothers : fathers)[child];
    const uint8_t* pa = hapA + par * par_stride;
    const uint8_t* pb = hapB + par * par_stride;
    uint8_t* po = (g ? outB : outA) + child * out_stride;
    for (int col0 = l_lo + 16 * threadIdx.x; col0 < l_hi;
         col0 += 16 * kThreads) {
      const int nb = min(16, l_hi - col0);
      const uint32_t bits =
          phase_bits(col0, nb, g, n_chr, chr_len, xs, xend, xcnt, st);
      if (kVec) {
        const uint4 a = *reinterpret_cast<const uint4*>(pa + col0);
        const uint4 b = *reinterpret_cast<const uint4*>(pb + col0);
        uint4 o;
        o.x = select4(a.x, b.x, bits & 0xF);
        o.y = select4(a.y, b.y, (bits >> 4) & 0xF);
        o.z = select4(a.z, b.z, (bits >> 8) & 0xF);
        o.w = select4(a.w, b.w, (bits >> 12) & 0xF);
        *reinterpret_cast<uint4*>(po + col0) = o;
      } else {
        for (int j = 0; j < nb; ++j) {
          const uint8_t a = pa[col0 + j], b = pb[col0 + j];
          po[col0 + j] = ((bits >> j) & 1u) ? b : a;
        }
      }
    }
  }
}

}  // namespace

// hapA/hapB: locus 0 of parent row 0 of (N, m) uint8 planes whose rows lie
// par_stride bytes apart; outA/outB: locus 0 of child row 0, rows
// out_stride bytes apart (a window of wider planes, or whole ones);
// fathers/mothers (n,) int32; xo_p/xo_m (n, n_chr, K) int32 loci of the
// window (pad = m); st_p/st_m (n, n_chr) int32.
GE_API int ge_meiose_planes(const void* hapA, const void* hapB,
                            int64_t par_stride, void* outA, void* outB,
                            int64_t out_stride, const void* fathers,
                            const void* mothers, const void* xo_p,
                            const void* st_p, const void* xo_m,
                            const void* st_m, int64_t n, int m, int n_chr,
                            int K, int chr_len, void* stream) {
  if (n == 0 || m == 0) return (int)cudaGetLastError();
  const int nchunks = (m + kLociPerBlock - 1) / kLociPerBlock;
  const size_t smem = sizeof(int32_t) * (2 * (size_t)n_chr * K + 6 * n_chr);
  const uintptr_t align =
      (uintptr_t)hapA | (uintptr_t)hapB | (uintptr_t)outA | (uintptr_t)outB;
  const bool vec = align % 16 == 0 && m % 16 == 0 && par_stride % 16 == 0 &&
                   out_stride % 16 == 0;
  const dim3 grid((unsigned)(n * nchunks));
  cudaStream_t s = (cudaStream_t)stream;
#define GE_LAUNCH(V)                                                        \
  meiose_planes_kernel<V><<<grid, kThreads, smem, s>>>(                     \
      (const uint8_t*)hapA, (const uint8_t*)hapB, par_stride,               \
      (uint8_t*)outA, (uint8_t*)outB, out_stride, (const int32_t*)fathers,  \
      (const int32_t*)mothers,                                              \
      (const int32_t*)xo_p, (const int32_t*)st_p, (const int32_t*)xo_m,     \
      (const int32_t*)st_m, m, n_chr, K, chr_len, nchunks)
  if (vec) {
    GE_LAUNCH(true);
  } else {
    GE_LAUNCH(false);
  }
#undef GE_LAUNCH
  return (int)cudaGetLastError();
}
