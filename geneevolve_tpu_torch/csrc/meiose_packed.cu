// Packed meiosis: one child's two gametes, 32 loci per 32-bit word.
//
// Replaces geneevolve_tpu/ops/meiosis_packed_pallas.py `meiose_packed_pallas`
// and its layout experiments tools/kexp.py `meiose_v2` (split planes, no
// mutations) and `meiose_v3` (combined planes, no mutations). Per child c,
// gamete g (0 = from the father, 1 = from the mother) and word w:
//
//   child[c, g, w] = A ^ (mask & (A ^ B)) ^ mutation bits,
//   mask = (start[chr] & 1 ? ~0 : 0) XOR over the chromosome's crossovers x
//          of (~0 if w > x>>5; ~0 << (x & 31) if w == x>>5; else 0),
//
// with A, B the parent's two planes and x local to the chromosome. The
// planes are addressed by a base pointer per chromatid and a row stride, so
// the combined (N, 2, mw) layout (stride 2*mw, B at +mw) and the split
// (N, mw) x 2 layout of `meiose_v2` are the same kernel.
//
// Bound: memory. A generation moves 6 x n x mw x 4 bytes (two parent
// planes read per gamete, one child plane written per gamete); the mask
// costs a few integer ops per real crossover per word. Design: one block
// per (child, chunk of 4,096 words); the block stages that child's real
// crossover loci (slots < m, in any order, compacted), their counts, the
// start chromatids and the real mutation loci in shared memory, then each
// thread moves 16 bytes (four words) per load and store, consecutive
// threads on consecutive words, so every access coalesces. Slots are not
// assumed sorted, nor a prefix: every slot < m is XORed in, exactly as the
// plain version XORs every slot (a pad slot = m contributes zero there).
// Mutations flip per occurrence: a locus drawn twice cancels.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWordsPerBlock = 4096;

struct Staged {
  const int32_t* xs;    // [2][n_chr][K] real crossovers, local loci
  const int32_t* xcnt;  // [2][n_chr]
  const int32_t* st;    // [2][n_chr] start chromatids
  const int32_t* mus;   // [2][km] real mutation loci, global
  const int32_t* mcnt;  // [2]
};

__device__ __forceinline__ uint32_t child_word(uint32_t a, uint32_t b, int w,
                                               int g, int n_chr, int K,
                                               int km, int cw,
                                               const Staged& s) {
  const int c = w / cw;
  const int wl = w - c * cw;
  const int r = g * n_chr + c;
  uint32_t mask = (s.st[r] & 1) ? 0xFFFFFFFFu : 0u;
  const int32_t* x = s.xs + r * K;
  const int nx = s.xcnt[r];
  for (int k = 0; k < nx; ++k) {
    const int xl = x[k];
    const int xw = xl >> 5;  // arithmetic, as the plain version's int32 >>
    if (wl > xw) {
      mask = ~mask;
    } else if (wl == xw) {
      mask ^= 0xFFFFFFFFu << (xl & 31);
    }
  }
  uint32_t out = a ^ (mask & (a ^ b));
  const int32_t* mu = s.mus + g * km;
  const int nm = s.mcnt[g];
  for (int k = 0; k < nm; ++k) {
    const int p = mu[k];
    if ((p >> 5) == w) out ^= 1u << (p & 31);
  }
  return out;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    meiose_packed_kernel(const uint32_t* __restrict__ a_plane,
                         const uint32_t* __restrict__ b_plane,
                         int64_t par_stride, uint32_t* __restrict__ out0,
                         uint32_t* __restrict__ out1, int64_t out_stride,
                         const int32_t* __restrict__ fathers,
                         const int32_t* __restrict__ mothers,
                         const int32_t* __restrict__ xo_p,
                         const int32_t* __restrict__ st_p,
                         const int32_t* __restrict__ xo_m,
                         const int32_t* __restrict__ st_m,
                         const int32_t* __restrict__ mu, int km, int n_chr,
                         int K, int cw, int mw, int nchunks) {
  extern __shared__ int32_t smem[];
  int32_t* xs = smem;
  int32_t* xcnt = xs + 2 * n_chr * K;
  int32_t* st = xcnt + 2 * n_chr;
  int32_t* mus = st + 2 * n_chr;
  int32_t* mcnt = mus + 2 * km;
  const int64_t child = blockIdx.x / nchunks;
  const int chunk = blockIdx.x - (int)(child * nchunks);
  const int m = mw * 32;
  const int chr_len = cw * 32;

  // one thread per (gamete, chromosome) row and per gamete's mutations
  for (int r = threadIdx.x; r < 2 * n_chr + 2; r += blockDim.x) {
    if (r < 2 * n_chr) {
      const int g = r / n_chr, c = r - (r / n_chr) * n_chr;
      const int64_t row = child * n_chr + c;
      const int32_t* src = (g ? xo_m : xo_p) + row * K;
      int cnt = 0;
      for (int k = 0; k < K; ++k) {
        const int x = src[k];
        if (x < m) xs[r * K + cnt++] = x - c * chr_len;
      }
      xcnt[r] = cnt;
      st[r] = (g ? st_m : st_p)[row];
    } else {
      const int g = r - 2 * n_chr;
      int cnt = 0;
      if (mu != nullptr) {
        const int32_t* src = mu + (child * 2 + g) * km;
        for (int k = 0; k < km; ++k) {
          const int p = src[k];
          if (p >= 0 && p < m) mus[g * km + cnt++] = p;
        }
      }
      mcnt[g] = cnt;
    }
  }
  __syncthreads();
  const Staged s{xs, xcnt, st, mus, mcnt};

  const int w_lo = chunk * kWordsPerBlock;
  const int w_hi = min(mw, w_lo + kWordsPerBlock);
  for (int g = 0; g < 2; ++g) {
    const int64_t par = (g ? mothers : fathers)[child];
    const uint32_t* pa = a_plane + par * par_stride;
    const uint32_t* pb = b_plane + par * par_stride;
    uint32_t* po = (g ? out1 : out0) + child * out_stride;
    if (kVec) {
      for (int w = w_lo + 4 * threadIdx.x; w < w_hi; w += 4 * kThreads) {
        const uint4 a = *reinterpret_cast<const uint4*>(pa + w);
        const uint4 b = *reinterpret_cast<const uint4*>(pb + w);
        uint4 o;
        o.x = child_word(a.x, b.x, w, g, n_chr, K, km, cw, s);
        o.y = child_word(a.y, b.y, w + 1, g, n_chr, K, km, cw, s);
        o.z = child_word(a.z, b.z, w + 2, g, n_chr, K, km, cw, s);
        o.w = child_word(a.w, b.w, w + 3, g, n_chr, K, km, cw, s);
        *reinterpret_cast<uint4*>(po + w) = o;
      }
    } else {
      for (int w = w_lo + threadIdx.x; w < w_hi; w += kThreads) {
        po[w] = child_word(pa[w], pb[w], w, g, n_chr, K, km, cw, s);
      }
    }
  }
}

}  // namespace

// a_plane/b_plane: chromatid A/B of parent row 0, rows `par_stride` words
// apart; out0/out1: gamete 0/1 of child 0, rows `out_stride` words apart;
// fathers/mothers (n,) int32; xo_p/xo_m (n, n_chr, K) int32 global loci
// (pad = m); st_p/st_m (n, n_chr) int32; mu (n, 2, km) int32 or null.
GE_API int ge_meiose_packed(const void* a_plane, const void* b_plane,
                            int64_t par_stride, void* out0, void* out1,
                            int64_t out_stride, const void* fathers,
                            const void* mothers, const void* xo_p,
                            const void* st_p, const void* xo_m,
                            const void* st_m, const void* mu, int km,
                            int64_t n, int n_chr, int K, int cw, int mw,
                            void* stream) {
  if (n == 0 || mw == 0) return (int)cudaGetLastError();
  const int nchunks = (mw + kWordsPerBlock - 1) / kWordsPerBlock;
  const size_t smem =
      sizeof(int32_t) * (2 * (size_t)n_chr * K + 4 * n_chr + 2 * km + 2);
  const uintptr_t align = (uintptr_t)a_plane | (uintptr_t)b_plane |
                          (uintptr_t)out0 | (uintptr_t)out1;
  const bool vec = align % 16 == 0 && mw % 4 == 0 && par_stride % 4 == 0 &&
                   out_stride % 4 == 0;
  const dim3 grid((unsigned)(n * nchunks));
  cudaStream_t s = (cudaStream_t)stream;
#define GE_LAUNCH(V)                                                         \
  meiose_packed_kernel<V><<<grid, kThreads, smem, s>>>(                      \
      (const uint32_t*)a_plane, (const uint32_t*)b_plane, par_stride,        \
      (uint32_t*)out0, (uint32_t*)out1, out_stride, (const int32_t*)fathers, \
      (const int32_t*)mothers, (const int32_t*)xo_p, (const int32_t*)st_p,   \
      (const int32_t*)xo_m, (const int32_t*)st_m, (const int32_t*)mu, km,    \
      n_chr, K, cw, mw, nchunks)
  if (vec) {
    GE_LAUNCH(true);
  } else {
    GE_LAUNCH(false);
  }
#undef GE_LAUNCH
  return (int)cudaGetLastError();
}
