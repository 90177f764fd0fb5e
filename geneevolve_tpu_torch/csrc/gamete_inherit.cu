// A gamete's mutation inheritance and CV alleles, after the ledger merge: one
// warp per gamete, a group of chromosomes of one parent's gametes in one
// launch. It ports no TPU kernel: it replaces the plain-torch chains of the
// segment engine's real pass, the JAX package's `segments.inherit_mutations`
// and `_make_per_chr`'s `gamete_cv` (both XLA there), which sort rows of a
// few dozen positions from scratch several times a gamete.
//
// Inputs for gamete t = ci * nc + i (chromosome ci of the launch, child i):
//   pm[t]    the parent's two mutation rows (2 x Mp, each ascending, BIG
//            padded), or none (no mutation map);
//   cv[t]    the parent's two CV allele rows (2 x C bytes), or none (the
//            gather path);
//   xo[t]    the crossovers (K, BIG padded, in any order);
//   start    the start chromatid, start[ci * st0 + i * st1];
//   nw[t]    the de novo slots (mn, in any order, BIG where the slot went
//            to the other chromatid);
//   q[ci]    the chromosome's CV positions (C, in any order).
// A position v lies on chromatid (start + #{xo <= v}) & 1.
//
// Outputs, through their strides (out_mut[ci * om0 + i * om1 + r], out_cv
// alike), so the group's child planes are written in place:
//   out_mut  the sorted distinct union of the parent mutations on the
//            chromatid that covers them and the de novo ones, cut to Mo
//            slots, BIG after; counts[t] its uncapped length;
//   out_cv   the covering chromatid's allele at each CV, flipped where a de
//            novo mutation lies on it, unless the covering chromatid
//            already carries a mutation there (membership, not parity).
// Equal to the plain version (`segments.inherit_mutations` and
// `segments.gamete_cv`) bit for bit.
//
// Design: only what arrives unsorted is sorted: the crossovers and the de
// novo slots, each in shared memory at its stable rank
// (`gi_sort_valid`). The parent rows are sorted already. A kept parent
// mutation is one whose chromatid covers it (a binary search of the
// crossovers), a fresh de novo one is one that no kept parent mutation
// equals; the three kept lists are disjoint and each is sorted, so each
// entry's output slot is its rank: the kept entries before it in its own
// list (a prefix count by ballots) plus those below it in the two others
// (binary searches). Each slot is written once, by one lane; a CV's
// chromatid, carried flag and flip are binary searches of the same lists.
// No global scratch.
//
// Bound: each input byte read once (the parent rows, crossovers, starts,
// de novo slots, a chromosome's CV positions) and each output byte written
// once, on HBM: ~884 bytes a gamete at the 300,000 group shapes (K 23, Mp 37,
// mn 11, C 100).
#include "common.cuh"

#define GI_WARPS_MAX 8        // gametes a block, at most
#define GI_SMEM_DEFAULT 49152  // shared memory a block gets without opt-in
#define GI_SMEM_MAX 232448     // the most a block may opt in to (227 KB)

// One gamete's shared memory, int32 words: sorted crossovers (K) | sorted
// de novo (mn) | parent rows P0 | P1 (2 Mp) | kept counts before each slot
// of P0 and P1 (2 (Mp + 1)) | fresh counts before each de novo entry (mn +
// 1). Rounded to 16 bytes. Without mutation rows mn and Mp count as 0.
static int64_t gamete_bytes(int K, int mn, int Mp) {
  const int64_t w = (int64_t)K + 2 * (int64_t)mn + 1 + 4 * (int64_t)Mp + 2;
  return (4 * w + 15) / 16 * 16;
}

// The valid entries of row x (K <= GE_MAXK slots, BIG padded, in any order)
// sorted into xs by (value, slot), as `ge_sort_crossovers` sorts them, but
// counting each rank over the valid slots alone (a ballot's set bits): a
// gamete's rows are mostly padding (~1 crossover in 23 slots, ~1 de novo
// mutation in 11). Returns the valid count; xs is visible to the warp.
__device__ __forceinline__ int gi_sort_valid(const int32_t* x, int K,
                                             int32_t big, int32_t* xs,
                                             int lane) {
  const int32_t v0 = lane < K ? x[lane] : big;
  const int32_t v1 = lane + 32 < K ? x[lane + 32] : big;
  const uint32_t m0 = __ballot_sync(GE_FULL, v0 < big);
  const uint32_t m1 = __ballot_sync(GE_FULL, v1 < big);
  int r0 = 0, r1 = 0;
  for (uint32_t m = m0; m; m &= m - 1) {  // slot j, before slot 32 + lane
    const int j = __ffs(m) - 1;
    const int32_t a = __shfl_sync(GE_FULL, v0, j);
    r0 += a < v0 || (a == v0 && j < lane);
    r1 += a <= v1;
  }
  for (uint32_t m = m1; m; m &= m - 1) {  // slot 32 + j, after slot lane
    const int j = __ffs(m) - 1;
    const int32_t b = __shfl_sync(GE_FULL, v1, j);
    r0 += b < v0;
    r1 += b < v1 || (b == v1 && j < lane);
  }
  if (v0 < big) xs[r0] = v0;
  if (v1 < big) xs[r1] = v1;
  __syncwarp();
  return __popc(m0) + __popc(m1);
}

// is v one of the sorted a[0..n)?
__device__ __forceinline__ bool gi_member(const int32_t* a, int n,
                                          int32_t v) {
  const int j = ge_lower_bound(a, n, v);
  return j < n && a[j] == v;
}

__global__ void __launch_bounds__(GI_WARPS_MAX * 32) gamete_inherit_kernel(
    const int32_t* __restrict__ pm, const uint8_t* __restrict__ cv,
    const int32_t* __restrict__ xo, const int32_t* __restrict__ start,
    const int32_t* __restrict__ nw, const int32_t* __restrict__ q,
    int32_t* __restrict__ out_mut, uint8_t* __restrict__ out_cv,
    int32_t* __restrict__ counts, int64_t nc, int64_t total, int64_t st0,
    int64_t st1, int64_t om0, int64_t om1, int64_t oc0, int64_t oc1, int K,
    int mn, int Mp, int Mo, int C, int32_t big, int per_warp) {
  extern __shared__ __align__(16) unsigned char ge_smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t t = (int64_t)blockIdx.x * (blockDim.x >> 5) + warp;
  if (t >= total) return;  // whole warps only
  const int64_t ci = t / nc;
  const int64_t i = t - ci * nc;
  const bool has_mut = pm != nullptr;
  int32_t* xs = (int32_t*)(ge_smem + (int64_t)warp * per_warp);
  int32_t* ns = xs + K;
  int32_t* P = ns + (has_mut ? mn : 0);
  int32_t* cnt = P + 2 * Mp;  // [chromatid][slot], Mp + 1 each
  int32_t* cntF = cnt + 2 * (Mp + 1);

  const int s0 = start[ci * st0 + i * st1];
  const int nxo = gi_sort_valid(xo + t * K, K, big, xs, lane);
  // the chromatid covering v; every slot counts once v reaches BIG
  auto phase = [&](int32_t v) {
    return (s0 + (v < big ? ge_upper_bound(xs, nxo, v) : K)) & 1;
  };

  int np[2] = {0, 0};  // each parent row's entries before its BIG padding
  int nn = 0;          // valid de novo slots
  if (has_mut) {
    const int32_t* pr = pm + t * 2 * Mp;
    for (int s = lane; s < 2 * Mp; s += 32) P[s] = pr[s];
    nn = gi_sort_valid(nw + t * mn, mn, big, ns, lane);  // syncs P too
    const uint32_t below = (1u << lane) - 1;
    int kept[2];
    for (int h = 0; h < 2; ++h) {
      const int32_t* Ph = P + h * Mp;
      int32_t* ch = cnt + h * (Mp + 1);
      np[h] = ge_lower_bound(Ph, Mp, big);
      int carry = 0;
      for (int b = 0; b < np[h]; b += 32) {
        const int s = b + lane;
        bool keep = false;
        if (s < np[h]) {
          const int32_t v = Ph[s];
          keep = (s == 0 || Ph[s - 1] != v) && phase(v) == h;
        }
        const uint32_t m = __ballot_sync(GE_FULL, keep);
        if (s < np[h]) ch[s] = carry + __popc(m & below);
        carry += __popc(m);
      }
      if (lane == 0) ch[np[h]] = carry;
      kept[h] = carry;
    }
    // a de novo entry is fresh unless an equal one precedes it or a kept
    // parent mutation equals it (one on the chromatid that covers it)
    int fresh_n = 0;
    for (int b = 0; b < nn; b += 32) {
      const int k = b + lane;
      bool fresh = false;
      if (k < nn) {
        const int32_t v = ns[k];
        if (k == 0 || ns[k - 1] != v) {
          const int h = phase(v);
          fresh = !gi_member(P + h * Mp, np[h], v);
        }
      }
      const uint32_t m = __ballot_sync(GE_FULL, fresh);
      if (k < nn) cntF[k] = fresh_n + __popc(m & below);
      fresh_n += __popc(m);
    }
    if (lane == 0) cntF[nn] = fresh_n;
    __syncwarp();

    int32_t* orow = out_mut + ci * om0 + i * om1;
    for (int h = 0; h < 2; ++h) {
      const int32_t* Ph = P + h * Mp;
      const int32_t* ch = cnt + h * (Mp + 1);
      const int32_t* Po = P + (1 - h) * Mp;
      const int32_t* co = cnt + (1 - h) * (Mp + 1);
      for (int s = lane; s < np[h]; s += 32) {
        if (ch[s + 1] == ch[s]) continue;  // not kept
        const int32_t v = Ph[s];
        const int r = ch[s] + co[ge_lower_bound(Po, np[1 - h], v)] +
                      cntF[ge_lower_bound(ns, nn, v)];
        if (r < Mo) orow[r] = v;
      }
    }
    for (int k = lane; k < nn; k += 32) {
      if (cntF[k + 1] == cntF[k]) continue;  // not fresh
      const int32_t v = ns[k];
      const int r = cntF[k] + cnt[ge_lower_bound(P, np[0], v)] +
                    cnt[Mp + 1 + ge_lower_bound(P + Mp, np[1], v)];
      if (r < Mo) orow[r] = v;
    }
    const int n = kept[0] + kept[1] + fresh_n;
    for (int r = n + lane; r < Mo; r += 32) orow[r] = big;
    if (lane == 0) counts[t] = n;
  }

  if (cv != nullptr) {
    const uint8_t* cr = cv + t * 2 * C;
    const int32_t* qr = q + ci * C;
    uint8_t* orow = out_cv + ci * oc0 + i * oc1;
    for (int c = lane; c < C; c += 32) {
      const int32_t v = qr[c];
      const int h = phase(v);
      uint8_t a = cr[h * C + c];
      if (has_mut) {
        // BIG itself is one of a row's slots where the row has padding
        const bool in_new = v < big ? gi_member(ns, nn, v)
                                    : v == big && nn < mn;
        if (in_new) {
          const bool carried = v < big ? gi_member(P + h * Mp, np[h], v)
                                       : v == big && np[h] < Mp;
          if (!carried) a = (uint8_t)(1 - a);
        }
      }
      orow[c] = a;
    }
  }
}

GE_API int ge_gamete_inherit(const void* pm, const void* cv, const void* xo,
                             const void* start, const void* nw, const void* q,
                             void* out_mut, void* out_cv, void* counts,
                             int64_t nchr, int64_t nc, int64_t st0,
                             int64_t st1, int64_t om0, int64_t om1,
                             int64_t oc0, int64_t oc1, int K, int mn, int Mp,
                             int Mo, int C, int big, void* stream) {
  if (K > GE_MAXK || (pm != nullptr && mn > GE_MAXK))
    return (int)cudaErrorInvalidValue;
  const int64_t per_warp =
      gamete_bytes(K, pm != nullptr ? mn : 0, pm != nullptr ? Mp : 0);
  if (per_warp > GI_SMEM_MAX) return (int)cudaErrorInvalidValue;
  int64_t warps = GI_SMEM_DEFAULT / per_warp;
  warps = warps < 1 ? 1 : (warps > GI_WARPS_MAX ? GI_WARPS_MAX : warps);
  const int64_t smem = warps * per_warp;
  if (smem > GI_SMEM_DEFAULT) {
    const cudaError_t e = cudaFuncSetAttribute(
        gamete_inherit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int64_t total = nchr * nc;
  const int64_t blocks = (total + warps - 1) / warps;
  if (blocks > 0) {
    gamete_inherit_kernel<<<(unsigned)blocks, (unsigned)(warps * 32),
                            (size_t)smem, (cudaStream_t)stream>>>(
        (const int32_t*)pm, (const uint8_t*)cv, (const int32_t*)xo,
        (const int32_t*)start, (const int32_t*)nw, (const int32_t*)q,
        (int32_t*)out_mut, (uint8_t*)out_cv, (int32_t*)counts, nc, total, st0,
        st1, om0, om1, oc0, oc1, K, pm != nullptr ? mn : 0,
        pm != nullptr ? Mp : 0, Mo, C, (int32_t)big, (int)per_warp);
  }
  return (int)cudaGetLastError();
}
