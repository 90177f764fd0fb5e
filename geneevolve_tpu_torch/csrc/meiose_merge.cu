// The meiosis ledger merge of geneevolve_tpu core/segments.py `meiose` ->
// `merge3_T` (XLA there; no Pallas kernel), one warp per gamete, every
// chromosome and both parents in one launch.
//
// Inputs for gamete (ci, i, g): the parent's two chromatid ledgers, read by
// index as seg_st[ci, parents[g, i]] / seg_hap[...] (2 x S each, sorted valid
// prefix, BIG padded), the gamete's crossover row (xo_f for g = 0, xo_m for
// g = 1; K positions, BIG padded, NOT sorted: same-bin crossovers may be out
// of order) and its start chromatid sh[ci, i, g].
//
// Output row c_st[ci, i, g, :cap] / c_hap: the stable merge, by (value,
// candidate index) with candidate order X < A < B, of
//   X = [chr_start; xo]   (all valid entries; chr_start = A[0])
//   A = chromatid 0 slots s > 0 that the gamete copies
//   B = chromatid 1 slots s > 0 that the gamete copies
// into `cap` slots (BIG / 0 padded), plus the uncapped valid count. A
// crossover's hap is the newly active chromatid's hap[#{pos <= q} - 1]. With
// merge_ibd == 0 equal positions are then collapsed keeping the last entry
// (the reference's exact part splitting) and the count is the kept one.
//
// Design: the XLA form ranks every candidate against every other. Here each
// candidate's output slot is its rank, computed by one lane with binary
// searches in the three sorted lists (merge3_T's formulas):
//   rank_X = stable rank within X + #{A' < x} + #{B' < x}
//   rank_A = #{copied A before it} + #{X <= a} + #{B' < a}
//   rank_B = #{copied B before it} + #{X <= b} + #{A' <= b}
// The warp stages the parent's rows in shared memory with coalesced loads,
// sorts the crossovers by ranks (`ge_sort_crossovers`), marks each 32-slot
// word's copied slots with one ballot (`ge_copied_word`, the probe's code)
// and keeps each word's mask and the copied count before it, so #{A' < v}
// is a binary search plus a popc. Candidates land in a shared output row,
// which the warp stores with lanes on consecutive slots.
//
// Bound: the parent rows (2S x 6 bytes at int16 haps, each distinct row read
// once), the crossover rows and the cap-slot child rows, on HBM.
#include "common.cuh"

#define GE_WARPS_MAX 8        // gametes a block, at most
#define GE_SMEM_DEFAULT 49152  // shared memory a block gets without opt-in
#define GE_SMEM_MAX 232448     // the most a block may opt in to (227 KB)

// One gamete's shared memory: int32 A | B (2S), xs (K), copied masks (2W),
// copied counts before each word (2W), output positions (cap); then the
// haps A | B (2S) and the output haps (cap). Rounded to 16 bytes.
static int64_t gamete_bytes(int S, int K, int cap, int hap_bytes) {
  const int64_t W = (S + 31) / 32;
  const int64_t b = 4 * (2 * (int64_t)S + K + 4 * W + cap) +
                    (int64_t)hap_bytes * (2 * (int64_t)S + cap);
  return (b + 15) / 16 * 16;
}

template <typename HT>
__global__ void __launch_bounds__(GE_WARPS_MAX * 32) meiose_merge_kernel(
    const int32_t* __restrict__ seg_st, const HT* __restrict__ seg_hap,
    const int32_t* __restrict__ parents, const int32_t* __restrict__ xo_f,
    const int32_t* __restrict__ xo_m, const int32_t* __restrict__ sh,
    int32_t* __restrict__ out_st, HT* __restrict__ out_hap,
    int32_t* __restrict__ n_valid, int64_t rows, int64_t nc, int64_t total,
    int S, int K, int cap, int merge_ibd, int32_t big, int per_warp) {
  extern __shared__ __align__(16) unsigned char ge_smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t t = (int64_t)blockIdx.x * (blockDim.x >> 5) + warp;
  if (t >= total) return;  // whole warps only
  const int W = (S + 31) >> 5;
  int32_t* A = (int32_t*)(ge_smem + (int64_t)warp * per_warp);
  int32_t* B = A + S;
  int32_t* xs = A + 2 * S;
  uint32_t* mask = (uint32_t*)(xs + K);     // [chromatid][word]
  int32_t* before = (int32_t*)(mask + 2 * W);  // copied slots before a word
  int32_t* ost = before + 2 * W;
  HT* hA = (HT*)(ost + cap);
  HT* hB = hA + S;
  HT* oh = hA + 2 * S;

  const int64_t prow = ge_parent_row(parents, t, rows, nc, S);
  for (int s = lane; s < 2 * S; s += 32) {
    A[s] = seg_st[prow + s];
    hA[s] = seg_hap[prow + s];
  }
  const int nxo =
      ge_sort_crossovers((t & 1 ? xo_m : xo_f) + (t >> 1) * K, K, big, xs,
                         lane);
  const int st0 = sh[t];
  __syncwarp();
  int tot[2];
  for (int c = 0; c < 2; ++c) {
    int run = 0;
    for (int w = 0; w < W; ++w) {
      const uint32_t m =
          ge_copied_word(A + c * S, S, w, c, st0, xs, nxo, big, lane);
      if (lane == 0) {
        mask[c * W + w] = m;
        before[c * W + w] = run;
      }
      run += __popc(m);
    }
    tot[c] = run;
  }
  __syncwarp();
  // copied slots of chromatid c among its slots [0, L)
  auto copied_below = [&](int c, int L) {
    const int w = L >> 5;
    if (w >= W) return tot[c];
    return before[c * W + w] + __popc(mask[c * W + w] & ((1u << (L & 31)) - 1u));
  };

  // X: chr_start (candidate 0) then the sorted crossovers
  const int32_t v0 = A[0];
  for (int e = lane; e <= nxo; e += 32) {
    const int32_t v = e == 0 ? v0 : xs[e - 1];
    const int own = e == 0 ? ge_lower_bound(xs, nxo, v0) : e - 1 + (v0 <= v);
    const int r = own + copied_below(0, ge_lower_bound(A, S, v)) +
                  copied_below(1, ge_lower_bound(B, S, v));
    if (r < cap) {
      const int c = (st0 + ge_upper_bound(xs, nxo, v)) & 1;
      const int k = ge_upper_bound(c ? B : A, S, v);
      ost[r] = v;
      oh[r] = k > 0 ? (c ? hB : hA)[k - 1] : (HT)0;
    }
  }
  // A' and B': X entries <= v come first; B' counts A' entries <= v, A'
  // counts B' entries < v (candidate order A < B)
  for (int c = 0; c < 2; ++c) {
    const int32_t* P = c ? B : A;
    const HT* hP = c ? hB : hA;
    for (int w = 0; w < W; ++w) {
      const uint32_t m = mask[c * W + w];
      if (!((m >> lane) & 1u)) continue;
      const int s = (w << 5) + lane;
      const int32_t v = P[s];
      const int other = c ? ge_upper_bound(A, S, v) : ge_lower_bound(B, S, v);
      const int r = before[c * W + w] + __popc(m & ((1u << lane) - 1u)) +
                    (v0 <= v) + ge_upper_bound(xs, nxo, v) +
                    copied_below(1 - c, other);
      if (r < cap) {
        ost[r] = v;
        oh[r] = hP[s];
      }
    }
  }
  int n = 1 + nxo + tot[0] + tot[1];
  for (int r = n + lane; r < cap; r += 32) {
    ost[r] = big;
    oh[r] = (HT)0;
  }
  __syncwarp();
  if (!merge_ibd) {
    // keep the last entry of each run of equal positions, compacted in
    // place: a pass writes only below its own last slot + 1, which later
    // passes never read
    int wr = 0;
    for (int r0 = 0; r0 < cap; r0 += 32) {
      const int r = r0 + lane;
      const int32_t v = r < cap ? ost[r] : big;
      const HT h = r < cap ? oh[r] : (HT)0;
      const int32_t next = r + 1 < cap ? ost[r + 1] : big;
      const bool keep = v < big && next != v;
      const uint32_t m = __ballot_sync(GE_FULL, keep);
      __syncwarp();  // every lane's reads before any lane's writes
      if (keep) {
        const int d = wr + __popc(m & ((1u << lane) - 1u));
        ost[d] = v;
        oh[d] = h;
      }
      wr += __popc(m);
      __syncwarp();
    }
    for (int r = wr + lane; r < cap; r += 32) {
      ost[r] = big;
      oh[r] = (HT)0;
    }
    n = wr;
    __syncwarp();
  }
  int32_t* ds = out_st + t * cap;
  HT* dh = out_hap + t * cap;
  for (int r = lane; r < cap; r += 32) {
    ds[r] = ost[r];
    dh[r] = oh[r];
  }
  if (lane == 0) n_valid[t] = n;
}

template <typename HT>
static int launch(const void* seg_st, const void* seg_hap,
                  const void* parents, const void* xo_f, const void* xo_m,
                  const void* sh, void* out_st, void* out_hap, void* n_valid,
                  int64_t rows, int64_t nc, int64_t total, int S, int K,
                  int cap, int merge_ibd, int big, cudaStream_t stream) {
  const int64_t per_warp = gamete_bytes(S, K, cap, (int)sizeof(HT));
  if (per_warp > GE_SMEM_MAX) return (int)cudaErrorInvalidValue;
  int64_t warps = GE_SMEM_DEFAULT / per_warp;
  warps = warps < 1 ? 1 : (warps > GE_WARPS_MAX ? GE_WARPS_MAX : warps);
  const int64_t smem = warps * per_warp;
  if (smem > GE_SMEM_DEFAULT) {
    const cudaError_t e = cudaFuncSetAttribute(
        meiose_merge_kernel<HT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int64_t blocks = (total + warps - 1) / warps;
  if (blocks > 0) {
    meiose_merge_kernel<HT><<<(unsigned)blocks, (unsigned)(warps * 32),
                              (size_t)smem, stream>>>(
        (const int32_t*)seg_st, (const HT*)seg_hap, (const int32_t*)parents,
        (const int32_t*)xo_f, (const int32_t*)xo_m, (const int32_t*)sh,
        (int32_t*)out_st, (HT*)out_hap, (int32_t*)n_valid, rows, nc, total, S,
        K, cap, merge_ibd, (int32_t)big, (int)per_warp);
  }
  return (int)cudaGetLastError();
}

GE_API int ge_meiose_merge(const void* seg_st, const void* seg_hap,
                           int hap_bytes, const void* parents,
                           const void* xo_f, const void* xo_m, const void* sh,
                           void* out_st, void* out_hap, void* n_valid,
                           int64_t nchr, int64_t rows, int64_t nc, int S,
                           int K, int cap, int merge_ibd, int big,
                           void* stream) {
  if (K > GE_MAXK) return (int)cudaErrorInvalidValue;
  const int64_t total = nchr * nc * 2;
  cudaStream_t s = (cudaStream_t)stream;
  if (hap_bytes == 2)
    return launch<int16_t>(seg_st, seg_hap, parents, xo_f, xo_m, sh, out_st,
                           out_hap, n_valid, rows, nc, total, S, K, cap,
                           merge_ibd, big, s);
  return launch<int32_t>(seg_st, seg_hap, parents, xo_f, xo_m, sh, out_st,
                         out_hap, n_valid, rows, nc, total, S, K, cap,
                         merge_ibd, big, s);
}
