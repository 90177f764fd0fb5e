// One gamete per thread: the meiosis ledger merge of geneevolve_tpu
// core/segments.py `meiose` -> `merge3_T` (XLA there; no Pallas kernel).
//
// Inputs per gamete i: the parent's two chromatid ledgers, read by index as
// par_st[idx[i]] / par_hap[idx[i]] (2 x S each, sorted valid prefix, BIG
// padded), the gamete's crossover row xo[i] (K positions, BIG padded, NOT
// sorted: same-bin crossovers may be out of order), and its start chromatid.
//
// Output: the stable merge, by (value, candidate index) with candidate order
// X < A < B, of
//   X = [chr_start; xo]   (all valid entries; chr_start = A[0])
//   A = chromatid 0 slots s > 0 that the gamete copies
//   B = chromatid 1 slots s > 0 that the gamete copies
// into `cap` slots (BIG / 0 padded), plus the uncapped valid count. A
// crossover's hap is the newly active chromatid's hap[#{pos <= q} - 1]. With
// merge_ibd == 0 equal positions are then collapsed keeping the last entry
// (the reference's exact part splitting).
//
// The XLA form ranks every candidate against every other, O((K+2S)^2) per
// gamete. Here X is insertion-sorted in registers (K <= GE_MAXK, ~25 on the
// human map) and the three sorted lists are merged in one sequential
// O(K + 2S) walk; each copied slot's chromatid test and each crossover's
// hap lookup are O(K) and O(S) scans. Bound: the parent rows (2S x 6 bytes
// at int16 haps) and the cap-slot output row per gamete, plus the integer
// scans; rows are read by index, so the parent ledger crosses HBM once.
#include "common.cuh"

#define GE_MAXK 64

template <typename HT>
__global__ void meiose_merge_kernel(
    const int32_t* __restrict__ par_st, const HT* __restrict__ par_hap,
    const int32_t* __restrict__ idx, const int32_t* __restrict__ xo,
    const int32_t* __restrict__ start, int32_t* __restrict__ out_st,
    HT* __restrict__ out_hap, int32_t* __restrict__ n_valid, int64_t nc,
    int S, int K, int cap, int merge_ibd, int32_t big) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nc) return;
  const int64_t prow = (int64_t)idx[i] * 2 * S;
  const int32_t* A = par_st + prow;
  const int32_t* B = A + S;
  const HT* hA = par_hap + prow;
  const HT* hB = hA + S;
  const int32_t* x = xo + i * K;
  const int st0 = start[i];
  int32_t* os = out_st + i * (int64_t)cap;
  HT* oh = out_hap + i * (int64_t)cap;

  // X: chr_start then the valid crossovers, stable insertion sort by value
  int32_t xs[GE_MAXK + 1];
  int nx = 1;
  xs[0] = A[0];
  for (int k = 0; k < K; ++k) {
    const int32_t v = x[k];
    if (v >= big) continue;
    int j = nx;
    while (j > 0 && xs[j - 1] > v) {
      xs[j] = xs[j - 1];
      --j;
    }
    xs[j] = v;
    ++nx;
  }

  // active chromatid at position q: (start + #{xo <= q}) & 1
  auto active = [&](int32_t q) {
    int cnt = 0;
    for (int k = 0; k < K; ++k) cnt += x[k] <= q ? 1 : 0;
    return (st0 + cnt) & 1;
  };
  // next slot at or after s of chromatid c that the gamete copies, or S
  auto next_copied = [&](const int32_t* P, int s, int c) {
    for (; s < S; ++s) {
      if (P[s] >= big) return S;
      if (active(P[s]) == c) return s;
    }
    return S;
  };

  int tx = 0;
  int ia = next_copied(A, 1, 0);
  int ib = next_copied(B, 1, 1);
  int w = 0;
  while (true) {
    int32_t v;
    HT h;
    if (tx < nx && (ia >= S || xs[tx] <= A[ia]) &&
        (ib >= S || xs[tx] <= B[ib])) {
      v = xs[tx++];
      const int c = active(v);
      const int32_t* P = c == 0 ? A : B;
      const HT* hP = c == 0 ? hA : hB;
      int cnt = 0;
      for (int s = 0; s < S; ++s) cnt += P[s] <= v ? 1 : 0;
      h = cnt > 0 ? hP[cnt - 1] : (HT)0;
    } else if (ia < S && (ib >= S || A[ia] <= B[ib])) {
      v = A[ia];
      h = hA[ia];
      ia = next_copied(A, ia + 1, 0);
    } else if (ib < S) {
      v = B[ib];
      h = hB[ib];
      ib = next_copied(B, ib + 1, 1);
    } else {
      break;
    }
    if (w < cap) {
      os[w] = v;
      oh[w] = h;
    }
    ++w;
  }
  for (int s = w; s < cap; ++s) {
    os[s] = big;
    oh[s] = (HT)0;
  }
  if (!merge_ibd) {
    // keep the last entry of each run of equal positions, in place
    // (the write index never passes the read index)
    int wr = 0;
    for (int r = 0; r < cap; ++r) {
      const int32_t v = os[r];
      const bool last = r == cap - 1 || os[r + 1] != v || os[r + 1] >= big;
      if (last && v < big) {
        os[wr] = v;
        oh[wr] = oh[r];
        ++wr;
      }
    }
    for (int s = wr; s < cap; ++s) {
      os[s] = big;
      oh[s] = (HT)0;
    }
    w = wr;
  }
  n_valid[i] = w;
}

GE_API int ge_meiose_merge(const void* par_st, const void* par_hap,
                           int hap_bytes, const void* idx, const void* xo,
                           const void* start, void* out_st, void* out_hap,
                           void* n_valid, int64_t nc, int S, int K, int cap,
                           int merge_ibd, int big, void* stream) {
  const int threads = 128;
  const int64_t blocks = (nc + threads - 1) / threads;
  if (K > GE_MAXK) return (int)cudaErrorInvalidValue;
  if (blocks > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (hap_bytes == 2) {
      meiose_merge_kernel<int16_t><<<(unsigned)blocks, threads, 0, s>>>(
          (const int32_t*)par_st, (const int16_t*)par_hap,
          (const int32_t*)idx, (const int32_t*)xo, (const int32_t*)start,
          (int32_t*)out_st, (int16_t*)out_hap, (int32_t*)n_valid, nc, S, K,
          cap, merge_ibd, (int32_t)big);
    } else {
      meiose_merge_kernel<int32_t><<<(unsigned)blocks, threads, 0, s>>>(
          (const int32_t*)par_st, (const int32_t*)par_hap,
          (const int32_t*)idx, (const int32_t*)xo, (const int32_t*)start,
          (int32_t*)out_st, (int32_t*)out_hap, (int32_t*)n_valid, nc, S, K,
          cap, merge_ibd, (int32_t)big);
    }
  }
  return (int)cudaGetLastError();
}
