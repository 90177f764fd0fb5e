// Row gather over raw bytes for B stacked tables in one launch:
//   out[b, i, :] = table[b, idx[i], :]
//
// Replaces geneevolve_tpu/ops/materialize.py `gather_rows` /
// `materialize_rows` (Pallas identity `_identity`), which existed to make
// XLA materialize a gather once instead of re-running it inside every
// consumer. Here the gather itself is the kernel.
//
// Bound: pure data movement, the distinct rows read once plus the rows
// written, through HBM: ~12 MB a (chromosome, parent) at the segment
// slice's 200-byte CV rows, which the card moves in ~4 us, less than a
// launch and its host wrapper. The first design ran one launch per
// chromosome and parent (88 a generation, each mostly launch) with one
// thread per unit and a 64-bit divide per unit. Here one launch gathers
// every chromosome's rows (grid y = the table b; the real pass's 4 gathers
// a generation). The unit is the widest of 16, 8, 4, 2 or 1 bytes that
// divides the row length, both base addresses and the table stride. A
// block takes a tile of whole rows, at least GE_TILE units (one row when a
// row is wider), and its threads walk the tile's (row, unit) pairs in
// order, finding the row with one 32-bit divide: consecutive threads copy
// consecutive units, so loads and stores coalesce across row ends, and a
// thread moves GE_UNITS units at a time whatever the row width, their
// loads all issued before any store (one memory round trip, not four).
// Warps of four rows served the slice's 25-unit rows as well but the dense
// slice's 275-unit rows worse (PERF.md, Findings).
#include "common.cuh"

#define GE_THREADS 256
#define GE_UNITS 4  // units a thread moves at once
#define GE_TILE (GE_THREADS * GE_UNITS)

template <typename T>
__global__ void __launch_bounds__(GE_THREADS)
    gather_rows_kernel(const char* __restrict__ table,
                       const int32_t* __restrict__ idx, char* __restrict__ out,
                       int64_t nc, int64_t row_bytes, int64_t t_batch,
                       int tile_rows) {
  const int64_t r0 = (int64_t)blockIdx.x * tile_rows;
  const unsigned rows =
      (unsigned)(nc - r0 < tile_rows ? nc - r0 : (int64_t)tile_rows);
  const unsigned w = (unsigned)(row_bytes / (int64_t)sizeof(T));
  const char* tb = table + (int64_t)blockIdx.y * t_batch;
  char* ob = out + (int64_t)blockIdx.y * nc * row_bytes;
  const unsigned total = rows * w;
  // GE_UNITS units a thread: all loads issued before any store
  for (unsigned s0 = threadIdx.x; s0 < total;
       s0 += GE_UNITS * GE_THREADS) {
    T v[GE_UNITS];
    T* dst[GE_UNITS];
#pragma unroll
    for (int j = 0; j < GE_UNITS; ++j) {
      const unsigned s = s0 + j * GE_THREADS;
      if (s < total) {
        const unsigned k = s / w;
        const unsigned u = s - k * w;
        const int64_t r = r0 + k;
        v[j] = ((const T*)(tb + (int64_t)idx[r] * row_bytes))[u];
        dst[j] = (T*)(ob + r * row_bytes) + u;
      }
    }
#pragma unroll
    for (int j = 0; j < GE_UNITS; ++j)
      if (s0 + j * GE_THREADS < total) *dst[j] = v[j];
  }
}

template <typename T>
static int launch(const void* table, const void* idx, void* out, int64_t B,
                  int64_t nc, int64_t row_bytes, int64_t t_batch,
                  cudaStream_t stream) {
  const int64_t w = row_bytes / (int64_t)sizeof(T);
  const int tile_rows = (int)(w >= GE_TILE ? 1 : (GE_TILE + w - 1) / w);
  const dim3 grid((unsigned)((nc + tile_rows - 1) / tile_rows), (unsigned)B);
  gather_rows_kernel<T><<<grid, GE_THREADS, 0, stream>>>(
      (const char*)table, (const int32_t*)idx, (char*)out, nc, row_bytes,
      t_batch, tile_rows);
  return (int)cudaGetLastError();
}

// table: B tables of n rows, `t_batch` bytes apart; out: B x nc rows,
// contiguous; every row `row_bytes` contiguous bytes.
GE_API int ge_gather_rows(const void* table, const void* idx, void* out,
                          int64_t B, int64_t nc, int64_t row_bytes,
                          int64_t t_batch, void* stream) {
  if (B == 0 || nc == 0 || row_bytes == 0) return (int)cudaGetLastError();
  // a tile's (row, unit) count fits 32 bits; the grid's x fits its limit
  if (B > 65535 || nc >= (1LL << 31) || row_bytes >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const uintptr_t a = (uintptr_t)table | (uintptr_t)out |
                      (uintptr_t)row_bytes | (uintptr_t)t_batch;
  const auto f = a % 16 == 0  ? &launch<uint4>
                 : a % 8 == 0 ? &launch<uint2>
                 : a % 4 == 0 ? &launch<uint32_t>
                 : a % 2 == 0 ? &launch<uint16_t>
                              : &launch<uint8_t>;
  return f(table, idx, out, B, nc, row_bytes, t_batch, (cudaStream_t)stream);
}
