// Row gather over raw bytes: out[i, :] = table[idx[i], :].
//
// Replaces geneevolve_tpu/ops/materialize.py `gather_rows` /
// `materialize_rows` (Pallas identity `_identity`), which existed to make
// XLA materialize a gather once instead of re-running it inside every
// consumer. Here the gather itself is the kernel: each thread copies one
// unit of one row, and the unit is the widest of 16, 8, 4, 2 or 1 bytes
// that divides the row and both base addresses, so rows whose length is a
// multiple of 16 bytes move as 16-byte loads and stores.
//
// Bound: pure data movement, 2 x rows x row_bytes through HBM; neighbouring
// threads touch neighbouring units of a row, so loads coalesce within a row.
#include "common.cuh"

template <typename T>
__global__ void gather_rows_kernel(const T* __restrict__ table,
                                   const int32_t* __restrict__ idx,
                                   T* __restrict__ out, int64_t n,
                                   int64_t w) {
  const int64_t total = n * w;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const int64_t r = i / w;
    const int64_t c = i - r * w;
    out[i] = table[(int64_t)idx[r] * w + c];
  }
}

template <typename T>
static int launch(const void* table, const void* idx, void* out, int64_t n,
                  int64_t row_bytes, cudaStream_t stream) {
  const int64_t w = row_bytes / (int64_t)sizeof(T);
  const int threads = 256;
  gather_rows_kernel<T><<<ge_blocks(n * w, threads, 132 * 16), threads, 0,
                          stream>>>((const T*)table, (const int32_t*)idx,
                                    (T*)out, n, w);
  return (int)cudaGetLastError();
}

GE_API int ge_gather_rows(const void* table, const void* idx, void* out,
                          int64_t n, int64_t row_bytes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const uintptr_t a = (uintptr_t)table | (uintptr_t)out | (uintptr_t)row_bytes;
  if (n == 0 || row_bytes == 0) return (int)cudaGetLastError();
  if (a % 16 == 0) return launch<uint4>(table, idx, out, n, row_bytes, s);
  if (a % 8 == 0) return launch<uint2>(table, idx, out, n, row_bytes, s);
  if (a % 4 == 0) return launch<uint32_t>(table, idx, out, n, row_bytes, s);
  if (a % 2 == 0) return launch<uint16_t>(table, idx, out, n, row_bytes, s);
  return launch<uint8_t>(table, idx, out, n, row_bytes, s);
}
