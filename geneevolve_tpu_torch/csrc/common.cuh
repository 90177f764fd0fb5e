// Shared declarations for the segment engine's Hopper kernels.
//
// Every entry point is a plain C function (loaded with ctypes): pointers and
// the stream arrive as void*, the kernel is launched on that stream, and the
// function returns cudaGetLastError() so a refused launch is reported to the
// Python wrapper, which raises on any non-zero code.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define GE_API extern "C" __attribute__((visibility("default")))

// grid size for a grid-stride loop over `n` items: enough blocks to fill the
// card several times over, never more than the items need
static inline int ge_blocks(int64_t n, int threads, int max_blocks) {
  int64_t want = (n + threads - 1) / threads;
  if (want < 1) want = 1;
  return (int)(want < max_blocks ? want : max_blocks);
}
