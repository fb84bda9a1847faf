// Shared by every kernel library of mcpower_tpu_torch: the C error-string
// entry point the Python wrappers call when a launch returns an error code.
// Each .cu file is its own shared library (one translation unit), so the
// definition below appears exactly once per library.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

extern "C" const char* mcp_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launch-size helper: blocks of `threads` covering `total` items, or 0 when
// the grid would not fit the x dimension.
static inline unsigned mcp_blocks(long long total, int threads) {
    long long blocks = (total + threads - 1) / threads;
    return (blocks > 0x7FFFFFFFLL) ? 0u : static_cast<unsigned>(blocks);
}
