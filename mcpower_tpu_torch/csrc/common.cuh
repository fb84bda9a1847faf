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

// Dispatch a runtime p in [1, 16] to a template instantiation:
// MCP_DISPATCH_P(p, FN, args...) calls FN<P>(args...) and returns its
// result, or cudaErrorInvalidValue for a p outside the range.
#define MCP_DISPATCH_P(p, FN, ...)                          \
    switch (p) {                                            \
        case 1: return FN<1>(__VA_ARGS__);                  \
        case 2: return FN<2>(__VA_ARGS__);                  \
        case 3: return FN<3>(__VA_ARGS__);                  \
        case 4: return FN<4>(__VA_ARGS__);                  \
        case 5: return FN<5>(__VA_ARGS__);                  \
        case 6: return FN<6>(__VA_ARGS__);                  \
        case 7: return FN<7>(__VA_ARGS__);                  \
        case 8: return FN<8>(__VA_ARGS__);                  \
        case 9: return FN<9>(__VA_ARGS__);                  \
        case 10: return FN<10>(__VA_ARGS__);                \
        case 11: return FN<11>(__VA_ARGS__);                \
        case 12: return FN<12>(__VA_ARGS__);                \
        case 13: return FN<13>(__VA_ARGS__);                \
        case 14: return FN<14>(__VA_ARGS__);                \
        case 15: return FN<15>(__VA_ARGS__);                \
        case 16: return FN<16>(__VA_ARGS__);                \
        default: return (int)cudaErrorInvalidValue;         \
    }
