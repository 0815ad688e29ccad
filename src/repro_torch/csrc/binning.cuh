// Log-bin sketch geometry shared by the hist_sketch and cell_update kernels.
//
// The bin of a value v is trunc((logf(v) - log_lo) * scale), clipped into
// [0, n_bins). log_lo and scale are float32 values that the host computes
// once (repro_torch.kernels.hist_sketch.ops.log_scale) and passes in, so the
// kernels and the plain PyTorch path bin with the same constants.
//
// Bit rules: full-precision logf (never __logf, never --use_fast_math),
// explicitly rounded subtract and multiply, a truncating float->int
// conversion, then the clip. Callers mask skipped entries (weight 0) BEFORE
// calling, so an infinite response is never converted.
#pragma once

#include <cuda_runtime.h>

// Encoding of an entry the accumulators skip (warmup, padding, incomplete).
constexpr int kSkipBin = -1;

__device__ __forceinline__ int log_bin(float v, float log_lo, float scale,
                                       int n_bins) {
  const float x = __fmul_rn(__fsub_rn(logf(v), log_lo), scale);
  const int i = __float2int_rz(x);  // truncation; saturates on +-inf
  return min(max(i, 0), n_bins - 1);
}

extern "C" const char* error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
