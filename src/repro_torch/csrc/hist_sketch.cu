// Per-cell log-bin histogram counts from bin indices: out[c, idx[t, c]] += 1.
//
// Replaces the TPU kernel src/repro/kernels/hist_sketch/kernel.py
// (_hist_kernel / hist_accum_tc, pl.pallas_call at :81), which contracted
// 0/1 indicator matrices on the matrix unit because a scatter is slow there.
// On Hopper a scatter into shared memory is cheap, so this kernel counts
// with shared-memory int32 atomics instead.
//
// Layout: idx (T, C) int32 row-major, -1 = skip; out (C, n_bins) float32,
// added to in place (the caller zeroes it, or passes a running histogram).
// Grid: one block per (group of G cells, slice of kSliceT steps). A block
// reads its (slice, G) sub-block of idx row by row, so consecutive threads
// read consecutive cells of one step (one 32-byte sector per step for G=8),
// counts into a shared G x n_bins int32 histogram, then adds the nonzero
// counts into out with float atomics. Counts are integers below 2^24, so the
// float sums are exact in any order: the result is bit-equal to the plain
// version however the blocks interleave.
//
// Bound on this card: bytes. Each index is read once (4 B) and each output
// bin read and written once; there is no arithmetic to speak of. What stands
// between this kernel and that bound is the atomic traffic of the flush
// (G * n_bins per block, skipped where zero) for small T.
#include <algorithm>

#include "binning.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSliceT = 1024;
constexpr int kMaxGroup = 8;
constexpr int kMaxSmem = 232448;  // bytes a Hopper block may use

__global__ void hist_accum_kernel(const int* __restrict__ idx,
                                  float* __restrict__ out, int T, int C,
                                  int n_bins, int G) {
  extern __shared__ int counts[];  // [G][n_bins]
  const int c0 = blockIdx.x * G;
  const int g = min(G, C - c0);
  const int t0 = blockIdx.y * kSliceT;
  const int t1 = min(T, t0 + kSliceT);
  for (int i = threadIdx.x; i < g * n_bins; i += blockDim.x) counts[i] = 0;
  __syncthreads();
  const int n = (t1 - t0) * g;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int t = t0 + i / g;
    const int c = i - (i / g) * g;
    const int b = idx[static_cast<size_t>(t) * C + c0 + c];
    if (b >= 0) atomicAdd(&counts[c * n_bins + min(b, n_bins - 1)], 1);  // kSkipBin < 0
  }
  __syncthreads();
  for (int i = threadIdx.x; i < g * n_bins; i += blockDim.x) {
    const int v = counts[i];
    if (v != 0) {
      const int c = i / n_bins;
      atomicAdd(&out[static_cast<size_t>(c0 + c) * n_bins + (i - c * n_bins)],
                static_cast<float>(v));
    }
  }
}

}  // namespace

extern "C" int hist_accum_launch(const void* idx, void* out, int T, int C,
                                 int n_bins, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t row = static_cast<size_t>(n_bins) * sizeof(int);
  if (T <= 0 || C <= 0 || n_bins <= 0 || row > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  int G = static_cast<int>(kMaxSmem / row);
  G = std::min(G, std::min(kMaxGroup, C));
  const size_t smem = row * G;
  err = cudaFuncSetAttribute(hist_accum_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((C + G - 1) / G, (T + kSliceT - 1) / kSliceT);
  hist_accum_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), static_cast<float*>(out), T, C, n_bins, G);
  return static_cast<int>(cudaGetLastError());
}
