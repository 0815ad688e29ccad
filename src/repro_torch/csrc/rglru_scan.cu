// RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t along time, h_{-1} = 0,
// float32.
//
// Replaces the TPU kernel src/repro/kernels/rglru_scan/kernel.py
// (_scan_kernel / chunked_linear_scan_raw, pl.pallas_call at :46). The plain
// PyTorch version is repro_torch/kernels/rglru_scan/ref.py.
//
// Layout: a, b, h (B, L, W), contiguous. The TPU grid walked time blocks in
// order and carried h across them in VMEM scratch. Here one thread owns one
// (batch, width lane) and walks the whole sequence, so h stays in a register
// and nothing is carried between blocks; neighbouring threads own
// neighbouring lanes, so every step's loads and store are coalesced across
// W. The loads of kUnroll steps are issued before their recurrence runs, so
// they are in flight together. Each step is __fmul_rn then __fadd_rn, the
// separately rounded multiply and add of the plain version, which this
// kernel equals bit for bit.
//
// Bound on this card: bytes (a and b read once, h written once, 2 flops per
// 12 bytes). At recurrentgemma-9b's width (W = 4096) and B = 1 there are only
// 4096 threads: 128 CTAs of one warp, one per SM, each with kUnroll loads in
// flight per operand, far fewer than the memory system needs to reach its
// rate. Splitting time into blocks with a second pass that carries h across
// them (a chunked scan) is the next step.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;
constexpr int kUnroll = 16;

__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ h, int L, int W, int n_lanes) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_lanes) return;
  const size_t base = static_cast<size_t>(i / W) * L * W + i % W;
  float hv = 0.f;
  int t = 0;
  for (; t + kUnroll <= L; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const size_t at = base + static_cast<size_t>(t + u) * W;
      av[u] = __ldg(a + at);
      bv[u] = __ldg(b + at);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      hv = __fadd_rn(__fmul_rn(av[u], hv), bv[u]);
      h[base + static_cast<size_t>(t + u) * W] = hv;
    }
  }
  for (; t < L; ++t) {
    const size_t at = base + static_cast<size_t>(t) * W;
    hv = __fadd_rn(__fmul_rn(__ldg(a + at), hv), __ldg(b + at));
    h[at] = hv;
  }
}

}  // namespace

extern "C" const char* error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

extern "C" int rglru_scan_launch(const void* a, const void* b, void* h, int B,
                                 int L, int W, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || L <= 0 || W <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long lanes = static_cast<long long>(B) * W;
  if (lanes > (1LL << 31) - 1) return static_cast<int>(cudaErrorInvalidValue);
  const int n_lanes = static_cast<int>(lanes);
  rglru_scan_kernel<<<(n_lanes + kThreads - 1) / kThreads, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(h), L, W, n_lanes);
  return static_cast<int>(cudaGetLastError());
}
