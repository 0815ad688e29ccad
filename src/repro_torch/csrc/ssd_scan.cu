// Mamba-2 SSD intra-chunk term: the chunked algorithm's quadratic part and
// each chunk's contributed state, in float32 on the CUDA cores.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/kernel.py
// (_ssd_kernel / ssd_intra_chunk_flat, pl.pallas_call at :62). The plain
// PyTorch version is repro_torch/kernels/ssd_scan/ref.py.
//
// Layout (the model's own, so no transpose is made), all float32 and
// contiguous, with BC = batch x chunks: x (BC, Q, H, P), b/c (BC, Q, N),
// dt/cum (BC, Q, H). Out: y (BC, Q, H, P) and states (BC, H, P, N):
//   y[q]   = sum_{s <= q} (C_q . B_s) exp(cum_q - cum_s) dt_s X_s
//   state  = sum_q (X_q exp(cum_{Q-1} - cum_q) dt_q) outer B_q
//
// The TPU kernel held a whole chunk in VMEM per (chunk, head) and formed
// C B^T for every head. At mamba2-370m (Q = 256, N = 128) B and C alone are
// 128 KB each in float32, so here the chunk is tiled, and C B^T, which the
// heads share, is formed once per chunk. Three kernels:
//   ssd_scores: one CTA of 256 threads per (64 x 64 tile on or below the
//     diagonal, chunk) writes G = C B^T into scratch (BC, Q, Q); each
//     thread sums 4 x 4 products over N.
//   ssd_y: one CTA per (tile of 64 query rows, head, chunk) walks the key
//     tiles s0 <= its last row (the causal half only): X, cum and dt of the
//     tile go to shared memory, the weights (G * exp(cum_q - cum_s)) * dt_s
//     are selected to 0 above the diagonal (the exponent overflows there: a
//     select, never a multiply by a 0/1 mask, which would give inf * 0 =
//     NaN), and W X is added into 4 x P/16 register accumulators a thread.
//   ssd_state: one CTA of 128 threads per (64 x 128 block of the state,
//     head, chunk) sums (X_q exp(total - cum_q) dt_q) outer B_q over the
//     chunk in tiles of 32 rows, 8 x 8 accumulators a thread.
// Every sum runs over its index in order, one __fmaf_rn a term (the library
// is built with --fmad=false, the bit contract of cell_update, which would
// split every a * b + c in two).
//
// Bound on this card: operations. At mamba2-370m's prefill of 16 chunks the
// useful work is ~4.5 GFLOP (C B^T over the causal half, the W X product
// and the state product per head) against ~89 MB of inputs and outputs:
// ~0.07 ms at the float32 rate, ~0.03 ms of memory. This version stays off
// the tensor cores; a TF32/bf16 mma for the three products is the next
// step.
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kTile = 64;       // rows and columns of a G tile
constexpr int kThreads = 256;   // 16 x 16; a thread owns rows ty + 16 i
constexpr int kMaxP = 128;
constexpr int kMaxN = 256;
constexpr int kStateP = 64;     // ssd_state block: P rows ...
constexpr int kStateN = 128;    // ... by N columns
constexpr int kStateThreads = 128;  // 8 x 16; a thread owns 8 x 8
constexpr int kStateQ = 32;     // chunk rows per ssd_state tile
constexpr int kMaxSmem = 232448;  // bytes a Hopper block may use

size_t scores_smem_bytes(int N) {
  return sizeof(float) * 2 * kTile * (N + 1);
}

size_t y_smem_bytes(int P) {
  return sizeof(float) * (kTile * (P + 1) + kTile * (kTile + 1));
}

__global__ void __launch_bounds__(kThreads)
ssd_scores_kernel(const float* __restrict__ bm, const float* __restrict__ cm,
                  float* __restrict__ g, int Q, int N) {
  const int qt = blockIdx.x, st = blockIdx.y;
  if (st > qt) return;  // above the diagonal: never read
  const size_t row0 = static_cast<size_t>(blockIdx.z) * Q;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int q0 = qt * kTile, s0 = st * kTile;
  const int ldn = N + 1;  // padded rows: column reads hit distinct banks
  extern __shared__ float smem[];
  float* sc = smem;              // [kTile][ldn] C rows
  float* sb = sc + kTile * ldn;  // [kTile][ldn] B rows
  for (int i = threadIdx.x; i < kTile * N; i += kThreads) {
    const int r = i / N, n = i % N;
    sc[r * ldn + n] = q0 + r < Q ? cm[(row0 + q0 + r) * N + n] : 0.f;
    sb[r * ldn + n] = s0 + r < Q ? bm[(row0 + s0 + r) * N + n] : 0.f;
  }
  __syncthreads();
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int n = 0; n < N; ++n) {
    float cv[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) cv[i] = sc[(ty + 16 * i) * ldn + n];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = sb[(tx + 16 * j) * ldn + n];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[i][j] = __fmaf_rn(cv[i], bv[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = q0 + ty + 16 * i;
    if (q >= Q) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int s = s0 + tx + 16 * j;
      if (s < Q) g[(row0 + q) * Q + s] = acc[i][j];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
ssd_y_kernel(const float* __restrict__ x, const float* __restrict__ g,
             const float* __restrict__ dt, const float* __restrict__ cum,
             float* __restrict__ y, int Q, int H, int P) {
  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const size_t row0 = static_cast<size_t>(blockIdx.z) * Q;  // chunk's rows
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int q0 = qt * kTile;
  const int q_last = min(Q, q0 + kTile) - 1;
  const int ldp = P + 1;
  constexpr int ldw = kTile + 1;

  extern __shared__ float smem[];
  float* sx = smem;               // [kTile][ldp] X rows of the key tile
  float* sw = sx + kTile * ldp;   // [kTile][ldw] weights
  __shared__ float cum_q[kTile], cum_s[kTile], dt_s[kTile];

  if (threadIdx.x < kTile) {
    const int q = q0 + threadIdx.x;
    cum_q[threadIdx.x] = q < Q ? cum[(row0 + q) * H + h] : 0.f;
  }

  float acc[4][kMaxP / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kMaxP / 16; ++j) acc[i][j] = 0.f;

  for (int s0 = 0; s0 <= q_last; s0 += kTile) {
    __syncthreads();  // the previous tile's sx / sw are read
    for (int i = threadIdx.x; i < kTile * P; i += kThreads) {
      const int r = i / P, p = i % P;
      sx[r * ldp + p] =
          s0 + r < Q ? x[((row0 + s0 + r) * H + h) * P + p] : 0.f;
    }
    if (threadIdx.x < kTile) {
      const int s = s0 + threadIdx.x;
      cum_s[threadIdx.x] = s < Q ? cum[(row0 + s) * H + h] : 0.f;
      dt_s[threadIdx.x] = s < Q ? dt[(row0 + s) * H + h] : 0.f;
    }
    __syncthreads();
    // weights of rows ty + 16 i, columns tx + 16 j; G rows are read
    // coalesced across tx
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int rq = ty + 16 * i, rs = tx + 16 * j;
        const int q = q0 + rq, s = s0 + rs;
        // select, never multiply by a mask: above the diagonal the
        // exponent is positive and overflows
        sw[rq * ldw + rs] =
            (s <= q && q < Q)
                ? __fmul_rn(__fmul_rn(g[(row0 + q) * Q + s],
                                      expf(cum_q[rq] - cum_s[rs])),
                            dt_s[rs])
                : 0.f;
      }
    }
    __syncthreads();

    // y += W X over the tile's keys
    for (int s = 0; s < kTile; ++s) {
      float wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) wv[i] = sw[(ty + 16 * i) * ldw + s];
#pragma unroll
      for (int j = 0; j < kMaxP / 16; ++j) {
        const int p = tx + 16 * j;
        if (p < P) {
          const float xv = sx[s * ldp + p];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[i][j] = __fmaf_rn(wv[i], xv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = q0 + ty + 16 * i;
    if (q >= Q) continue;
#pragma unroll
    for (int j = 0; j < kMaxP / 16; ++j) {
      const int p = tx + 16 * j;
      if (p < P) y[((row0 + q) * H + h) * P + p] = acc[i][j];
    }
  }
}

__global__ void __launch_bounds__(kStateThreads)
ssd_state_kernel(const float* __restrict__ x, const float* __restrict__ bm,
                 const float* __restrict__ dt, const float* __restrict__ cum,
                 float* __restrict__ states, int Q, int H, int P, int N) {
  const int n_pblocks = (P + kStateP - 1) / kStateP;
  const int p0 = (blockIdx.x % n_pblocks) * kStateP;
  const int n0 = (blockIdx.x / n_pblocks) * kStateN;
  const int h = blockIdx.y;
  const int chunk = blockIdx.z;
  const size_t row0 = static_cast<size_t>(chunk) * Q;
  const int tx = threadIdx.x % 16;  // columns n0 + tx + 16 j
  const int ty = threadIdx.x / 16;  // rows p0 + ty + 8 i
  __shared__ float sx[kStateQ][kStateP + 1];  // X * exp(total - cum) * dt
  __shared__ float sb[kStateQ][kStateN + 1];
  __shared__ float sgate[kStateQ];
  const float total = cum[(row0 + Q - 1) * H + h];

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int q0 = 0; q0 < Q; q0 += kStateQ) {
    __syncthreads();
    if (threadIdx.x < kStateQ) {
      const int q = q0 + threadIdx.x;
      sgate[threadIdx.x] =
          q < Q ? __fmul_rn(expf(total - cum[(row0 + q) * H + h]),
                            dt[(row0 + q) * H + h])
                : 0.f;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kStateQ * kStateP; i += kStateThreads) {
      const int r = i / kStateP, pp = i % kStateP;
      const int q = q0 + r, p = p0 + pp;
      sx[r][pp] = (q < Q && p < P)
                      ? __fmul_rn(x[((row0 + q) * H + h) * P + p], sgate[r])
                      : 0.f;
    }
    for (int i = threadIdx.x; i < kStateQ * kStateN; i += kStateThreads) {
      const int r = i / kStateN, nn = i % kStateN;
      const int q = q0 + r, n = n0 + nn;
      sb[r][nn] = (q < Q && n < N) ? bm[(row0 + q) * N + n] : 0.f;
    }
    __syncthreads();
    for (int r = 0; r < kStateQ; ++r) {
      float xv[8], bv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) xv[i] = sx[r][ty + 8 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) bv[j] = sb[r][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc[i][j] = __fmaf_rn(xv[i], bv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int p = p0 + ty + 8 * i;
    if (p >= P) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N)
        states[((static_cast<size_t>(chunk) * H + h) * P + p) * N + n] =
            acc[i][j];
    }
  }
}

}  // namespace

extern "C" const char* error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// Scratch g: (BC, Q, Q) float32, C B^T of every chunk (the tiles on and
// below the diagonal are written). Both outputs are written in full; P <=
// 128, N <= 256.
extern "C" int ssd_scan_launch(const void* x, const void* b, const void* c,
                               const void* dt, const void* cum, void* y,
                               void* states, void* g, int BC, int Q, int H,
                               int P, int N, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (BC <= 0 || Q <= 0 || H <= 0 || P <= 0 || P > kMaxP || N <= 0 ||
      N > kMaxN || H > 65535 || BC > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem_g = scores_smem_bytes(N), smem_y = y_smem_bytes(P);
  if (smem_g > static_cast<size_t>(kMaxSmem) ||
      smem_y > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(ssd_scores_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_g));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(ssd_y_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_y));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* bf = static_cast<const float*>(b);
  const float* dtf = static_cast<const float*>(dt);
  const float* cumf = static_cast<const float*>(cum);
  float* gf = static_cast<float*>(g);
  const int n_tiles = (Q + kTile - 1) / kTile;
  ssd_scores_kernel<<<dim3(n_tiles, n_tiles, BC), kThreads, smem_g, st>>>(
      bf, static_cast<const float*>(c), gf, Q, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_y_kernel<<<dim3(n_tiles, H, BC), kThreads, smem_y, st>>>(
      xf, gf, dtf, cumf, static_cast<float*>(y), Q, H, P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_blocks = ((P + kStateP - 1) / kStateP) *
                       ((N + kStateN - 1) / kStateN);
  ssd_state_kernel<<<dim3(n_blocks, H, BC), kStateThreads, 0, st>>>(
      xf, bf, dtf, cumf, static_cast<float*>(states), Q, H, P, N);
  return static_cast<int>(cudaGetLastError());
}
