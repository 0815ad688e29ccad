// Decode attention: one new query token against a dense or ring KV cache,
// all G = H / KV query heads of a KV group together (flash-decoding).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/kernel.py
// (_decode_kernel / decode_attention_grouped, pl.pallas_call at :88). The
// plain PyTorch version is repro_torch/kernels/decode_attention/ref.py.
//
// Layout: q (B, 1, H, hd), k/v (B, L, KV, hd) — the model's cache layout,
// so no transpose is made — all bf16 and contiguous; slot_pos (L,) int32,
// the position held in each slot (-1 = empty). Slot s takes part iff
// 0 <= slot_pos[s] <= pos and, with a window, slot_pos[s] > pos - window
// (kernel.py:47-49). A ring cache (local layers) and a dense one (global
// layers) differ only in slot_pos.
//
// Two kernels. The TPU grid walked L sequentially per (batch, KV head); at
// B = 1 and KV = 4 that is 4 blocks on 132 SMs, so here L is split instead:
//   decode_partial: one CTA of 128 threads per (split of 64 slots, KV head,
//     batch). Phase 1: two threads per slot each read half of the slot's K
//     row once (16-byte loads) and dot it with all G queries (float32); a
//     shuffle joins the halves: scale by hd^-0.5, softcap, mask. Phase 2:
//     per query head the split's max m and sum l of exp(s - m); then each
//     thread owns two adjacent d and sums p * V over the split's slots for
//     all G heads. Partial (m, l, acc) go to float32 scratch.
//   decode_combine: one CTA per (128 output elements, KV head, batch)
//     rescales the splits' partials by exp(m_split - m) and writes acc / l
//     in bf16 (0 where no slot was live).
//
// Bound on this card: bytes. Every live slot's K and V rows are read once
// (2 * hd * 2 bytes per slot and KV head) for 4 * G * hd flops — at G = 2
// that is 2 flops a byte, far below the tensor cores' ridge. Empty or
// out-of-window slots' K rows are not read, nor the V rows of a split with no
// live slot. This simple version keeps the partials in device memory and
// reads V with 4-byte loads; TMA staging and an on-chip (cluster) combine
// are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kSplit = kThreads / 2;  // cache slots per CTA, two threads each
constexpr int kMaxGroup = 16;  // query heads per KV head (recurrentgemma: 16)
constexpr int kMaxSmem = 232448;  // bytes a Hopper block may use

using bf16 = __nv_bfloat16;

__device__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// MaxG: the group size the arrays are unrolled over (8 or 16, the least
// that holds G), so gemma2-2b's G = 2 keeps the registers of 8.
template <int MaxG>
__global__ void __launch_bounds__(kThreads)
decode_partial_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const int* __restrict__ slot_pos,
                      float* __restrict__ m_part, float* __restrict__ l_part,
                      float* __restrict__ acc_part, int L, int H, int KV,
                      int hd, int pos, int window, float softcap,
                      float scale) {
  const int sp = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int n_splits = gridDim.x;
  const int G = H / KV;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int s0 = sp * kSplit;
  const int n = min(L, s0 + kSplit) - s0;

  extern __shared__ float smem[];
  float* sq = smem;               // [G][hd] queries in float32
  __shared__ float sc[MaxG][kSplit];  // scores, then probabilities
  __shared__ float sm[MaxG], sl[MaxG];

  for (int i = threadIdx.x; i < G * hd; i += kThreads)
    sq[i] = __bfloat162float(q[(static_cast<size_t>(b) * H + kvh * G) * hd + i]);
  __syncthreads();

  // phase 1: scores; threads 2j and 2j+1 share slot j, each dotting half of
  // the K row (16-byte loads, all in flight together) with the G queries
  {
    const int j = threadIdx.x >> 1;
    const int half = threadIdx.x & 1;
    const int s = s0 + j;
    const int p = j < n ? slot_pos[s] : -1;
    const bool live = p >= 0 && p <= pos && (window <= 0 || p > pos - window);
    float dot[MaxG];  // unrolled over MaxG so it stays in registers
#pragma unroll
    for (int g = 0; g < MaxG; ++g) dot[g] = 0.f;
    if (live) {
      const int d0 = half * (hd / 2);
      const bf16* krow =
          k + ((static_cast<size_t>(b) * L + s) * KV + kvh) * hd + d0;
#pragma unroll 4
      for (int c = 0; c < hd / 2; c += 8) {
        const uint4 raw = *reinterpret_cast<const uint4*>(krow + c);
        const bf16* kv8 = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float kd = __bfloat162float(kv8[e]);
#pragma unroll
          for (int g = 0; g < MaxG; ++g)
            if (g < G) dot[g] += sq[g * hd + d0 + c + e] * kd;
        }
      }
    }
#pragma unroll
    for (int g = 0; g < MaxG; ++g) {
      if (g >= G) break;
      float x = (dot[g] + __shfl_xor_sync(0xffffffffu, dot[g], 1)) * scale;
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      if (half == 0) sc[g][j] = live ? x : -INFINITY;
    }
  }
  __syncthreads();

  // phase 2a: per query head, the split's max and sum of exp(s - max)
  for (int g = warp; g < G; g += kWarps) {
    float mx = -INFINITY;
    for (int j = lane; j < kSplit; j += 32) mx = fmaxf(mx, sc[g][j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < kSplit; j += 32) {
      const float x = sc[g][j];
      const float p = x == -INFINITY ? 0.f : expf(x - mx);
      sc[g][j] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      sm[g] = mx;
      sl[g] = sum;
    }
  }
  __syncthreads();

  // phase 2b: acc[g][d] = sum over the split's slots of p * v[d]; a thread
  // owns two adjacent d (4-byte loads); a split with no live slot reads no V
  const size_t part = (static_cast<size_t>(b) * KV + kvh) * n_splits + sp;
  bool any = false;
  for (int g = 0; g < G; ++g) any |= sm[g] != -INFINITY;
  for (int d = 2 * threadIdx.x; d < hd; d += 2 * kThreads) {
    float acc[MaxG][2];
#pragma unroll
    for (int g = 0; g < MaxG; ++g) acc[g][0] = acc[g][1] = 0.f;
    if (any) {
      const bf16* vcol =
          v + (static_cast<size_t>(b) * L + s0) * KV * hd + kvh * hd + d;
#pragma unroll 16
      for (int j = 0; j < n; ++j) {
        const float2 vv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            vcol + static_cast<size_t>(j) * KV * hd));
#pragma unroll
        for (int g = 0; g < MaxG; ++g) {
          if (g < G) {
            acc[g][0] += sc[g][j] * vv.x;
            acc[g][1] += sc[g][j] * vv.y;
          }
        }
      }
    }
#pragma unroll
    for (int g = 0; g < MaxG; ++g) {
      if (g < G) {
        acc_part[(part * G + g) * hd + d] = acc[g][0];
        acc_part[(part * G + g) * hd + d + 1] = acc[g][1];
      }
    }
  }
  if (threadIdx.x < G) {
    m_part[part * G + threadIdx.x] = sm[threadIdx.x];
    l_part[part * G + threadIdx.x] = sl[threadIdx.x];
  }
}

// One CTA per (chunk of kThreads (g, d) pairs, KV head, batch). Per query
// head g the splits' weights w[g][s] = exp(m_s - m) (0 for a split with no
// live slot) and 1 / sum(w * l) go to shared memory; then each thread sums
// w * acc over the splits for its (g, d), loads coalesced across d.
template <int MaxG>
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const float* __restrict__ m_part,
                      const float* __restrict__ l_part,
                      const float* __restrict__ acc_part,
                      bf16* __restrict__ out, int H, int KV, int hd,
                      int n_splits) {
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KV;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t base = (static_cast<size_t>(b) * KV + kvh) * n_splits;
  extern __shared__ float w[];  // [G][n_splits]
  __shared__ float inv_l[MaxG];

  for (int g = warp; g < G; g += kWarps) {
    float mx = -INFINITY;
    for (int s = lane; s < n_splits; s += 32)
      mx = fmaxf(mx, m_part[(base + s) * G + g]);
    mx = warp_max(mx);
    float l = 0.f;
    for (int s = lane; s < n_splits; s += 32) {
      const float ms = m_part[(base + s) * G + g];
      const float wt = ms == -INFINITY ? 0.f : expf(ms - mx);
      w[g * n_splits + s] = wt;
      l += wt * l_part[(base + s) * G + g];
    }
    l = warp_sum(l);
    if (lane == 0) inv_l[g] = l == 0.f ? 0.f : 1.f / l;
  }
  __syncthreads();

  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= G * hd) return;
  const int g = i / hd;
  const float* wg = w + g * n_splits;
  float a = 0.f;
#pragma unroll 8
  for (int s = 0; s < n_splits; ++s)
    a += wg[s] * acc_part[(base + s) * G * hd + i];
  out[(static_cast<size_t>(b) * H + kvh * G) * hd + i] =
      __float2bfloat16(a * inv_l[g]);
}

}  // namespace

extern "C" const char* error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

extern "C" int decode_attention_split() { return kSplit; }

namespace {

template <int MaxG>
int launch(const void* q, const void* k, const void* v, const void* slot_pos,
           void* out, void* m_part, void* l_part, void* acc_part, int B,
           int L, int H, int KV, int hd, int pos, int window, float softcap,
           float scale, cudaStream_t st) {
  const int G = H / KV;
  const int n_splits = (L + kSplit - 1) / kSplit;
  const size_t smem = static_cast<size_t>(G) * hd * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      decode_partial_kernel<MaxG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_partial_kernel<MaxG><<<dim3(n_splits, KV, B), kThreads, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int*>(slot_pos),
      static_cast<float*>(m_part), static_cast<float*>(l_part),
      static_cast<float*>(acc_part), L, H, KV, hd, pos, window, softcap,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem_w = static_cast<size_t>(G) * n_splits * sizeof(float);
  if (smem_w > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(decode_combine_kernel<MaxG>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_w));
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_combine_kernel<MaxG><<<dim3((G * hd + kThreads - 1) / kThreads, KV,
                                     B),
                                kThreads, smem_w, st>>>(
      static_cast<const float*>(m_part), static_cast<const float*>(l_part),
      static_cast<const float*>(acc_part), static_cast<bf16*>(out), H, KV, hd,
      n_splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Scratch: m_part, l_part (B, KV, n_splits, G) and acc_part (B, KV, n_splits,
// G, hd) float32, n_splits = ceil(L / decode_attention_split()). window <= 0:
// no window; softcap <= 0: no softcap. G = H / KV at most 16.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* slot_pos,
    void* out, void* m_part, void* l_part, void* acc_part, int B, int L,
    int H, int KV, int hd, int pos, int window, float softcap, float scale,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || L <= 0 || H <= 0 || KV <= 0 || H % KV != 0 ||
      H / KV > kMaxGroup || hd <= 0 || hd % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (H / KV <= 8)
    return launch<8>(q, k, v, slot_pos, out, m_part, l_part, acc_part, B, L,
                     H, KV, hd, pos, window, softcap, scale, st);
  return launch<16>(q, k, v, slot_pos, out, m_part, l_part, acc_part, B, L,
                    H, KV, hd, pos, window, softcap, scale, st);
}
