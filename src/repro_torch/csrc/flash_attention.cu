// Causal GQA flash attention, forward (prefill): optional sliding window and
// tanh logit softcap, online softmax in float32.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_attn_kernel / flash_attention_bhsd, pl.pallas_call at :109). The plain
// PyTorch version is repro_torch/kernels/flash_attention/ref.py.
//
// Layout: q (B, S, H, hd), k/v (B, S, KV, hd), out (B, S, H, hd), all bf16
// and contiguous — the model's own layout, so no transpose is made. Query
// head h reads KV head h * KV / H (GQA, as the TPU kernel's index map).
// hd is a template parameter: 16, 32, 64, 128 or 256.
//
// Grid: one CTA per (tile of 64 query rows, query head, batch); four warps,
// each owning 16 of the rows. The CTA stages its Q tile in shared memory
// once, then walks only the KV tiles that the causal and window masks leave
// live — from the tile of max(0, q_start - window + 1) to the tile of its
// last row (the TPU kernel's pl.when skip). For each KV tile of 64 keys:
//   1. K and V tiles are copied into shared memory with cp.async, V(t)
//      while the scores of tile t are computed and K(t+1) while its
//      softmax and value product run;
//   2. each warp computes its 16 x 64 scores with bf16 mma.sync (m16n8k16,
//      float32 accumulation), fragments loaded with ldmatrix;
//   3. in registers: scale by hd^-0.5, then softcap cap * tanh(s / cap),
//      then the mask (the order of kernel.py:60-70); each row's running max
//      m (a quad of lanes holds a row) and the probabilities; masked
//      entries get probability exactly 0;
//   4. the float32 accumulator O stays in registers: it is rescaled by
//      exp(m_old - m_new) and the probabilities, rounded to bf16, feed the
//      P V product straight from the score registers.
// At the end O / l is written in bf16; a row whose every key was masked has
// l = 0 and is written as 0. Rows past S are computed on zero padding and
// never written; tile edges are masked, so any S works.
//
// Precision: P enters the value product rounded to bf16 (the TPU kernel kept
// it in float32, the plain version rounds it too), so kernel and plain
// version agree to a bf16 tolerance, not bit for bit.
//
// Bound on this card: operations. The live (query, key) pairs cost 4 * hd
// flops each (QK and PV), which at S = 4608, hd = 256 is ~80 GFLOP per head
// group against ~50 MB of Q/K/V/out: far above the ~295 flop/byte ridge of
// the bf16 tensor cores. This version uses mma.sync rather than wgmma, and
// cp.async with one buffer per operand rather than a TMA ring with warp
// specialisation; at hd = 256 its 101 KB of shared memory fit two CTAs (8
// warps) on an SM. Those are the next steps towards the bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBQ = 64;    // query rows per CTA
constexpr int kBKV = 64;   // keys per tile
constexpr int kWarps = kBQ / 16;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;    // bf16 row padding of the tiles (ldmatrix banks)
constexpr int kMaxSmem = 232448;  // bytes a Hopper block may use
static_assert(kBQ == kBKV, "load_tile_async stages tiles of kBKV rows");

using bf16 = __nv_bfloat16;

size_t smem_bytes(int hd) {
  return 3 * static_cast<size_t>(kBQ) * (hd + kPad) * sizeof(bf16);
}

// Start copying rows [row0, row0 + 64) of head `head` of a (B, S, n_heads,
// hd) tensor into a 64 x ld shared tile, 16 bytes a thread with cp.async;
// rows at or past S are zero-filled. The caller commits and waits.
__device__ void load_tile_async(bf16* dst, int ld, const bf16* __restrict__ src,
                                int b, int row0, int S, int n_heads, int head,
                                int hd) {
  const int vecs = hd / 8;
  for (int i = threadIdx.x; i < kBKV * vecs; i += kThreads) {
    const int r = i / vecs;
    const int c = (i - r * vecs) * 8;
    const int s = row0 + r;
    const bool in = s < S;
    const bf16* g = src + ((static_cast<size_t>(b) * S + (in ? s : 0)) *
                               n_heads + head) * hd + c;
    const unsigned d =
        static_cast<unsigned>(__cvta_generic_to_shared(dst + r * ld + c));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(g), "r"(in ? 16 : 0)
                 : "memory");
  }
}

__device__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed copy groups are pending.
template <int N>
__device__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8. TRANS transposes each matrix.
template <bool TRANS>
__device__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  if (TRANS) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a));
  } else {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a));
  }
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, float32 accumulate.
__device__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ out,
                       int S, int H, int KV, int window, float softcap,
                       float scale) {
  constexpr int ld = HD + kPad;
  constexpr int kTilesN = HD / 8;  // n8 tiles of the output row
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h * KV / H;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // fragment row (and row + 8)
  const int t = lane & 3;   // fragment column pair
  const int r0 = warp * 16;

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sk = sq + kBQ * ld;
  bf16* sv = sk + kBKV * ld;

  const int q_last = min(q0 + kBQ, S) - 1;
  const int kv_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_lo = kv_lo / kBKV, t_hi = q_last / kBKV;
  const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;
  const int qi[2] = {q0 + r0 + g, q0 + r0 + g + 8};

  // copy groups: {Q, K(t_lo)} now; then per tile {V(t)} and {K(t+1)}
  load_tile_async(sq, ld, q, b, q0, S, H, h, HD);
  load_tile_async(sk, ld, k, b, t_lo * kBKV, S, KV, kvh, HD);
  cp_async_commit();

  float o[kTilesN][4];
#pragma unroll
  for (int n = 0; n < kTilesN; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of rows g, g + 8
  float l[2] = {0.f, 0.f};              // this lane's part of the row sums

  // ldmatrix lane roles: matrix mi = lane / 8, row lane % 8 of it
  const int mi = lane >> 3, mr = lane & 7;

  for (int tile = t_lo; tile <= t_hi; ++tile) {
    const int k0 = tile * kBKV;
    __syncthreads();  // every warp is done with the previous V tile
    load_tile_async(sv, ld, v, b, k0, S, KV, kvh, HD);
    cp_async_commit();
    cp_async_wait<1>();  // Q and K(tile) have landed
    __syncthreads();

    // 2. scores: s[j] is keys 8j..8j+7 of the warp's 16 rows
    float s[kBKV / 8][4];
#pragma unroll
    for (int j = 0; j < kBKV / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD; kk += 16) {
      uint32_t a[4];
      ldmatrix_x4<false>(a,
                         sq + (r0 + (mi & 1) * 8 + mr) * ld + kk + (mi >> 1) * 8);
#pragma unroll
      for (int j = 0; j < kBKV / 8; j += 2) {
        uint32_t bk[4];  // b0, b1 of key tiles j and j + 1
        ldmatrix_x4<false>(
            bk, sk + (8 * j + (mi >> 1) * 8 + mr) * ld + kk + (mi & 1) * 8);
        mma_bf16(s[j], a, bk[0], bk[1]);
        mma_bf16(s[j + 1], a, bk[2], bk[3]);
      }
    }
    __syncthreads();  // every warp is done with K(tile)
    if (tile < t_hi) load_tile_async(sk, ld, k, b, k0 + kBKV, S, KV, kvh, HD);
    cp_async_commit();  // possibly empty, so the group count stays fixed

    // 3. softmax in registers: s[j][c] is row g + 8 (c / 2), key
    //    k0 + 8j + 2t + c % 2
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kBKV / 8; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kj = k0 + 8 * j + 2 * t + (c & 1);
        const int row = qi[c >> 1];
        float x = s[j][c] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x * inv_cap);
        const bool live =
            kj <= row && kj < S && (window <= 0 || kj > row - window);
        x = live ? x : -INFINITY;
        s[j][c] = x;
        mx[c >> 1] = fmaxf(mx[c >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      // a row with no live key yet keeps m = -inf and alpha = 1
      alpha[i] = m_new == -INFINITY ? 1.f : __expf(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < kBKV / 8; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float x = s[j][c];
        const float p = x == -INFINITY ? 0.f : __expf(x - m[c >> 1]);
        s[j][c] = p;
        l[c >> 1] += p;
      }
    }
#pragma unroll
    for (int n = 0; n < kTilesN; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // 4. O += P V; P's A fragments come straight from the score registers
    cp_async_wait<1>();  // V(tile) has landed (K(tile+1) may be in flight)
    __syncthreads();
#pragma unroll
    for (int kc = 0; kc < kBKV / 16; ++kc) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                              pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                              pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                              pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int n = 0; n < kTilesN; n += 2) {
        uint32_t bv[4];  // b0, b1 of output tiles n and n + 1
        ldmatrix_x4<true>(
            bv, sv + (16 * kc + (mi & 1) * 8 + mr) * ld + 8 * n + (mi >> 1) * 8);
        mma_bf16(o[n], pa, bv[0], bv[1]);
        mma_bf16(o[n + 1], pa, bv[2], bv[3]);
      }
    }
  }

  // out = O / l, 0 for a row with no live key
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = l[i] == 0.f ? 0.f : 1.f / l[i];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (qi[i] >= S) continue;
    bf16* orow = out + ((static_cast<size_t>(b) * S + qi[i]) * H + h) * HD;
#pragma unroll
    for (int n = 0; n < kTilesN; ++n) {
      *reinterpret_cast<uint32_t*>(orow + 8 * n + 2 * t) =
          pack_bf16(o[n][2 * i] * l[i], o[n][2 * i + 1] * l[i]);
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int H, int KV, int window, float softcap, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(HD);
  if (smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), S, H, KV, window,
      softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// hd one of 16, 32, 64, 128, 256; window <= 0: no window; softcap <= 0: no
// softcap.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int S,
                                      int H, int KV, int hd, int window,
                                      float softcap, float scale, int device,
                                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
      return launch<16>(q, k, v, out, B, S, H, KV, window, softcap, scale, st);
    case 32:
      return launch<32>(q, k, v, out, B, S, H, KV, window, softcap, scale, st);
    case 64:
      return launch<64>(q, k, v, out, B, S, H, KV, window, softcap, scale, st);
    case 128:
      return launch<128>(q, k, v, out, B, S, H, KV, window, softcap, scale,
                         st);
    case 256:
      return launch<256>(q, k, v, out, B, S, H, KV, window, softcap, scale,
                         st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
