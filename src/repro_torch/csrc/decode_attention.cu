// Decode attention: one new query token against a dense or ring KV cache,
// all G = H / KV query heads of a KV group together (flash-decoding), in one
// launch.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/kernel.py
// (_decode_kernel / decode_attention_grouped, pl.pallas_call at :88). The
// plain PyTorch version is repro_torch/kernels/decode_attention/ref.py.
//
// Layout: q (B, 1, H, hd), k/v (B, L, KV, hd): the model's cache layout, so
// no transpose is made; all bf16 and contiguous. slot_pos (L,) int32, the
// position held in each slot (-1 = empty). Slot s takes part iff
// 0 <= slot_pos[s] <= pos and, with a window, slot_pos[s] > pos - window
// (kernel.py:47-49). A ring cache (local layers) and a dense one (global
// layers) differ only in slot_pos.
//
// Bound on this card: bytes. Every live slot's K and V rows are read once
// (2 * hd * 2 bytes per slot and KV head) for 4 * G * hd flops: at G = 2
// that is 2 flops a byte, at G = 16 (MQA) 16, far below the tensor cores'
// ridge of ~295. What the design does about it:
//   - the cache is cut into splits whose size the wrapper derives from the
//     shape and the SM count (kernel.py's split_plan), so that
//     B x KV x splits fills the card at least twice; one CTA per (split,
//     KV head, batch), of 128 threads (256 for a group of 8-16 heads);
//   - a CTA first finds its split's live slots (a ballot per warp) and
//     issues every live slot's K row, then every V row, into shared memory
//     as 16-byte cp.async copies in two groups, all in flight together
//     before any arithmetic; the scores start when the K group has landed,
//     while V is still arriving; empty and out-of-window slots are neither
//     copied nor computed;
//   - scores (8 lanes per slot and query head, each holding its eighth of
//     the query in registers, joined by three shuffles) and the value
//     product (a thread per output column, all G heads) read
//     shared memory only, on the CUDA cores: at 2-16 flops a byte the
//     tensor cores would idle on the same bytes;
//   - the combine is in the same launch. The CTAs of 8 consecutive splits
//     form a thread-block cluster: after each has its split's (max, sum,
//     acc) in shared memory, CTA rank r reads its peers' through
//     distributed shared memory and combines the r-th eighth of the
//     G x hd outputs; it writes that slice's partial to a small float32
//     scratch, fences, and bumps a counter per (batch, KV head, rank).
//     The CTA that brings the counter to the number of clusters combines
//     the slice over the clusters (an online softmax whose loads are
//     issued ahead), writes it out in bf16 (0 where no slot was live), and
//     sets the counter back to 0 for the next launch. The counters are
//     zeroed once when the wrapper allocates them.
// P stays float32 in the value product (the plain version rounds it to
// bf16; the row gate of chip_smoke.py covers the difference).
//
// Partial results (a cache split over ranks, combined across them: a
// KV-sequence-sharded decode): given out32 and lse, the launch writes the
// output in float32 to out32 (not rounded to bf16) and each query head's
// log-sum-exp of its masked, soft-capped, scaled scores, lse = m + log l,
// to lse (B, H); where no slot is live the output is 0 and lse is -inf.
//
// What is left: at the main path's shapes the time after the last rows land
// sets the kernel's time, not the bytes: the CUDA-core products, two
// cluster barriers, the fence and atomic that publish a slice, and the
// combine over the clusters. mma.sync tiles for the two products would
// shorten the first, at a cost in shared memory that the grid's one wave
// (3 CTAs an SM at gemma2-2b) does not leave.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;  // splits combined on chip
constexpr int kMaxSplit = 128;  // slots a CTA stages, one a thread in the scan

// Threads of a CTA at group bound MaxG: 8 warps for the 8-16 query heads
// of a large group (recurrentgemma-9b's MQA), 4 for smaller ones, where the
// shorter syncs win.
__host__ __device__ constexpr int threads_for(int max_g) {
  return max_g >= 8 ? 256 : 128;
}
static_assert(threads_for(1) >= kMaxSplit, "one slot a thread in the scan");
// CTAs an SM must hold so that the main path's grid (288 CTAs at gemma2-2b,
// 296 at recurrentgemma-9b) runs in one wave: caps registers at 85 for 256
// threads
constexpr int kMinBlocks = 3;
constexpr int kMaxGroup = 16;  // query heads per KV head (recurrentgemma: 16)
constexpr int kMaxHeadDim = 256;  // a thread holds 4 x 8 query values
constexpr int kMaxSmem = 232448;  // bytes a Hopper block may use

using bf16 = __nv_bfloat16;

__device__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// Shared memory of a CTA; offsets in floats (bf16 rows count half).
struct Layout {
  int ss, k, v, sc, acc, m, l, idx, total;  // total in bytes
  __host__ __device__ Layout(int split, int G, int hd) {
    ss = (split + 3) & ~3;        // score row stride: float4 reads
    k = 0;                        // [split][hd] bf16, live rows compacted
    v = k + split * hd / 2;       // [split][hd] bf16
    sc = v + split * hd / 2;      // [G][ss] scores, then probabilities
    acc = sc + G * ss;            // [G][hd] the split's sum of p * v
    m = acc + G * hd;             // [G] the split's max
    l = m + G;                    // [G] the split's sum of exp(s - max)
    idx = l + G;                  // [split] int: the live slots, and count
    total = 4 * (idx + split + 1);
  }
};

// MaxG: the group size the arrays are unrolled over (the least of 2, 4, 8,
// 16 that holds G), so gemma2-2b's G = 2 keeps the registers of 2.
template <int MaxG>
__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(threads_for(MaxG), kMinBlocks)
decode_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const int* __restrict__ slot_pos,
                        bf16* __restrict__ out, float* __restrict__ out32,
                        float* __restrict__ lse, float* __restrict__ part_acc,
                        float* __restrict__ part_ml, int* __restrict__ counters,
                        int L, int H, int KV, int hd, int pos, int window,
                        float softcap, float scale, int split) {
  constexpr int kThreads = threads_for(MaxG);
  constexpr int kWarps = kThreads / 32;
  // scores: 8 lanes per (slot, head), kSlots slots at a time
  constexpr int kSlots = kThreads / (8 * MaxG);
  const int sp = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KV;
  const int E = G * hd;  // outputs of a (batch, KV head)
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n_clusters = gridDim.x / kCluster;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int cid = sp / kCluster;

  extern __shared__ float smem[];
  const Layout lay(split, G, hd);
  bf16* sk = reinterpret_cast<bf16*>(smem + lay.k);
  bf16* sv = reinterpret_cast<bf16*>(smem + lay.v);
  float* sc = smem + lay.sc;
  const int ss = lay.ss;
  float* sacc = smem + lay.acc;
  float* sm = smem + lay.m;
  float* sl = smem + lay.l;
  int* idx = reinterpret_cast<int*>(smem + lay.idx);
  __shared__ int warp_live[kWarps];
  __shared__ int is_last;

  // 1. the split's live slots, compacted in slot order
  const int s0 = sp * split;
  {
    const int s = s0 + threadIdx.x;
    const int p = threadIdx.x < split && s < L ? slot_pos[s] : -1;
    const bool live = p >= 0 && p <= pos && (window <= 0 || p > pos - window);
    const unsigned ballot = __ballot_sync(0xffffffffu, live);
    if (lane == 0) warp_live[warp] = __popc(ballot);
    __syncthreads();
    int before = 0;
    for (int w = 0; w < warp; ++w) before += warp_live[w];
    if (live) idx[before + __popc(ballot & ((1u << lane) - 1u))] = s;
    if (threadIdx.x == kThreads - 1) idx[split] = before + warp_live[warp];
    __syncthreads();
  }
  const int n_live = idx[split];

  // 2. stage every live K row, then every live V row (16-byte copies, two
  //    groups, all in flight): the scores start when K has landed
  const int vecs = hd / 8;
  for (int pass = 0; pass < 2; ++pass) {
    const bf16* src = pass == 0 ? k : v;
    bf16* dst = pass == 0 ? sk : sv;
    for (int i = threadIdx.x; i < n_live * vecs; i += kThreads) {
      const int r = i / vecs;
      const int c = (i - r * vecs) * 8;
      cp_async16(dst + r * hd + c,
                 src + ((static_cast<size_t>(b) * L + idx[r]) * KV + kvh) *
                               hd + c);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  // this thread's query part: head g, columns 8 part + 64 i (hd <= 256)
  const int part = threadIdx.x % 8;
  const int g_own = threadIdx.x / 8 % MaxG;
  const int j_own = threadIdx.x / (8 * MaxG);
  float qr[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = 8 * part + 64 * i;
    const bool in = g_own < G && c < hd;
    const uint4 raw =
        in ? *reinterpret_cast<const uint4*>(
                 q + (static_cast<size_t>(b) * H + kvh * G + g_own) * hd + c)
           : make_uint4(0, 0, 0, 0);
    const bf16* q8 = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int e = 0; e < 8; ++e) qr[i][e] = __bfloat162float(q8[e]);
  }
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  __syncthreads();

  // 3. scores of kSlots slots at a time: the 8 lanes of a (slot, head) dot
  //    their parts of the K row with the query (four partial sums each)
  //    and join by shuffles
#pragma unroll 2
  for (int j0 = 0; j0 < n_live; j0 += kSlots) {
    const int j = j0 + j_own;
    float d4[4] = {0.f, 0.f, 0.f, 0.f};
    if (j < n_live) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = 8 * part + 64 * i;
        if (c < hd) {
          const uint4 raw = *reinterpret_cast<const uint4*>(sk + j * hd + c);
          const bf16* k8 = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            d4[e & 3] += qr[i][e] * __bfloat162float(k8[e]);
        }
      }
    }
    float dot = (d4[0] + d4[1]) + (d4[2] + d4[3]);
    dot += __shfl_xor_sync(0xffffffffu, dot, 4);
    dot += __shfl_xor_sync(0xffffffffu, dot, 2);
    dot += __shfl_xor_sync(0xffffffffu, dot, 1);
    if (part == 0 && j < n_live && g_own < G) {
      float x = dot * scale;
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      sc[g_own * ss + j] = x;
    }
  }
  __syncthreads();

  // 4. per query head the split's max and sum of exp(s - max); the scores
  //    past the last live slot, up to a multiple of 4, become 0
  const int n4 = (n_live + 3) & ~3;
  for (int g = warp; g < G; g += kWarps) {
    float mx = -INFINITY;
    for (int j = lane; j < n_live; j += 32) mx = fmaxf(mx, sc[g * ss + j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < n4; j += 32) {
      const float p = j < n_live ? __expf(sc[g * ss + j] - mx) : 0.f;
      sc[g * ss + j] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      sm[g] = mx;  // -inf where no slot is live
      sl[g] = sum;
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // 5. the split's acc[g][d] = sum over live slots of p * v[d]; a thread
  //    owns an output column d and takes four slots at a time
  for (int d = threadIdx.x; d < hd; d += kThreads) {
    float acc[MaxG];
#pragma unroll
    for (int g = 0; g < MaxG; ++g) acc[g] = 0.f;
    for (int j = 0; j < n4; j += 4) {
      float vv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        vv[u] = j + u < n_live ? __bfloat162float(sv[(j + u) * hd + d]) : 0.f;
#pragma unroll
      for (int g = 0; g < MaxG; ++g) {
        if (g < G) {
          const float4 p = *reinterpret_cast<const float4*>(sc + g * ss + j);
          acc[g] += p.x * vv[0] + p.y * vv[1] + p.z * vv[2] + p.w * vv[3];
        }
      }
    }
#pragma unroll
    for (int g = 0; g < MaxG; ++g)
      if (g < G) sacc[g * hd + d] = acc[g];
  }

  // 6. on chip: rank r combines the cluster's 8 splits over slice r of the
  //    G x hd outputs, two outputs a thread, reading its peers' shared
  //    memory: their maxima, sums and partials in one round
  cluster.sync();
  const int per = E / kCluster;
  const int e_lo = rank * per;
  const size_t bk = static_cast<size_t>(b) * KV + kvh;
  const size_t part_id = bk * n_clusters + cid;
  for (int u = e_lo / 2 + threadIdx.x; u < (e_lo + per) / 2; u += kThreads) {
    const int g = 2 * u / hd;
    float mc[kCluster], lc[kCluster];
    float2 pk[kCluster];
#pragma unroll
    for (int c = 0; c < kCluster; ++c) {
      mc[c] = cluster.map_shared_rank(sm, c)[g];
      lc[c] = cluster.map_shared_rank(sl, c)[g];
      pk[c] = reinterpret_cast<const float2*>(
          cluster.map_shared_rank(sacc, c))[u];
    }
    float M = -INFINITY;
#pragma unroll
    for (int c = 0; c < kCluster; ++c) M = fmaxf(M, mc[c]);
    float2 a = make_float2(0.f, 0.f);
    float lsum = 0.f;
#pragma unroll
    for (int c = 0; c < kCluster; ++c) {
      const float w = mc[c] == -INFINITY ? 0.f : __expf(mc[c] - M);
      a.x += w * pk[c].x;
      a.y += w * pk[c].y;
      lsum += w * lc[c];
    }
    reinterpret_cast<float2*>(part_acc + part_id * E)[u] = a;
    if (2 * u == e_lo || 2 * u % hd == 0) {  // once per head of the slice
      float* ml = part_ml + ((part_id * kCluster + rank) * G + g) * 2;
      ml[0] = M;
      ml[1] = lsum;
    }
  }
  cluster.sync();  // peers are done reading this CTA's shared memory

  // 7. publish the slice; the last cluster to publish it combines it: an
  //    online softmax over the clusters' (max, sum, partial), its loads
  //    issued ahead of the arithmetic
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const int done = atomicAdd(&counters[bk * kCluster + rank], 1);
    is_last = done == n_clusters - 1;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int u = e_lo / 2 + threadIdx.x; u < (e_lo + per) / 2; u += kThreads) {
    const int g = 2 * u / hd;
    float M = -INFINITY, lsum = 0.f;
    float2 a = make_float2(0.f, 0.f);
#pragma unroll 8
    for (int c = 0; c < n_clusters; ++c) {
      const size_t pc = bk * n_clusters + c;
      const float* ml = part_ml + ((pc * kCluster + rank) * G + g) * 2;
      const float mcl = __ldcg(ml), lcl = __ldcg(ml + 1);
      const float2 x =
          __ldcg(reinterpret_cast<const float2*>(part_acc + pc * E) + u);
      const float m_new = fmaxf(M, mcl);
      if (m_new != -INFINITY) {  // exp(-inf) = 0 drops an empty side
        const float s_old = __expf(M - m_new), s_new = __expf(mcl - m_new);
        a.x = a.x * s_old + x.x * s_new;
        a.y = a.y * s_old + x.y * s_new;
        lsum = lsum * s_old + lcl * s_new;
        M = m_new;
      }
    }
    const float inv = lsum == 0.f ? 0.f : 1.f / lsum;
    const size_t o = (static_cast<size_t>(b) * H + kvh * G) * hd + 2 * u;
    if (out32 != nullptr)
      *reinterpret_cast<float2*>(out32 + o) = make_float2(a.x * inv,
                                                          a.y * inv);
    else
      *reinterpret_cast<__nv_bfloat162*>(out + o) =
          __floats2bfloat162_rn(a.x * inv, a.y * inv);
    if (lse != nullptr && 2 * u % hd == 0)  // once per head
      lse[static_cast<size_t>(b) * H + kvh * G + g] =
          lsum == 0.f ? -INFINITY : M + logf(lsum);
  }
  if (threadIdx.x == 0) counters[bk * kCluster + rank] = 0;
}

template <int MaxG>
int launch(const void* q, const void* k, const void* v, const void* slot_pos,
           void* out, void* out32, void* lse, void* part_acc, void* part_ml,
           void* counters, int B,
           int L, int H, int KV, int hd, int pos, int window, float softcap,
           float scale, int split, int n_splits, cudaStream_t st) {
  const Layout lay(split, H / KV, hd);
  if (lay.total > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      decode_attention_kernel<MaxG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, lay.total);
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_attention_kernel<MaxG><<<dim3(n_splits, KV, B), threads_for(MaxG),
                                  lay.total, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int*>(slot_pos),
      static_cast<bf16*>(out), static_cast<float*>(out32),
      static_cast<float*>(lse), static_cast<float*>(part_acc),
      static_cast<float*>(part_ml), static_cast<int*>(counters), L, H, KV, hd,
      pos, window, softcap, scale, split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

extern "C" int decode_attention_cluster() { return kCluster; }

extern "C" int decode_attention_max_split() { return kMaxSplit; }

// The device's SM count (cudaDevAttrMultiProcessorCount), or -1 on error.
extern "C" int decode_attention_sm_count(int device) {
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) !=
      cudaSuccess)
    return -1;
  return n;
}

// split: cache slots per CTA (1..decode_attention_max_split()); n_splits a
// multiple of decode_attention_cluster() with split * n_splits >= L.
// Scratch, float32: part_acc (B, KV, n_splits / 8, G * hd) and part_ml
// (B, KV, n_splits / 8, 8, G, 2); counters (B, KV, 8) int32, zero before the
// first launch (each launch leaves them zero). window <= 0: no window;
// softcap <= 0: no softcap. G = H / KV at most 16; hd a multiple of 16,
// at most 256; every pointer 16-byte aligned. out32 and lse null: the output
// in bf16 to out; else the float32 output (B, 1, H, hd) to out32 and the
// log-sum-exp (B, H) to lse, out unused.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* slot_pos,
    void* out, void* out32, void* lse, void* part_acc, void* part_ml,
    void* counters, int B, int L,
    int H, int KV, int hd, int pos, int window, float softcap, float scale,
    int split, int n_splits, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || L <= 0 || H <= 0 || KV <= 0 || H % KV != 0 ||
      H / KV > kMaxGroup || hd <= 0 || hd % 16 != 0 || hd > kMaxHeadDim ||
      split <= 0 ||
      split > kMaxSplit || n_splits <= 0 || n_splits % kCluster != 0 ||
      static_cast<long long>(split) * n_splits < L || KV > 65535 ||
      B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = H / KV;
#define DECODE_LAUNCH(MAXG)                                                   \
  launch<MAXG>(q, k, v, slot_pos, out, out32, lse, part_acc, part_ml,       \
               counters, B, L, H, KV, hd, pos, window, softcap, scale, split, \
               n_splits, st)
  if (G <= 2) return DECODE_LAUNCH(2);
  if (G <= 4) return DECODE_LAUNCH(4);
  if (G <= 8) return DECODE_LAUNCH(8);
  return DECODE_LAUNCH(16);
#undef DECODE_LAUNCH
}
