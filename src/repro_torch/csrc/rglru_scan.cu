// RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t along time, h_{-1} = 0,
// float32.
//
// Replaces the TPU kernel src/repro/kernels/rglru_scan/kernel.py
// (_scan_kernel / chunked_linear_scan_raw, pl.pallas_call at :46). The plain
// PyTorch version is repro_torch/kernels/rglru_scan/ref.py.
//
// Layout: a, b, h (B, L, W), contiguous, W a multiple of 4 (rows of 16-byte
// multiples, as TMA needs). The TPU grid walked time blocks in order and
// carried h across them in VMEM scratch. Here a CTA owns a strip of 32 lanes
// of one batch row and walks the whole sequence, so h stays in a register of
// its lane and nothing is carried between CTAs. Each step is __fmul_rn then
// __fadd_rn, the separately rounded multiply and add of the plain version,
// in the same time order: the kernel equals it bit for bit.
//
// Bound on this card: bytes (a and b read once, h written once, 2 flops per
// 12 bytes): 0.060 ms at recurrentgemma-9b's (1, 4096, 4096). The chain of
// one multiply and one add a step is ~8 dependent clocks, 4,096 steps
// ~0.02 ms, so what the card needs is bytes in flight: at 3.35 TB/s and
// ~1 us of latency, 3+ MB. With B = 1 there are only 128 strips, so each
// CTA keeps its own deep ring. One thread of warp 0 (the producer) asks the
// Tensor Memory Accelerator for each time tile of the strip's a and b (one
// box of 32 lanes x kTile steps per operand, through 3-D tensor maps over
// (W, L, B), so a ragged last tile and lanes past W are zero-filled inside
// their own batch row) into an S-stage ring of shared memory, each stage's
// bytes counted on its full mbarrier. Warp 1 (the consumer) waits on it,
// runs the recurrence from shared memory, one lane per thread, writes the
// tile's h into one of two shared-memory tiles, frees the stage on its
// empty mbarrier, and one lane hands the h tile to the TMA as one box store
// (clipped at L and W) while the next tile runs. At 4 stages of 64 steps a
// CTA has 64 KB in flight, 8 MB across 128 CTAs.
//
// A sequence of one tile or less (a served prompt) has nothing to overlap
// the TMA's round trip with: the ring's own run took 1.84 us at
// (1, 16, 4096) on the H100, the first port's direct loads 1.41 us, a gap
// that the tensor-map parameters, -lcuda and the dynamic shared memory do
// not explain (each added to the first port alone costs nothing). So such a
// sequence takes rglru_scan_kernel_one_tile: one thread per lane of the
// same strips, its steps loaded straight from global memory 16 at a time,
// the same multiply and add in the same order. (Loading all 64 steps at
// once, each load predicated on the length, ran 4.5 us at 16 steps.)
//
// The first design of this ring staged with cp.async and let the consumer
// store each step's 128-byte row itself: 0.20 ms at (1, 4096, 4096) on the
// H100, against 0.055 ms with the stores taken out and 0.046 ms for the
// loads alone; the loads' and the stores' requests shared the SM's
// load/store path. Here neither passes through it.
#include <cuda.h>  // CUtensorMap, cuTensorMapEncodeTiled (linked with -lcuda)
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLanes = 32;    // lanes of W per CTA, one box row (128 bytes)
constexpr int kThreads = 64;  // warp 0 producer, warp 1 consumer
constexpr int kTile = 64;     // steps per stage; a shorter sequence is direct
constexpr int kMaxStages = 4;
constexpr int kUnroll = 16;   // steps the direct kernel loads at once
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may use

// The ring: stages x (a tile, b tile) of kTile x 32 floats, two h tiles,
// then the full and empty mbarriers of each stage. Stages 0: the direct
// kernel, which has none.
__host__ __device__ constexpr int layout_bytes(int stages) {
  return stages == 0 ? 0
                     : (stages + 1) * 2 * kTile * kLanes * 4 + 2 * stages * 8;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// One arrival that also expects `bytes` of TMA transactions this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Block until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// TMA: the box at (lane c0, step c1, batch c2) of `map` into shared memory
// at `dst`, completing its bytes on barrier `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// TMA: shared memory at `src` to the box at (c0, c1, c2) of `map`, in this
// thread's current bulk group; elements past the tensor are not written.
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Until at most `pending` of this thread's bulk groups still read shared
// memory. Their writes to global memory complete on their own, before the
// kernel is done; a CTA only has to keep its shared memory until read.
template <int pending>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(pending)
               : "memory");
}
// Fetch a tensor map ahead of its first use (the first tile would wait for
// it otherwise).
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}
// This thread's shared-memory writes become visible to the TMA.
__device__ __forceinline__ void fence_to_tma() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const __grid_constant__ CUtensorMap tm_a,
                  const __grid_constant__ CUtensorMap tm_b,
                  const __grid_constant__ CUtensorMap tm_h, int L,
                  int n_strips, int S) {
  extern __shared__ __align__(128) float smem[];
  const int strip = static_cast<int>(blockIdx.x) % n_strips;
  const int bi = static_cast<int>(blockIdx.x) / n_strips;
  const int w0 = strip * kLanes;
  const int tile_floats = kTile * kLanes;
  float* h_tiles = smem + S * 2 * tile_floats;  // [2][kTile][32]
  uint64_t* full = reinterpret_cast<uint64_t*>(h_tiles + 2 * tile_floats);
  uint64_t* empty = full + S;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_tiles = (L + kTile - 1) / kTile;
  if (threadIdx.x == 32) prefetch_map(&tm_h);
  if (threadIdx.x == 0) {
    prefetch_map(&tm_a);
    prefetch_map(&tm_b);
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 1);    // the producer's arrival, plus the bytes
      mbar_init(empty + s, 32);  // one per consumer lane
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 0) {
    // producer: tile k into stage k % S once the consumer has freed it
    if (lane == 0) {
      for (int k = 0; k < n_tiles; ++k) {
        const int s = k % S;
        if (k >= S) mbar_wait(empty + s, ((k / S) - 1) & 1);
        float* stage = smem + s * 2 * tile_floats;
        mbar_expect_tx(full + s, 2 * 4 * tile_floats);
        tma_load(stage, &tm_a, full + s, w0, k * kTile, bi);
        tma_load(stage + tile_floats, &tm_b, full + s, w0, k * kTile, bi);
      }
    }
  } else {
    // consumer: the recurrence in time order, one lane per thread
    float hv = 0.f;
    for (int k = 0; k < n_tiles; ++k) {
      const int s = k % S;
      mbar_wait(full + s, (k / S) & 1);
      const float* as = smem + s * 2 * tile_floats + lane;
      const float* bs = as + tile_floats;
      const int t0 = k * kTile, n = min(kTile, L - t0);
      // this tile's h goes where the store of tile k - 2 has read from
      float* hs = h_tiles + (k & 1) * tile_floats;
      if (lane == 0) bulk_wait_read<1>();
      __syncwarp();
      int r = 0;
      for (; r + 8 <= n; r += 8) {
        float av[8], bv[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          av[u] = as[(r + u) * kLanes];
          bv[u] = bs[(r + u) * kLanes];
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          hv = __fadd_rn(__fmul_rn(av[u], hv), bv[u]);
          hs[(r + u) * kLanes + lane] = hv;
        }
      }
      for (; r < n; ++r) {
        hv = __fadd_rn(__fmul_rn(as[r * kLanes], hv), bs[r * kLanes]);
        hs[r * kLanes + lane] = hv;
      }
      mbar_arrive(empty + s);
      fence_to_tma();
      __syncwarp();
      if (lane == 0) {
        tma_store(&tm_h, hs, w0, t0, bi);
        bulk_commit();
      }
    }
    if (lane == 0) bulk_wait_read<0>();
  }
}

// A sequence of at most kTile steps: one thread per lane of the CTA's strip,
// as the ring's strips are laid out; the first port's loop, which loads 16
// steps before it runs them, in the ring's order of operations.
__global__ void __launch_bounds__(kLanes)
rglru_scan_kernel_one_tile(const float* __restrict__ a,
                           const float* __restrict__ b, float* __restrict__ h,
                           int L, int W, int n_strips) {
  const int strip = static_cast<int>(blockIdx.x) % n_strips;
  const int bi = static_cast<int>(blockIdx.x) / n_strips;
  const int w = strip * kLanes + static_cast<int>(threadIdx.x);
  if (w >= W) return;
  const size_t base = static_cast<size_t>(bi) * L * W + w;
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

// A 3-D map over (W, L, B) float32 with a box of 32 lanes x kTile steps.
CUresult make_map(CUtensorMap* map, const void* ptr, int B, int L, int W) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {4ull * W, 4ull * W * L};
  const cuuint32_t box[3] = {kLanes, kTile, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return cuTensorMapEncodeTiled(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" const char* error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// The dynamic shared memory of a CTA with `stages` stages (0: the direct
// kernel), for the launch plan in kernel.py to be held against.
extern "C" int rglru_scan_smem(int stages) { return layout_bytes(stages); }

// One CTA per (strip of 32 lanes, batch row). stages 0: the direct kernel,
// for L <= kTile; else the ring, 1 <= stages <= kMaxStages, for L > kTile.
// W a multiple of 4 and every pointer 16-byte aligned.
extern "C" int rglru_scan_launch(const void* a, const void* b, void* h, int B,
                                 int L, int W, int stages, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || L <= 0 || W <= 0 || W % 4 != 0 || stages < 0 ||
      stages > kMaxStages || (stages == 0) != (L <= kTile) || !aligned16(a) ||
      !aligned16(b) || !aligned16(h))
    return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = layout_bytes(stages);
  const int n_strips = (W + kLanes - 1) / kLanes;
  const long long n_blocks = static_cast<long long>(n_strips) * B;
  if (bytes > kMaxSmem || n_blocks > (1LL << 31) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (stages == 0) {
    rglru_scan_kernel_one_tile<<<static_cast<unsigned>(n_blocks), kLanes, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<float*>(h), L, W, n_strips);
    return static_cast<int>(cudaGetLastError());
  }
  CUtensorMap ma, mb, mh;
  if (make_map(&ma, a, B, L, W) != CUDA_SUCCESS ||
      make_map(&mb, b, B, L, W) != CUDA_SUCCESS ||
      make_map(&mh, h, B, L, W) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(rglru_scan_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  rglru_scan_kernel<<<static_cast<unsigned>(n_blocks), kThreads, bytes,
                      static_cast<cudaStream_t>(stream)>>>(ma, mb, mh, L,
                                                           n_strips, stages);
  return static_cast<int>(cudaGetLastError());
}
