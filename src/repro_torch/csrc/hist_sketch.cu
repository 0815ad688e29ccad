// Per-cell log-bin histogram counts from bin indices: out[c, idx[t, c]] += 1.
//
// Replaces the TPU kernel src/repro/kernels/hist_sketch/kernel.py
// (_hist_kernel / hist_accum_tc, pl.pallas_call at :81), which contracted
// 0/1 indicator matrices on the matrix unit because a scatter is slow there.
// On Hopper a scatter into shared memory is cheap, so this kernel counts
// with shared-memory int32 atomics instead.
//
// Layout: idx (T, C) int32 row-major, -1 = skip, an index at or above n_bins
// counts in the top bin; out (C, n_bins) float32, added to in place (the
// caller zeroes it, or passes a running histogram). Counts are integers
// below 2^24, so the float sums are exact in any order: the result is
// bit-equal to the plain version however the CTAs interleave.
//
// Bound on this card: bytes. Each index is read once (4 B) and each output
// bin read and written once; there is one add per counted entry. At the
// percentile chunk (T = 4096, C = 12, 2048 bins) those bytes take 0.1 us,
// far below one launch, so the time there is latency: the launch, a round
// trip to memory and the barriers. The launch plan (kernel.py's
// launch_plan; the wrapper passes it in, this launcher checks it):
//   - the grid is (CTAs along T, groups of G cells). G is the widest of 8,
//     4, 2 that still gives two groups an SM (1 where the cells are fewer):
//     a row of a CTA's slab is then 16-32 contiguous bytes, read as 16-byte
//     loads where C is a multiple of 4 (V = 4). A thread's cells and first
//     row are fixed and its rows step by a constant (no division per
//     entry); it issues kUnroll loads before it counts any;
//   - where the groups alone leave SMs idle, the steps of a group are split
//     over a thread-block cluster of K <= 8 CTAs (and over several
//     clusters along T where K = 8 is not enough), so that the grid holds
//     at least one CTA an SM. Each CTA counts into its own shared G x
//     n_bins histogram; after a cluster barrier, rank r sums the r-th
//     share of the bins over its peers' shared memory (16-byte reads of
//     distributed shared memory) and adds it to out with a plain
//     read-add-write of each bin that moved. The clusters along T add
//     their shares into out with float atomics instead. Where the groups
//     fill the card (K = 1), a CTA walks all of T and adds its own bins.
// What was measured against that (kernel_bench.py's variants; PERF.md
// keeps the numbers): a warp that elected one lane per (cell, bin) with
// __match_any_sync before its shared atomics took 2x the time at C = 1440,
// and a vote that merged a warp whose entries all share one bin was slower
// too, even on such input: the shared-memory atomics take the contention as
// it comes. The combine reads every peer's whole histogram (G x n_bins x 4
// bytes a CTA), as many bytes as the slab's indices or more, so a cluster
// pays only where the card would otherwise idle.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "binning.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;        // loads in flight a thread
constexpr int kQuads = 2;         // 4-bin words a thread combines at once
constexpr int kMaxGroup = 8;      // cells a CTA: one 32-byte sector a row
constexpr int kMaxCluster = 8;    // CTAs a cluster: the portable limit
constexpr int kMaxSmem = 232448;  // bytes a Hopper block may use
constexpr int kMaxGroups = 65535;  // grid.y

// The shared histogram of G cells, in 16-byte words' worth of ints.
__host__ __device__ constexpr int hist_words(int G, int n_bins) {
  return (G * n_bins + 3) & ~3;
}

// Count entry b (-1: skip) of local cell `cell`.
__device__ __forceinline__ void count_entry(int* hist, int b, int cell,
                                            int n_bins) {
  if (b >= 0) atomicAdd(&hist[cell * n_bins + min(b, n_bins - 1)], 1);
}

// V consecutive cells of one step: loaded as one 4- or 16-byte word.
template <int V>
struct Entries;

template <>
struct Entries<1> {
  int b;
  __device__ void load(const int* p) { b = __ldg(p); }
  __device__ void skip() { b = kSkipBin; }
  __device__ void count(int* hist, int cell, int n_bins) const {
    count_entry(hist, b, cell, n_bins);
  }
};

template <>
struct Entries<4> {
  int4 b;
  __device__ void load(const int* p) {
    b = __ldg(reinterpret_cast<const int4*>(p));
  }
  __device__ void skip() {
    b = make_int4(kSkipBin, kSkipBin, kSkipBin, kSkipBin);
  }
  __device__ void count(int* hist, int cell, int n_bins) const {
    count_entry(hist, b.x, cell, n_bins);
    count_entry(hist, b.y, cell + 1, n_bins);
    count_entry(hist, b.z, cell + 2, n_bins);
    count_entry(hist, b.w, cell + 3, n_bins);
  }
};

// Count this CTA's slab, steps [t0, t0 + n) of cells [c0, c0 + g), into
// hist. A thread takes V consecutive cells of every RS-th step and issues
// its kUnroll loads before it counts them.
template <int V>
__device__ void count_slab(const int* __restrict__ idx, int* hist, int C,
                           int n_bins, int G, int g, int c0, int t0, int n) {
  const int cols = G / V;  // threads a step: 1, 2, 4 or 8
  const int tc = threadIdx.x % cols;
  const int tr = threadIdx.x / cols;
  const int RS = kThreads / cols;
  const int cell = tc * V;
  const bool live = cell < g;  // at V = 4, g is a multiple of 4
  const int sweeps = (n + RS - 1) / RS;
  const int* p = idx + static_cast<size_t>(t0 + tr) * C + c0 + cell;
  const size_t stride = static_cast<size_t>(RS) * C;
  for (int s = 0; s < sweeps; s += kUnroll) {
    Entries<V> e[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (live && (s + u) * RS + tr < n)
        e[u].load(p + (s + u) * stride);
      else
        e[u].skip();
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) e[u].count(hist, cell, n_bins);
  }
}

// Grid (K x clusters along T, groups of G cells), clusters of (K, 1, 1);
// CTA x counts steps [x S, (x + 1) S).
template <int V>
__global__ void __launch_bounds__(kThreads)
    hist_accum_kernel(const int* __restrict__ idx, float* __restrict__ out,
                      int T, int C, int n_bins, int G, int K, int S,
                      bool vec_out) {
  extern __shared__ __align__(16) int hist[];  // [G][n_bins], padded
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int c0 = blockIdx.y * G;
  const int g = min(G, C - c0);
  const int t0 = blockIdx.x * S;
  const int n = max(0, min(S, T - t0));
  const int words = hist_words(G, n_bins);
  for (int i = 4 * threadIdx.x; i < words; i += 4 * kThreads)
    *reinterpret_cast<int4*>(hist + i) = make_int4(0, 0, 0, 0);
  __syncthreads();

  // count this CTA's slab, then wait for every peer's
  count_slab<V>(idx, hist, C, n_bins, G, g, c0, t0, n);
  cluster.sync();

  // rank r's share of the group's bins: 4-aligned, no gap, no overlap
  const int total = g * n_bins;
  const int per = (total + 4 * K - 1) / (4 * K) * 4;
  const int lo = min(total, rank * per);
  const int hi = min(total, lo + per);
  const bool atomic_out = gridDim.x > K;  // more than one cluster along T
  float* o = out + static_cast<size_t>(c0) * n_bins;
  for (int i0 = lo + 4 * threadIdx.x; i0 < hi; i0 += 4 * kThreads * kQuads) {
    // kQuads words of bins summed over the peers, then their bins of out
    // read together, then added and written
    int4 s[kQuads];
#pragma unroll
    for (int q = 0; q < kQuads; ++q) {
      const int i = i0 + 4 * kThreads * q;
      s[q] = make_int4(0, 0, 0, 0);
#pragma unroll
      for (int peer = 0; peer < kMaxCluster; ++peer) {
        if (peer < K && i < hi) {
          const int4 v = *reinterpret_cast<const int4*>(
              cluster.map_shared_rank(hist, peer) + i);
          s[q].x += v.x;
          s[q].y += v.y;
          s[q].z += v.z;
          s[q].w += v.w;
        }
      }
    }
    float4 w[kQuads];
#pragma unroll
    for (int q = 0; q < kQuads; ++q) {
      const int i = i0 + 4 * kThreads * q;
      if (i + 4 <= hi && vec_out && !atomic_out &&
          (s[q].x | s[q].y | s[q].z | s[q].w) != 0)
        w[q] = *reinterpret_cast<const float4*>(o + i);
    }
#pragma unroll
    for (int q = 0; q < kQuads; ++q) {
      const int i = i0 + 4 * kThreads * q;
      if (i >= hi || (s[q].x | s[q].y | s[q].z | s[q].w) == 0) continue;
      const int c[4] = {s[q].x, s[q].y, s[q].z, s[q].w};
      const int m = min(4, hi - i);
      if (atomic_out) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (j < m && c[j] != 0)
            atomicAdd(o + i + j, static_cast<float>(c[j]));
      } else if (vec_out && m == 4) {
        w[q].x += static_cast<float>(c[0]);
        w[q].y += static_cast<float>(c[1]);
        w[q].z += static_cast<float>(c[2]);
        w[q].w += static_cast<float>(c[3]);
        *reinterpret_cast<float4*>(o + i) = w[q];
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (j < m && c[j] != 0) o[i + j] += static_cast<float>(c[j]);
      }
    }
  }
  cluster.sync();  // the peers are done reading this CTA's histogram
}

// The same grid, clusters and shared memory, doing nothing: the floor of a
// launch of this plan.
__global__ void __launch_bounds__(kThreads) hist_empty_kernel() {}

// The plan's launch configuration, or an error where the card would not
// take it or it would not cover (T, C).
cudaError_t configure(const void* idx, int T, int C, int n_bins, int cells,
                      int vec, int cluster, int clusters_t, int slice,
                      void* stream, cudaLaunchConfig_t* cfg,
                      cudaLaunchAttribute* attr) {
  const bool pow2 = cells > 0 && (cells & (cells - 1)) == 0 &&
                    cluster > 0 && (cluster & (cluster - 1)) == 0;
  if (T <= 0 || C <= 0 || n_bins <= 0 || !pow2 || cells > kMaxGroup ||
      cluster > kMaxCluster || clusters_t <= 0 || slice <= 0 ||
      (vec != 1 && vec != 4) ||
      (vec == 4 && (cells % 4 != 0 || C % 4 != 0 ||
                    reinterpret_cast<uintptr_t>(idx) % 16 != 0)) ||
      static_cast<long long>(cluster) * clusters_t > INT_MAX ||
      static_cast<long long>(slice) * cluster * clusters_t < T ||
      (C + cells - 1) / cells > kMaxGroups ||
      hist_words(cells, n_bins) > kMaxSmem / 4)
    return cudaErrorInvalidValue;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(cluster * clusters_t, (C + cells - 1) / cells, 1);
  cfg->blockDim = dim3(kThreads, 1, 1);
  cfg->dynamicSmemBytes = 4 * hist_words(cells, n_bins);
  cfg->stream = static_cast<cudaStream_t>(stream);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, const cudaLaunchConfig_t& cfg) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(cfg.dynamicSmemBytes));
}

}  // namespace

// idx (T, C) int32, out (C, n_bins) float32, both contiguous on `device`.
// The plan (kernel.py's launch_plan): cells a CTA (1, 2, 4 or 8), vec (4:
// 16-byte loads, which need cells and C multiples of 4 and idx 16-byte
// aligned; else 1), cluster (CTAs splitting one group's steps: 1, 2, 4 or
// 8), clusters_t (clusters along T) and slice (steps a CTA), with slice x
// cluster x clusters_t >= T. A plan the card refuses (its cluster, its
// shared memory) returns the launch's error.
extern "C" int hist_accum_launch(const void* idx, void* out, int T, int C,
                                 int n_bins, int cells, int vec, int cluster,
                                 int clusters_t, int slice, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  err = configure(idx, T, C, n_bins, cells, vec, cluster, clusters_t, slice,
                  stream, &cfg, &attr);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec_out = reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                       (cells * n_bins) % 4 == 0;
  const int* in = static_cast<const int*>(idx);
  float* o = static_cast<float*>(out);
  if (vec == 4) {
    err = allow_smem(hist_accum_kernel<4>, cfg);
    if (err == cudaSuccess)
      err = cudaLaunchKernelEx(&cfg, hist_accum_kernel<4>, in, o, T, C,
                               n_bins, cells, cluster, slice, vec_out);
  } else {
    err = allow_smem(hist_accum_kernel<1>, cfg);
    if (err == cudaSuccess)
      err = cudaLaunchKernelEx(&cfg, hist_accum_kernel<1>, in, o, T, C,
                               n_bins, cells, cluster, slice, vec_out);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel on the launch configuration of the same plan: the time
// of a launch with nothing in it (the benchmarks' latency floor).
extern "C" int hist_accum_empty_launch(const void* idx, int T, int C,
                                       int n_bins, int cells, int vec,
                                       int cluster, int clusters_t, int slice,
                                       int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  err = configure(idx, T, C, n_bins, cells, vec, cluster, clusters_t, slice,
                  stream, &cfg, &attr);
  if (err == cudaSuccess) err = allow_smem(hist_empty_kernel, cfg);
  if (err == cudaSuccess) err = cudaLaunchKernelEx(&cfg, hist_empty_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
