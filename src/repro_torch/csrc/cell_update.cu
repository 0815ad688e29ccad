// One chunk of the sweep engine's discrete-event simulation, for every cell.
//
// Replaces the TPU kernel src/repro/kernels/cell_update/kernel.py
// (_cell_kernel / cell_update_tc, pl.pallas_call at :378). The arithmetic is
// that of the plain PyTorch version, repro_torch/kernels/cell_update/ref.py
// (step_cell, kahan_fold), which is the bit anchor of this kernel.
//
// Work: each cell is an independent FIFO replication queue; its arrivals
// are a sequential recurrence in T (gather the free times of the request's
// copy servers, apply the policy / service-model / degradation / timed
// dispatch selects, scatter the new free times, take the winning response,
// fold it into a gated Kahan sum). Parallelism is therefore across cells
// only: one thread per cell, 32 cells per block. A thread keeps its cell's
// N free times in shared memory (laid out [server][thread], so the threads
// of a warp touching the same server index hit different banks) and its
// Kahan state in registers. The sampled inputs are per SEED row; cells are
// ordered seed-slowest, so the threads of a warp mostly read the same row
// and the loads broadcast or hit L1/L2.
//
// Bound on this card: the work per cell is a chain of dependent steps, so
// the kernel is bound by the latency of one step times T, not by bytes or
// by issue rate — the byte and operation counts are a few microseconds at
// the fig2 shape. This first version does nothing to hide that latency
// beyond running many cells at once; a warp per cell, or staging the input
// rows in shared memory with TMA ahead of the recurrence, is later work.
//
// Histogram: when bins is not null the kernel writes each step's log-bin
// index (or -1 for a step with zero weight) to bins (T, C); the caller folds
// them with the hist_accum kernel (hist_sketch.cu). Writes of one step are
// coalesced across the cells of a warp.
//
// Bit rules (the kernel must equal the plain version bit for bit):
//   * built with --fmad=false, and every multiply/add/subtract below is an
//     explicitly rounded intrinsic, so a*b+c is never contracted;
//   * t = cum / rate is an IEEE division (__fdiv_rn);
//   * the free-time gather reads the old grid for every copy before any
//     write, and the scatter writes in copy order (last write wins on a
//     duplicated server, as the plain version's sequential scatter does);
//   * the bin index uses full-precision logf and a truncating conversion,
//     and a zero-weight step is masked before any conversion.
#include <math.h>

#include "binning.cuh"

namespace {

constexpr int kThreads = 32;
constexpr int kMaxK = 16;
constexpr int kMaxSmem = 232448;

// repro_torch.core.scenario codes
constexpr int kCancelOnComplete = 1;
constexpr int kReplicateToIdle = 2;
constexpr int kTimeoutRetry = 3;
constexpr int kHedgeAfterDelay = 4;
constexpr int kServerDependent = 1;
// TIMEOUT_RETRY backoff cap (repro_torch.kernels.cell_update.ref)
constexpr int kBackoffCap = 8;

struct CellParams {
  const int* seed_idx;     // (C,) input row of gaps / servers per cell
  const int* svc_idx;      // (C,) input row of services, or null (= seed_idx)
  const int* k_count;      // (C,) copies per request (prefix of k_max)
  const int* policy;       // (C,) scenario.Policy code
  const int* model;        // (C,) scenario.ServiceModel code
  const float* rates;      // (C,) arrival rate
  const float* ovh;        // (C,) client overhead
  const float* mix;        // (C,) SERVER_DEPENDENT blend
  const float* p_slow;     // (C,) straggler probability
  const float* slow_factor;  // (C,) straggler inflation
  const float* p_fail;     // (C,) blackhole probability
  const float* delay;      // (C,) timed-policy delay
};

__global__ void __launch_bounds__(kThreads)
cell_update_kernel(float* __restrict__ free_, float* __restrict__ ssum_,
                   float* __restrict__ comp_, float* __restrict__ cnt_,
                   int* __restrict__ bins, const float* __restrict__ cum,
                   const float* __restrict__ warm,
                   const float* __restrict__ valid,
                   const int* __restrict__ servers,
                   const float* __restrict__ services, CellParams p, int C,
                   int N, int T, int k_max, int n_svc, int has_shared,
                   int n_bins, float log_lo, float scale) {
  extern __shared__ float free_sh[];  // [N][kThreads]
  const int tid = threadIdx.x;
  const int c = blockIdx.x * kThreads + tid;
  if (c >= C) return;  // no barrier follows: each thread owns its column

  float* fr = free_sh + tid;
  for (int n = 0; n < N; ++n) fr[n * kThreads] = free_[static_cast<size_t>(c) * N + n];

  const int seed = p.seed_idx[c];
  const int srow = p.svc_idx ? p.svc_idx[c] : seed;
  const int kc = p.k_count[c];
  const int pol = p.policy[c];
  const bool is_sd = p.model[c] == kServerDependent;
  const bool is_cancel = pol == kCancelOnComplete;
  const bool is_idle = pol == kReplicateToIdle;
  const bool is_retry = pol == kTimeoutRetry;
  const bool is_timed = is_retry || pol == kHedgeAfterDelay;
  const float rate = p.rates[c], ovh = p.ovh[c], mix = p.mix[c];
  const float slow = p.slow_factor[c], p_fail = p.p_fail[c];
  const float delay = p.delay[c];
  const float one_m_mix = __fsub_rn(1.0f, mix);
  const float one_m_slow = __fsub_rn(1.0f, p.p_slow[c]);
  const int n_base = k_max + (has_shared ? 1 : 0);
  const bool has_degr = n_svc > n_base;

  const float* cum_row = cum + static_cast<size_t>(seed) * T;
  const int* srv_row = servers + static_cast<size_t>(seed) * T * k_max;
  const float* svc_rows = services + static_cast<size_t>(srow) * T * n_svc;
  float ssum = ssum_[c], comp = comp_[c], cnt = cnt_[c];

  for (int s = 0; s < T; ++s) {
    const float t = __fdiv_rn(cum_row[s], rate);
    const float* row = svc_rows + static_cast<size_t>(s) * n_svc;
    const int* srvs = srv_row + static_cast<size_t>(s) * k_max;
    const float shared = has_shared ? row[k_max] : row[0];

    int srv[kMaxK];
    float cur[kMaxK], svc[kMaxK], fin[kMaxK], nv[kMaxK];
    bool mask[kMaxK], alive[kMaxK];
    float t_win = INFINITY, idle_best = INFINITY;
#pragma unroll
    for (int j = 0; j < kMaxK; ++j) {
      if (j < k_max) {
        srv[j] = srvs[j];
        if (static_cast<unsigned>(srv[j]) >= static_cast<unsigned>(N)) __trap();
        cur[j] = fr[srv[j] * kThreads];
        float x = row[j];
        if (is_sd) x = __fadd_rn(__fmul_rn(mix, shared), __fmul_rn(one_m_mix, x));
        const float u = has_degr ? row[n_base + j] : 0.0f;
        if (u >= one_m_slow) x = __fmul_rn(x, slow);
        svc[j] = x;
        alive[j] = u >= p_fail;
        mask[j] = j < kc;
        fin[j] = __fadd_rn(fmaxf(cur[j], t), x);
        if (mask[j] && alive[j]) t_win = fminf(t_win, fin[j]);
        if (mask[j] && (j == 0 || cur[j] <= t) && alive[j])
          idle_best = fminf(idle_best, fin[j]);
      }
    }

    float best = INFINITY;
    if (is_timed) {
      // sequential dispatch over the copy budget (ref.step_cell)
      const float d_eff = valid[s] > 0.0f ? delay : 0.0f;
      const bool fire_all = d_eff <= 0.0f;
      int retry_off = 0;  // sum_{i<j} min(2^i, cap), exact in float
#pragma unroll
      for (int j = 0; j < kMaxK; ++j) {
        if (j < k_max) {
          const float coeff = static_cast<float>(is_retry ? retry_off : j);
          retry_off += min(1 << j, kBackoffCap);
          const float disp_t = __fadd_rn(t, __fmul_rn(d_eff, coeff));
          const bool alive_eff = alive[j] || (is_retry && j == kc - 1);
          const float fired = __fadd_rn(fmaxf(cur[j], disp_t), svc[j]);
          const bool made = j == 0 ? mask[0]
                                   : (mask[j] && (fire_all || best > disp_t));
          if (made && alive_eff) best = fminf(best, fired);
          nv[j] = (made && alive_eff) ? fired : cur[j];
        }
      }
    }

#pragma unroll
    for (int j = 0; j < kMaxK; ++j) {
      if (j < k_max) {
        const bool ma = mask[j] && alive[j];
        if (is_cancel) {
          nv[j] = ma ? fmaxf(cur[j], t_win) : cur[j];
        } else if (is_idle) {
          nv[j] = (ma && (j == 0 || cur[j] <= t)) ? fin[j] : cur[j];
        } else if (!is_timed) {
          nv[j] = ma ? fin[j] : cur[j];
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kMaxK; ++j) {
      if (j < k_max) fr[srv[j] * kThreads] = nv[j];  // copy order: last wins
    }

    const float won = is_idle ? idle_best : (is_timed ? best : t_win);
    const float resp = __fadd_rn(__fsub_rn(won, t), ovh);
    const float w_live = isfinite(resp) ? warm[s] : 0.0f;
    // gated Kahan step (ref.kahan_fold)
    const float y = __fsub_rn(resp, comp);
    const float tot = __fadd_rn(ssum, y);
    const float comp_new = __fsub_rn(__fsub_rn(tot, ssum), y);
    if (w_live > 0.0f) {
      ssum = tot;
      comp = comp_new;
    }
    cnt = __fadd_rn(cnt, w_live);
    if (bins) {
      bins[static_cast<size_t>(s) * C + c] =
          w_live > 0.0f ? log_bin(resp, log_lo, scale, n_bins) : kSkipBin;
    }
  }

  for (int n = 0; n < N; ++n) free_[static_cast<size_t>(c) * N + n] = fr[n * kThreads];
  ssum_[c] = ssum;
  comp_[c] = comp;
  cnt_[c] = cnt;
}

}  // namespace

extern "C" int cell_update_launch(
    void* free_, void* ssum, void* comp, void* cnt, void* bins,
    const void* cum, const void* warm, const void* valid, const void* servers,
    const void* services, const void* seed_idx, const void* svc_idx,
    const void* k_count, const void* policy, const void* model,
    const void* rates, const void* ovh, const void* mix, const void* p_slow,
    const void* slow_factor, const void* p_fail, const void* delay, int C,
    int N, int T, int k_max, int n_svc, int has_shared, int n_bins,
    float log_lo, float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(N) * kThreads * sizeof(float);
  if (C <= 0 || T <= 0 || N <= 0 || k_max < 1 || k_max > kMaxK ||
      k_max > N || smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(cell_update_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  CellParams p{static_cast<const int*>(seed_idx),
               static_cast<const int*>(svc_idx),
               static_cast<const int*>(k_count),
               static_cast<const int*>(policy),
               static_cast<const int*>(model),
               static_cast<const float*>(rates),
               static_cast<const float*>(ovh),
               static_cast<const float*>(mix),
               static_cast<const float*>(p_slow),
               static_cast<const float*>(slow_factor),
               static_cast<const float*>(p_fail),
               static_cast<const float*>(delay)};
  const dim3 grid((C + kThreads - 1) / kThreads);
  cell_update_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(free_), static_cast<float*>(ssum),
      static_cast<float*>(comp), static_cast<float*>(cnt),
      static_cast<int*>(bins), static_cast<const float*>(cum),
      static_cast<const float*>(warm), static_cast<const float*>(valid),
      static_cast<const int*>(servers), static_cast<const float*>(services), p,
      C, N, T, k_max, n_svc, has_shared, n_bins, log_lo, scale);
  return static_cast<int>(cudaGetLastError());
}
