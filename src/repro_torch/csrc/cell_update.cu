// One chunk of the sweep engine's discrete-event simulation, for every cell,
// with each cell's log-bin response histogram kept on chip.
//
// Replaces the TPU kernel src/repro/kernels/cell_update/kernel.py
// (_cell_kernel / cell_update_tc, pl.pallas_call at :378), which also keeps
// the histogram on chip for a chunk. The arithmetic is that of the plain
// PyTorch version, repro_torch/kernels/cell_update/ref.py (step_cell,
// kahan_fold, bin_indices + hist_accum_ref), the bit anchor of this kernel.
//
// Work: each cell is an independent FIFO replication queue; its arrivals are
// a sequential recurrence in T (gather the free times of the request's copy
// servers, select by policy, scatter the new free times in copy order, take
// the winning response, fold it into a gated Kahan sum). Parallelism is
// across cells only, and the byte and operation counts are microseconds at
// the main path's shapes: the kernel is bound by the latency of one step of
// the recurrence times T. So the design keeps on a step's path only what
// depends on the free times, and does everything else in other warps:
//
//   * A block holds G <= 32 cells, one per lane in each of its seven warps,
//     and the grid ceil(C / G) blocks. The launch plan
//     (kernels/cell_update/kernel.py) picks G, the tile of TS steps and the
//     Q prepared stages from the chunk's shape.
//   * Producers (warps 1-4) take the tiles in turn. Each stages its tile's
//     inputs in shared memory with cp.async, double-buffered: the block's
//     distinct seed rows of cum and servers, its distinct service rows and
//     the step weights (cells are ordered seed-slowest, so a block touches
//     few rows). It then computes every cell's carry-independent step
//     inputs, as ref.py does before its loop: t = cum / rate (first, on
//     its own: the division's slow path is a branch), then, four steps at
//     a time with all their loads ahead of their stores, the
//     SERVER_DEPENDENT blend, the straggler and blackhole selects, the copy
//     mask, the timed policies' dispatch times, and each copy's server as
//     a byte offset into the free-time grid with its live and fire-all
//     bits. It checks the server indices (a bad one traps). The results go
//     into a ring of Q slots (mbarriers full / done / empty; one producer
//     fills a given slot).
//   * The consumer (warp 0) runs the recurrence: gather, fmax/fadd, select,
//     scatter, winning finish. It is templated on K, the smallest of
//     {1, 2, 3, 4, 8, 16} that holds k_max, so no loop is wider than the
//     copies (copies past k_max write a scratch row of the grid), and takes
//     a loop without the per-step choice of policy where every cell of the
//     warp replicates to all. The free times stay in shared memory
//     ([server][cell]: a warp's lanes hit different banks). At step s the
//     codes of step s + 2 are loaded and the inputs and gather of step
//     s + 1 issued ahead of step s's scatter, with s's new values forwarded
//     into that gather where the servers match (in copy order): the
//     shared-memory round trip is off the chain.
//   * The fold warp (warp 5) turns each winning finish into the response
//     and folds it into the gated Kahan sum and the count.
//   * The histogram warp (warp 6), with the sketch on, bins the same
//     responses with log_bin and counts them in 16-bit counters per cell
//     ([bin / 2][cell] words, shared-memory atomic adds, four steps' loads
//     ahead of their adds). The counters are flushed into hist every
//     kFlushSteps steps, so they never overflow, and by the whole block at
//     the end of the chunk. Counts are integers below 2^24, so the float
//     sums equal the plain version's in any order.
//
// Bit rules (the kernel must equal the plain version bit for bit):
//   * built with --fmad=false, and every multiply/add/subtract below is an
//     explicitly rounded intrinsic, so a*b+c is never contracted;
//   * t = cum / rate is an IEEE division (__fdiv_rn);
//   * the gather reads the old grid for every copy before any write, and
//     the scatter writes in copy order (last write wins on a duplicated
//     server, as the plain version's sequential scatter does);
//   * the bin index uses full-precision logf and a truncating conversion,
//     and a zero-weight step is never counted.
#include <math.h>
#include <stdint.h>

#include "binning.cuh"

namespace {

constexpr int kMaxK = 16;
constexpr int kMaxServers = 16384;
constexpr int kMaxCells = 32;       // cells per block: one per lane
constexpr int kProducers = 4;
// warps: the consumer, the producers, the fold warp, the histogram warp
constexpr int kThreads = 32 * (3 + kProducers);
constexpr int kMaxStages = 8;
constexpr int kFlushSteps = 8192;   // 16-bit counters flushed before 65536
constexpr int kMaxSmem = 232448;    // bytes a Hopper block may use
constexpr int kStaticSmem = 1024;   // reserved for the static arrays below

// repro_torch.core.scenario codes
constexpr int kCancelOnComplete = 1;
constexpr int kReplicateToIdle = 2;
constexpr int kTimeoutRetry = 3;
constexpr int kHedgeAfterDelay = 4;
constexpr int kServerDependent = 1;
// TIMEOUT_RETRY backoff cap (repro_torch.kernels.cell_update.ref)
constexpr int kBackoffCap = 8;

// a prepared copy: byte offset of its server's free time, and two flags
constexpr uint32_t kLive = 1u << 31;
constexpr uint32_t kFire = 1u << 30;
constexpr uint32_t kOffset = kFire - 1;

extern __shared__ __align__(16) unsigned char smem[];

__host__ __device__ constexpr int align16(int x) { return (x + 15) & ~15; }

// Dynamic shared memory, in bytes from its base: the free-time grid
// [N + 1][G] (row N takes the stores of copies past k_max), the histogram
// words [(n_bins + 1) / 2][G], Q prepared slots and two raw buffers per
// producer, each of TS steps. The launch plan in kernel.py computes the
// same sizes, and its wrapper holds them to cell_update_smem below.
struct Layout {
  int G, TS, Q, words;
  int hist, slots, slot_bytes, raw, raw_bytes, total;
  // within a slot: t [TS][G], winning finish [TS][G], service [TS][K][G],
  // dispatch time [TS][K][G] (timed grids), copy code [TS][K][G], weight
  // [TS]
  int s_t, s_won, s_svc, s_d, s_code, s_warm;
  // within a raw buffer: cum [rs][TS], servers [rs][TS][k_max], services
  // [rv][TS][n_svc], valid [TS], warm [TS]
  int r_cum, r_srv, r_svc, r_valid, r_warm;
};

__host__ __device__ inline Layout make_layout(int G, int TS, int Q, int N,
                                              int K, int k_max, int n_svc,
                                              int n_bins, int rs, int rv,
                                              bool timed) {
  Layout L{};
  L.G = G;
  L.TS = TS;
  L.Q = Q;
  L.words = (n_bins + 1) / 2;
  int o = align16((N + 1) * G * 4);
  L.hist = o;
  o += align16(L.words * G * 4);
  int s = 0;
  L.s_t = s;
  s += align16(TS * G * 4);
  L.s_won = s;
  s += align16(TS * G * 4);
  L.s_svc = s;
  s += align16(TS * K * G * 4);
  L.s_d = s;
  s += timed ? align16(TS * K * G * 4) : 0;
  L.s_code = s;
  s += align16(TS * K * G * 4);
  L.s_warm = s;
  s += align16(TS * 4);
  L.slot_bytes = s;
  L.slots = o;
  o += Q * s;
  int r = 0;
  L.r_cum = r;
  r += align16(rs * TS * 4);
  L.r_srv = r;
  r += align16(rs * TS * k_max * 4);
  L.r_svc = r;
  r += align16(rv * TS * n_svc * 4);
  L.r_valid = r;
  r += align16(TS * 4);
  L.r_warm = r;
  r += align16(TS * 4);
  L.raw_bytes = r;
  L.raw = o;
  o += 2 * kProducers * r;
  L.total = o;
  return L;
}

struct Args {
  float* free_;
  float* ssum;
  float* comp;
  float* cnt;
  float* hist;  // (C, n_bins), added to; null without the sketch
  const float* cum;
  const float* warm;
  const float* valid;
  const int* servers;
  const float* services;
  const int* seed_idx;  // (C,) input row of gaps / servers per cell
  const int* svc_idx;   // (C,) input row of services, or null (= seed_idx)
  const int* k_count;   // (C,) copies per request (prefix of k_max)
  const int* policy;    // (C,) scenario.Policy code
  const int* model;     // (C,) scenario.ServiceModel code
  const float* rates;   // (C,) arrival rate
  const float* ovh;     // (C,) client overhead
  const float* mix;     // (C,) SERVER_DEPENDENT blend
  const float* p_slow;  // (C,) straggler probability
  const float* slow_factor;  // (C,) straggler inflation
  const float* p_fail;  // (C,) blackhole probability
  const float* delay;   // (C,) timed-policy delay
  int C, N, T, k_max, n_svc, has_shared, n_bins, S, S_svc;
  float log_lo, scale;
  Layout L;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The shared-memory address of the dynamic region, in a register the
// compiler cannot recompute (it would read the CTA's cluster rank again at
// every use).
__device__ __forceinline__ uint32_t smem_base() {
  uint32_t r;
  asm volatile("mov.u32 %0, %1;\n" : "=r"(r) : "r"(smem_addr(smem)));
  return r;
}

// Shared-memory loads and stores at 32-bit shared addresses, in program
// order: the consumer's gather of a step must precede the scatter of the
// step before it.
__device__ __forceinline__ float lds(uint32_t a) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(a) : "memory");
  return v;
}
__device__ __forceinline__ uint32_t ldsu(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(a) : "memory");
  return v;
}
__device__ __forceinline__ void sts(uint32_t a, float v) {
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(a), "f"(v) : "memory");
}
__device__ __forceinline__ void stsu(uint32_t a, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(a), "r"(v) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// One arrival for the lanes of `mask`, after their shared-memory writes.
__device__ __forceinline__ void warp_arrive(uint64_t* bar, int lane,
                                            unsigned mask) {
  __syncwarp(mask);
  if (lane == 0)
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

// `n` 4-byte words from global `src` to shared address `dst`, across the
// warp.
__device__ __forceinline__ void stage_words(uint32_t dst, const void* src,
                                            int n, int lane) {
  const uint32_t* s = static_cast<const uint32_t*>(src);
  for (int i = lane; i < n; i += 32)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     dst + 4 * i),
                 "l"(s + i)
                 : "memory");
}

// Shared state of a block besides the Layout's regions.
struct Block {
  uint64_t* full;   // [Q] producer -> consumer
  uint64_t* done;   // [Q] consumer -> fold and histogram warps
  uint64_t* empty;  // [Q] fold and histogram warps -> producer
  const int* rows;  // [2][32]: the block's distinct seed rows, service rows
  const int* slot;  // [2][32 + 1]: each lane's index into those, and counts
  int c0, ng;       // first cell, live cells
  int qmask, qshift;  // tile -> stage: tile & qmask, use: tile >> qshift
                      // (Q is a power of two and a multiple of kProducers,
                      // so each stage has one producer)
  unsigned cells;   // mask of the lanes that hold a cell slot (lane < G)
};

// The consumer's wait for a prepared slot.
__device__ __forceinline__ void consumer_wait(const Block& b, int tile) {
  mbar_wait(b.full + (tile & b.qmask), (tile >> b.qshift) & 1);
}

// ---------------------------------------------------------------- producer
template <int K, bool kTimed>
__device__ void producer(const Args& a, const Block& b, int p, int lane) {
  // steps prepared together: their loads in flight at once
  constexpr int kGroup = K <= 4 ? 4 : (K <= 8 ? 2 : 1);
  const Layout& L = a.L;
  const int G = L.G, TS = L.TS, T = a.T, k_max = a.k_max;
  const int n_svc = a.n_svc, N = a.N;
  const bool act = lane < G;
  const int c = b.c0 + min(lane, b.ng - 1);
  const int kc = a.k_count[c];
  const int pol = a.policy[c];
  const bool is_sd = a.model[c] == kServerDependent;
  const bool is_retry = pol == kTimeoutRetry;
  const bool is_timed = is_retry || pol == kHedgeAfterDelay;
  if (!kTimed && is_timed) __trap();  // the launch said the grid has none
  const float rate = a.rates[c], mix = a.mix[c];
  const float slow = a.slow_factor[c], p_fail = a.p_fail[c];
  const float delay = a.delay[c];
  const float one_m_mix = __fsub_rn(1.0f, mix);
  const float one_m_slow = __fsub_rn(1.0f, a.p_slow[c]);
  const int n_base = k_max + (a.has_shared ? 1 : 0);
  const bool has_degr = n_svc > n_base;
  const int rs = b.slot[lane], rv = b.slot[33 + lane];
  const int n_rs = b.slot[32], n_rv = b.slot[65];
  const uint32_t unused = static_cast<uint32_t>(N * G + lane) * 4u;
  const int n_tiles = (T + TS - 1) / TS;
  const uint32_t base = smem_base();
  const uint32_t raw = base + L.raw + 2 * p * L.raw_bytes;  // two buffers

  auto stage = [&](int tile, uint32_t buf) {
    const int s0 = tile * TS, len = min(TS, T - s0);
    for (int r = 0; r < n_rs; ++r) {
      const size_t row = static_cast<size_t>(b.rows[r]) * T + s0;
      stage_words(buf + L.r_cum + r * TS * 4, a.cum + row, len, lane);
      stage_words(buf + L.r_srv + r * TS * k_max * 4, a.servers + row * k_max,
                  len * k_max, lane);
    }
    for (int r = 0; r < n_rv; ++r) {
      const size_t row = static_cast<size_t>(b.rows[32 + r]) * T + s0;
      stage_words(buf + L.r_svc + r * TS * n_svc * 4, a.services + row * n_svc,
                  len * n_svc, lane);
    }
    stage_words(buf + L.r_valid, a.valid + s0, len, lane);
    stage_words(buf + L.r_warm, a.warm + s0, len, lane);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  if (p < n_tiles) stage(p, raw);
  for (int k = 0, tile = p; tile < n_tiles; ++k, tile += kProducers) {
    if (tile + kProducers < n_tiles) {
      stage(tile + kProducers, raw + ((k + 1) & 1) * L.raw_bytes);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncwarp();  // every lane's copies of this tile have landed
    const uint32_t in = raw + (k & 1) * L.raw_bytes;
    const int q = tile & b.qmask, use = tile >> b.qshift;
    if (use > 0) mbar_wait(b.empty + q, (use - 1) & 1);
    const uint32_t out = base + L.slots + q * L.slot_bytes;
    const int s0 = tile * TS, len = min(TS, T - s0);
    for (int e = lane; e < len; e += 32)
      sts(out + L.s_warm + 4 * e, lds(in + L.r_warm + 4 * e));
    if (act) {
      const uint32_t r_cum = in + L.r_cum + rs * TS * 4;
      const uint32_t r_srv = in + L.r_srv + rs * TS * k_max * 4;
      const uint32_t r_svc = in + L.r_svc + rv * TS * n_svc * 4;
      const uint32_t o_t = out + L.s_t + 4 * lane;
      const uint32_t o_svc = out + L.s_svc + 4 * lane;
      const uint32_t o_code = out + L.s_code + 4 * lane;
      const uint32_t o_d = out + L.s_d + 4 * lane;
      // t = cum / rate first, on its own: the division's rare slow path is
      // a branch, which no other work should wait behind
      float cum_e = lds(r_cum);
      for (int e = 0; e < len; ++e) {
        const float cum_next = lds(r_cum + 4 * min(e + 1, len - 1));
        sts(o_t + 4 * e * G, __fdiv_rn(cum_e, rate));
        cum_e = cum_next;
      }
      // then the copies, kGroup steps at a time: all their loads, their
      // arithmetic, their stores (a load after a store waits for it); rows
      // past len are computed from stale input and never read
      bool bad = false;
      for (int e0 = 0; e0 < len; e0 += kGroup) {
        float t[kGroup], valid[kGroup], shared[kGroup];
        float x[kGroup][K], u[kGroup][K];
        int srv[kGroup][K];
#pragma unroll
        for (int v = 0; v < kGroup; ++v) {
          const int e = e0 + v;
          const uint32_t row = r_svc + 4 * e * n_svc;
          const uint32_t srvs = r_srv + 4 * e * k_max;
          t[v] = kTimed ? lds(o_t + 4 * e * G) : 0.0f;
          valid[v] = kTimed ? lds(in + L.r_valid + 4 * e) : 0.0f;
          shared[v] = a.has_shared ? lds(row + 4 * k_max) : 0.0f;
#pragma unroll
          for (int j = 0; j < K; ++j) {
            const int jj = j < k_max ? j : 0;  // the template may hold more
            srv[v][j] = static_cast<int>(ldsu(srvs + 4 * jj));
            x[v][j] = lds(row + 4 * jj);
            u[v][j] = has_degr ? lds(row + 4 * (n_base + jj)) : 0.0f;
          }
        }
#pragma unroll
        for (int v = 0; v < kGroup; ++v) {
          const int e = e0 + v;
          float d_eff = 0.0f;
          uint32_t fire = 0;
          if (kTimed) {
            d_eff = valid[v] > 0.0f ? delay : 0.0f;
            fire = d_eff <= 0.0f ? kFire : 0u;
          }
          int retry_off = 0;  // sum_{i<j} min(2^i, cap), exact in float
#pragma unroll
          for (int j = 0; j < K; ++j) {
            const bool real = j < k_max;
            bad |= real && e < len &&
                   static_cast<unsigned>(srv[v][j]) >= static_cast<unsigned>(N);
            float xj = x[v][j];
            if (is_sd)
              xj = __fadd_rn(__fmul_rn(mix, shared[v]), __fmul_rn(one_m_mix, xj));
            if (u[v][j] >= one_m_slow) xj = __fmul_rn(xj, slow);
            // the retry's last attempt is exempt from blackholes
            const bool live =
                j < kc && (u[v][j] >= p_fail || (is_retry && j == kc - 1));
            const uint32_t code =
                real ? static_cast<uint32_t>(srv[v][j] * G + lane) * 4u |
                           (live ? kLive : 0u) | fire
                     : unused;
            x[v][j] = xj;
            srv[v][j] = static_cast<int>(code);
            if (kTimed) {
              const float coeff = static_cast<float>(is_retry ? retry_off : j);
              u[v][j] = is_timed ? __fadd_rn(t[v], __fmul_rn(d_eff, coeff))
                                 : t[v];  // the copy's dispatch time
            }
            retry_off += min(1 << j, kBackoffCap);
          }
        }
#pragma unroll
        for (int v = 0; v < kGroup; ++v)
#pragma unroll
          for (int j = 0; j < K; ++j) {
            const uint32_t i = 4 * ((e0 + v) * K + j) * G;
            sts(o_svc + i, x[v][j]);
            stsu(o_code + i, static_cast<uint32_t>(srv[v][j]));
            if (kTimed) sts(o_d + i, u[v][j]);
          }
      }
      if (bad) __trap();  // a server index past N
    }
    warp_arrive(b.full + q, lane, 0xffffffffu);
  }
}

// ---------------------------------------------------------------- consumer
template <int K, bool kTimed>
struct StepIn {
  float t;
  float svc[K], d[kTimed ? K : 1];
  uint32_t code[K];
};

// The codes of step e of the slot at shared address `slot` (this lane's).
template <int K>
__device__ __forceinline__ void load_codes(uint32_t (&code)[K], const Layout& L,
                                           uint32_t slot, int e) {
#pragma unroll
  for (int j = 0; j < K; ++j)
    code[j] = ldsu(slot + L.s_code + 4 * (e * K + j) * L.G);
}

// The rest of step e's inputs.
template <int K, bool kTimed>
__device__ __forceinline__ void load_inputs(StepIn<K, kTimed>& s,
                                            const Layout& L, uint32_t slot,
                                            int e) {
  s.t = lds(slot + L.s_t + 4 * e * L.G);
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const uint32_t i = slot + 4 * (e * K + j) * L.G;
    s.svc[j] = lds(i + L.s_svc);
    if (kTimed) s.d[j] = lds(i + L.s_d);
  }
}

// One step of the recurrence on `in` and the free times `cur` of its copy
// servers; returns the winning finish (inf where no copy was dispatched
// alive) and leaves each copy's new free time in nv. kArm >= 0 names the
// policy arm of every lane of the warp; -1 selects it per lane (`arm`).
template <int K, bool kTimed, int kArm>
__device__ __forceinline__ float step(const StepIn<K, kTimed>& in,
                                      const float (&cur)[K], float (&nv)[K],
                                      int arm) {
  if (kArm >= 0) arm = kArm;
  float fin[K], won = INFINITY;
#pragma unroll
  for (int j = 0; j < K; ++j)
    fin[j] = __fadd_rn(fmaxf(cur[j], kTimed ? in.d[j] : in.t), in.svc[j]);
  if (arm == 0) {  // replicate to all
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const bool live = in.code[j] & kLive;
      if (live) won = fminf(won, fin[j]);
      nv[j] = live ? fin[j] : cur[j];
    }
  } else if (arm == 1) {  // cancel on complete
#pragma unroll
    for (int j = 0; j < K; ++j)
      if (in.code[j] & kLive) won = fminf(won, fin[j]);
#pragma unroll
    for (int j = 0; j < K; ++j)
      nv[j] = (in.code[j] & kLive) ? fmaxf(cur[j], won) : cur[j];
  } else if (arm == 2) {  // replicate to idle
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const bool disp = (in.code[j] & kLive) && (j == 0 || cur[j] <= in.t);
      if (disp) won = fminf(won, fin[j]);
      nv[j] = disp ? fin[j] : cur[j];
    }
  } else if (kTimed) {  // sequential dispatch over the copy budget
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const bool made = (in.code[j] & kLive) &&
                        (j == 0 || (in.code[j] & kFire) || won > in.d[j]);
      if (made) won = fminf(won, fin[j]);
      nv[j] = made ? fin[j] : cur[j];
    }
  }
  return won;
}

// The recurrence over the chunk. At step s the codes of step s + 2 are
// loaded, and the inputs and gather of step s + 1 issued, ahead of step
// s's scatter; s's new free times are forwarded into that gather where the
// servers match (in copy order).
template <int K, bool kTimed, int kArm>
__device__ void recurrence(const Args& a, const Block& b, int lane, int arm) {
  const Layout& L = a.L;
  const int TS = L.TS, T = a.T;
  const int n_tiles = (T + TS - 1) / TS;
  const uint32_t base = smem_base();
  const uint32_t lane_slots = base + L.slots + 4 * lane;
  auto slot_of = [&](int tile) {
    return lane_slots + (tile & b.qmask) * L.slot_bytes;
  };

  StepIn<K, kTimed> in, nx;
  uint32_t nc[K], nnc[K];
  float cur[K], ncur[K], nv[K];
  // step e of the slot at `slot`; the next step is (nslot, ne), the one
  // after it (nnslot, nne); absent where has_nx / has_nnx is false
  auto advance = [&](uint32_t slot, int e, uint32_t nslot, int ne,
                     bool has_nx, uint32_t nnslot, int nne, bool has_nnx) {
    if (has_nnx) load_codes(nnc, L, nnslot, nne);
    if (has_nx) {
      load_inputs(nx, L, nslot, ne);
#pragma unroll
      for (int j = 0; j < K; ++j) {
        nx.code[j] = nc[j];
        ncur[j] = lds(base + (nc[j] & kOffset));
      }
    }
    const float won = step<K, kTimed, kArm>(in, cur, nv, arm);
    if (has_nx) {  // forward this step's writes, in copy order
#pragma unroll
      for (int i = 0; i < K; ++i)
#pragma unroll
        for (int j = 0; j < K; ++j)
          if (((nx.code[i] ^ in.code[j]) & kOffset) == 0) ncur[i] = nv[j];
    }
#pragma unroll
    for (int j = 0; j < K; ++j)  // copy order: last wins
      sts(base + (in.code[j] & kOffset), nv[j]);
    sts(slot + L.s_won + 4 * e * L.G, won);
    in = nx;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      cur[j] = ncur[j];
      nc[j] = nnc[j];
    }
  };

  consumer_wait(b, 0);
  load_codes(in.code, L, slot_of(0), 0);
  load_inputs(in, L, slot_of(0), 0);
#pragma unroll
  for (int j = 0; j < K; ++j) cur[j] = lds(base + (in.code[j] & kOffset));
  if (T > 1) load_codes(nc, L, slot_of(0), 1);  // tiles hold 16 or more
  for (int tile = 0; tile < n_tiles; ++tile) {
    const uint32_t slot = slot_of(tile), next = slot_of(tile + 1);
    const int len = min(TS, T - tile * TS);
    const bool more = tile + 1 < n_tiles;
#pragma unroll 2
    for (int e = 0; e + 2 < len; ++e)
      advance(slot, e, slot, e + 1, true, slot, e + 2, true);
    if (len >= 2) {  // only the last tile may be shorter than 16
      if (more) consumer_wait(b, tile + 1);
      advance(slot, len - 2, slot, len - 1, true, next, 0, more);
    }
    advance(slot, len - 1, next, 0, more, next, 1,
            T - (tile + 1) * TS > 1);
    warp_arrive(b.done + (tile & b.qmask), lane, b.cells);
  }
}

template <int K, bool kTimed>
__device__ void consumer(const Args& a, const Block& b, int lane) {
  if (lane >= a.L.G) return;  // no cell: the arrivals are the lanes below
  const int c = b.c0 + min(lane, b.ng - 1);
  const int pol = a.policy[c];
  // 0 replicate-all, 1 cancel-on-complete, 2 replicate-to-idle, 3 timed
  const int arm = pol == kTimeoutRetry || pol == kHedgeAfterDelay ? 3
                  : pol == kCancelOnComplete                       ? 1
                  : pol == kReplicateToIdle                        ? 2
                                                                   : 0;
  // the paper's policy everywhere (the main path) takes a loop without
  // the per-step choice of arm
  if (__all_sync(b.cells, arm == 0))
    recurrence<K, kTimed, 0>(a, b, lane, arm);
  else
    recurrence<K, kTimed, -1>(a, b, lane, arm);
}

// ------------------------------------------------------------ fold warp
// Add the counters of the block's live cells into hist and zero them;
// thread `first` of `stride` takes every stride-th word.
__device__ void flush_hist(const Args& a, const Block& b, int first,
                           int stride) {
  const Layout& L = a.L;
  const uint32_t hist = smem_base() + L.hist;
  for (int i = first; i < L.words * b.ng; i += stride) {
    const int w = i / b.ng, cc = i - w * b.ng;
    const uint32_t word = hist + 4 * (w * L.G + cc);
    const uint32_t v = ldsu(word);
    if (v == 0) continue;
    stsu(word, 0);
    float* h = a.hist + static_cast<size_t>(b.c0 + cc) * a.n_bins + 2 * w;
    if (v & 0xffffu) h[0] = __fadd_rn(h[0], static_cast<float>(v & 0xffffu));
    if (v >> 16) h[1] = __fadd_rn(h[1], static_cast<float>(v >> 16));
  }
}

// The response of each step and its gated Kahan fold and count (ref.py's
// kahan_fold).
__device__ void fold_warp(const Args& a, const Block& b, int lane) {
  const Layout& L = a.L;
  const int G = L.G, TS = L.TS, T = a.T;
  if (lane >= G) return;  // no cell: the arrivals are the lanes below
  const int c = b.c0 + min(lane, b.ng - 1);
  const float ovh = a.ovh[c];
  float ssum = a.ssum[c], comp = a.comp[c], cnt = a.cnt[c];
  const int n_tiles = (T + TS - 1) / TS;
  const uint32_t base = smem_base();
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int q = tile & b.qmask;
    mbar_wait(b.done + q, (tile >> b.qshift) & 1);
    const uint32_t slot = base + L.slots + q * L.slot_bytes;
    const uint32_t won = slot + L.s_won + 4 * lane, t = slot + L.s_t + 4 * lane;
    const int len = min(TS, T - tile * TS);
#pragma unroll 4
    for (int e = 0; e < len; ++e) {
      const float won_e = lds(won + 4 * e * G), t_e = lds(t + 4 * e * G);
      const float warm_e = lds(slot + L.s_warm + 4 * e);
      const float resp = __fadd_rn(__fsub_rn(won_e, t_e), ovh);
      const float w_live = isfinite(resp) ? warm_e : 0.0f;
      // gated Kahan step (ref.kahan_fold)
      const float y = __fsub_rn(resp, comp);
      const float tot = __fadd_rn(ssum, y);
      const float comp_new = __fsub_rn(__fsub_rn(tot, ssum), y);
      if (w_live > 0.0f) {
        ssum = tot;
        comp = comp_new;
      }
      cnt = __fadd_rn(cnt, w_live);
    }
    warp_arrive(b.empty + q, lane, b.cells);
  }
  if (lane < b.ng) {
    a.ssum[c] = ssum;
    a.comp[c] = comp;
    a.cnt[c] = cnt;
  }
}

// With the sketch, the same responses binned (log_bin) and counted in the
// block's 16-bit counters, which are flushed into hist every kFlushSteps
// steps (and by the whole block at the end).
__device__ void hist_warp(const Args& a, const Block& b, int lane) {
  const Layout& L = a.L;
  const int G = L.G, TS = L.TS, T = a.T;
  if (lane >= G) return;  // no cell: the arrivals are the lanes below
  const int c = b.c0 + min(lane, b.ng - 1);
  const float ovh = a.ovh[c];
  const bool sketch = a.n_bins > 0;
  const int n_tiles = (T + TS - 1) / TS;
  const uint32_t base = smem_base();
  const uint32_t counters = base + L.hist + 4 * lane;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int q = tile & b.qmask;
    mbar_wait(b.done + q, (tile >> b.qshift) & 1);
    const uint32_t slot = base + L.slots + q * L.slot_bytes;
    const uint32_t won = slot + L.s_won + 4 * lane, t = slot + L.s_t + 4 * lane;
    const int n_live = min(TS, T - tile * TS);  // steps the sketch counts
    // four steps' loads ahead of their counter updates, no branch
    for (int e0 = 0; sketch && e0 < n_live; e0 += 4) {
      float resp[4], warm[4];
#pragma unroll
      for (int v = 0; v < 4; ++v) {  // rows past n_live: stale, not counted
        const int e = e0 + v;
        resp[v] = __fadd_rn(
            __fsub_rn(lds(won + 4 * e * G), lds(t + 4 * e * G)), ovh);
        warm[v] = lds(slot + L.s_warm + 4 * e);
      }
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const bool live =
            e0 + v < n_live && isfinite(resp[v]) && warm[v] > 0.0f;
        const int bin = log_bin(resp[v], a.log_lo, a.scale, a.n_bins);
        asm volatile("red.shared.add.u32 [%0], %1;\n" ::"r"(
                         counters + 4 * (bin >> 1) * G),
                     "r"(live ? 1u << ((bin & 1) * 16) : 0u)
                     : "memory");
      }
    }
    warp_arrive(b.empty + q, lane, b.cells);
    if (sketch && ((tile + 1) * TS) % kFlushSteps == 0 && tile + 1 < n_tiles) {
      __syncwarp(b.cells);
      flush_hist(a, b, lane, G);
      __syncwarp(b.cells);
    }
  }
}

template <int K, bool kTimed>
__global__ void __launch_bounds__(kThreads)
cell_update_kernel(const Args a) {
  __shared__ uint64_t bars[3 * kMaxStages];
  __shared__ int rows[2 * 32];
  __shared__ int slots[2 * 33];
  static_assert(sizeof(bars) + sizeof(rows) + sizeof(slots) <= kStaticSmem,
                "static shared memory exceeds its reserve");
  const Layout& L = a.L;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c0 = static_cast<int>(blockIdx.x) * L.G;
  const Block b{bars, bars + kMaxStages, bars + 2 * kMaxStages, rows, slots,
                c0, min(L.G, a.C - c0), L.Q - 1, L.Q == 8 ? 3 : 2,
                L.G == 32 ? 0xffffffffu : (1u << L.G) - 1u};
  const uint32_t base = smem_base();

  if (threadIdx.x == 0)
    for (int q = 0; q < L.Q; ++q) {
      mbar_init(b.full + q, 1);
      mbar_init(b.done + q, 1);
      mbar_init(b.empty + q, 2);
    }
  if (warp == 0) {
    // the block's distinct input rows; lanes past its cells repeat the last
    const int c = b.c0 + min(lane, b.ng - 1);
    const int seed = a.seed_idx[c];
    const int keys[2] = {seed, a.svc_idx ? a.svc_idx[c] : seed};
    const int n_keys[2] = {a.S, a.S_svc};
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (static_cast<unsigned>(keys[k]) >= static_cast<unsigned>(n_keys[k]))
        __trap();
      const unsigned peers = __match_any_sync(0xffffffffu, keys[k]);
      const int leader = __ffs(peers) - 1;
      const unsigned leaders = __ballot_sync(0xffffffffu, lane == leader);
      const int slot = __popc(leaders & ((1u << leader) - 1u));
      if (lane == leader) rows[32 * k + slot] = keys[k];
      slots[33 * k + lane] = slot;
      if (lane == 0) slots[33 * k + 32] = __popc(leaders);
    }
  }
  for (int i = threadIdx.x; i < L.words * L.G; i += kThreads)
    stsu(base + L.hist + 4 * i, 0);
  for (int i = threadIdx.x; i < L.G * a.N; i += kThreads) {
    const int cc = i / a.N, n = i - cc * a.N;
    sts(base + 4 * (n * L.G + cc),
        a.free_[static_cast<size_t>(b.c0 + min(cc, b.ng - 1)) * a.N + n]);
  }
  __syncthreads();

  if (warp == 0)
    consumer<K, kTimed>(a, b, lane);
  else if (warp <= kProducers)
    producer<K, kTimed>(a, b, warp - 1, lane);
  else if (warp == kProducers + 1)
    fold_warp(a, b, lane);
  else
    hist_warp(a, b, lane);
  __syncthreads();

  for (int i = threadIdx.x; i < b.ng * a.N; i += kThreads) {
    const int cc = i / a.N, n = i - cc * a.N;
    a.free_[static_cast<size_t>(b.c0 + cc) * a.N + n] =
        lds(base + 4 * (n * L.G + cc));
  }
  if (a.n_bins > 0) flush_hist(a, b, threadIdx.x, kThreads);
}

template <int K>
void* kernel_for(bool timed) {
  return timed ? reinterpret_cast<void*>(&cell_update_kernel<K, true>)
               : reinterpret_cast<void*>(&cell_update_kernel<K, false>);
}

}  // namespace

// The dynamic shared memory of one block as make_layout lays it out, for the
// launch plan in kernel.py to be held against (rs, rv: the block's distinct
// seed and service rows).
extern "C" int cell_update_smem(int G, int TS, int Q, int N, int K, int k_max,
                                int n_svc, int n_bins, int rs, int rv,
                                int timed) {
  return make_layout(G, TS, Q, N, K, k_max, n_svc, n_bins, rs, rv, timed != 0)
      .total;
}

extern "C" int cell_update_launch(
    void* free_, void* ssum, void* comp, void* cnt, void* hist,
    const void* cum, const void* warm, const void* valid, const void* servers,
    const void* services, const void* seed_idx, const void* svc_idx,
    const void* k_count, const void* policy, const void* model,
    const void* rates, const void* ovh, const void* mix, const void* p_slow,
    const void* slow_factor, const void* p_fail, const void* delay, int C,
    int N, int T, int k_max, int n_svc, int has_shared, int has_timed,
    int n_bins, int S, int S_svc, float log_lo, float scale, int K, int G,
    int TS, int Q, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool k_ok = K == 1 || K == 2 || K == 3 || K == 4 || K == 8 || K == 16;
  const int rs = min(G, S), rv = min(G, S_svc);
  if (C <= 0 || T <= 0 || N <= 0 || N > kMaxServers || k_max < 1 ||
      k_max > kMaxK || k_max > N || !k_ok || K < k_max ||
      n_svc < k_max + (has_shared ? 1 : 0) || n_bins < 0 || S <= 0 ||
      S_svc <= 0 || G < 1 || G > kMaxCells ||
      (TS != 16 && TS != 32 && TS != 64) || (Q != 4 && Q != kMaxStages) ||
      (n_bins > 0) != (hist != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout L = make_layout(G, TS, Q, N, K, k_max, n_svc, n_bins, rs, rv,
                               has_timed != 0);
  if (L.total > kMaxSmem - kStaticSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool timed = has_timed != 0;
  void* fn = K == 1   ? kernel_for<1>(timed)
             : K == 2 ? kernel_for<2>(timed)
             : K == 3 ? kernel_for<3>(timed)
             : K == 4 ? kernel_for<4>(timed)
             : K == 8 ? kernel_for<8>(timed)
                      : kernel_for<16>(timed);
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L.total);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a{static_cast<float*>(free_),
         static_cast<float*>(ssum),
         static_cast<float*>(comp),
         static_cast<float*>(cnt),
         static_cast<float*>(hist),
         static_cast<const float*>(cum),
         static_cast<const float*>(warm),
         static_cast<const float*>(valid),
         static_cast<const int*>(servers),
         static_cast<const float*>(services),
         static_cast<const int*>(seed_idx),
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
         static_cast<const float*>(delay),
         C, N, T, k_max, n_svc, has_shared, n_bins, S, S_svc, log_lo, scale,
         L};
  void* params[] = {&a};
  err = cudaLaunchKernel(fn, dim3((C + G - 1) / G), dim3(kThreads), params,
                         static_cast<size_t>(L.total),
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
