// Mamba-2 SSD intra-chunk term: the chunked algorithm's quadratic part and
// each chunk's contributed state, in one launch on the tensor cores.
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
// Bound on this card: at mamba2-370m's prefill of 16 chunks (Q = 256,
// H = 32, P = 64, N = 128) the three products are ~4.4 GFLOP against ~89 MB
// of inputs and outputs: 0.066 ms at the float32 rate of the CUDA cores, so
// the products run on the tensor cores (mma.sync m16n8k8 in TF32). One TF32
// pass keeps 11 bits of each operand, which misses the gate of
// tests/test_kernels.py (5e-3 + 5e-3 |plain|) by ~5x at standard-normal
// inputs. So every operand is split, x = hi + lo with both rounded to TF32
// (as cvt.rna rounds), and each product is hi.hi + hi.lo + lo.hi,
// accumulated in float32 (three mma; "split TF32"), which lands at ~0.01 of
// the gate. Three passes at the dense TF32 rate and the bytes at the memory
// rate give a bound of ~0.028 ms. What holds the kernel above it is
// mma.sync itself: on the H100 a TF32 m16n8k8 issues about once per 4 SM
// clocks, a quarter of the rate that only wgmma reaches, and the kernel's
// ~9M of them take ~0.15 of its ~0.25 ms (without them it runs in 0.095).
//
// One launch, two kinds of CTA, 4 warps each:
//   y CTAs, one per (query tile of 64 rows, group of HG heads, chunk),
//     heaviest query tiles first. The heads share C B^T, so the CTA first
//     forms the causal tiles of its G = C B^T rows (key tiles at or below
//     the diagonal) into shared memory, in the mma accumulators' own order,
//     then for each head walks the same key tiles: each thread reads back
//     the G values it wrote, makes the weights G exp(cum_q - cum_s) dt_s
//     (selected to 0 above the diagonal: the exponent overflows there, and
//     inf * 0 would be NaN) and feeds them straight to W X as A fragments.
//     The accumulator holds columns 2t, 2t + 1 where an A fragment wants
//     t, t + 4; the sum over keys does not care which slot a key sits in,
//     so the B fragment of X takes the same order (keys 2t and 2t + 1) and
//     nothing moves between lanes. A warp owns 16 query rows. The launch
//     plan (kernel.py) picks HG so that the grid fills the card at one
//     chunk (HG = 1: 4 x 32 = 128 CTAs) as at 16 (HG = 4).
//   state CTAs, one per (64 x 128 block of the state, head, chunk), sum
//     (X_q gate_q) outer B_q over the chunk in slices of 16 rows; a warp
//     owns 32 x 64 of the block.
// Every CTA stages its operands with cp.async into a ring of shared memory
// (two stages for a y CTA, four for a state CTA, which holds no G; 16-byte
// copies where rows allow, else 4-byte ones; rows and columns past the
// tensor are zero-filled), so the next step's copy is in flight while the
// tensor cores run on the current one. Fragments are read at padded
// strides that keep the 32 lanes on distinct banks. Each mma3 runs its
// three passes over all of a fragment's independent tiles, so that no mma
// waits for the one before it.
//
// The library is built with --fmad=false: the split's residual x - hi and
// the weights' products are rounded on their own, as the plain version's
// are. The weights use expf and __fmul_rn in the plain version's order.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kTile = 64;      // query rows of a y CTA; rows of a key tile
constexpr int kWarps = 4;      // a y warp owns 16 query rows
constexpr int kThreads = 32 * kWarps;
constexpr int kSlice = 32;     // d_state columns of C and B per G stage
constexpr int kStages = 2;     // the ring of staged operands
constexpr int kMaxP = 128;
constexpr int kMaxN = 256;
constexpr int kStateP = 64;    // a state CTA's block: P rows ...
constexpr int kStateN = 128;   // ... by N columns
constexpr int kStateQ = 16;    // chunk rows per state stage
constexpr int kStateStages = 4;  // the state CTAs' ring: they hold no G
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may use

__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Shared memory of a CTA, in floats. A y CTA: the G tiles of one query
// tile (in the accumulators' order), then kStages stages, each the larger
// of a G stage (C and B slices) and a W X stage (X rows of a key tile, cum
// and dt). A state CTA: kStateStages stages of X and B slices, cum, dt and
// the gate, from the start. Strides are padded so that fragment reads fall
// on distinct banks.
struct Layout {
  int ldx;       // X rows of a W X stage: P rounded to 8, plus 4
  int stage;     // floats per y stage
  int g_floats;  // G tiles: ceil(Q / 64) of 64 x 64
  int bytes;
};

constexpr int kLdG = kSlice + 4;   // C and B slice rows (G stage)
constexpr int kLdSX = kStateP + 8;  // X slice rows (state stage)
constexpr int kLdSB = kStateN + 8;  // B slice rows (state stage)
constexpr int kSStage = kStateQ * (kLdSX + kLdSB) + 3 * kStateQ;

__host__ __device__ inline Layout make_layout(int Q, int P) {
  Layout L;
  L.ldx = round_up(P, 8) + 4;
  const int g_stage = 2 * kTile * kLdG;
  const int x_stage = kTile * L.ldx + 2 * kTile;
  L.stage = round_up(imax(g_stage, x_stage), 4);
  L.g_floats = (Q + kTile - 1) / kTile * kTile * kTile;
  L.bytes = 4 * imax(L.g_floats + kStages * L.stage, kStateStages * kSStage);
  return L;
}

struct Args {
  const float* x;
  const float* b;
  const float* c;
  const float* dt;
  const float* cum;
  float* y;
  float* states;
  int BC, Q, H, P, N;
  int HG;          // heads per y CTA
  int n_qt, n_hg;  // query tiles, head groups
  int n_y;         // y CTAs; the state CTAs follow
  int n_pb, n_nb;  // state blocks per head along P and N
  int vec_x, vec_bc;  // rows of x (of b and c) allow 16-byte copies
  Layout L;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 16 or 4 bytes; `ok` false zero-fills the destination (`src`
// must still be a valid address).
__device__ __forceinline__ void cp16(uint32_t dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp4(uint32_t dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Until at most `pending` of this thread's cp.async groups are in flight.
template <int pending>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}

// rows x cols floats of a row-major source (row r at src + r * ld_src) into
// shared memory at dst (row stride ld_dst floats), across the CTA; elements
// at rows >= n_rows or columns >= n_cols are zero-filled. `vec`: 16-byte
// copies (cols, ld_src and n_cols multiples of 4, src 16-byte aligned).
__device__ __forceinline__ void stage_tile(uint32_t dst, int ld_dst,
                                           const float* src, size_t ld_src,
                                           int rows, int cols, int n_rows,
                                           int n_cols, bool vec) {
  if (vec) {
    const int c4 = cols / 4;
    for (int i = threadIdx.x; i < rows * c4; i += kThreads) {
      const int r = i / c4, c = (i - r * c4) * 4;
      const bool ok = r < n_rows && c < n_cols;
      cp16(dst + 4 * (r * ld_dst + c), ok ? src + r * ld_src + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += kThreads) {
      const int r = i / cols, c = i - r * cols;
      const bool ok = r < n_rows && c < n_cols;
      cp4(dst + 4 * (r * ld_dst + c), ok ? src + r * ld_src + c : src, ok);
    }
  }
}

// `rows` floats of a strided column (element r at src + r * ld_src).
__device__ __forceinline__ void stage_col(uint32_t dst, const float* src,
                                          int ld_src, int rows, int n_rows) {
  const int r = threadIdx.x;
  if (r < rows) {
    const bool ok = r < n_rows;
    cp4(dst + 4 * r, ok ? src + static_cast<size_t>(r) * ld_src : src, ok);
  }
}

// x = hi + lo, both rounded to TF32 (round to nearest, ties away); the
// residual x - hi is exact in float32. The rounding is cvt.rna.tf32.f32's,
// bit for bit on finite values, in two integer operations: cvt itself cost
// the kernel 14% (0.288 against 0.247 ms at 16 chunks on the H100).
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(__fsub_rn(x, __uint_as_float(hi)));
}

// d += a b on one m16n8k8 TF32 tile, float32 accumulators. Not volatile:
// the compiler may interleave the mma of independent tiles.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The split-TF32 product of one A fragment with n B fragments into n
// accumulators: the two correction terms, then hi.hi, each pass over all
// n tiles, so that no mma waits on the one before it. Tiles at or past
// `live` are skipped.
template <int n>
__device__ __forceinline__ void mma3(float (&d)[n][4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[n][2],
                                     const uint32_t (&bl)[n][2], int live) {
#pragma unroll
  for (int i = 0; i < n; ++i)
    if (i < live) mma(d[i], al, bh[i]);
#pragma unroll
  for (int i = 0; i < n; ++i)
    if (i < live) mma(d[i], ah, bl[i]);
#pragma unroll
  for (int i = 0; i < n; ++i)
    if (i < live) mma(d[i], ah, bh[i]);
}

__device__ __forceinline__ void split4(const float (&v)[4], uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split(v[i], hi[i], lo[i]);
}
__device__ __forceinline__ void split2(float v0, float v1, uint32_t (&hi)[2],
                                       uint32_t (&lo)[2]) {
  split(v0, hi[0], lo[0]);
  split(v1, hi[1], lo[1]);
}

// One weight of W: (C_q . B_s) exp(cum_q - cum_s) dt_s where s <= q < Q,
// else 0, selected (never a multiply by a mask). Above the diagonal expf
// takes 0 instead of the exponent, so nothing overflows and no lane
// branches.
__device__ __forceinline__ float weight(float g, float cq, float cs, float ds,
                                        bool live) {
  const float e = expf(live ? cq - cs : 0.f);
  return live ? __fmul_rn(__fmul_rn(g, e), ds) : 0.f;
}

// ---------------------------------------------------------------- y CTAs
// NP: n8 blocks of P a thread accumulates (P <= 8 NP).
template <int NP>
__device__ void y_block(const Args& a, float* smem) {
  const int per_qt = a.BC * a.n_hg;
  const int qt = a.n_qt - 1 - static_cast<int>(blockIdx.x) / per_qt;
  const int rem = static_cast<int>(blockIdx.x) % per_qt;
  const int hg = rem % a.n_hg, chunk = rem / a.n_hg;
  const int Q = a.Q, H = a.H, P = a.P, N = a.N;
  const int h0 = hg * a.HG, n_heads = min(a.HG, H - h0);
  const size_t row0 = static_cast<size_t>(chunk) * Q;
  const int q0 = qt * kTile;
  const int n_keys = qt + 1;  // key tiles at or below the diagonal
  const int n_slices = (N + kSlice - 1) / kSlice;
  const int n_g = n_keys * n_slices;  // steps of C B^T; then W X steps
  const int n_steps = n_g + n_heads * n_keys;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r_lo = warp * 16 + g;  // the thread's tile rows: r_lo, r_lo + 8
  const int ldx = a.L.ldx;
  const int p8 = round_up(P, 8);
  const int n_pb = p8 / 8;  // n8 blocks of P that hold columns
  float4* gs = reinterpret_cast<float4*>(smem);
  float* ring = smem + a.L.g_floats;

  auto load = [&](int i) {
    const uint32_t d = smem_addr(ring + (i % kStages) * a.L.stage);
    if (i < n_g) {
      const int s0 = (i / n_slices) * kTile, k0 = (i % n_slices) * kSlice;
      stage_tile(d, kLdG, a.c + (row0 + q0) * N + k0, N, kTile, kSlice,
                 Q - q0, N - k0, a.vec_bc);
      stage_tile(d + 4 * kTile * kLdG, kLdG, a.b + (row0 + s0) * N + k0, N,
                 kTile, kSlice, Q - s0, N - k0, a.vec_bc);
    } else {
      const int j = i - n_g;
      const int h = h0 + j / n_keys, s0 = (j % n_keys) * kTile;
      stage_tile(d, ldx, a.x + ((row0 + s0) * H + h) * P,
                 static_cast<size_t>(H) * P, kTile, p8, Q - s0, P, a.vec_x);
      stage_col(d + 4 * kTile * ldx, a.cum + (row0 + s0) * H + h, H, kTile,
                Q - s0);
      stage_col(d + 4 * (kTile * ldx + kTile), a.dt + (row0 + s0) * H + h, H,
                kTile, Q - s0);
    }
    cp_commit();
  };

  float gacc[8][4];
  float yacc[NP][4];
  float cq[2] = {0.f, 0.f};  // cum of the rows q0 + r_lo (+ 8), this head
  const int qa = q0 + r_lo, qb = qa + 8;

  load(0);
  for (int i = 0; i < n_steps; ++i) {
    if (i + 1 < n_steps)
      load(i + 1);
    else
      cp_commit();
    cp_wait<kStages - 1>();
    __syncthreads();
    const float* st = ring + (i % kStages) * a.L.stage;
    if (i < n_g) {
      // G tile (the warp's 16 query rows x 64 keys) += C B^T over a slice
      const int kt = i / n_slices, ks = i % n_slices;
      if (ks == 0) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) gacc[j][e] = 0.f;
      }
      const float* cs = st;
      const float* bs = st + kTile * kLdG;
#pragma unroll
      for (int kk = 0; kk < kSlice; kk += 8) {
        const float av[4] = {cs[r_lo * kLdG + kk + t],
                             cs[(r_lo + 8) * kLdG + kk + t],
                             cs[r_lo * kLdG + kk + t + 4],
                             cs[(r_lo + 8) * kLdG + kk + t + 4]};
        uint32_t ah[4], al[4], bh[8][2], bl[8][2];
        split4(av, ah, al);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          split2(bs[(8 * j + g) * kLdG + kk + t],
                 bs[(8 * j + g) * kLdG + kk + t + 4], bh[j], bl[j]);
        mma3<8>(gacc, ah, al, bh, bl, 8);
      }
      if (ks == n_slices - 1) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          gs[((kt * kWarps + warp) * 8 + j) * 32 + lane] =
              make_float4(gacc[j][0], gacc[j][1], gacc[j][2], gacc[j][3]);
      }
    } else {
      // y (the warp's 16 rows x P) += W X over one key tile of one head
      const int jj = i - n_g, kt = jj % n_keys;
      const int h = h0 + jj / n_keys;
      if (kt == 0) {
#pragma unroll
        for (int np = 0; np < NP; ++np)
#pragma unroll
          for (int e = 0; e < 4; ++e) yacc[np][e] = 0.f;
        cq[0] = qa < Q ? __ldg(a.cum + (row0 + qa) * H + h) : 0.f;
        cq[1] = qb < Q ? __ldg(a.cum + (row0 + qb) * H + h) : 0.f;
      }
      const float* xs = st;
      const float* cum_s = st + kTile * ldx;
      const float* dt_s = cum_s + kTile;
      const int s0 = kt * kTile;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (kt == qt && 8 * j > warp * 16 + 15) break;  // all above the
                                                         // diagonal
        // this thread's G: rows qa, qb x keys c, c + 1 of the tile
        const float4 gv = gs[((kt * kWarps + warp) * 8 + j) * 32 + lane];
        const int c = 8 * j + 2 * t;
        const int sa = s0 + c, sb = sa + 1;
        const float ca = cum_s[c], cb = cum_s[c + 1];
        const float da = dt_s[c], db = dt_s[c + 1];
        // A fragment: (row g, slot t) = key c, (row g, slot t + 4) = c + 1
        const float wv[4] = {
            weight(gv.x, cq[0], ca, da, sa <= qa && qa < Q),
            weight(gv.z, cq[1], ca, da, sa <= qb && qb < Q),
            weight(gv.y, cq[0], cb, db, sb <= qa && qa < Q),
            weight(gv.w, cq[1], cb, db, sb <= qb && qb < Q)};
        uint32_t ah[4], al[4], bh[NP][2], bl[NP][2];
        split4(wv, ah, al);
#pragma unroll
        for (int np = 0; np < NP; ++np)
          if (np < n_pb)
            split2(xs[c * ldx + np * 8 + g], xs[(c + 1) * ldx + np * 8 + g],
                   bh[np], bl[np]);
        mma3<NP>(yacc, ah, al, bh, bl, n_pb);
      }
      if (kt == n_keys - 1) {
#pragma unroll
        for (int np = 0; np < NP; ++np) {
          const int p = np * 8 + 2 * t;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int q = half ? qb : qa;
            if (q >= Q) continue;
            float* out = a.y + ((row0 + q) * H + h) * P;
            if (p < P) out[p] = yacc[np][2 * half];
            if (p + 1 < P) out[p + 1] = yacc[np][2 * half + 1];
          }
        }
      }
    }
    __syncthreads();  // the stage is read before the next load refills it
  }
}

// ------------------------------------------------------------ state CTAs
__device__ void state_block(const Args& a, float* smem) {
  const int i_blk = static_cast<int>(blockIdx.x) - a.n_y;
  const int per_head = a.n_pb * a.n_nb;
  const int blk = i_blk % per_head, hc = i_blk / per_head;
  const int Q = a.Q, H = a.H, P = a.P, N = a.N;
  const int h = hc % H, chunk = hc / H;
  const int p0 = (blk % a.n_pb) * kStateP, n0 = (blk / a.n_pb) * kStateN;
  const size_t row0 = static_cast<size_t>(chunk) * Q;
  const float total = __ldg(a.cum + (row0 + Q - 1) * H + h);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int pw = (warp % 2) * 32, nw = (warp / 2) * 64;  // the warp's block
  const int n_steps = (Q + kStateQ - 1) / kStateQ;

  auto load = [&](int i) {
    const uint32_t d = smem_addr(smem + (i % kStateStages) * kSStage);
    const int qs = i * kStateQ;
    stage_tile(d, kLdSX, a.x + ((row0 + qs) * H + h) * P + p0,
               static_cast<size_t>(H) * P, kStateQ, kStateP, Q - qs, P - p0,
               a.vec_x);
    const uint32_t db = d + 4 * kStateQ * kLdSX;
    stage_tile(db, kLdSB, a.b + (row0 + qs) * N + n0, N, kStateQ, kStateN,
               Q - qs, N - n0, a.vec_bc);
    const uint32_t dc = db + 4 * kStateQ * kLdSB;
    stage_col(dc, a.cum + (row0 + qs) * H + h, H, kStateQ, Q - qs);
    stage_col(dc + 4 * kStateQ, a.dt + (row0 + qs) * H + h, H, kStateQ,
              Q - qs);
    cp_commit();
  };

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  // kStateStages - 1 slices in flight ahead of the one in use
  for (int i = 0; i < kStateStages - 1; ++i) {
    if (i < n_steps)
      load(i);
    else
      cp_commit();
  }
  for (int i = 0; i < n_steps; ++i) {
    if (i + kStateStages - 1 < n_steps)
      load(i + kStateStages - 1);
    else
      cp_commit();
    cp_wait<kStateStages - 1>();
    __syncthreads();
    float* st = smem + (i % kStateStages) * kSStage;
    const float* xs = st;
    const float* bs = xs + kStateQ * kLdSX;
    const float* cum_s = bs + kStateQ * kLdSB;
    const float* dt_s = cum_s + kStateQ;
    float* gate = st + kStateQ * (kLdSX + kLdSB) + 2 * kStateQ;
    if (threadIdx.x < kStateQ) {
      const int r = threadIdx.x;
      gate[r] = i * kStateQ + r < Q
                    ? __fmul_rn(expf(total - cum_s[r]), dt_s[r])
                    : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kStateQ; k += 8) {
      // A = (X gate)^T: rows p, columns (the sum's index) q
      const float ga = gate[k + t], gb = gate[k + t + 4];
      uint32_t ah[2][4], al[2][4], bh[8][2], bl[8][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int pr = pw + mi * 16 + g;
        const float av[4] = {__fmul_rn(xs[(k + t) * kLdSX + pr], ga),
                             __fmul_rn(xs[(k + t) * kLdSX + pr + 8], ga),
                             __fmul_rn(xs[(k + t + 4) * kLdSX + pr], gb),
                             __fmul_rn(xs[(k + t + 4) * kLdSX + pr + 8], gb)};
        split4(av, ah[mi], al[mi]);
      }
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int nc = nw + ni * 8 + g;
        split2(bs[(k + t) * kLdSB + nc], bs[(k + t + 4) * kLdSB + nc], bh[ni],
               bl[ni]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        mma3<8>(acc[mi], ah[mi], al[mi], bh, bl, 8);
    }
    __syncthreads();
  }

  float* out = a.states + (static_cast<size_t>(chunk) * H + h) * P * N;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = p0 + pw + mi * 16 + g + 8 * half;
      if (p >= P) continue;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int n = n0 + nw + ni * 8 + 2 * t;
        if (n < N) out[static_cast<size_t>(p) * N + n] = acc[mi][ni][2 * half];
        if (n + 1 < N)
          out[static_cast<size_t>(p) * N + n + 1] = acc[mi][ni][2 * half + 1];
      }
    }
  }
}

template <int NP>
__global__ void __launch_bounds__(kThreads) ssd_scan_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  if (static_cast<int>(blockIdx.x) < a.n_y)
    y_block<NP>(a, smem);
  else
    state_block(a, smem);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" const char* error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// The dynamic shared memory of a CTA as make_layout lays it out, for the
// launch plan in kernel.py to be held against.
extern "C" int ssd_scan_smem(int Q, int P) { return make_layout(Q, P).bytes; }

// One launch: y CTAs (query tile, group of HG heads, chunk), then state
// CTAs (block of the state, head, chunk). Both outputs are written in full;
// P <= 128, N <= 256, 1 <= HG <= H.
extern "C" int ssd_scan_launch(const void* x, const void* b, const void* c,
                               const void* dt, const void* cum, void* y,
                               void* states, int BC, int Q, int H, int P,
                               int N, int HG, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (BC <= 0 || Q <= 0 || H <= 0 || P <= 0 || P > kMaxP || N <= 0 ||
      N > kMaxN || HG < 1 || HG > H)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout L = make_layout(Q, P);
  if (L.bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const float*>(x), static_cast<const float*>(b),
         static_cast<const float*>(c), static_cast<const float*>(dt),
         static_cast<const float*>(cum), static_cast<float*>(y),
         static_cast<float*>(states), BC, Q, H, P, N, HG,
         (Q + kTile - 1) / kTile, (H + HG - 1) / HG, 0,
         (P + kStateP - 1) / kStateP, (N + kStateN - 1) / kStateN,
         P % 4 == 0 && aligned16(x), N % 4 == 0 && aligned16(b) &&
             aligned16(c), L};
  const long long n_y = static_cast<long long>(BC) * a.n_qt * a.n_hg;
  const long long n_blocks =
      n_y + static_cast<long long>(BC) * H * a.n_pb * a.n_nb;
  if (n_blocks > (1LL << 31) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  a.n_y = static_cast<int>(n_y);
  const int np = (P + 7) / 8;
  void* fn = np <= 1   ? reinterpret_cast<void*>(&ssd_scan_kernel<1>)
             : np <= 2 ? reinterpret_cast<void*>(&ssd_scan_kernel<2>)
             : np <= 4 ? reinterpret_cast<void*>(&ssd_scan_kernel<4>)
             : np <= 8 ? reinterpret_cast<void*>(&ssd_scan_kernel<8>)
                       : reinterpret_cast<void*>(&ssd_scan_kernel<16>);
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* params[] = {&a};
  err = cudaLaunchKernel(fn, dim3(static_cast<unsigned>(n_blocks)),
                         dim3(kThreads), params, static_cast<size_t>(L.bytes),
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
