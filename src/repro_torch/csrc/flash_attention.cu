// Causal GQA flash attention, forward (prefill): optional sliding window and
// tanh logit softcap, online softmax in float32.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_attn_kernel / flash_attention_bhsd, pl.pallas_call at :109). The plain
// PyTorch version is repro_torch/kernels/flash_attention/ref.py.
//
// Layout: q (B, Sq, H, hd), k/v (B, Sk, KV, hd), out (B, Sq, H, hd), all
// bf16 and contiguous: the model's own layout, read by TMA through 4-d
// tensor maps (hd, heads, S, B), so no transpose is made. Query head h reads
// KV head h / (H / KV) (GQA, as the TPU kernel's index map). hd is a
// template parameter: 16, 32, 64, 128 or 256, all on this one design.
// The queries are the rows at global positions q_off .. q_off + Sq - 1 and
// the keys positions 0 .. Sk - 1 with Sk = q_off + Sq (a sequence-sharded
// prefill: a rank's block of rows over the gathered causal prefix); the
// causal mask, the window and the tile skipping and ordering below read the
// global row. q_off = 0 with Sq = Sk is the whole sequence.
//
// Bound on this card: operations. The live (query, key) pairs cost 4 * hd
// flops each (QK and PV), which at gemma2-2b's S = 4608, hd = 256 is 88
// GFLOP against ~50 MB of Q/K/V/out: far above the ~295 flop/byte ridge of
// the bf16 tensor cores. What the design does about it:
//   - one CTA of 384 threads per (query tile of 128 rows, query head,
//     batch): two consumer warpgroups own 64 rows each and compute with
//     wgmma, so each shared-memory K or V tile is read once per 64 rows
//     (mma.sync with ldmatrix read it once per 16); one producer
//     warpgroup, cut to 24 registers by setmaxnreg so the consumers get
//     240 (the float32 O accumulator alone is 128 a thread at hd = 256);
//   - one thread of the producer issues TMA copies (cp.async.bulk.tensor)
//     with the 128-byte swizzle that the wgmma descriptors read (64-byte
//     or 32-byte at hd = 32 or 16, where a row is that narrow): Q once,
//     then K and V in a ring of two stages each, with separate full and
//     empty mbarriers for K and V, so Q K^T of a tile starts while its V
//     lands and the next tile's K and V are in flight;
//   - S = Q K^T by wgmma m64n64k16 with both operands in shared memory
//     (both hd-contiguous: K-major); in registers: scale by hd^-0.5,
//     softcap cap * tanh(s / cap), then the mask (the order of
//     kernel.py:60-70; a tile wholly inside the causal and window bounds
//     skips the mask), the running max and sum; P is rounded to bf16 and
//     fed from the score registers as wgmma's A operand for O += P V
//     (m64n{hd}k16, V read from shared memory as a transposed B: keys by
//     hd, hd contiguous);
//   - only live KV tiles are visited: from the tile of
//     max(0, q0 - window + 1) to that of the CTA's last row (the TPU
//     kernel's pl.when skip); a warpgroup skips the products of a tile none
//     of its rows can see;
//   - the heaviest causal tiles start first: grid (H, query tiles, B),
//     blockIdx.y mapped in reverse, so the block scheduler, which walks
//     blocks in order, hands out the longest rows before the short ones.
// A row whose every key was masked has l = 0 and is written as 0. Rows past
// Sq are zero-filled by TMA, computed, and never written; keys past Sk are
// zero-filled and masked: any S works.
//
// Precision: the FMA contraction that nvcc applies here is allowed (the
// kernel is held to its plain version by a bf16 tolerance). P enters the
// value product rounded to bf16 as in the plain version. exp is
// ex2.approx (relative error ~2^-22) and the softcap's tanh is
// tanh.approx.f32, one special-function instruction a score: with it the
// gates of phases 5 and 7 of chip_smoke.py sit where they sit with an exact
// tanh, so the cheaper form was chosen (PERF.md).
//
// What is left: no intra-warpgroup overlap of one tile's softmax with the
// next tile's Q K^T (FA3's second pipeline), no pingpong ordering of the
// two consumers, the output written from registers rather than by TMA, and
// no packing of a KV group's query heads into one CTA (K and V are read
// once per query head, from L2 after the first). At hd = 256 the ring has
// two stages of 64 keys: Q (64 KB) and two K and two V stages (128 KB) use
// 192 KB of the 227 KB a block may have, so a third stage does not fit.
#include <cuda.h>  // CUtensorMap, cuTensorMapEncodeTiled (linked with -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBM = 128;          // query rows per CTA
constexpr int kBN = 64;           // keys per KV tile
constexpr int kStages = 2;        // depth of the K ring and of the V ring
constexpr int kConsumers = 2;     // consumer warpgroups, 64 rows each
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kMaxSmem = 232448;  // bytes a Hopper block may use
constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

// Shared-memory geometry at head dim HD. A tile of R rows is stored as
// kBlocks column blocks of R x kCols, each as TMA writes one box: rows of
// kRowBytes, 16-byte chunks swizzled within 8-row groups.
template <int HD>
struct Tile {
  static constexpr int kCols = HD < 64 ? HD : 64;
  static constexpr int kRowBytes = 2 * kCols;  // = the swizzle span
  static constexpr int kBlocks = HD / kCols;
  static constexpr int kQBytes = kBM * HD * 2;
  static constexpr int kKVBytes = kBN * HD * 2;
  static constexpr int kOffK = kQBytes;
  static constexpr int kOffV = kOffK + kStages * kKVBytes;
  static constexpr int kOffBar = kOffV + kStages * kKVBytes;
  static constexpr int kSmem = kOffBar + 128 + 1024;  // barriers; alignment
  // wgmma descriptor layout type: 1 = 128-byte swizzle, 2 = 64, 3 = 32
  static constexpr uint64_t kLayout =
      kRowBytes == 128 ? 1 : (kRowBytes == 64 ? 2 : 3);
  static constexpr CUtensorMapSwizzle kSwizzle =
      kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                       : (kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                          : CU_TENSOR_MAP_SWIZZLE_32B);
};

// mbarriers, at 8-byte slots from the barrier base
constexpr int kBarQ = 0;                     // Q landed
constexpr int kBarKFull = 1;                 // + stage: K tile landed
constexpr int kBarVFull = kBarKFull + kStages;
constexpr int kBarKEmpty = kBarVFull + kStages;  // + stage: K tile released
constexpr int kBarVEmpty = kBarKEmpty + kStages;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// One arrival that also expects `bytes` of TMA transactions this phase.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Block until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// TMA: the box at coordinates (c0, c1, c2, c3) of `map` into shared memory
// at `dst`, completing `bytes` on barrier `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads of wgmma accumulators above the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma shared-memory descriptor: start address, leading byte offset (the
// stride between column blocks of an N-major operand; unused by K-major
// ones), stride byte offset (between 8-row groups) and swizzle.
template <int HD>
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo) {
  using T = Tile<HD>;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>((8 * T::kRowBytes) >> 4) << 32) |
         (T::kLayout << 62);
}

// d (64 x 64, float32) (+)= A (64 x 16, shared, K-major) B (64 x 16,
// shared, K-major)^T; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x N, float32) += A (64 x 16, bf16 in registers) B (16 x N, shared,
// N-major, so transposed)
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b);

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8],
                                          const uint32_t (&a)[4],
                                          uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                          const uint32_t (&a)[4],
                                          uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                          const uint32_t (&a)[4],
                                          uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128],
                                          const uint32_t (&a)[4],
                                          uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       bf16* __restrict__ out, int Sq, int H, int KV,
                       int n_tiles, int window, float softcap, float scale,
                       int q_off) {
  using T = Tile<HD>;
  const int tile = n_tiles - 1 - static_cast<int>(blockIdx.y);  // heavy first
  const int h = blockIdx.x;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int S = q_off + Sq;  // keys; queries are rows q_off .. S - 1
  const int q0 = tile * kBM;  // the tile's first query, local (Q's map)
  const int g0 = q_off + q0;  // its global row
  const int q_last = q_off + min(q0 + kBM, Sq) - 1;
  const int kv_lo = window > 0 ? max(0, g0 - window + 1) : 0;
  const int t_lo = kv_lo / kBN, t_hi = q_last / kBN;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base, sk = base + T::kOffK, sv = base + T::kOffV;
  const uint32_t bars = base + T::kOffBar;

  if (threadIdx.x == 0) {
    mbar_init(bars + 8 * kBarQ, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * (kBarKFull + s), 1);
      mbar_init(bars + 8 * (kBarVFull + s), 1);
      mbar_init(bars + 8 * (kBarKEmpty + s), 128 * kConsumers);
      mbar_init(bars + 8 * (kBarVEmpty + s), 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ---- producer warpgroup: one thread issues every copy ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 128 * kConsumers) {
      mbar_expect_tx(bars + 8 * kBarQ, T::kQBytes);
      for (int c = 0; c < T::kBlocks; ++c)
        tma_load(sq + c * kBM * T::kRowBytes, &tm_q, bars + 8 * kBarQ,
                 c * T::kCols, h, q0, b);
      for (int t = t_lo, n = 0; t <= t_hi; ++t, ++n) {
        const int st = n % kStages;
        const uint32_t free_parity = ((n / kStages) & 1) ^ 1;
        const uint32_t kfull = bars + 8 * (kBarKFull + st);
        const uint32_t vfull = bars + 8 * (kBarVFull + st);
        mbar_wait(bars + 8 * (kBarKEmpty + st), free_parity);
        mbar_expect_tx(kfull, T::kKVBytes);
        for (int c = 0; c < T::kBlocks; ++c)
          tma_load(sk + st * T::kKVBytes + c * kBN * T::kRowBytes, &tm_k,
                   kfull, c * T::kCols, kvh, t * kBN, b);
        mbar_wait(bars + 8 * (kBarVEmpty + st), free_parity);
        mbar_expect_tx(vfull, T::kKVBytes);
        for (int c = 0; c < T::kBlocks; ++c)
          tma_load(sv + st * T::kKVBytes + c * kBN * T::kRowBytes, &tm_v,
                   vfull, c * T::kCols, kvh, t * kBN, b);
      }
    }
  } else {
    // ---- consumer warpgroup wg: global rows g0 + 64 wg + [0, 64) ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int col = 2 * (lane % 4);  // accumulator column pair in 8
    const int wg_first = g0 + 64 * wg;
    const int wg_last = min(wg_first + 64, S) - 1;  // < wg_first: no row
    const int rows[2] = {wg_first + 16 * (tid / 32) + lane / 4,
                         wg_first + 16 * (tid / 32) + lane / 4 + 8};
    const bool capped = softcap > 0.f;
    // scores to log2-domain logits: s * scale * log2 e, or
    // cap * log2 e * tanh(s * scale / cap)
    const float in_mul = capped ? scale / softcap : scale * kLog2e;
    const float out_mul = capped ? softcap * kLog2e : 1.f;
    const uint32_t q_wg = sq + 64 * wg * T::kRowBytes;

    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};  // running max (log2 domain)
    float l[2] = {0.f, 0.f};              // this thread's part of the sums

    mbar_wait(bars + 8 * kBarQ, 0);
    for (int t = t_lo, n = 0; t <= t_hi; ++t, ++n) {
      const int st = n % kStages;
      const uint32_t parity = (n / kStages) & 1;
      const uint32_t kfull = bars + 8 * (kBarKFull + st);
      const uint32_t vfull = bars + 8 * (kBarVFull + st);
      const uint32_t kfree = bars + 8 * (kBarKEmpty + st);
      const uint32_t vfree = bars + 8 * (kBarVEmpty + st);
      const int k0 = t * kBN;
      // no row of this warpgroup sees a key of the tile: release it unread
      if (wg_last < wg_first || k0 > wg_last ||
          (window > 0 && k0 + kBN - 1 <= wg_first - window)) {
        mbar_wait(kfull, parity);
        mbar_arrive(kfree);
        mbar_wait(vfull, parity);
        mbar_arrive(vfree);
        continue;
      }

      // S = Q K^T: s[4j + e] is row rows[e / 2], key k0 + 8j + col + e % 2
      float s[32];
      mbar_wait(kfull, parity);
      const uint32_t k_tile = sk + st * T::kKVBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int c = kk / (T::kCols / 16);       // column block
        const int w = kk % (T::kCols / 16) * 32;  // byte offset in a row
        wgmma_ss_n64(s,
                     make_desc<HD>(q_wg + c * kBM * T::kRowBytes + w, 16),
                     make_desc<HD>(k_tile + c * kBN * T::kRowBytes + w, 16),
                     kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      mbar_arrive(kfree);

      // scale, softcap, then the mask (a tile inside every row's causal
      // and window bounds needs none)
      if (capped) {
#pragma unroll
        for (int i = 0; i < 32; ++i)
          s[i] = out_mul * tanh_approx(s[i] * in_mul);
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] *= in_mul;
      }
      if (!(k0 + kBN - 1 <= wg_first &&
            (window <= 0 || k0 > wg_last - window))) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int key = k0 + 8 * (i / 4) + col + (i & 1);
          const int row = rows[(i >> 1) & 1];
          const bool live =
              key <= row && key < S && (window <= 0 || key > row - window);
          if (!live) s[i] = -INFINITY;
        }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < 32; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      float alpha[2], mu[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        // a row with no live key yet: subtract 0, so exp2(-inf) = 0
        mu[r] = m_new == -INFINITY ? 0.f : m_new;
        alpha[r] = ex2(m[r] - mu[r]);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        s[i] = ex2(s[i] - mu[(i >> 1) & 1]);
        l[(i >> 1) & 1] += s[i];
      }
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      // P in bf16 as wgmma's A fragments, k-step ks = keys 16 ks + [0, 16)
      uint32_t p[4][4];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          p[ks][r] = pack_bf16(s[8 * ks + 2 * r], s[8 * ks + 2 * r + 1]);

      // O += P V
      mbar_wait(vfull, parity);
      const uint32_t v_tile = sv + st * T::kKVBytes;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_rs<HD>(o, p[ks],
                     make_desc<HD>(v_tile + ks * 16 * T::kRowBytes,
                                   kBN * T::kRowBytes));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      mbar_arrive(vfree);
    }

    // out = O / l, 0 for a row with no live key
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      l[r] = l[r] == 0.f ? 0.f : 1.f / l[r];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (rows[r] >= S) continue;
      const size_t row = static_cast<size_t>(b) * Sq + rows[r] - q_off;
      bf16* orow = out + (row * H + h) * HD;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j + col) =
            pack_bf16(o[4 * j + 2 * r] * l[r], o[4 * j + 2 * r + 1] * l[r]);
    }
  }
}

// Tensor map of a contiguous (B, S, heads, HD) bf16 tensor in boxes of
// kCols x 1 x rows x 1 (one column block of `rows` sequence rows).
template <int HD>
CUresult make_map(CUtensorMap* map, const void* ptr, int B, int S, int heads,
                  int rows) {
  using T = Tile<HD>;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(HD),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {2ull * HD, 2ull * HD * heads,
                                 2ull * HD * heads * S};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(T::kCols), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return cuTensorMapEncodeTiled(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, T::kSwizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int H, int KV, int window, float softcap, float scale,
           int q_off, cudaStream_t stream) {
  using T = Tile<HD>;
  static_assert(T::kSmem <= kMaxSmem, "tiles exceed shared memory");
  const int n_tiles = (Sq + kBM - 1) / kBM;
  if (n_tiles > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mq, mk, mv;
  if (make_map<HD>(&mq, q, B, Sq, H, kBM) != CUDA_SUCCESS ||
      make_map<HD>(&mk, k, B, q_off + Sq, KV, kBN) != CUDA_SUCCESS ||
      make_map<HD>(&mv, v, B, q_off + Sq, KV, kBN) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_attention_kernel<HD><<<dim3(H, n_tiles, B), kThreads, T::kSmem,
                               stream>>>(mq, mk, mv, static_cast<bf16*>(out),
                                         Sq, H, KV, n_tiles, window,
                                         softcap, scale, q_off);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// q (B, Sq, H, hd) at global rows q_off .. q_off + Sq - 1, k/v (B, q_off +
// Sq, KV, hd); hd one of 16, 32, 64, 128, 256; window <= 0: no window;
// softcap <= 0: no softcap. Every pointer 16-byte aligned.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int Sq,
                                      int H, int KV, int hd, int window,
                                      float softcap, float scale, int q_off,
                                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || Sq <= 0 || q_off < 0 || H <= 0 || KV <= 0 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FLASH_LAUNCH(HD)                                                    \
  launch<HD>(q, k, v, out, B, Sq, H, KV, window, softcap, scale, q_off, st)
  switch (hd) {
    case 16:
      return FLASH_LAUNCH(16);
    case 32:
      return FLASH_LAUNCH(32);
    case 64:
      return FLASH_LAUNCH(64);
    case 128:
      return FLASH_LAUNCH(128);
    case 256:
      return FLASH_LAUNCH(256);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLASH_LAUNCH
}
