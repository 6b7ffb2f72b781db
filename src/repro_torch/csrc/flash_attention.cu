// flash_attention: causal GQA online-softmax attention on Hopper's tensor
// cores, for bf16 inputs.
//
// Replaces the TPU kernel src/repro/kernels/flash_attn.py::flash_attention
// (a Pallas kernel on a (B*H, Tq/bq, Tk/bk) grid that carries the running
// max, sum and accumulator of a q tile in VMEM scratch across the
// sequential kv grid steps). Float32 inputs, and bf16 rows whose width TMA
// cannot take (D not a multiple of 8), go to the split-TF32 kernel in
// flash_attention_f32.cu.
//
// Contract: q [B, H, Tq, D], k/v [B, Hkv, Tk, D], bf16, contiguous, H a
// multiple of Hkv (query head h reads kv head h / (H/Hkv)), D <= 256 and a
// multiple of 8 -> out [B, H, Tq, D] bf16. The reference's function in f32:
// the causal mask is row >= col (only Tq == Tk is asked of it); masked
// scores are -inf and the reference's guards keep them out: m_safe = 0 for
// a row with no finite score yet, p = 0 where the score is not finite,
// corr = 0 while the running max is -inf; out = acc / max(l, 1e-30),
// rounded once to bf16.
//
// Arithmetic. S = Q.K^T runs on the tensor cores (wgmma, bf16 operands,
// f32 accumulation): products of bf16 values are exact in f32, so only the
// order of the sum differs from the f32 reference. The 1/sqrt(D) scale
// multiplies S in f32 after the product, folded with log2(e) into one FMA
// before the SFU's 2^x (ex2.approx, which flushes a p below 2^-126 to 0
// against a row sum of at least 1); q is not scaled first, since q * scale
// is no bf16 value. P.V needs P as a bf16 operand: rounding p once to bf16
// leaves an error of 2^-9 of p, which moves outputs near zero by more than
// the gate of one bf16 step plus 1e-5 (tests/test_torch_kernels.py shows
// it). So p is split, p_hi = bf16(p) and p_lo = bf16(p - p_hi), and both
// go through a register-A wgmma with V into one f32 accumulator: an error
// of about 2^-17 of p, at 1.5x the tensor-core work of a single bf16 P.
//
// The bf16-score variant (entry flash_attention_bf16, kernel
// flash_attention_bf16_wgmma; the LM's attn_p_bf16 and attn_scores_bf16
// knobs, src/repro/models/transformer.py _attention_scan) keeps the
// reference's rounding points and takes P.V in one register-A wgmma (no
// p_lo pass), so its least time is 1.0x the flops bound, not the split's
// 1.5x. What bounds it instead is the softmax on the CUDA cores: the
// first design rounded one value at a time (a convert and a widen for
// each of S, s - m and p, and a second convert to pack p), which took
// more time than the tensor cores. So the CUDA cores round in packed
// pairs, and each value is converted once:
// - kMode 2 (attn_scores_bf16): one cvt.rn.bf16x2.f32 rounds two S
//   accumulators into one register; the row max runs on the pairs
//   (max.bf16x2, exact); m stays a bf16 value, so bf16(m_safe) = m_safe,
//   and s - m_safe is one sub.rn.bf16x2 a pair (a single rounding of the
//   exact difference, which is what the plain version's float32
//   difference rounded to bf16 gives for every pair of finite bf16
//   values: tools/flash_bf16.py --part gate checks all 2^32 on the card);
//   the pair is widened (a shift and a mask), 2^(x log2 e) taken on the
//   SFU, and one cvt packs p, which is then P.V's operand as it is; l sums
//   the packed bf16 values in f32. Q is rounded to bf16(q / bf16(sqrt D))
//   by a multiply with the f32 reciprocal (equal for every bf16 q:
//   tests/test_torch_attn_bf16.py), in shared memory once it lands, while
//   the first K/V stage loads.
// - kMode 1 (attn_p_bf16): S and p in f32 as above, l sums the f32 p, one
//   cvt packs each pair of p into P.V's operand.
// A masked score (-inf) gives p = 2^-inf = 0 without a test, and a fully
// masked row has m_safe = 0. p lives in 32 packed registers, not 64
// floats, and no instance spills. The kv loop is unrolled by two, which
// the H100 runs 2 to 11% faster than one tile an iteration. What is left
// above the products is the softmax's latency between a tile's S and its
// P.V; taking turns on the tensor cores between the two consumer
// warpgroups (FA3's ping-pong, named barriers) made both modes slower (by
// 13 and 19% on the H100, tools/flash_bf16.py's "turns") and was left
// out.
//
// Bound on the H100: operations. 4*B*H*Tq*Tk*D flops (halved by the
// causal mask) at 989 TFLOP/s bf16 dense; the split makes the least time
// 1.5x that bound. q, k, v and out are read or written once each (an
// eighth of the flops' time at the LM's shapes).
//
// The design: one block per (b*h, q tile), heaviest (last) q tiles first.
// Consumer warpgroups of 64 q rows each (two at D <= 128, with 128-row kv
// tiles; one at D = 256, with 64-row kv tiles) and one producer warpgroup,
// of which one thread issues TMA copies (cp.async.bulk.tensor) into a ring
// of three K/V stages, with a full and an empty mbarrier per stage: the
// loads of the next tiles run while the consumers work. The tensor maps
// are 3-D ([B*H, T, D]), so TMA zero-fills rows past a ragged T (and
// columns past D < 64) instead of reading the next head. Tiles are
// 128-byte swizzled panels of 64 columns, [rows][64] bf16, which is what
// wgmma's descriptors read: Q and K as K-major operands, V as an MN-major
// B operand (transpose bit set; LBO = the stride of a 64-column panel,
// SBO = 1024 bytes per 8 rows). Softmax runs on the S accumulator in
// registers: a row of the m64 fragment lies in a quad of threads, so its
// max takes two shuffles, and the sum stays per thread until the end. The
// accumulator layout of S is the register-A layout of P, so P needs no
// shared memory. Inside a warpgroup, tile j's S = Q K^T is issued together
// with tile j-1's P.V, and tile j's softmax runs while that P.V is still
// on the tensor cores; O is rescaled once it has landed. Only tiles that
// cross Tk or the diagonal are masked. The producer warpgroup gives
// registers up (setmaxnreg: 56 a thread, which its loop needs without
// spilling) to the two consumer warpgroups (224). Taking turns on the
// tensor cores between the two consumer warpgroups (named barriers, as
// FA3 does) gained nothing here and was left out. Shared memory: Q 32 KB
// + 3 x (K 32 KB + V 32 KB) = 224 KB at D = 128 and D = 256, 112 KB at
// D = 64. This kernel and the bf16-score variant share the block's
// set-up, the producer and the epilogue; each keeps its own consumer
// loop: at D = 128 this kernel's registers sit at ptxas's limit, and
// with the variant's helpers for S's issue and the mask in its loop as
// well, it spilled 428 bytes and took 2.6x its time.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "device_guard.cuh"

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kStages = 3;

// what P.V reads: p split into two bf16 halves (the float32 contract),
// bf16(p) of an f32 p (attn_p_bf16), or bf16 scores and p (attn_scores_bf16)
constexpr int kSplitP = 0, kBf16P = 1, kBf16S = 2;
constexpr float kLog2e = 1.4426950408889634f;

template <int kD> struct Tiles;  // kv rows per tile, consumer warpgroups
template <> struct Tiles<64> { static constexpr int kBK = 128, kWG = 2; };
template <> struct Tiles<128> { static constexpr int kBK = 128, kWG = 2; };
template <> struct Tiles<256> { static constexpr int kBK = 64, kWG = 1; };

// Shared memory, in bytes from a 1024-aligned base: Q as kP panels of
// [kBQ][64] bf16; per stage, K then V as kP panels of [kBK][64]; then the
// barriers: full[kStages], empty[kStages], q.
template <int kD>
struct Layout {
  static constexpr int kBK = Tiles<kD>::kBK, kWG = Tiles<kD>::kWG;
  static constexpr int kBQ = 64 * kWG, kP = kD / 64;
  static constexpr int kQPanel = kBQ * 128, kKPanel = kBK * 128;
  static constexpr int kQBytes = kP * kQPanel;
  static constexpr int kKBytes = kP * kKPanel;
  static constexpr int kStageBytes = 2 * kKBytes;
  static constexpr int kBarOff = kQBytes + kStages * kStageBytes;
  static constexpr int kSmem = kBarOff + 64 + 1024;
  static constexpr int kThreads = 128 * (kWG + 1);
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// Wait for the completion of the barrier's phase of the given parity.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte swizzled operand.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// m64nNk16, f32 += bf16 * bf16. ss: A and B from shared memory (K-major);
// rs: A from registers, B from shared memory, MN-major (transposed).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57,"
      "%58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57,"
      "%58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57,"
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85,"
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99,"
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110,"
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121,"
      "%122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]),
        "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]),
        "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]),
        "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]),
        "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]),
        "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
        "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t da,
                                       uint64_t db, int scale_d) {
  if constexpr (N == 64) wgmma_ss_n64(d, da, db, scale_d);
  else wgmma_ss_n128(d, da, db, scale_d);
}

template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2],
                                       const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, db, 1);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, db, 1);
  else wgmma_rs_n256(d, a, db, 1);
}

// p_hi = bf16(p), p_lo = bf16(p - p_hi), two values packed per register
// (the lower column in the low half).
__device__ __forceinline__ void split(float p0, float p1, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(p0 - hf.x, p1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ uint32_t full_bar(uint32_t bars, int s) {
  return bars + 8u * s;
}
__device__ __forceinline__ uint32_t empty_bar(uint32_t bars, int s) {
  return bars + 8u * (kStages + s);
}
__device__ __forceinline__ uint32_t q_full_bar(uint32_t bars) {
  return bars + 8u * 2 * kStages;
}

// What a block computes: query head bh (of B*H), its kv head, its first q
// row (heaviest, last, q tiles first) and the kv tiles it reads.
struct Block {
  int bh, kvh, q0, n_kt;
};

template <int kD>
__device__ __forceinline__ Block block_of(int H, int G, int Tq, int Tk,
                                          int causal) {
  using L = Layout<kD>;
  Block b;
  b.bh = blockIdx.x;
  b.kvh = (b.bh / H) * (H / G) + (b.bh % H) / G;
  b.q0 = (gridDim.y - 1 - blockIdx.y) * L::kBQ;
  b.n_kt = (Tk + L::kBK - 1) / L::kBK;
  if (causal) b.n_kt = min(b.n_kt, (min(b.q0 + L::kBQ, Tq) - 1) / L::kBK + 1);
  return b;
}

template <int kD>
__device__ __forceinline__ void init_barriers(uint32_t bars) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar(bars, s), 1);
      mbar_init(empty_bar(bars, s), Layout<kD>::kWG);
    }
    mbar_init(q_full_bar(bars), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The producer warpgroup: one thread loads Q, then keeps the ring of K/V
// stages filled.
template <int kD>
__device__ __forceinline__ void produce(const CUtensorMap* tq,
                                        const CUtensorMap* tk,
                                        const CUtensorMap* tv, uint32_t q_s,
                                        uint32_t bars, const Block& b) {
  using L = Layout<kD>;
  constexpr int kWG = L::kWG, kP = L::kP;
  if constexpr (kWG > 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
  if (threadIdx.x == kWG * 128) {
    const uint32_t kv_s = q_s + L::kQBytes;
    mbar_expect_tx(q_full_bar(bars), L::kQBytes);
    for (int p = 0; p < kP; ++p)
      tma_load(q_s + p * L::kQPanel, tq, q_full_bar(bars), 64 * p, b.q0, b.bh);
    for (int kt = 0; kt < b.n_kt; ++kt) {
      const int s = kt % kStages, use = kt / kStages;
      if (use > 0) mbar_wait(empty_bar(bars, s), (use - 1) & 1);
      mbar_expect_tx(full_bar(bars, s), L::kStageBytes);
      const uint32_t k_dst = kv_s + s * L::kStageBytes;
      for (int p = 0; p < kP; ++p) {
        tma_load(k_dst + p * L::kKPanel, tk, full_bar(bars, s), 64 * p,
                 kt * L::kBK, b.kvh);
        tma_load(k_dst + L::kKBytes + p * L::kKPanel, tv, full_bar(bars, s),
                 64 * p, kt * L::kBK, b.kvh);
      }
    }
  }
}

// S = Q K^T of the kv tile at k_sm into sc: D / 16 steps of k16, each
// inside one 64-column panel; committed as one wgmma group.
template <int kD>
__device__ __forceinline__ void issue_scores(float (&sc)[Layout<kD>::kBK / 2],
                                             uint32_t q_wg, uint32_t k_sm) {
  using L = Layout<kD>;
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    mma_ss<L::kBK>(sc,
                   sw128_desc(q_wg + (kk / 4) * L::kQPanel + off, 16, 1024),
                   sw128_desc(k_sm + (kk / 4) * L::kKPanel + off, 16, 1024),
                   kk > 0);
  }
  wg_commit();
}

// -inf at the scores of kv tile k0 that are past Tk or, causal, above the
// diagonal. The thread holds rows row_a (sc[4j], sc[4j+1]) and row_b
// (sc[4j+2], sc[4j+3]) at columns k0 + 8j + cq + {0, 1}.
template <int kBK>
__device__ __forceinline__ void mask_tile(float (&sc)[kBK / 2], int k0,
                                          int Tk, int causal, int row_a,
                                          int row_b, int cq) {
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = k0 + 8 * j + cq + e;
      if (col >= Tk || (causal && col > row_a)) sc[4 * j + e] = -INFINITY;
      if (col >= Tk || (causal && col > row_b)) sc[4 * j + 2 + e] = -INFINITY;
    }
  }
}

// Both rows' sums across their quads, then out = o / max(l, 1e-30) in bf16
// for the rows below Tq and the columns below D.
template <int kD>
__device__ __forceinline__ void store_rows(const float (&o)[kD / 2],
                                           float l_a, float l_b,
                                           __nv_bfloat16* out, int bh, int Tq,
                                           int D, int row_a, int row_b,
                                           int cq) {
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
  __nv_bfloat16* out_a = out + ((size_t)bh * Tq + row_a) * D;
  __nv_bfloat16* out_b = out_a + (size_t)8 * D;
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
    const int col = 8 * j + cq;
    if (col >= D) continue;
    if (row_a < Tq)
      *reinterpret_cast<__nv_bfloat162*>(out_a + col) =
          __floats2bfloat162_rn(o[4 * j] / den_a, o[4 * j + 1] / den_a);
    if (row_b < Tq)
      *reinterpret_cast<__nv_bfloat162*>(out_b + col) =
          __floats2bfloat162_rn(o[4 * j + 2] / den_b, o[4 * j + 3] / den_b);
  }
}

// scale_log2: 1/sqrt(D) * log2(e)
template <int kD>
__global__ void __launch_bounds__(Layout<kD>::kThreads, 1)
flash_attention_wgmma(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      __nv_bfloat16* __restrict__ out, int H, int G, int Tq,
                      int Tk, int D, int causal, float scale_log2) {
  using L = Layout<kD>;
  constexpr int kBK = L::kBK, kWG = L::kWG;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t kv_s = q_s + L::kQBytes;
  const uint32_t bars = q_s + L::kBarOff;
  auto full = [&](int s) { return full_bar(bars, s); };
  auto empty = [&](int s) { return empty_bar(bars, s); };

  const Block b = block_of<kD>(H, G, Tq, Tk, causal);
  const int bh = b.bh, q0 = b.q0, n_kt = b.n_kt;
  const int wg = threadIdx.x / 128;
  init_barriers<kD>(bars);

  if (wg == kWG) {
    produce<kD>(&tq, &tk, &tv, q_s, bars, b);
  } else {
    // consumer warpgroup wg: q rows q0 + 64 wg .. + 63
    if constexpr (kWG > 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
    const int t = threadIdx.x % 128, w = t / 32, lane = t % 32;
    const int row_a = q0 + 64 * wg + 16 * w + lane / 4, row_b = row_a + 8;
    const int cq = 2 * (lane % 4);
    const uint32_t q_wg = q_s + wg * 64 * 128;
    float o[kD / 2];
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) o[i] = 0.0f;
    float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.0f, l_b = 0.0f;
    float cr_a = 0.0f, cr_b = 0.0f;
    float sc[kBK / 2];                         // S, then p, of one kv tile
    uint32_t p_hi[kBK / 16][4], p_lo[kBK / 16][4];

    // S = Q K^T of the tile in stage s: D / 16 steps of k16, each inside
    // one 64-column panel; committed as one wgmma group
    auto issue_scores = [&](int s) {
      const uint32_t k_sm = kv_s + s * L::kStageBytes;
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        mma_ss<kBK>(sc,
                    sw128_desc(q_wg + (kk / 4) * L::kQPanel + off, 16, 1024),
                    sw128_desc(k_sm + (kk / 4) * L::kKPanel + off, 16, 1024),
                    kk > 0);
      }
      wg_commit();
    };
    // O += P_hi V + P_lo V of the tile in stage s: k16 step kk reads V
    // rows 16 kk .. 16 kk + 15; committed as one wgmma group
    auto issue_values = [&](int s) {
      const uint32_t v_sm = kv_s + s * L::kStageBytes + L::kKBytes;
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t dv = sw128_desc(v_sm + kk * 2048, L::kKPanel, 1024);
        mma_rs<kD>(o, p_hi[kk], dv);
        mma_rs<kD>(o, p_lo[kk], dv);
      }
      wg_commit();
    };
    // mask S of tile kt where it must be, update the running max (m, in
    // units of log2, S times scale_log2) and sum, leave p in sc and the
    // correction of O in cr_a, cr_b. The thread holds rows row_a (sc[4j],
    // sc[4j+1]) and row_b (sc[4j+2], sc[4j+3]) at columns k0 + 8j + cq +
    // {0, 1}. A tile needs the mask only past Tk or, causal, past the
    // warpgroup's first row.
    auto softmax = [&](int kt) {
      const int k0 = kt * kBK;
      if (k0 + kBK > Tk || (causal && k0 + kBK - 1 > q0 + 64 * wg)) {
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = k0 + 8 * j + cq + e;
            if (col >= Tk || (causal && col > row_a)) sc[4 * j + e] = -INFINITY;
            if (col >= Tk || (causal && col > row_b))
              sc[4 * j + 2 + e] = -INFINITY;
          }
        }
      }
      float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        mx_a = fmaxf(mx_a, fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx_b = fmaxf(mx_b, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
      }
      const float mn_a = fmaxf(m_a, mx_a * scale_log2);
      const float mn_b = fmaxf(m_b, mx_b * scale_log2);
      const float ms_a = isfinite(mn_a) ? mn_a : 0.0f;
      const float ms_b = isfinite(mn_b) ? mn_b : 0.0f;
      cr_a = isfinite(m_a) ? ex2(m_a - ms_a) : 0.0f;
      cr_b = isfinite(m_b) ? ex2(m_b - ms_b) : 0.0f;
      m_a = mn_a;
      m_b = mn_b;
      float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float& x = sc[4 * j + e];
          const float ms = e < 2 ? ms_a : ms_b;
          x = isfinite(x) ? ex2(fmaf(x, scale_log2, -ms)) : 0.0f;
          if (e < 2) sum_a += x;
          else sum_b += x;
        }
      }
      l_a = l_a * cr_a + sum_a;
      l_b = l_b * cr_b + sum_b;
    };
    // rescale O by cr and split p into its bf16 halves in wgmma's
    // register-A layout: register i of k16 step kk holds sc[8 kk + 2 i],
    // sc[8 kk + 2 i + 1]
    auto rescale_and_split = [&]() {
#pragma unroll
      for (int j = 0; j < kD / 8; ++j) {
        o[4 * j] *= cr_a;
        o[4 * j + 1] *= cr_a;
        o[4 * j + 2] *= cr_b;
        o[4 * j + 3] *= cr_b;
      }
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          split(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1], p_hi[kk][i],
                p_lo[kk][i]);
        }
    };

    // Tile kt's scores go to the tensor cores together with tile kt-1's
    // P.V, and tile kt's softmax runs while that P.V is still in flight.
    mbar_wait(q_full_bar(bars), 0);
    mbar_wait(full(0), 0);
    wg_fence();
    issue_scores(0);
    wg_wait<0>();
    pin(sc);
    softmax(0);
    rescale_and_split();
    for (int kt = 1; kt < n_kt; ++kt) {
      const int s = kt % kStages, prev = (kt - 1) % kStages;
      mbar_wait(full(s), (kt / kStages) & 1);
      pin(sc);
      pin(o);
      pin(p_hi);
      pin(p_lo);
        wg_fence();
      issue_scores(s);
      issue_values(prev);
        wg_wait<1>();          // the scores are in
      pin(sc);
      softmax(kt);
      wg_wait<0>();          // so is tile kt-1's P.V
      pin(o);
      pin(p_hi);
      pin(p_lo);
      if (t == 0) mbar_arrive(empty(prev));
      rescale_and_split();
    }
    pin(o);
    pin(p_hi);
    pin(p_lo);
    wg_fence();
    issue_values((n_kt - 1) % kStages);
    wg_wait<0>();
    pin(o);
    pin(p_hi);
    pin(p_lo);
    if (t == 0) mbar_arrive(empty((n_kt - 1) % kStages));

    store_rows<kD>(o, l_a, l_b, out, bh, Tq, D, row_a, row_b, cq);
  }
}

// The bf16-score variant: kMode kBf16P (attn_p_bf16) or kBf16S
// (attn_scores_bf16), with the split kernel's blocks, ring and producer.
// scale_log2: 1/sqrt(D) * log2(e) (kBf16P); q_rcp: the float32 reciprocal
// of bf16(sqrt(D)), which scales Q (kBf16S).
template <int kD, int kMode>
__global__ void __launch_bounds__(Layout<kD>::kThreads, 1)
flash_attention_bf16_wgmma(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           __nv_bfloat16* __restrict__ out, int H, int G,
                           int Tq, int Tk, int D, int causal,
                           float scale_log2, float q_rcp) {
  using L = Layout<kD>;
  constexpr int kBK = L::kBK, kWG = L::kWG, kP = L::kP;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t kv_s = q_s + L::kQBytes;
  const uint32_t bars = q_s + L::kBarOff;
  const Block b = block_of<kD>(H, G, Tq, Tk, causal);
  const int q0 = b.q0, n_kt = b.n_kt;
  const int wg = threadIdx.x / 128;
  init_barriers<kD>(bars);

  if (wg == kWG) {
    produce<kD>(&tq, &tk, &tv, q_s, bars, b);
  } else {
    if constexpr (kWG > 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
    const int t = threadIdx.x % 128, w = t / 32, lane = t % 32;
    const int row_a = q0 + 64 * wg + 16 * w + lane / 4, row_b = row_a + 8;
    const int cq = 2 * (lane % 4);
    const uint32_t q_wg = q_s + wg * 64 * 128;
    float o[kD / 2];
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) o[i] = 0.0f;
    float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.0f, l_b = 0.0f;
    float cr_a = 0.0f, cr_b = 0.0f;
    float sc[kBK / 2];      // S of one kv tile, as the wgmma leaves it
    // p in wgmma's register-A layout, bf16 pairs: register i of k16 step
    // kk holds sc[8 kk + 2 i], sc[8 kk + 2 i + 1] (row_a for even i,
    // row_b for odd). pk: the tile in softmax; pv: the tile whose P.V is
    // in flight.
    uint32_t pk[kBK / 16][4], pv[kBK / 16][4];

    // O += P V of the tile in stage s, one register-A wgmma a k16 step
    auto issue_values = [&](int s) {
      const uint32_t v_sm = kv_s + s * L::kStageBytes + L::kKBytes;
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        mma_rs<kD>(o, pv[kk], sw128_desc(v_sm + kk * 2048, L::kKPanel, 1024));
      wg_commit();
    };
    // Mask S of tile kt where it must be, update the running max and sum,
    // leave p in pk and the correction of O in cr_a, cr_b.
    auto softmax = [&](int kt) {
      const int k0 = kt * kBK;
      if (k0 + kBK > Tk || (causal && k0 + kBK - 1 > q0 + 64 * wg))
        mask_tile<kBK>(sc, k0, Tk, causal, row_a, row_b, cq);
      float sum_a = 0.0f, sum_b = 0.0f;
      if constexpr (kMode == kBf16S) {
        // S rounded in pairs; the row max on the pairs is exact (a max of
        // bf16 values is one), m in natural units and a bf16 value
        uint32_t mx2_a = 0xFF80FF80u, mx2_b = 0xFF80FF80u;    // -inf, -inf
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            pk[kk][i] = pack_bf16x2(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);
            if (i % 2) mx2_b = max_bf16x2(mx2_b, pk[kk][i]);
            else mx2_a = max_bf16x2(mx2_a, pk[kk][i]);
          }
        float mx_a = fmaxf(bf16_lo(mx2_a), bf16_hi(mx2_a));
        float mx_b = fmaxf(bf16_lo(mx2_b), bf16_hi(mx2_b));
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
          mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
        }
        const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
        const float ms_a = isfinite(mn_a) ? mn_a : 0.0f;
        const float ms_b = isfinite(mn_b) ? mn_b : 0.0f;
        cr_a = isfinite(m_a) ? ex2((m_a - ms_a) * kLog2e) : 0.0f;
        cr_b = isfinite(m_b) ? ex2((m_b - ms_b) * kLog2e) : 0.0f;
        m_a = mn_a;
        m_b = mn_b;
        // bf16(m_safe) = m_safe; p = bf16(2^(bf16(s - m_safe) log2 e)),
        // each pair rounded once; a masked s (-inf) gives p = 0
        const uint32_t mb_a = pack_bf16x2(ms_a, ms_a);
        const uint32_t mb_b = pack_bf16x2(ms_b, ms_b);
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const uint32_t d = sub_bf16x2(pk[kk][i], i % 2 ? mb_b : mb_a);
            const uint32_t p = pack_bf16x2(ex2(bf16_lo(d) * kLog2e),
                                           ex2(bf16_hi(d) * kLog2e));
            pk[kk][i] = p;
            if (i % 2) sum_b += bf16_lo(p) + bf16_hi(p);
            else sum_a += bf16_lo(p) + bf16_hi(p);
          }
      } else {
        // S and p in float32 (m in units of log2, S times scale_log2),
        // l sums the float32 p, P.V takes bf16(p); a masked s gives p = 0
        float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j) {
          mx_a = fmaxf(mx_a, fmaxf(sc[4 * j], sc[4 * j + 1]));
          mx_b = fmaxf(mx_b, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
          mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
        }
        const float mn_a = fmaxf(m_a, mx_a * scale_log2);
        const float mn_b = fmaxf(m_b, mx_b * scale_log2);
        const float ms_a = isfinite(mn_a) ? mn_a : 0.0f;
        const float ms_b = isfinite(mn_b) ? mn_b : 0.0f;
        cr_a = isfinite(m_a) ? ex2(m_a - ms_a) : 0.0f;
        cr_b = isfinite(m_b) ? ex2(m_b - ms_b) : 0.0f;
        m_a = mn_a;
        m_b = mn_b;
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float ms = i % 2 ? ms_b : ms_a;
            const float p0 = ex2(fmaf(sc[8 * kk + 2 * i], scale_log2, -ms));
            const float p1 =
                ex2(fmaf(sc[8 * kk + 2 * i + 1], scale_log2, -ms));
            pk[kk][i] = pack_bf16x2(p0, p1);
            if (i % 2) sum_b += p0 + p1;
            else sum_a += p0 + p1;
          }
      }
      l_a = l_a * cr_a + sum_a;
      l_b = l_b * cr_b + sum_b;
    };
    // once tile kt-1's P.V has landed: rescale O by cr, hand p to P.V
    auto rescale_and_take = [&]() {
#pragma unroll
      for (int j = 0; j < kD / 8; ++j) {
        o[4 * j] *= cr_a;
        o[4 * j + 1] *= cr_a;
        o[4 * j + 2] *= cr_b;
        o[4 * j + 3] *= cr_b;
      }
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[kk][i] = pk[kk][i];
    };

    mbar_wait(q_full_bar(bars), 0);
    if constexpr (kMode == kBf16S) {
      // Q of this warpgroup's 64 rows -> bf16(q * q_rcp), which is
      // bf16(q / bf16(sqrt(D))) for every bf16 q, in place (an elementwise
      // map, so the swizzle does not matter), 16 bytes a thread at a time;
      // then make the writes visible to wgmma and wait for the
      // warpgroup's threads. It overlaps the first K/V stage's load.
      uint8_t* q_gen = smem_raw + (q_wg - smem_u32(smem_raw));
#pragma unroll
      for (int p = 0; p < kP; ++p)
#pragma unroll
        for (int r = 0; r < 64 * 128 / 16 / 128; ++r) {
          uint4* at =
              reinterpret_cast<uint4*>(q_gen + p * L::kQPanel) + t + 128 * r;
          uint4 u = *at;
          uint32_t* x = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            x[e] = pack_bf16x2(bf16_lo(x[e]) * q_rcp, bf16_hi(x[e]) * q_rcp);
          *at = u;
        }
      fence_async_smem();
      asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
    }
    mbar_wait(full_bar(bars, 0), 0);
    wg_fence();
    issue_scores<kD>(sc, q_wg, kv_s);
    wg_wait<0>();
    pin(sc);
    softmax(0);
    rescale_and_take();
    // two tiles an iteration (faster than one: see the top of the file)
#pragma unroll 2
    for (int kt = 1; kt < n_kt; ++kt) {
      const int s = kt % kStages, prev = (kt - 1) % kStages;
      mbar_wait(full_bar(bars, s), (kt / kStages) & 1);
      pin(sc);
      pin(o);
      pin(pv);
      wg_fence();
      issue_scores<kD>(sc, q_wg, kv_s + s * L::kStageBytes);
      issue_values(prev);
      wg_wait<1>();          // the scores are in
      pin(sc);
      softmax(kt);
      wg_wait<0>();          // so is tile kt-1's P.V
      pin(o);
      pin(pv);
      if (t == 0) mbar_arrive(empty_bar(bars, prev));
      rescale_and_take();
    }
    pin(o);
    pin(pv);
    wg_fence();
    issue_values((n_kt - 1) % kStages);
    wg_wait<0>();
    pin(o);
    pin(pv);
    if (t == 0) mbar_arrive(empty_bar(bars, (n_kt - 1) % kStages));
    store_rows<kD>(o, l_a, l_b, out, b.bh, Tq, D, row_a, row_b, cq);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime has loaded, so the
// library needs no link against libcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// [n_heads, T, D] bf16 read in boxes of [1, rows, 64], 128-byte swizzled;
// out of bounds reads as zero.
bool tensor_map(CUtensorMap* map, const void* base, int n_heads, int T,
                int D, int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)T,
                              (cuuint64_t)n_heads};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)T * D * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Launch with the dynamic shared memory the kernel asks for.
template <typename... Params, typename... Args>
int start(void (*kernel)(Params...), dim3 grid, int threads, int smem,
          cudaStream_t stream, Args... args) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <int kD, int kMode>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int Hkv, int Tq, int Tk, int D, int causal,
           float scale_log2, float q_rcp, cudaStream_t stream) {
  using L = Layout<kD>;
  CUtensorMap mq, mk, mv;
  if (!tensor_map(&mq, q, B * H, Tq, D, L::kBQ) ||
      !tensor_map(&mk, k, B * Hkv, Tk, D, L::kBK) ||
      !tensor_map(&mv, v, B * Hkv, Tk, D, L::kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(B * H, (Tq + L::kBQ - 1) / L::kBQ);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  if constexpr (kMode == kSplitP)
    return start(flash_attention_wgmma<kD>, grid, L::kThreads, L::kSmem,
                 stream, mq, mk, mv, o, H, H / Hkv, Tq, Tk, D, causal,
                 scale_log2);
  else
    return start(flash_attention_bf16_wgmma<kD, kMode>, grid, L::kThreads,
                 L::kSmem, stream, mq, mk, mv, o, H, H / Hkv, Tq, Tk, D,
                 causal, scale_log2, q_rcp);
}

template <int kMode>
int launch_width(const void* q, const void* k, const void* v, void* out,
                 int B, int H, int Hkv, int Tq, int Tk, int D, int causal,
                 float scale, cudaStream_t s) {
  const float scale_log2 = static_cast<float>(scale * 1.4426950408889634);
  // bf16(sqrt(D)), rounded to nearest even on the host, and its float32
  // reciprocal: bf16(q * q_rcp) = bf16(q / bf16(sqrt(D))) for every bf16 q
  // and every D the kernel takes (tests/test_torch_attn_bf16.py)
  float q_div = sqrtf(static_cast<float>(D));
  uint32_t u;
  memcpy(&u, &q_div, 4);
  u = (u + 0x7FFFu + ((u >> 16) & 1u)) & 0xFFFF0000u;
  memcpy(&q_div, &u, 4);
  const float q_rcp = 1.0f / q_div;
  if (D <= 64)
    return launch<64, kMode>(q, k, v, out, B, H, Hkv, Tq, Tk, D, causal,
                             scale_log2, q_rcp, s);
  if (D <= 128)
    return launch<128, kMode>(q, k, v, out, B, H, Hkv, Tq, Tk, D, causal,
                              scale_log2, q_rcp, s);
  return launch<256, kMode>(q, k, v, out, B, H, Hkv, Tq, Tk, D, causal,
                            scale_log2, q_rcp, s);
}

}  // namespace

// All of q, k, v and out bf16, 16-byte aligned; D a multiple of 8, <= 256.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int B, int H, int Hkv, int Tq,
                               int Tk, int D, int causal, float scale,
                               int device, void* stream) {
  if (B == 0 || H == 0 || Tq == 0) return 0;
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Tk == 0)  // no key: every row is acc / max(l, 1e-30) = 0
    return static_cast<int>(cudaMemsetAsync(
        out, 0, (size_t)B * H * Tq * D * sizeof(__nv_bfloat16), s));
  if (D % 8 || D > 256) return static_cast<int>(cudaErrorInvalidValue);
  return launch_width<kSplitP>(q, k, v, out, B, H, Hkv, Tq, Tk, D, causal,
                               scale, s);
}

// The bf16-score variant: mode 1 = attn_p_bf16, 2 = attn_scores_bf16 (see
// the top of the file); the same contract otherwise.
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* out, int B, int H,
                                    int Hkv, int Tq, int Tk, int D,
                                    int causal, float scale, int mode,
                                    int device, void* stream) {
  if (B == 0 || H == 0 || Tq == 0) return 0;
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Tk == 0)
    return static_cast<int>(cudaMemsetAsync(
        out, 0, (size_t)B * H * Tq * D * sizeof(__nv_bfloat16), s));
  if (D % 8 || D > 256 || (mode != kBf16P && mode != kBf16S))
    return static_cast<int>(cudaErrorInvalidValue);
  if (mode == kBf16P)
    return launch_width<kBf16P>(q, k, v, out, B, H, Hkv, Tq, Tk, D, causal,
                                scale, s);
  return launch_width<kBf16S>(q, k, v, out, B, H, Hkv, Tq, Tk, D, causal,
                              scale, s);
}
