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
// D = 64.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "device_guard.cuh"

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kStages = 3;

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

template <int kD>
__global__ void __launch_bounds__(Layout<kD>::kThreads, 1)
flash_attention_wgmma(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      __nv_bfloat16* __restrict__ out, int H, int G, int Tq,
                      int Tk, int D, int causal, float scale_log2) {
  using L = Layout<kD>;
  constexpr int kBK = L::kBK, kWG = L::kWG, kBQ = L::kBQ, kP = L::kP;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t kv_s = q_s + L::kQBytes;
  const uint32_t bars = q_s + L::kBarOff;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (kStages + s); };
  const uint32_t q_bar = bars + 8u * 2 * kStages;

  const int bh = blockIdx.x;
  const int kvh = (bh / H) * (H / G) + (bh % H) / G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  int n_kt = (Tk + kBK - 1) / kBK;
  if (causal) n_kt = min(n_kt, (min(q0 + kBQ, Tq) - 1) / kBK + 1);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kWG);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kWG) {
    // producer: one thread keeps the ring of K/V stages filled
    if constexpr (kWG > 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    if (threadIdx.x == kWG * 128) {
      mbar_expect_tx(q_bar, L::kQBytes);
      for (int p = 0; p < kP; ++p)
        tma_load(q_s + p * L::kQPanel, &tq, q_bar, 64 * p, q0, bh);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % kStages, use = kt / kStages;
        if (use > 0) mbar_wait(empty(s), (use - 1) & 1);
        mbar_expect_tx(full(s), L::kStageBytes);
        const uint32_t k_dst = kv_s + s * L::kStageBytes;
        for (int p = 0; p < kP; ++p) {
          tma_load(k_dst + p * L::kKPanel, &tk, full(s), 64 * p, kt * kBK,
                   kvh);
          tma_load(k_dst + L::kKBytes + p * L::kKPanel, &tv, full(s), 64 * p,
                   kt * kBK, kvh);
        }
      }
    }
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
        for (int i = 0; i < 4; ++i)
          split(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1], p_hi[kk][i],
                p_lo[kk][i]);
    };

    // Tile kt's scores go to the tensor cores together with tile kt-1's
    // P.V, and tile kt's softmax runs while that P.V is still in flight.
    mbar_wait(q_bar, 0);
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
            __floats2bfloat162_rn(o[4 * j + 2] / den_b,
                                  o[4 * j + 3] / den_b);
    }
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

template <int kD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int Hkv, int Tq, int Tk, int D, int causal,
           float scale_log2, cudaStream_t stream) {
  using L = Layout<kD>;
  CUtensorMap mq, mk, mv;
  if (!tensor_map(&mq, q, B * H, Tq, D, L::kBQ) ||
      !tensor_map(&mk, k, B * Hkv, Tk, D, L::kBK) ||
      !tensor_map(&mv, v, B * Hkv, Tk, D, L::kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_wgmma<kD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(B * H, (Tq + L::kBQ - 1) / L::kBQ);
  flash_attention_wgmma<kD><<<grid, L::kThreads, L::kSmem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), H, H / Hkv, Tq, Tk, D,
      causal, scale_log2);
  return static_cast<int>(cudaGetLastError());
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
  const float scale_log2 = static_cast<float>(scale * 1.4426950408889634);
  if (D % 8 || D > 256) return static_cast<int>(cudaErrorInvalidValue);
  if (D <= 64) return launch<64>(q, k, v, out, B, H, Hkv, Tq, Tk, D, causal, scale_log2, s);
  if (D <= 128) return launch<128>(q, k, v, out, B, H, Hkv, Tq, Tk, D, causal, scale_log2, s);
  return launch<256>(q, k, v, out, B, H, Hkv, Tq, Tk, D, causal, scale_log2, s);
}
