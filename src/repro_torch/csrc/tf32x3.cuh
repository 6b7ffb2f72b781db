// tf32x3.cuh: float32 products on Hopper's TF32 tensor cores, split in
// three passes so that they hold the port's float32 tolerances.
//
// A TF32 operand keeps 10 of float32's 23 fraction bits. Split each f32
// value as x = hi + lo with hi = tf32(x) and lo = tf32(x - hi), both
// rounded explicitly to nearest with ties away from zero, as CUTLASS's
// 3xTF32 does: the low 13 bits of each are then zero, whatever the tensor
// cores do with them. x - hi is exact in f32, so hi + lo carries x to
// within 2^-22 |x|. The product a.b is then a_lo.b_hi + a_hi.b_lo +
// a_hi.b_hi, each pass on the tensor cores with f32 accumulation; the
// dropped a_lo.b_lo is about 2^-22 of |a||b|. A bf16 value is exact in
// TF32 (lo = 0), so bf16 inputs take one pass. Each instruction rounds
// its f32 sum toward zero, and that bias grows with the number of
// instructions that share an accumulator; flash_attention_f32.cu keeps
// those runs short (its comment has the numbers).
//
// Included by l2dist.cu and flash_attention_f32.cu; each still builds
// alone into its own library.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace tf32x3 {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Values c .. c+3 of a row of d values, as f32 (0 past d); vec: one
// 16-byte (f32) or 8-byte (bf16) load, which needs d % 4 == 0 and a base
// aligned to four elements.
template <typename T>
__device__ __forceinline__ float4 load4(const T* row, int c, int d,
                                        bool vec) {
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (c >= d) return v;
  if (vec) {
    if constexpr (sizeof(T) == 4) {
      v = *reinterpret_cast<const float4*>(row + c);
    } else {
      const uint2 u = *reinterpret_cast<const uint2*>(row + c);
      const float2 a = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&u.x));
      const float2 b = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&u.y));
      v = make_float4(a.x, a.y, b.x, b.y);
    }
  } else {
    v.x = to_f32(row[c]);
    if (c + 1 < d) v.y = to_f32(row[c + 1]);
    if (c + 2 < d) v.z = to_f32(row[c + 2]);
    if (c + 3 < d) v.w = to_f32(row[c + 3]);
  }
  return v;
}

// x rounded to TF32 (round to nearest, ties away from zero), as a b32
// register whose low 13 bits are zero; inf and NaN stay what they are.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both TF32: hi by cvt.rna (four instructions on sm_90: a
// guard for inf and NaN, add, select, mask). x - hi is exact, and finite
// whenever x is, so lo takes the same rounding on its bit pattern without
// the guard: add half of the dropped bits' weight to the magnitude, clear
// them (two instructions). For an inf or NaN x, hi carries it.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xFFFFE000u;
}

// ---- mma.sync m16n8k8, f32 += tf32 * tf32 (row-major A, column-major B).
// Fragments, with g = lane / 4 and t = lane % 4: A a0 (row g, k t), a1
// (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); B b0 (k t, col g), b1
// (k t + 4, g); C c0, c1 (row g, cols 2t, 2t + 1), c2, c3 (row g + 8),
// four consecutive floats at c.
__device__ __forceinline__ void mma_m16n8k8(float* c, const uint32_t (&a)[4],
                                            const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c[4u .. 4u+3] += a b_u for u < G, each a split product in three passes,
// the small terms first (lo.hi, hi.lo, hi.hi), with b_u the (hi, hi, lo,
// lo) quad of a thread's B fragments. The passes go pass by pass across
// the G products: mma.sync is volatile asm, which keeps its written order,
// so this order puts independent instructions next to each other where
// one product at a time would chain three that wait on each other.
template <int G>
__device__ __forceinline__ void mma3_m16n8k8(float* c,
                                             const uint32_t (&a_hi)[4],
                                             const uint32_t (&a_lo)[4],
                                             const uint4 (&b)[G]) {
#pragma unroll
  for (int u = 0; u < G; ++u) {
    const uint32_t b_hi[2] = {b[u].x, b[u].y};
    mma_m16n8k8(c + 4 * u, a_lo, b_hi);
  }
#pragma unroll
  for (int u = 0; u < G; ++u) {
    const uint32_t b_lo[2] = {b[u].z, b[u].w};
    mma_m16n8k8(c + 4 * u, a_hi, b_lo);
  }
#pragma unroll
  for (int u = 0; u < G; ++u) {
    const uint32_t b_hi[2] = {b[u].x, b[u].y};
    mma_m16n8k8(c + 4 * u, a_hi, b_hi);
  }
}

// ---- wgmma (sm_90a): both operands K-major in shared memory.

// Descriptor of a K-major operand in the 32-byte swizzled layout: a
// "panel" of rows of 8 TF32 values (32 bytes, one k8 step), 8-row groups
// 256 bytes apart, the two 16-byte halves of row r swapped when bit 2 of r
// is set (address bit 4 ^= bit 7). The panel must start on a 256-byte
// boundary.
__device__ __forceinline__ uint64_t sw32_desc(uint32_t smem_addr) {
  return static_cast<uint64_t>((smem_addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(16 >> 4) << 16) |     // LBO: unused
         (static_cast<uint64_t>(256 >> 4) << 32) |    // SBO: 8 rows
         (3ull << 62);                                // 32-byte swizzle
}

// Byte offset of the 16-byte half h (0 or 1) of row r in such a panel.
__device__ __forceinline__ uint32_t sw32_offset(int r, int h) {
  return static_cast<uint32_t>(r * 32 + ((h ^ ((r >> 2) & 1)) << 4));
}

// m64n128k8, f32 += tf32 * tf32, A and B from shared memory (K-major; TF32
// wgmma takes no transposed operand). d[4j + {0,1}] is row 16w + g, cols
// 8j + 2t + {0,1} of the warp w's slice; d[4j + {2,3}] row 16w + g + 8.
__device__ __forceinline__ void wgmma_m64n128k8(float (&d)[64], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57,"
      "%58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
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


// The same for other widths: SS m64n32k8 (A and B from shared memory) and
// RS m64n{32,64,128}k8 (A from registers: a0 row 16w + g, k t; a1 row +8;
// a2 k t + 4; a3 both, as mma.sync's m16n8k8; B from shared memory).
__device__ __forceinline__ void wgmma_m64n32k8(float (&d)[16], uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n32k8(float (&d)[16],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n64k8(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n128k8(float (&d)[64],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

}  // namespace tf32x3
