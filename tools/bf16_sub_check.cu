// bf16_sub_check: the packed bf16 subtraction that flash_attention_bf16
// uses for s - bf16(m_safe) (hopper::sub_bf16x2, one sub.rn.bf16x2),
// against the plain version's bf16 subtraction (torch's: the float32
// difference of the two values, rounded to bf16), over every ordered pair
// of finite bf16 values, in both halves of the register.
//
// Block a (of 65,536) takes the bf16 with bits a; its threads take every b.
// The register (b:a) minus (a:b) gives a - b in its low half and b - a in
// its high half, so each half sees all 2^32 pairs (less the non-finite).
// Built and run by tools/flash_bf16.py --part gate:
//
//   nvcc <the package's flags> -I src/repro_torch/csrc -o check.so \
//       tools/bf16_sub_check.cu
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

__device__ __forceinline__ bool finite_bits(uint32_t x) {
  return ((x >> 7) & 0xFFu) != 0xFFu;
}

__device__ __forceinline__ uint32_t f32_path(uint32_t a, uint32_t b) {
  const float d = __uint_as_float(a << 16) - __uint_as_float(b << 16);
  return __bfloat16_as_ushort(__float2bfloat16_rn(d));
}

// counts[0]: lane results compared; counts[1]: mismatches; first[0..7]: the
// first mismatches found, as (a << 16) | b, first[8..15] which half
// differed (1: a - b, 2: b - a, 3: both), first[16] how many were found
__global__ void __launch_bounds__(256) check(unsigned long long* counts,
                                             unsigned int* first) {
  const uint32_t a = blockIdx.x;
  if (!finite_bits(a)) return;
  unsigned long long n = 0, bad = 0;
  for (uint32_t b = threadIdx.x; b < 65536u; b += blockDim.x) {
    if (!finite_bits(b)) continue;
    const uint32_t d = hopper::sub_bf16x2((b << 16) | a, (a << 16) | b);
    const bool lo = (d & 0xFFFFu) != f32_path(a, b);
    const bool hi = (d >> 16) != f32_path(b, a);
    n += 2;
    if (lo || hi) {
      bad += lo + hi;
      const unsigned int slot = atomicAdd(first + 16, 1u);
      if (slot < 8) {
        first[slot] = (a << 16) | b;
        first[8 + slot] = lo | (hi << 1);
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    n += __shfl_xor_sync(0xffffffffu, n, off);
    bad += __shfl_xor_sync(0xffffffffu, bad, off);
  }
  if (threadIdx.x % 32 == 0) {
    atomicAdd(counts, n);
    atomicAdd(counts + 1, bad);
  }
}

}  // namespace

// counts: 2 x u64, first: 17 x u32, both zeroed on the device by the
// caller; returns the launch's error.
extern "C" int bf16_sub_check(void* counts, void* first, void* stream) {
  check<<<65536, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(counts),
      static_cast<unsigned int*>(first));
  return static_cast<int>(cudaGetLastError());
}
