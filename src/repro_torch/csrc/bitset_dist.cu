// bitset_dist: packed-bitset distance matrix by popcount.
//
// Replaces the TPU kernel src/repro/kernels/bitset.py::bitset_dist (XOR /
// AND-NOT plus population_count on (bq, W) x (bn, W) VMEM tiles).
//
// Contract: a u32 [B, W], b u32 [N, W] -> out int32 [B, N],
//   op xor:     out[i, j] = sum_w popc(a[i, w] ^ b[j, w])   (Hamming, dist_A)
//   op deficit: out[i, j] = sum_w popc(a[i, w] & ~b[j, w])  (|a \ b|, dist_F)
// The result is an exact integer.
//
// Bound on the H100: bytes for few words (the subset filters of the main
// path have W = 1, and writing B*N*4 output bytes dominates), operations
// for many (the Boolean one-hot membership test runs W = 2^15/32 = 1024
// words, B*N*W popcounts). The design: a block owns 32 x 64 outputs; the
// word loop runs inside the kernel in chunks of 32 words staged in shared
// memory, so each a word is reused by 64 columns and each b word by 32
// rows; each thread accumulates 8 outputs in int32 registers with __popc
// and writes them once, coalesced along N. `op` is a template parameter.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 32;   // rows of a per block
constexpr int kBN = 64;   // rows of b per block
constexpr int kWK = 32;   // words per shared-memory chunk
constexpr int kPer = kBQ / 4;

template <bool kDeficit>
__global__ void __launch_bounds__(kThreads)
bitset_dist_kernel(const uint32_t* __restrict__ a,
                   const uint32_t* __restrict__ b,
                   int* __restrict__ out, int B, int N, int W) {
  __shared__ uint32_t as[kBQ][kWK + 1];
  __shared__ uint32_t bs[kBN][kWK + 1];
  const int t = threadIdx.x;
  const int q0 = blockIdx.y * kBQ;
  const int n0 = blockIdx.x * kBN;
  const int tn = t & 63;   // this thread's column of b
  const int tq = t >> 6;   // this thread's rows of a: tq + 4 j
  int acc[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) acc[j] = 0;
  for (int w0 = 0; w0 < W; w0 += kWK) {
    const int ww = min(kWK, W - w0);
    __syncthreads();
    for (int i = t; i < kBQ * kWK; i += kThreads) {
      const int qq = i / kWK, kk = i % kWK;
      uint32_t v = 0u;
      if (kk < ww && q0 + qq < B) v = a[(size_t)(q0 + qq) * W + w0 + kk];
      as[qq][kk] = v;
    }
    for (int i = t; i < kBN * kWK; i += kThreads) {
      const int nn = i / kWK, kk = i % kWK;
      uint32_t v = 0u;
      if (kk < ww && n0 + nn < N) v = b[(size_t)(n0 + nn) * W + w0 + kk];
      bs[nn][kk] = v;
    }
    __syncthreads();
    for (int kk = 0; kk < ww; ++kk) {
      const uint32_t bv = bs[tn][kk];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const uint32_t av = as[tq + 4 * j][kk];
        acc[j] += __popc(kDeficit ? (av & ~bv) : (av ^ bv));
      }
    }
  }
  const int n = n0 + tn;
  if (n >= N) return;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int r = q0 + tq + 4 * j;
    if (r < B) out[(size_t)r * N + n] = acc[j];
  }
}

}  // namespace

// op: 0 = xor, 1 = deficit.
extern "C" int bitset_dist_u32(const void* a, const void* b, void* out,
                               int B, int N, int W, int op, int device, void* stream) {
  if (B == 0 || N == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((N + kBN - 1) / kBN, (B + kBQ - 1) / kBQ);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* pa = static_cast<const uint32_t*>(a);
  const uint32_t* pb = static_cast<const uint32_t*>(b);
  int* po = static_cast<int*>(out);
  if (op == 1) {
    bitset_dist_kernel<true><<<grid, kThreads, 0, s>>>(pa, pb, po, B, N, W);
  } else {
    bitset_dist_kernel<false><<<grid, kThreads, 0, s>>>(pa, pb, po, B, N, W);
  }
  return static_cast<int>(cudaGetLastError());
}
