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
// path have W = 1, and writing B*N*4 output bytes is the whole of the
// work), the popcount pipe for many (the Boolean one-hot membership test
// runs W = 2^15/32 = 1024 words, B*N*W popcounts at 16 per clock per SM).
// So the launch picks one of two kernels by W:
//
// - W <= kRunsMaxW, `runs`: a store-bound kernel without shared memory.
//   A block row covers one row of `a`; each thread owns a run of four
//   consecutive outputs, reads the row's words of `a` once (the same
//   address across the warp), reads its columns' 4 W words of `b` with W
//   16-byte loads and writes the run with one 16-byte store. Row r of
//   `out` starts at element r*N, which is 16-byte aligned only when
//   r*N % 4 == 0, so the runs of a row are laid out from the row's first
//   aligned element: the run before it and the ragged end take scalar
//   stores, and a vector load of `b` is taken only when its first column
//   is a multiple of four. No vector access is ever misaligned.
// - W > kRunsMaxW, `tiles`: a block owns 32 x 64 outputs; the word loop
//   runs inside the kernel in chunks of 32 words staged in shared memory,
//   so each a word is reused by 64 columns and each b word by 32 rows; each
//   thread accumulates 8 outputs in int32 registers with __popc and writes
//   them once, coalesced along N.
// `op` is a template parameter of both.
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

template <bool kDeficit>
__device__ __forceinline__ int popc_op(uint32_t x, uint32_t y) {
  return __popc(kDeficit ? (x & ~y) : (x ^ y));
}

// ---- W <= kRunsMaxW: runs of four outputs, one 16-byte store each ------

constexpr int kRunsMaxW = 2;     // picked on the card (PERF.md)
constexpr int kRunThreads = 256;
constexpr int kRun = 4;

template <bool kDeficit, int kW>
__global__ void __launch_bounds__(kRunThreads)
bitset_dist_runs_kernel(const uint32_t* __restrict__ a,
                        const uint32_t* __restrict__ b,
                        int* __restrict__ out, int N, int pos0,
                        bool b_aligned) {
  const int r = blockIdx.x;
  // `lead` elements of this row lie before its first 16-byte aligned one;
  // the leading run (offset lead - 4) covers them with scalar stores
  const int lead = (4 - (int)((pos0 + (long long)r * N) & 3)) & 3;
  const int c = lead - (lead ? kRun : 0)
                + kRun * (int)(blockIdx.y * kRunThreads + threadIdx.x);
  if (c >= N) return;
  uint32_t x[kW];
#pragma unroll
  for (int w = 0; w < kW; ++w) x[w] = a[(size_t)r * kW + w];
  int* orow = out + (size_t)r * N;
  int v[kRun] = {0, 0, 0, 0};
  if (c >= 0 && c + kRun <= N) {
    if (b_aligned && (c & 3) == 0) {
      // the run's 4 kW words of b are contiguous and 16-byte aligned
      const uint4* bv = reinterpret_cast<const uint4*>(b + (size_t)c * kW);
#pragma unroll
      for (int i = 0; i < kW; ++i) {
        const uint4 y = bv[i];
        const uint32_t ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
        for (int m = 0; m < 4; ++m) {   // word 4i + m: column (4i + m) / kW
          const int e = 4 * i + m;
          v[e / kW] += popc_op<kDeficit>(x[e % kW], ys[m]);
        }
      }
    } else {
#pragma unroll
      for (int t = 0; t < kRun; ++t) {
#pragma unroll
        for (int w = 0; w < kW; ++w) {
          v[t] += popc_op<kDeficit>(x[w], b[(size_t)(c + t) * kW + w]);
        }
      }
    }
    // c = lead (mod 4): orow + c lies on a 16-byte boundary
    *reinterpret_cast<int4*>(orow + c) = make_int4(v[0], v[1], v[2], v[3]);
    return;
  }
  // the row's leading elements before its first aligned one, or its end
#pragma unroll
  for (int t = 0; t < kRun; ++t) {
    const int cc = c + t;
    if (cc < 0 || cc >= N) continue;
    int s = 0;
#pragma unroll
    for (int w = 0; w < kW; ++w) {
      s += popc_op<kDeficit>(x[w], b[(size_t)cc * kW + w]);
    }
    orow[cc] = s;
  }
}

// ---- W > kRunsMaxW: 32 x 64 tiles, words staged in shared memory -------

constexpr int kThreads = 256;
constexpr int kBQ = 32;   // rows of a per block
constexpr int kBN = 64;   // rows of b per block
constexpr int kWK = 32;   // words per shared-memory chunk
constexpr int kPer = kBQ / 4;

template <bool kDeficit>
__global__ void __launch_bounds__(kThreads)
bitset_dist_tiles_kernel(const uint32_t* __restrict__ a,
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
        acc[j] += popc_op<kDeficit>(as[tq + 4 * j][kk], bv);
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

template <bool kDeficit>
int launch(const uint32_t* a, const uint32_t* b, int* out, int B, int N,
           int W, cudaStream_t s) {
  if (W <= kRunsMaxW) {
    // runs per row: the leading run (when the row starts unaligned) and
    // ceil(N / 4) more
    const int runs = N / kRun + 2;
    dim3 grid(B, (runs + kRunThreads - 1) / kRunThreads);
    // the place of out[0] inside its 16-byte group of four int32
    const int pos0 = static_cast<int>(
        (reinterpret_cast<uintptr_t>(out) >> 2) & 3);
    const bool b_aligned = (reinterpret_cast<uintptr_t>(b) & 15) == 0;
    if (W == 1) {
      bitset_dist_runs_kernel<kDeficit, 1><<<grid, kRunThreads, 0, s>>>(
          a, b, out, N, pos0, b_aligned);
    } else {
      bitset_dist_runs_kernel<kDeficit, 2><<<grid, kRunThreads, 0, s>>>(
          a, b, out, N, pos0, b_aligned);
    }
  } else {
    dim3 grid((N + kBN - 1) / kBN, (B + kBQ - 1) / kBQ);
    bitset_dist_tiles_kernel<kDeficit><<<grid, kThreads, 0, s>>>(
        a, b, out, B, N, W);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// op: 0 = xor, 1 = deficit.
extern "C" int bitset_dist_u32(const void* a, const void* b, void* out,
                               int B, int N, int W, int op, int device,
                               void* stream) {
  if (B == 0 || N == 0) return 0;
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* pa = static_cast<const uint32_t*>(a);
  const uint32_t* pb = static_cast<const uint32_t*>(b);
  int* po = static_cast<int*>(out);
  return op == 1 ? launch<true>(pa, pb, po, B, N, W, s)
                 : launch<false>(pa, pb, po, B, N, W, s);
}
