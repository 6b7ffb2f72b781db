// gather_dist: row gather, then squared L2 in the difference form.
//
// Replaces the TPU kernel src/repro/kernels/gather_dist.py::gather_dist
// (a scalar-prefetch Pallas kernel with one grid step per (b, c) id that
// DMAs the single row xb[ids[b, c]] and reduces (x - q)^2 on it).
//
// Contract: xb [N, d] f32 or bf16 (read as f32), ids int32 [B, C]
// (clamped into [0, N) here), q f32 [B, d], any d, B and C
//   -> out f32 [B, C], out[b, c] = sum_k (xb[ids[b, c], k] - q[b, k])^2,
//      not clamped (the difference form cannot go below 0).
//
// Bound on the H100: bytes. Each id pulls one row of d elements from HBM
// (400 B at d = 100 in f32) and does 3 flops per element on it; a caller
// reads new rows at every expansion, so every row is a miss. The time goes
// to waiting on loads unless many rows are in flight at once, each thread
// in one short chain (id, then row, then sum):
// - A group of kLanes = 8 threads serves one row; a block of 256 threads
//   serves 32 consecutive rows of the flattened [B * C] ids, so one block
//   may span several query lanes, and the grid is ceil(B * C / 32) on x
//   (no extent on y to run out of at large C).
// - Rows are read in passes of 128 values: each lane issues all of its
//   pass's loads (four 16-byte loads of f32, or two of eight bf16 values)
//   before it uses any. The row loads take the read-only path and do not
//   allocate in L1 (ld.global.nc.L1::no_allocate), which keeps L1 for the
//   query rows: each lane loads its slice of q[b] from L1 as it uses the
//   row's values, again at each pass of a wide row, so no d-sized buffer
//   limits d.
// - The sum is reduced within the group by three shuffles; the group's
//   first lane writes it.
// - __launch_bounds__(256, 1): with the block size alone, ptxas held the
//   kernel to 32 registers by using each value as it arrived, with fewer
//   loads in flight; allowed one block an SM, it takes 54 and keeps the
//   row's four loads and q's in flight together, 5% faster cold on an
//   H100 80GB HBM3 at 700 W (PERF.md).
// - Rows whose start is not 16-byte aligned (d * sizeof(T) % 16 != 0, or a
//   table or query that starts off a 16-byte boundary) take the same
//   design with single-value loads, kept coalesced within the group.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 8;                   // threads that share a row
constexpr int kRows = kThreads / kLanes;    // rows a block serves
constexpr int kPass = 128;                  // values of a row per pass
constexpr int kPer = kPass / kLanes;        // values a lane holds a pass

// Rows are read once: the read-only path, no L1 allocation. volatile keeps
// each load under its bounds test (it is never hoisted out of it).
__device__ __forceinline__ uint4 ld_row16(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}
__device__ __forceinline__ float ld_row1(const float* p) {
  float v;
  asm volatile("ld.global.nc.L1::no_allocate.f32 %0, [%1];"
               : "=f"(v)
               : "l"(p));
  return v;
}
__device__ __forceinline__ float ld_row1(const __nv_bfloat16* p) {
  unsigned short v;
  asm volatile("ld.global.nc.L1::no_allocate.b16 %0, [%1];"
               : "=h"(v)
               : "l"(p));
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

// The values of one 16-byte load, as f32.
template <typename T>
__device__ __forceinline__ void unpack(const uint4& u,
                                       float (&x)[16 / sizeof(T)]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(T) == 4) {
      x[i] = __uint_as_float(w[i]);
    } else {   // bf16: element 2i in the low half of word i
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
  }
}

// kVec: 16-byte loads (every row and q row 16-byte aligned); else single
// values. Lane l holds, in a pass from value j0, values j0 + (l + 8k) V +
// v of the row and of q (V = values per load), zero past d.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
gather_dist_kernel(const T* __restrict__ xb, const int* __restrict__ ids,
                   const float* __restrict__ q, float* __restrict__ out,
                   long long rows, int C, int N, int d) {
  constexpr int V = kVec ? 16 / sizeof(T) : 1;   // values per load
  constexpr int K = kPer / V;                    // loads a lane a pass
  const long long r = (long long)blockIdx.x * kRows + threadIdx.x / kLanes;
  if (r >= rows) return;                         // the whole group leaves
  const int l = threadIdx.x % kLanes;
  const unsigned mask = 0xFFu << (threadIdx.x & 24);   // the group's lanes
  const int id = min(max(__ldg(ids + r), 0), N - 1);
  const T* row = xb + (size_t)id * d;
  const float* qb = q + (size_t)(r / C) * d;
  float acc = 0.0f;
  for (int j0 = 0; j0 < d; j0 += kPass) {
    float x[K][V];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = j0 + (l + kLanes * k) * V;
      if constexpr (kVec) {
        if (j < d) {
          unpack<T>(ld_row16(row + j), x[k]);
        } else {
#pragma unroll
          for (int v = 0; v < V; ++v) x[k][v] = 0.0f;
        }
      } else {
        x[k][0] = j < d ? ld_row1(row + j) : 0.0f;
      }
    }
    // q from L1 as the row's values are used, each load a select on j < d
    // that ptxas may hoist
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = j0 + (l + kLanes * k) * V;
      if constexpr (kVec) {
#pragma unroll
        for (int v = 0; v < V; v += 4) {
          const float4 t =
              j < d ? __ldg(reinterpret_cast<const float4*>(qb + j + v))
                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          const float e[4] = {x[k][v] - t.x, x[k][v + 1] - t.y,
                              x[k][v + 2] - t.z, x[k][v + 3] - t.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) acc = fmaf(e[u], e[u], acc);
        }
      } else {
        const float e = x[k][0] - (j < d ? __ldg(qb + j) : 0.0f);
        acc = fmaf(e, e, acc);
      }
    }
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(mask, acc, off, kLanes);
  }
  if (l == 0) out[r] = acc;
}

template <typename T>
int launch(const void* xb, const void* ids, const void* q, void* out, int B,
           int C, int N, int d, cudaStream_t stream) {
  const long long rows = (long long)B * C;
  const long long blocks = (rows + kRows - 1) / kRows;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = reinterpret_cast<uintptr_t>(xb) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   ((size_t)d * sizeof(T)) % 16 == 0;
  auto* x = static_cast<const T*>(xb);
  auto* pi = static_cast<const int*>(ids);
  auto* pq = static_cast<const float*>(q);
  auto* po = static_cast<float*>(out);
  if (vec) {
    gather_dist_kernel<T, true><<<(unsigned)blocks, kThreads, 0, stream>>>(
        x, pi, pq, po, rows, C, N, d);
  } else {
    gather_dist_kernel<T, false><<<(unsigned)blocks, kThreads, 0, stream>>>(
        x, pi, pq, po, rows, C, N, d);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x_bf16: 0 if xb is f32, 1 if bf16.
extern "C" int gather_dist(const void* xb, const void* ids, const void* q,
                           void* out, int B, int C, int N, int d, int x_bf16,
                           int device, void* stream) {
  if (B == 0 || C == 0) return 0;
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_bf16 ? launch<__nv_bfloat16>(xb, ids, q, out, B, C, N, d, s)
                : launch<float>(xb, ids, q, out, B, C, N, d, s);
}
