// fused_expand: one-gather beam expansion over the packed serving layout.
//
// Replaces the TPU kernel src/repro/kernels/fused_expand.py::fused_expand
// (a scalar-prefetch Pallas kernel that DMAs one packed row per grid step).
//
// Contract: packed f32 [N, d+1+A] rows of [vec | sq-norm | attr words],
// ids int32 [B, C] (clamped into [0, N) here), q f32 [B, d], q_norm f32 [B]
//   -> d2 f32 [B, C] = max(norm - 2 q.vec + q_norm, 0)
//      words u32 [B, C, A], copied bit for bit.
//
// Bound on the H100: bytes. Each candidate pulls one row of (d+1+A)*4
// bytes from HBM (about B*C*(d+1+A)*4 in all) and does 2*d flops on it,
// far below the 67 TFLOP/s FP32 line. The rows are scattered, so the time
// goes to waiting on loads unless as many rows as possible are in flight
// at once, each thread in one short chain (id, then row, then sum):
// - A group of 16 threads (half a warp) serves one candidate row; a block
//   of 256 threads serves 16 consecutive candidates of one query lane, and
//   the grid is (B, ceil(C / 16)). At 32 to 48 registers a thread, five
//   or six blocks fit an SM, so 10,000 to 13,000 of the main path's
//   45,360 rows are in flight at once, each group waiting on one row.
// - The group reads its id once (the warp's two ids are adjacent), loads
//   q for the columns its lanes read into registers (no shared copy, no
//   barrier), then issues all of the row's loads before it uses any.
// - The load width V (1, 2 or 4 words) is the widest that divides the row
//   stride d+1+A and the base's alignment: 102 words (d = 100, A = 1) load
//   as 8-byte pairs, an odd width as single words. A row is read in passes
//   of kChunk = 128 words (one pass up to 128 words; wider rows take
//   several, with q reloaded per pass).
// - The dot is reduced within the group by four shuffles; the lane that
//   holds the norm writes d2, the lanes that hold attr words write them.
//   The two groups of a warp hold consecutive candidates, so d2 and the
//   words are written as contiguous runs.
// - Rows are read once per step, so the loads carry the streaming
//   (evict-first) hint. Everything is loaded as 32-bit integers: the attr
//   words never pass through a float operation (a packed bitmap may look
//   like a NaN); the vector and the norm are reinterpreted as floats.
// On the card, one block per query lane holding all C candidates, each
// group taking several rows in turn, ran slower: its groups waited for
// two or three rows one after another (PERF.md).
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 16;                    // threads that share a row
constexpr int kGroups = kThreads / kLanes;    // candidates per block
constexpr int kChunk = 128;                   // words of a row per pass

template <int V>
__device__ __forceinline__ void load_words(const uint32_t* p,
                                           uint32_t (&w)[V]) {
  if constexpr (V == 4) {
    const uint4 t = __ldcs(reinterpret_cast<const uint4*>(p));
    w[0] = t.x; w[1] = t.y; w[2] = t.z; w[3] = t.w;
  } else if constexpr (V == 2) {
    const uint2 t = __ldcs(reinterpret_cast<const uint2*>(p));
    w[0] = t.x; w[1] = t.y;
  } else {
    w[0] = __ldcs(p);
  }
}

template <int V, bool kWide>
__global__ void __launch_bounds__(kThreads)
fused_expand_kernel(const uint32_t* __restrict__ packed,
                    const int* __restrict__ ids,
                    const float* __restrict__ q,
                    const float* __restrict__ q_norm,
                    float* __restrict__ d2,
                    uint32_t* __restrict__ words,
                    int C, int N, int d, int A) {
  constexpr int K = kChunk / (kLanes * V);    // vectors a lane reads a pass
  const int b = blockIdx.x;
  const int c = blockIdx.y * kGroups + threadIdx.x / kLanes;
  if (c >= C) return;                         // the whole group leaves
  const int l = threadIdx.x % kLanes;
  const unsigned mask = 0xFFFFu << (threadIdx.x & 16);  // the group's lanes
  const int rw = d + 1 + A;
  const size_t o = (size_t)b * C + c;
  const float* qb = q + (size_t)b * d;
  const uint32_t* row = packed + (size_t)min(max(ids[o], 0), N - 1) * rw;
  // the lane that holds column d (the norm) writes d2
  const int l_norm = ((d % kChunk) / V) % kLanes;
  const int passes = kWide ? (rw + kChunk - 1) / kChunk : 1;
  float dot = 0.0f, nrm = 0.0f;
  for (int p = 0; p < passes; ++p) {
    const int j0 = p * kChunk;
    float qr[K][V];   // q at the columns this lane reads in the pass
    uint32_t x[K][V];
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int j = j0 + (l + kLanes * k) * V + v;
        qr[k][v] = j < d ? qb[j] : 0.0f;
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = j0 + (l + kLanes * k) * V;
      if (j < rw) {
        load_words<V>(row + j, x[k]);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) x[k][v] = 0u;
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int j = j0 + (l + kLanes * k) * V + v;
        if (j < d) {
          dot = fmaf(__uint_as_float(x[k][v]), qr[k][v], dot);
        } else if (j == d) {
          nrm = __uint_as_float(x[k][v]);
        } else if (j < rw) {
          words[o * A + (j - d - 1)] = x[k][v];
        }
      }
    }
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) {
    dot += __shfl_xor_sync(mask, dot, off, kLanes);
  }
  if (l == l_norm) d2[o] = fmaxf(nrm - 2.0f * dot + q_norm[b], 0.0f);
}

template <int V>
void launch(dim3 grid, bool wide, cudaStream_t s, const uint32_t* packed,
            const int* ids, const float* q, const float* q_norm, float* d2,
            uint32_t* words, int C, int N, int d, int A) {
  if (wide) {
    fused_expand_kernel<V, true><<<grid, kThreads, 0, s>>>(
        packed, ids, q, q_norm, d2, words, C, N, d, A);
  } else {
    fused_expand_kernel<V, false><<<grid, kThreads, 0, s>>>(
        packed, ids, q, q_norm, d2, words, C, N, d, A);
  }
}

}  // namespace

extern "C" int fused_expand_f32(const void* packed, const void* ids,
                                const void* q, const void* q_norm, void* d2,
                                void* words, int B, int C, int N, int d,
                                int A, int device, void* stream) {
  if (B == 0 || C == 0) return 0;
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  const int rw = d + 1 + A;
  const uintptr_t base = reinterpret_cast<uintptr_t>(packed);
  const int V = (rw % 4 == 0 && base % 16 == 0)  ? 4
                : (rw % 2 == 0 && base % 8 == 0) ? 2
                                                 : 1;
  const dim3 grid(B, (C + kGroups - 1) / kGroups);
  const bool wide = rw > kChunk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* p = static_cast<const uint32_t*>(packed);
  auto* pi = static_cast<const int*>(ids);
  auto* pq = static_cast<const float*>(q);
  auto* pn = static_cast<const float*>(q_norm);
  auto* pd = static_cast<float*>(d2);
  auto* pw = static_cast<uint32_t*>(words);
  if (V == 4) {
    launch<4>(grid, wide, s, p, pi, pq, pn, pd, pw, C, N, d, A);
  } else if (V == 2) {
    launch<2>(grid, wide, s, p, pi, pq, pn, pd, pw, C, N, d, A);
  } else {
    launch<1>(grid, wide, s, p, pi, pq, pn, pd, pw, C, N, d, A);
  }
  return static_cast<int>(cudaGetLastError());
}
