// gather_dist: row gather, then squared L2 in the difference form.
//
// Replaces the TPU kernel src/repro/kernels/gather_dist.py::gather_dist
// (a scalar-prefetch Pallas kernel with one grid step per (b, c) id that
// DMAs the single row xb[ids[b, c]] and reduces (x - q)^2 on it).
//
// Contract: xb [N, d] f32 or bf16 (read as f32), ids int32 [B, C]
// (clamped into [0, N) here), q f32 [B, d]
//   -> out f32 [B, C], out[b, c] = sum_k (xb[ids[b, c], k] - q[b, k])^2,
//      not clamped (the difference form cannot go below 0).
//
// Bound on the H100: bytes. Each id pulls one row of d elements from HBM
// and does 3 flops per element on it. The design reads each gathered row
// once: one warp per (b, c) row, lanes striding along the row so the loads
// coalesce, the query row of the block's lane b held in shared memory, the
// sum reduced with shuffles and written by lane 0. A block serves 8 ids of
// one query lane.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // ids in flight per block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
gather_dist_kernel(const T* __restrict__ xb, const int* __restrict__ ids,
                   const float* __restrict__ q, float* __restrict__ out,
                   int C, int N, int d) {
  extern __shared__ float qs[];  // [d], this block's query
  const int b = blockIdx.x;
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    qs[j] = q[(size_t)b * d + j];
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.y * kWarps + warp;
  if (c >= C) return;
  const size_t o = (size_t)b * C + c;
  const int id = min(max(ids[o], 0), N - 1);
  const T* row = xb + (size_t)id * d;
  float acc = 0.0f;
  for (int j = lane; j < d; j += 32) {
    const float diff = to_f32(row[j]) - qs[j];
    acc = fmaf(diff, diff, acc);
  }
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) out[o] = acc;
}

template <typename T>
int launch(const void* xb, const void* ids, const void* q, void* out, int B,
           int C, int N, int d, cudaStream_t stream) {
  dim3 grid(B, (C + kWarps - 1) / kWarps);
  gather_dist_kernel<T><<<grid, kWarps * 32, d * sizeof(float), stream>>>(
      static_cast<const T*>(xb), static_cast<const int*>(ids),
      static_cast<const float*>(q), static_cast<float*>(out), C, N, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x_bf16: 0 if xb is f32, 1 if bf16.
extern "C" int gather_dist(const void* xb, const void* ids, const void* q,
                           void* out, int B, int C, int N, int d, int x_bf16,
                           int device, void* stream) {
  if (B == 0 || C == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_bf16 ? launch<__nv_bfloat16>(xb, ids, q, out, B, C, N, d, s)
                : launch<float>(xb, ids, q, out, B, C, N, d, s);
}
