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
// far below the 67 TFLOP/s FP32 line. The design keeps the row read down
// to one pass: one warp per candidate row makes coalesced 4-byte loads
// along the row (the row stride (d+1+A)*4 is not 16-byte aligned in
// general, so no float4), reduces the dot with shuffles, and lane 0 writes
// d2; the query stays in shared memory for every row of its lane. The
// attr words are copied through a uint32_t pointer, never through float
// registers, so a packed subset bitmap that happens to look like a NaN is
// not canonicalised.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // candidate rows in flight per block

__global__ void __launch_bounds__(kWarps * 32)
fused_expand_kernel(const float* __restrict__ packed,
                    const int* __restrict__ ids,
                    const float* __restrict__ q,
                    const float* __restrict__ q_norm,
                    float* __restrict__ d2,
                    uint32_t* __restrict__ words,
                    int C, int N, int d, int A) {
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
  int id = ids[o];
  id = min(max(id, 0), N - 1);
  const size_t row_w = (size_t)d + 1 + A;
  const float* row = packed + (size_t)id * row_w;
  float acc = 0.0f;
  for (int j = lane; j < d; j += 32) acc = fmaf(row[j], qs[j], acc);
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) d2[o] = fmaxf(row[d] - 2.0f * acc + q_norm[b], 0.0f);
  const uint32_t* wrow = reinterpret_cast<const uint32_t*>(row + d + 1);
  for (int a = lane; a < A; a += 32) words[o * A + a] = wrow[a];
}

}  // namespace

extern "C" int fused_expand_f32(const void* packed, const void* ids,
                                const void* q, const void* q_norm, void* d2,
                                void* words, int B, int C, int N, int d,
                                int A, int device, void* stream) {
  if (B == 0 || C == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(B, (C + kWarps - 1) / kWarps);
  fused_expand_kernel<<<grid, kWarps * 32, d * sizeof(float),
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(packed), static_cast<const int*>(ids),
      static_cast<const float*>(q), static_cast<const float*>(q_norm),
      static_cast<float*>(d2), static_cast<uint32_t*>(words), C, N, d, A);
  return static_cast<int>(cudaGetLastError());
}
