// l2dist: blocked squared-L2 distance matrix.
//
// Replaces the TPU kernel src/repro/kernels/l2dist.py::l2dist (a Pallas
// kernel that accumulates -2 q.x^T on the MXU plus the partial norms of
// each d-block into a resident (bq, bn) f32 tile and clamps at 0).
//
// Contract: q [B, d], xb [N, d], both f32 or both bf16 (read as f32)
//   -> out f32 [B, N], out[i, j] = max(|q_i|^2 + |x_j|^2 - 2 q_i.x_j, 0).
//
// Bound on the H100: operations for a query batch in the hundreds or more
// (2*B*N*d flops over 67 TFLOP/s FP32 against (B + N)*d + B*N elements
// moved), bytes for a handful of queries. The product is the body of the
// TPU kernel, so it is computed here in FP32 on the CUDA cores: TF32 and
// the tensor cores are never used. The design is the classic SIMT tiling:
// a block owns a 128 x 128 output tile and walks d in chunks of 16 staged
// in shared memory (every q element loaded is reused by 128 rows of x and
// every x element by 128 queries); each of 256 threads keeps an 8 x 8 tile
// of sums in registers, at rows ty + 16 i and columns tx + 16 j so that a
// warp's shared-memory reads are broadcasts or consecutive words. While a
// chunk sits in shared memory, threads 0-127 add it to the squared norm of
// one query row and threads 128-255 to that of one x row; the epilogue
// adds the norms and clamps. Ragged edges (B, N, d not multiples of the
// tile) are zero-filled on load and masked on store.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128;  // queries per block
constexpr int kBN = 128;  // x rows per block
constexpr int kBK = 16;   // d chunk in shared memory
constexpr int kTM = kBM / 16;
constexpr int kTN = kBN / 16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
l2dist_kernel(const T* __restrict__ q, const T* __restrict__ xb,
              float* __restrict__ out, int B, int N, int d) {
  __shared__ float qs[kBK][kBM + 1];
  __shared__ float xs[kBK][kBN + 1];
  __shared__ float qn_s[kBM];
  __shared__ float xn_s[kBN];
  const int t = threadIdx.x;
  const int tx = t & 15, ty = t >> 4;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;
  float norm = 0.0f;  // |q_{m0+t}|^2 for t < 128, |x_{n0+t-128}|^2 else

  for (int k0 = 0; k0 < d; k0 += kBK) {
    __syncthreads();  // the previous chunk is consumed
    for (int e = t; e < kBM * kBK; e += kThreads) {
      const int r = e / kBK, kk = e % kBK;
      float v = 0.0f;
      if (m0 + r < B && k0 + kk < d) v = to_f32(q[(size_t)(m0 + r) * d + k0 + kk]);
      qs[kk][r] = v;
    }
    for (int e = t; e < kBN * kBK; e += kThreads) {
      const int r = e / kBK, kk = e % kBK;
      float v = 0.0f;
      if (n0 + r < N && k0 + kk < d) v = to_f32(xb[(size_t)(n0 + r) * d + k0 + kk]);
      xs[kk][r] = v;
    }
    __syncthreads();
    if (t < kBM) {
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) norm = fmaf(qs[kk][t], qs[kk][t], norm);
    } else {
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        norm = fmaf(xs[kk][t - kBM], xs[kk][t - kBM], norm);
      }
    }
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float qv[kTM], xv[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) qv[i] = qs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) xv[j] = xs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(qv[i], xv[j], acc[i][j]);
    }
  }
  if (t < kBM) {
    qn_s[t] = norm;
  } else {
    xn_s[t - kBM] = norm;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = ty + 16 * i;
    if (m0 + r >= B) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int c = tx + 16 * j;
      if (n0 + c >= N) continue;
      const float v = qn_s[r] + xn_s[c] - 2.0f * acc[i][j];
      out[(size_t)(m0 + r) * N + n0 + c] = fmaxf(v, 0.0f);
    }
  }
}

template <typename T>
int launch(const void* q, const void* xb, void* out, int B, int N, int d,
           cudaStream_t stream) {
  dim3 grid((N + kBN - 1) / kBN, (B + kBM - 1) / kBM);
  l2dist_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(xb),
      static_cast<float*>(out), B, N, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16: 0 if q and xb are f32, 1 if both are bf16.
extern "C" int l2dist(const void* q, const void* xb, void* out, int B, int N,
                      int d, int bf16, int device, void* stream) {
  if (B == 0 || N == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(q, xb, out, B, N, d, s)
              : launch<float>(q, xb, out, B, N, d, s);
}
