// gather_dist_tile: the exact scan's distance tile.
//
// Replaces the TPU kernel src/repro/kernels/gather_dist.py::gather_dist_tile
// (a scalar-prefetch Pallas kernel that DMAs one (tile, d) block of rows per
// query lane and reduces it on the resident tile).
//
// Contract: xb f32 [N_pad, dp] (N_pad a multiple of tile, dp of 8),
// base int32 [B] (clamped into [0, N_pad/tile)), q f32 [B, dp]
//   -> out f32 [B, tile], out[b, t] = max(|x|^2 - 2 q.x + |q|^2, 0)
//      for x = xb[base[b]*tile + t].
//
// Bound on the H100: operations, 2*B*tile*dp flops against 67 TFLOP/s of
// FP32 (the rows are read once per block of 16 lanes; at the scan's batch
// widths the arithmetic outweighs the bytes). The design: a block owns 16
// query lanes x 128 rows; the x rows and the queries come into shared
// memory in d-chunks of 32 and every x element loaded is reused by the 16
// lanes, every q element by the 128 rows; each thread keeps a 4 x 2 tile
// of sums in registers, with the row norms beside them, and adds the
// norms and clamps in the epilogue. All lanes of the exact scan share one
// base, so one shared tile serves the block; lanes with differing bases
// are still right, one lane per pass.
//
// Arithmetic: every term is a rounded multiply followed by a rounded add
// (__fmul_rn/__fadd_rn, which the compiler may not contract into an FMA),
// summed over d in order. That is the plain PyTorch version's arithmetic,
// so kernel and plain version agree bit for bit and the kernel scan and
// the plain scan return the same ids. The cost is two instructions per
// term where an FMA takes one.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBT = 128;           // rows per block
constexpr int kBQ = 16;            // query lanes per block
constexpr int kDK = 32;            // d chunk held in shared memory
constexpr int kRT = kBT / 64;      // rows per thread
constexpr int kLQ = kBQ / 4;       // lanes per thread

__global__ void __launch_bounds__(kThreads)
gather_dist_tile_kernel(const float* __restrict__ xb,
                        const int* __restrict__ base,
                        const float* __restrict__ q,
                        float* __restrict__ out,
                        int B, int tile, int dp, int n_tiles) {
  __shared__ float xs[kDK][kBT + 1];
  __shared__ float qs[kDK][kBQ + 1];
  __shared__ float qn_s[kBQ];
  __shared__ int uniform_s;
  const int t = threadIdx.x;
  const int r0 = blockIdx.x * kBT;   // first row of the block inside a tile
  const int b0 = blockIdx.y * kBQ;   // first query lane of the block
  const int nq = min(kBQ, B - b0);
  const int tr = t & 63;             // this thread's rows: tr + 64 i
  const int tq = t >> 6;             // this thread's lanes: tq + 4 j

  if (t == 0) {
    int u = 1;
    for (int j = 1; j < nq; ++j) u &= (base[b0 + j] == base[b0]);
    uniform_s = u;
  }
  if (t < nq) {
    const float* qr = q + (size_t)(b0 + t) * dp;
    float s = 0.0f;
    for (int k = 0; k < dp; ++k) s = __fadd_rn(s, __fmul_rn(qr[k], qr[k]));
    qn_s[t] = s;
  }
  __syncthreads();
  const int passes = uniform_s ? 1 : nq;

  for (int p = 0; p < passes; ++p) {
    const int tb = min(max(base[b0 + p], 0), n_tiles - 1);
    const size_t row0 = (size_t)tb * tile + r0;
    float acc[kLQ][kRT];
    float xn[kRT];
#pragma unroll
    for (int i = 0; i < kRT; ++i) {
      xn[i] = 0.0f;
#pragma unroll
      for (int j = 0; j < kLQ; ++j) acc[j][i] = 0.0f;
    }
    for (int k0 = 0; k0 < dp; k0 += kDK) {
      const int kw = min(kDK, dp - k0);
      __syncthreads();  // the previous chunk is consumed
      for (int i = t; i < kBT * kDK; i += kThreads) {
        const int rr = i / kDK, kk = i % kDK;
        float v = 0.0f;
        if (kk < kw && r0 + rr < tile) v = xb[(row0 + rr) * dp + k0 + kk];
        xs[kk][rr] = v;
      }
      for (int i = t; i < kBQ * kDK; i += kThreads) {
        const int qq = i / kDK, kk = i % kDK;
        float v = 0.0f;
        if (kk < kw && qq < nq) v = q[(size_t)(b0 + qq) * dp + k0 + kk];
        qs[kk][qq] = v;
      }
      __syncthreads();
      for (int kk = 0; kk < kw; ++kk) {
        float xv[kRT], qv[kLQ];
#pragma unroll
        for (int i = 0; i < kRT; ++i) xv[i] = xs[kk][tr + 64 * i];
#pragma unroll
        for (int j = 0; j < kLQ; ++j) qv[j] = qs[kk][tq + 4 * j];
#pragma unroll
        for (int i = 0; i < kRT; ++i) {
          xn[i] = __fadd_rn(xn[i], __fmul_rn(xv[i], xv[i]));
#pragma unroll
          for (int j = 0; j < kLQ; ++j) {
            acc[j][i] = __fadd_rn(acc[j][i], __fmul_rn(qv[j], xv[i]));
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kLQ; ++j) {
      const int lane = tq + 4 * j;
      if (lane >= nq || (passes > 1 && lane != p)) continue;
#pragma unroll
      for (int i = 0; i < kRT; ++i) {
        const int r = r0 + tr + 64 * i;
        if (r >= tile) continue;
        const float v = __fadd_rn(__fsub_rn(xn[i], 2.0f * acc[j][i]),
                                  qn_s[lane]);
        out[(size_t)(b0 + lane) * tile + r] = fmaxf(v, 0.0f);
      }
    }
  }
}

}  // namespace

extern "C" int gather_dist_tile_f32(const void* xb, const void* base,
                                    const void* q, void* out, int B,
                                    int tile, int dp, int n_rows,
                                    int device, void* stream) {
  if (B == 0 || tile == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((tile + kBT - 1) / kBT, (B + kBQ - 1) / kBQ);
  gather_dist_tile_kernel<<<grid, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xb), static_cast<const int*>(base),
      static_cast<const float*>(q), static_cast<float*>(out), B, tile, dp,
      n_rows / tile);
  return static_cast<int>(cudaGetLastError());
}
