// flash_attention_f32: online-softmax attention with FP32 SIMT arithmetic.
//
// Replaces the TPU kernel src/repro/kernels/flash_attn.py::flash_attention
// (a Pallas kernel on a (B*H, Tq/bq, Tk/bk) grid that carries the running
// max, sum and accumulator of a q tile in VMEM scratch across the
// sequential kv grid steps) for float32 inputs, and for bf16 rows whose
// width the tensor-core kernel's TMA copies cannot take (D not a multiple
// of 8). bf16 with D a multiple of 8 runs on the tensor cores
// (flash_attention.cu).
//
// Contract: q [B, H, Tq, D], k/v [B, Hkv, Tk, D], all f32 or all bf16,
// contiguous, H a multiple of Hkv (query head h reads kv head h / (H/Hkv)),
// D <= 256 -> out [B, H, Tq, D] in q's dtype. All arithmetic is f32: q is
// scaled by `scale` (1/sqrt(D), rounded to f32) as it is loaded, before the
// product, as the TPU kernel does; the causal mask is row >= col (only
// Tq == Tk is asked of it); masked scores are -inf and the TPU kernel's
// guards keep them out: m_safe = 0 for a row with no finite score yet,
// p = 0 where the score is not finite, corr = 0 while the running max is
// -inf; out = acc / max(l, 1e-30).
//
// Bound on the H100: at the LM's prefill shapes, operations. 4*B*H*Tq*Tk*D
// flops (halved by the causal mask) against (q + k + v + out) bytes, at the
// 67 TFLOP/s FP32 rate for float32 inputs. The design: one block of
// 256 threads per (b*h, 64-row q tile); the scaled q tile stays in shared
// memory for the whole kv loop; k and v tiles of 64 rows take turns in one
// shared buffer (k transposed for the score product, then v), so that at
// D = 128 two blocks fit on an SM. Thread (ty, tx) of the 16 x 16 grid owns
// score columns tx + 16 j and accumulator columns tx + 16 u of q rows
// ty + 16 i; the rows' max and sum reduce with shuffles among the 16 lanes
// of a half-warp, which own the same rows, so m, l and the accumulator of
// each row live in those lanes' registers and the correction factor needs
// no shared memory. p goes through shared memory for the p.v product. k
// tiles wholly above the diagonal are skipped, and the heaviest q tiles
// (the last) start first. Ragged Tq, Tk and D are zero-filled on load,
// masked as -inf in the scores and not stored. Shared memory is dynamic:
// 50 KB at D = 64, 83 KB at 128 and 150 KB at 256, past the 48 KB of the
// static limit (cudaFuncSetAttribute raises the cap).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;  // q rows per block
constexpr int kBK = 64;  // k/v rows per tile
constexpr int kRows = kBQ / 16;
constexpr int kCols = kBK / 16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as a dtype cast does
}

template <int kD>
constexpr size_t smem_floats() {
  // q tile [kD][kBQ+1], kv tile [kD][kBK+1] (also holds v as [kBK][kD]),
  // p tile [kBQ][kBK+1]
  return (size_t)kD * (kBQ + 1) + (size_t)kD * (kBK + 1) +
         (size_t)kBQ * (kBK + 1);
}

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       int H, int G, int Tq, int Tk, int D, int causal,
                       float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                              // [kD][kBQ + 1]
  float* kv = qs + kD * (kBQ + 1);               // [kD][kBK + 1] | [kBK][kD]
  float* ps = kv + kD * (kBK + 1);               // [kBQ][kBK + 1]
  constexpr int kU = kD / 16;                    // accumulator columns
  const int t = threadIdx.x;
  const int tx = t & 15, ty = t >> 4;
  const int bh = blockIdx.y;
  const int kvh = (bh / H) * (H / G) + (bh % H) / G;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const T* qp = q + (size_t)bh * Tq * D;
  const T* kp = k + (size_t)kvh * Tk * D;
  const T* vp = v + (size_t)kvh * Tk * D;

  for (int e = t; e < kBQ * kD; e += kThreads) {
    const int r = e / kD, d = e % kD;
    float x = 0.0f;
    if (q0 + r < Tq && d < D) x = to_f32(qp[(size_t)(q0 + r) * D + d]) * scale;
    qs[d * (kBQ + 1) + r] = x;
  }

  float m[kRows], l[kRows], acc[kRows][kU];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int u = 0; u < kU; ++u) acc[i][u] = 0.0f;
  }

  int n_kt = (Tk + kBK - 1) / kBK;
  if (causal) n_kt = min(n_kt, (min(q0 + kBQ, Tq) - 1) / kBK + 1);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's p.v is done with kv and ps
    for (int e = t; e < kBK * kD; e += kThreads) {
      const int c = e / kD, d = e % kD;
      float x = 0.0f;
      if (k0 + c < Tk && d < D) x = to_f32(kp[(size_t)(k0 + c) * D + d]);
      kv[d * (kBK + 1) + c] = x;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < kD; ++d) {
      float qv[kRows], kvv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = qs[d * (kBQ + 1) + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kvv[j] = kv[d * (kBK + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kvv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = k0 + tx + 16 * j;
        if (col >= Tk || (causal && row < col)) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float m_new = fmaxf(m[i], mx);
      const float m_safe = isfinite(m_new) ? m_new : 0.0f;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = isfinite(s[i][j]) ? expf(s[i][j] - m_safe) : 0.0f;
        ps[(ty + 16 * i) * (kBK + 1) + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      }
      const float corr = isfinite(m[i]) ? expf(m[i] - m_safe) : 0.0f;
      l[i] = l[i] * corr + sum;
#pragma unroll
      for (int u = 0; u < kU; ++u) acc[i][u] *= corr;
      m[i] = m_new;
    }
    __syncthreads();  // every thread is done reading k; p is written

    for (int e = t; e < kBK * kD; e += kThreads) {
      const int c = e / kD, d = e % kD;
      float x = 0.0f;
      if (k0 + c < Tk && d < D) x = to_f32(vp[(size_t)(k0 + c) * D + d]);
      kv[c * kD + d] = x;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = ps[(ty + 16 * i) * (kBK + 1) + c];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const float vv = kv[c * kD + tx + 16 * u];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][u] = fmaf(pv[i], vv, acc[i][u]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Tq) continue;
    const float inv = 1.0f / fmaxf(l[i], 1e-30f);
    T* orow = out + ((size_t)bh * Tq + row) * D;
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int d = tx + 16 * u;
      if (d < D) store(orow + d, acc[i][u] * inv);
    }
  }
}

template <typename T, int kD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int Hkv, int Tq, int Tk, int D, int causal, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_floats<kD>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, kD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Tq + kBQ - 1) / kBQ, B * H);
  flash_attention_kernel<T, kD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), H, H / Hkv, Tq, Tk, D,
      causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* out, int B,
             int H, int Hkv, int Tq, int Tk, int D, int causal, float scale,
             cudaStream_t s) {
  if (D <= 32) return launch<T, 32>(q, k, v, out, B, H, Hkv, Tq, Tk, D, causal, scale, s);
  if (D <= 64) return launch<T, 64>(q, k, v, out, B, H, Hkv, Tq, Tk, D, causal, scale, s);
  if (D <= 128) return launch<T, 128>(q, k, v, out, B, H, Hkv, Tq, Tk, D, causal, scale, s);
  if (D <= 256) return launch<T, 256>(q, k, v, out, B, H, Hkv, Tq, Tk, D, causal, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// bf16: 0 if q, k, v and out are f32, 1 if all are bf16.
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v,
                                   void* out, int B, int H, int Hkv,
                                   int Tq, int Tk, int D, int causal,
                                   int bf16, float scale, int device,
                                   void* stream) {
  if (B == 0 || H == 0 || Tq == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_d<__nv_bfloat16>(q, k, v, out, B, H, Hkv, Tq, Tk, D,
                                        causal, scale, s)
              : launch_d<float>(q, k, v, out, B, H, Hkv, Tq, Tk, D, causal,
                                scale, s);
}
