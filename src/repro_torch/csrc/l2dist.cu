// l2dist: blocked squared-L2 distance matrix on Hopper's TF32 tensor cores.
//
// Replaces the TPU kernel src/repro/kernels/l2dist.py::l2dist (a Pallas
// kernel that accumulates -2 q.x^T on the MXU plus the partial norms of
// each d-block into a resident (bq, bn) f32 tile and clamps at 0).
//
// Contract: q [B, d], xb [N, d], both f32 or both bf16 (read as f32), any
// B, N and d -> out f32 [B, N], out[i, j] = max(|q_i|^2 + |x_j|^2 -
// 2 q_i.x_j, 0).
//
// Arithmetic. q.x runs on wgmma in TF32 with f32 accumulation, split in
// three passes (tf32x3.cuh): q_lo.x_hi + q_hi.x_lo + q_hi.x_hi, which
// drops about 2^-22 of |q||x|; the tile's 39 instructions (d = 100) share
// one accumulator, whose rounding toward zero adds to that. It holds the
// d2 tolerance, 1e-5 (|q|^2 + |x|^2), with its largest error at 0.21 of
// it on MSTuring-width rows (chip_smoke.py prints the share). Against
// float64, at q [1024, 100] and xb [262144, 100] drawn in float32 on an
// H100 80GB HBM3 (700 W), its largest error is 1.75x the plain float32
// version's (mean 2.1x), 0.65 of it moving q.x toward zero; under 2x, so
// the runs of instructions stay unsplit (PERF.md; on chip_smoke.py's
// MSTuring-width rows the ratio reads 2.05x, an open question). bf16 values
// are exact in TF32, so bf16 inputs take one pass. The norms are summed in
// f32 on the CUDA cores.
//
// Bound on the H100, at q [1024, 100] and xb [262144, 100]: bytes. The
// [B, N] f32 output is 1.07 GB of the 1.18 GB moved (0.352 ms at 3.35
// TB/s), while three TF32 passes take 0.325 ms at 495 TFLOP/s (one FP32
// pass on the CUDA cores 0.80 ms). So the tensor cores have to keep up
// with the output's stores, and the stores must not wait on them.
//
// The design. Operands live in K-major panels of [128 rows][8 values]
// with the 32-byte swizzle, one panel per k8 step (tf32x3.cuh), hi and lo
// apart, so K is padded only to a multiple of 8 (d = 100 -> 104); values
// past d and rows past B or N are zero. A pre-pass (x_split) splits xb
// once into these panels, tile by tile, with each row's squared norm: 8
// blocks read every x tile (one per 128 queries), and splitting it in each
// of them cost a quarter of the kernel's time and 52 registers a thread
// for the loads in flight. The main kernel: a block of two warpgroups owns
// 128 queries (64 each), splits their panels itself (106 KB, resident for
// d <= 104; longer rows walk d in chunks of 104 and stage the query chunk
// again at each) and walks up to 16 x tiles along N, copying each tile's
// image (106 KB, cp.async) into its one x buffer. Tile j's products are
// one group of 39 asynchronous m64n128k8 wgmma at d = 100, unrolled (a loop
// of runtime length makes ptxas close a group at every k8 step), and tile
// j-1's distances are written between them from a copy of its accumulator
// (norms added, clamped, 8-byte stores of whole 32-byte sectors when N is
// even, single values otherwise). Between the wgmma rather than after them,
// because a warp cannot issue a wgmma before the tensor cores have room for
// it; and from a copy, because reading a register that a wgmma wrote makes
// ptxas wait for every wgmma in flight. Measured on the card (clock64 at
// each phase): the copy of the next x tile, which cannot start before the
// products release the buffer, is a third of a tile's time; shared memory
// holds no second x buffer beside the queries' panels. Blocks are numbered
// with the query tile fastest, so the blocks of one span of x run together
// and read it from the L2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

#include "tf32x3.cuh"

namespace {

using namespace hopper;
using namespace tf32x3;

constexpr int kThreads = 256;            // two warpgroups
constexpr int kBM = 128;                 // queries per block
constexpr int kBN = 128;                 // x rows per tile
constexpr int kKC = 13;                  // k8 panels per chunk of d
constexpr int kChunk = 8 * kKC;          // 104 values of d
constexpr int kPanel = 128 * 32;         // bytes: 128 rows of 8 TF32
constexpr int kPart = kKC * kPanel;      // hi or lo of one operand
constexpr int kMaxTiles = 16;            // x tiles a block walks
// q_hi, q_lo, x_hi, x_lo, then |q|^2 [kBM] and |x|^2 [2][kBN]
constexpr int kSmem = 4 * kPart + (kBM + 2 * kBN) * 4 + 1024;

// The thread's half h of row r (0..127) of chunk kc: values kc*104 + 8p +
// 4h .. + 3 of each panel p; rows at or past n_rows read as zero.
template <typename T>
__device__ __forceinline__ void load_rows(float4 (&v)[kKC], const T* base,
                                          int row, int n_rows, int h, int kc,
                                          int d, bool vec) {
  const T* rp = base + (size_t)row * d;
#pragma unroll
  for (int p = 0; p < kKC; ++p) {
    v[p] = row < n_rows ? load4(rp, kc * kChunk + 8 * p + 4 * h, d, vec)
                        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// Write the values into the panels, hi and (kSplit) lo, and add their
// squares to norm. Values past d are zeros, so every panel of the chunk is
// written (the products always run over all kKC of them).
template <bool kSplit>
__device__ __forceinline__ void store_rows(uint8_t* hi, uint8_t* lo,
                                           const float4 (&v)[kKC], int r,
                                           int h, float& norm) {
  const uint32_t off = sw32_offset(r, h);
#pragma unroll
  for (int p = 0; p < kKC; ++p) {
    const float4 x = v[p];
    norm = fmaf(x.x, x.x, norm);
    norm = fmaf(x.y, x.y, norm);
    norm = fmaf(x.z, x.z, norm);
    norm = fmaf(x.w, x.w, norm);
    uint4 vh, vl;
    if constexpr (kSplit) {
      split(x.x, vh.x, vl.x);
      split(x.y, vh.y, vl.y);
      split(x.z, vh.z, vl.z);
      split(x.w, vh.w, vl.w);
      *reinterpret_cast<uint4*>(lo + p * kPanel + off) = vl;
    } else {
      vh = make_uint4(__float_as_uint(x.x), __float_as_uint(x.y),
                      __float_as_uint(x.z), __float_as_uint(x.w));
    }
    *reinterpret_cast<uint4*>(hi + p * kPanel + off) = vh;
  }
}

// The pre-pass: chunk blockIdx.y of x tile blockIdx.x, split once into
// its shared-memory image, [hi panels][lo panels] (img: [n_tiles][nkc]
// [2 kPart] bytes), with the partial squared norm of each row over the
// chunk (xn: [nkc][n_tiles * kBN]). Every block that reads the tile copies
// the image as it stands.
template <typename T>
__global__ void __launch_bounds__(kThreads)
x_split(const T* __restrict__ xb, uint8_t* __restrict__ img,
        float* __restrict__ xn, int N, int d) {
  constexpr bool kSplit = sizeof(T) == 4;
  const int sr = threadIdx.x / 2, sh = threadIdx.x % 2;
  const int row = blockIdx.x * kBN + sr, kc = blockIdx.y;
  const bool vec =
      d % 4 == 0 && reinterpret_cast<uintptr_t>(xb) % (4 * sizeof(T)) == 0;
  float4 v[kKC];
  load_rows(v, xb, row, N, sh, kc, d, vec);
  uint8_t* hi = img + ((size_t)blockIdx.x * gridDim.y + kc) * 2 * kPart;
  float norm = 0.0f;
  store_rows<kSplit>(hi, hi + kPart, v, sr, sh, norm);
  norm += __shfl_xor_sync(0xffffffffu, norm, 1);
  if (sh == 0) xn[(size_t)kc * gridDim.x * kBN + row] = norm;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
l2dist_tf32(const T* __restrict__ q, const uint8_t* __restrict__ img,
            const float* __restrict__ xn_g, float* __restrict__ out, int B,
            int N, int d, int tiles_per_block) {
  constexpr bool kSplit = sizeof(T) == 4;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_hi = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* q_lo = q_hi + kPart;
  uint8_t* x_hi = q_lo + kPart;
  uint8_t* x_lo = x_hi + kPart;
  float* qn_s = reinterpret_cast<float*>(x_lo + kPart);
  float* xn_s = qn_s + kBM;

  const int tid = threadIdx.x;
  const int wg = tid / 128, w = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int sr = tid / 2, sh = tid % 2;    // staging: row and half
  const int m0 = blockIdx.x * kBM;
  const int tile0 = blockIdx.y * tiles_per_block;
  const int nt = min(tiles_per_block, (N + kBN - 1) / kBN - tile0);
  const int nkc = (d + kChunk - 1) / kChunk;
  const bool vec_q =
      d % 4 == 0 && reinterpret_cast<uintptr_t>(q) % (4 * sizeof(T)) == 0;

  {  // |q|^2 of the block's queries: a pair of threads per row
    float s = 0.0f;
    if (m0 + sr < B) {
      const T* row = q + (size_t)(m0 + sr) * d;
      for (int c = sh; c < d; c += 2) {
        const float v = to_f32(row[c]);
        s = fmaf(v, v, s);
      }
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    if (sh == 0) qn_s[sr] = s;
  }
  auto stage_q = [&](int kc) {
    float4 v[kKC];
    float unused = 0.0f;
    load_rows(v, q, m0 + sr, B, sh, kc, d, vec_q);
    store_rows<kSplit>(q_hi, q_lo, v, sr, sh, unused);
  };
  if (nkc == 1) stage_q(0);   // resident for the whole walk

  // distances of tile j from its accumulator copy: rows ra and ra + 8,
  // columns 8jj + 2t + {0, 1} of the tile, for jj in [jj0, jj1)
  const int lr = 64 * wg + 16 * w + g;
  const int ra = m0 + lr;
  const bool in_a = ra < B, in_b = ra + 8 < B;
  auto epilogue = [&](const float (&acc)[64], int j, int jj0, int jj1) {
    const int n0 = (tile0 + j) * kBN;
    const float* xn = xn_s + (j & 1) * kBN;
    const float qa = qn_s[lr], qb = qn_s[lr + 8];
    float* oa = out + (size_t)ra * N + n0;
    float* ob = oa + (size_t)8 * N;
#pragma unroll
    for (int jj = jj0; jj < jj1; ++jj) {
      const int c = 8 * jj + 2 * t;
      const float2 xc = *reinterpret_cast<const float2*>(xn + c);
      const float a0 = fmaxf(fmaf(-2.0f, acc[4 * jj], qa + xc.x), 0.0f);
      const float a1 = fmaxf(fmaf(-2.0f, acc[4 * jj + 1], qa + xc.y), 0.0f);
      const float b0 = fmaxf(fmaf(-2.0f, acc[4 * jj + 2], qb + xc.x), 0.0f);
      const float b1 = fmaxf(fmaf(-2.0f, acc[4 * jj + 3], qb + xc.y), 0.0f);
      if (n0 + c + 1 < N && (N & 1) == 0) {   // 8-byte aligned pairs
        if (in_a) *reinterpret_cast<float2*>(oa + c) = make_float2(a0, a1);
        if (in_b) *reinterpret_cast<float2*>(ob + c) = make_float2(b0, b1);
      } else {
        if (n0 + c < N) {
          if (in_a) oa[c] = a0;
          if (in_b) ob[c] = b0;
        }
        if (n0 + c + 1 < N) {
          if (in_a) oa[c + 1] = a1;
          if (in_b) ob[c + 1] = b1;
        }
      }
    }
  };

  // products of one chunk: kKC k8 steps, each 3 passes (1 for bf16),
  // unrolled, one wgmma group; with a previous tile, its distances are
  // written between the steps
  const uint32_t qa_hi = smem_u32(q_hi) + wg * 64 * 32;
  const uint32_t qa_lo = smem_u32(q_lo) + wg * 64 * 32;
  const uint32_t xs_hi = smem_u32(x_hi), xs_lo = smem_u32(x_lo);
  auto step = [&](float (&acc)[64], int kk, int sc) {
    const uint32_t off = kk * kPanel;
    if constexpr (kSplit) {
      wgmma_m64n128k8(acc, sw32_desc(qa_lo + off), sw32_desc(xs_hi + off),
                      sc);
      wgmma_m64n128k8(acc, sw32_desc(qa_hi + off), sw32_desc(xs_lo + off), 1);
      wgmma_m64n128k8(acc, sw32_desc(qa_hi + off), sw32_desc(xs_hi + off), 1);
    } else {
      wgmma_m64n128k8(acc, sw32_desc(qa_hi + off), sw32_desc(xs_hi + off),
                      sc);
    }
  };
  auto issue = [&](float (&acc)[64], int accumulate) {
#pragma unroll
    for (int kk = 0; kk < kKC; ++kk) step(acc, kk, accumulate | (kk > 0));
  };
  auto issue_and_write = [&](float (&acc)[64], const float (&prev)[64],
                             int j) {
#pragma unroll
    for (int kk = 0; kk < kKC; ++kk) {
      step(acc, kk, kk > 0);
      epilogue(prev, j, 16 * kk / kKC, 16 * (kk + 1) / kKC);
    }
  };

  // x tile j, chunk kc: its image into x_hi and x_lo (contiguous), its
  // rows' squared norms into xn_s
  const int n_tiles = (N + kBN - 1) / kBN;
  auto stage_x = [&](int j, int kc) {
    const uint8_t* src = img + ((size_t)(tile0 + j) * nkc + kc) * 2 * kPart;
    for (int i = 16 * tid; i < 2 * kPart; i += 16 * kThreads)
      cp_async16(x_hi + i, src + i);
    if (kc == 0 && tid < kBN) {
      float s = 0.0f;
      for (int c = 0; c < nkc; ++c)
        s += xn_g[(size_t)c * n_tiles * kBN + (tile0 + j) * kBN + tid];
      xn_s[(j & 1) * kBN + tid] = s;
    }
    cp_commit();
    cp_wait_all();
  };

  // tile j into acc; tile j-1's distances leave from ep, a copy of its
  // accumulator, meanwhile
  float acc[64], ep[64];
  for (int j = 0; j < nt; ++j) {
    for (int kc = 0; kc < nkc; ++kc) {
      stage_x(j, kc);
      if (nkc > 1) stage_q(kc);
      fence_async_smem();
      __syncthreads();
      wg_fence();
      if (kc == 0 && j > 0) {
        issue_and_write(acc, ep, j - 1);
      } else {
        issue(acc, kc > 0);
      }
      wg_commit();
      wg_wait<0>();
      pin(acc);
      if (kc == nkc - 1) {
#pragma unroll
        for (int i = 0; i < 64; ++i) ep[i] = acc[i];
        pin(ep);
      }
      __syncthreads();   // both warpgroups are done reading the tiles
    }
  }
  epilogue(ep, nt - 1, 0, 16);
}

size_t image_bytes(int N, int d) {
  const size_t tiles = (N + kBN - 1) / kBN, nkc = (d + kChunk - 1) / kChunk;
  return tiles * nkc * (2 * kPart + kBN * sizeof(float));
}

template <typename T>
int launch(const void* q, const void* xb, void* out, void* scratch, int B,
           int N, int d, int device, cudaStream_t stream) {
  int sms = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nq = (B + kBM - 1) / kBM, nxt = (N + kBN - 1) / kBN;
  // about two blocks per SM at least, at most kMaxTiles tiles a block
  // (more only where the grid's y extent runs out)
  long per = ((long)nq * nxt + 2L * sms - 1) / (2L * sms);
  per = per < 1 ? 1 : (per > kMaxTiles ? kMaxTiles : per);
  if ((nxt + per - 1) / per > 65535) per = (nxt + 65534) / 65535;
  err = cudaFuncSetAttribute(l2dist_tf32<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nkc = (d + kChunk - 1) / kChunk;
  uint8_t* img = static_cast<uint8_t*>(scratch);
  float* xn = reinterpret_cast<float*>(img + (size_t)nxt * nkc * 2 * kPart);
  x_split<T><<<dim3(nxt, nkc), kThreads, 0, stream>>>(
      static_cast<const T*>(xb), img, xn, N, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(nq, (nxt + per - 1) / per);
  l2dist_tf32<T><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const T*>(q), img, xn, static_cast<float*>(out), B, N, d,
      static_cast<int>(per));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of scratch that l2dist needs for xb [N, d]: the split x tiles'
// images and their rows' partial norms.
extern "C" long long l2dist_scratch(int N, int d) {
  return d > 0 ? static_cast<long long>(image_bytes(N, d)) : 0;
}

// bf16: 0 if q and xb are f32, 1 if both are bf16. scratch: at least
// l2dist_scratch(N, d) bytes, 16-byte aligned.
extern "C" int l2dist(const void* q, const void* xb, void* out, void* scratch,
                      int B, int N, int d, int bf16, int device,
                      void* stream) {
  if (B == 0 || N == 0) return 0;
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 0)   // every distance is 0
    return static_cast<int>(
        cudaMemsetAsync(out, 0, (size_t)B * N * sizeof(float), s));
  return bf16 ? launch<__nv_bfloat16>(q, xb, out, scratch, B, N, d, device, s)
              : launch<float>(q, xb, out, scratch, B, N, d, device, s);
}
