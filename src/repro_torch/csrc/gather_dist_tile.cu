// gather_dist_tile: the exact scan's distance tile, register-tiled.
//
// Replaces the TPU kernel src/repro/kernels/gather_dist.py::gather_dist_tile
// (a scalar-prefetch Pallas kernel that DMAs one (tile, d) block of rows per
// query lane and reduces it on the resident tile).
//
// Contract: xb f32 [N_pad, dp] (N_pad a multiple of tile, dp of 8, 16-byte
// aligned), base int32 [B] (clamped into [0, N_pad/tile)), q f32 [B, dp]
//   -> out f32 [B, tile], out[b, t] = max(|x|^2 - 2 q.x + |q|^2, 0)
//      for x = xb[base[b]*tile + t].
//
// Arithmetic: every term is a rounded multiply followed by a rounded add
// (__fmul_rn/__fadd_rn, which the compiler may not contract into an FMA),
// summed over d in order. That is the plain PyTorch version's arithmetic,
// so kernel and plain version agree bit for bit and the kernel scan and
// the plain scan return the same ids. It rules out the tensor cores, TF32
// and FMA.
//
// Bound on the H100: operations. 2*B*tile*dp flops at the 67 TFLOP/s FMA
// rate is the table's bound (0.0072 ms at the prefilter's 568 lanes x 4096
// rows x 104); the contract's own floor is two FP32 instructions per term,
// 2*B*tile*dp instructions at about 33 T instructions/s (132 SMs x 128
// lanes x 1.98 GHz), twice that: 0.0145 ms at the same shape.
//
// The design: a block of 128 threads owns 64 rows x 64 query lanes; each
// thread keeps a 4-row x 8-lane micro-tile of sums in registers (rows
// g + 16 i, lanes l + 8 j for thread (g, l)), so each step of four d
// reads 4 x rows and 8 q lanes as float4 from shared memory (the q reads
// are broadcasts): 12 wide loads for 128 multiply/add pairs. A sum still
// runs over d in order; the tile only decides which thread owns it. Each
// row's squared norm is summed once per block, by warp 0 from the x values
// it holds, and each lane's by warp 1 from the staged queries. Each add
// waits on its multiply (no FMA), so the SM needs warps to hide that
// latency, and the scan tile is a small product: at 568 lanes x 4096 rows
// the grid is 576 blocks, four or five on each SM (16 to 20 warps), all
// resident at once under 100 registers a thread. An 8 x 8 micro-tile, or more
// registers a thread, leaves fewer warps or fewer resident blocks, and ran
// slower on the H100. The rows and the queries come into shared memory
// in d-chunks of 8 through cp.async, into a ring of three stages, so the
// next chunks load while the current one is consumed; each staged row is
// padded to 12 floats, which keeps the row reads free of bank conflicts.
// The queries stream with the rows rather than staying resident, so the
// shared memory does not grow with dp. All lanes of the exact scan share
// one base, and one pass serves the block. Lanes with differing bases take
// one pass per distinct base in the block, each pass storing the lanes of
// its base.
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBT = 64;            // rows per block
constexpr int kBQ = 64;            // query lanes per block
constexpr int kDK = 8;             // d chunk per stage
constexpr int kStages = 3;
constexpr int kPitch = 12;         // floats per staged row (8 + 4 of pad)
constexpr int kRT = 4;             // rows per thread: g + kRG i
constexpr int kLQ = 8;             // lanes per thread: l + kLG j
constexpr int kRG = kBT / kRT;     // row groups
constexpr int kLG = kBQ / kLQ;     // lane groups
constexpr int kNR = kBT / 32;      // norms of rows per thread of warp 0
constexpr int kNQ = kBQ / 32;      // norms of lanes per thread of warp 1
constexpr int kCopies = (kBT + kBQ) * 2 / kThreads;  // 16-byte copies
static_assert(kThreads == kRG * kLG && kThreads >= kBQ && kThreads >= 64 &&
                  kRG <= 32 && 32 % kRG == 0 && kNR >= 1 && kNQ >= 1 &&
                  (2 * kBT) % kThreads == 0 && (2 * kBQ) % kThreads == 0,
              "a thread per row group and lane group; a lane per thread in "
              "the prologue; warp 0 holds whole row groups; whether a copy "
              "is of a row or a lane is known at compile time");

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool fill) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(fill ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ float term(float acc, float a, float b) {
  return __fadd_rn(acc, __fmul_rn(a, b));
}

__device__ __forceinline__ float norm4(float acc, float4 x) {
  acc = term(acc, x.x, x.x);
  acc = term(acc, x.y, x.y);
  acc = term(acc, x.z, x.z);
  return term(acc, x.w, x.w);
}

__global__ void __launch_bounds__(kThreads, 640 / kThreads)
gather_dist_tile_kernel(const float* __restrict__ xb,
                        const int* __restrict__ base,
                        const float* __restrict__ q,
                        float* __restrict__ out,
                        int B, int tile, int dp, int n_tiles) {
  __shared__ __align__(16) float xs[kStages][kBT][kPitch];
  __shared__ __align__(16) float qs[kStages][kBQ][kPitch];
  __shared__ float xn_s[kBT];
  __shared__ float qn_s[kBQ];
  __shared__ int tb_s[kBQ];     // the lane's tile, clamped
  __shared__ int first_s[kBQ];  // the block's first lane with that tile
  const int t = threadIdx.x;
  const int g = t % kRG, l = t / kRG, warp = t / 32, u = t % 32;
  const int r0 = blockIdx.x * kBT;   // first row of the block inside a tile
  const int b0 = blockIdx.y * kBQ;   // first query lane of the block
  const int nq = min(kBQ, B - b0);
  const int n_chunks = dp / kDK;

  if (t < nq) tb_s[t] = min(max(base[b0 + t], 0), n_tiles - 1);
  __syncthreads();
  if (__syncthreads_and(t >= nq || tb_s[t] == tb_s[0])) {
    if (t < nq) first_s[t] = 0;
  } else if (t < nq) {
    int f = t;
    for (int j = 0; j < t; ++j) {
      if (tb_s[j] == tb_s[t]) {
        f = j;
        break;
      }
    }
    first_s[t] = f;
  }
  __syncthreads();

  for (int p = 0; p < nq; ++p) {
    if (first_s[p] != p) continue;   // a pass per distinct tile
    const size_t row0 = (size_t)tb_s[p] * tile + r0;
    // chunk c into stage st: copy k of thread t is half e % 2 of row (or,
    // past the rows, lane) e / 2, e = t + k kThreads
    float* dst[kCopies];
    const float* src[kCopies];
    bool fill[kCopies];
#pragma unroll
    for (int k = 0; k < kCopies; ++k) {
      const int e = t + k * kThreads, r = e >> 1, h = 4 * (e & 1);
      if (k * kThreads < 2 * kBT) {
        fill[k] = r0 + r < tile;
        dst[k] = &xs[0][r][h];
        src[k] = fill[k] ? xb + (row0 + r) * dp + h : xb;
      } else {
        const int lq = r - kBT;
        fill[k] = lq < nq;
        dst[k] = &qs[0][lq][h];
        src[k] = fill[k] ? q + (size_t)(b0 + lq) * dp + h : q;
      }
    }
    auto load = [&](int c, int st) {
#pragma unroll
      for (int k = 0; k < kCopies; ++k) {
        const int stage_floats = (k * kThreads < 2 * kBT ? kBT : kBQ) * kPitch;
        cp_async16(dst[k] + st * stage_floats,
                   fill[k] ? src[k] + c * kDK : src[k], fill[k]);
      }
    };
#pragma unroll
    for (int c = 0; c < kStages - 1; ++c) {
      if (c < n_chunks) load(c, c);
      cp_async_commit();
    }

    float acc[kRT][kLQ];
    float nrm[kNR > kNQ ? kNR : kNQ] = {};   // warp 0: rows; warp 1: lanes
#pragma unroll
    for (int i = 0; i < kRT; ++i)
#pragma unroll
      for (int j = 0; j < kLQ; ++j) acc[i][j] = 0.0f;

    for (int c = 0; c < n_chunks; ++c) {
      const int cn = c + kStages - 1;
      if (cn < n_chunks) load(cn, cn % kStages);
      cp_async_commit();
      cp_async_wait<kStages - 1>();  // this thread's copies of chunk c
      __syncthreads();               // everyone's
      const int st = c % kStages;
#pragma unroll
      for (int h = 0; h < kDK / 4; ++h) {
        float4 xv[kRT];
#pragma unroll
        for (int i = 0; i < kRT; ++i)
          xv[i] = *reinterpret_cast<const float4*>(&xs[st][g + kRG * i][4 * h]);
        if (warp == 0) {
          // thread (g, l) sums the norms of rows g + kRG (kNR l + ii)
#pragma unroll
          for (int ii = 0; ii < kNR; ++ii) {
            float4 x = xv[ii];
#pragma unroll
            for (int k = 1; k < kRT / kNR; ++k)
              if (l == k) x = xv[kNR * k + ii];
            nrm[ii] = norm4(nrm[ii], x);
          }
        } else if (warp == 1) {
          // thread u of warp 1 sums the norms of lanes u + 32 ii
#pragma unroll
          for (int ii = 0; ii < kNQ; ++ii)
            nrm[ii] = norm4(nrm[ii], *reinterpret_cast<const float4*>(
                                         &qs[st][u + 32 * ii][4 * h]));
        }
#pragma unroll
        for (int j = 0; j < kLQ; ++j) {
          const float4 qv =
              *reinterpret_cast<const float4*>(&qs[st][l + kLG * j][4 * h]);
#pragma unroll
          for (int i = 0; i < kRT; ++i) acc[i][j] = term(acc[i][j], qv.x, xv[i].x);
#pragma unroll
          for (int i = 0; i < kRT; ++i) acc[i][j] = term(acc[i][j], qv.y, xv[i].y);
#pragma unroll
          for (int i = 0; i < kRT; ++i) acc[i][j] = term(acc[i][j], qv.z, xv[i].z);
#pragma unroll
          for (int i = 0; i < kRT; ++i) acc[i][j] = term(acc[i][j], qv.w, xv[i].w);
        }
      }
      __syncthreads();  // the stage is consumed before it is refilled
    }

    if (warp == 0) {
#pragma unroll
      for (int ii = 0; ii < kNR; ++ii) xn_s[g + kRG * (kNR * l + ii)] = nrm[ii];
    } else if (warp == 1) {
#pragma unroll
      for (int ii = 0; ii < kNQ; ++ii) qn_s[u + 32 * ii] = nrm[ii];
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kLQ; ++j) {
      const int lane = l + kLG * j;
      if (lane >= nq || first_s[lane] != p) continue;
      const float qn = qn_s[lane];
      float* orow = out + (size_t)(b0 + lane) * tile + r0;
#pragma unroll
      for (int i = 0; i < kRT; ++i) {
        const int r = g + kRG * i;
        if (r0 + r >= tile) continue;
        const float v = __fadd_rn(__fsub_rn(xn_s[r], 2.0f * acc[i][j]), qn);
        orow[r] = fmaxf(v, 0.0f);
      }
    }
    __syncthreads();  // xn_s and qn_s are rewritten by the next pass
  }
}

}  // namespace

extern "C" int gather_dist_tile_f32(const void* xb, const void* base,
                                    const void* q, void* out, int B,
                                    int tile, int dp, int n_rows,
                                    int device, void* stream) {
  if (B == 0 || tile == 0) return 0;
  if (dp % kDK) return static_cast<int>(cudaErrorInvalidValue);
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  dim3 grid((tile + kBT - 1) / kBT, (B + kBQ - 1) / kBQ);
  gather_dist_tile_kernel<<<grid, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xb), static_cast<const int*>(base),
      static_cast<const float*>(q), static_cast<float*>(out), B, tile, dp,
      n_rows / tile);
  return static_cast<int>(cudaGetLastError());
}
