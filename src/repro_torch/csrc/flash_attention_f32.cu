// flash_attention_f32: online-softmax attention with float32 products on
// the TF32 tensor cores, split in three passes (tf32x3.cuh).
//
// Replaces the TPU kernel src/repro/kernels/flash_attn.py::flash_attention
// (a Pallas kernel on a (B*H, Tq/bq, Tk/bk) grid that carries the running
// max, sum and accumulator of a q tile in VMEM scratch across the
// sequential kv grid steps) for float32 inputs, and for bf16 rows whose
// width the bf16 kernel's TMA copies cannot take (D not a multiple of 8).
// bf16 with D a multiple of 8 runs on flash_attention.cu.
//
// Contract: q [B, H, Tq, D], k/v [B, Hkv, Tk, D], all f32 or all bf16,
// contiguous, H a multiple of Hkv (query head h reads kv head h / (H/Hkv)),
// D <= 256 -> out [B, H, Tq, D] in q's dtype. q is scaled by `scale`
// (1/sqrt(D), rounded to f32) in f32 before the product, as the TPU kernel
// does; the causal mask is row >= col (only Tq == Tk is asked of it);
// masked scores are -inf and the TPU kernel's guards keep them out: m_safe
// = 0 for a row with no finite score yet, p = 0 where the score is not
// finite, corr = 0 while the running max is -inf; out = acc / max(l,
// 1e-30).
//
// Arithmetic. Both products, S = (q scale) K^T and O += P V, run on the
// tensor cores in TF32, each operand split as hi + lo and each product in
// three passes (lo.hi + hi.lo + hi.hi), which drops about 2^-22 of
// |a||b|; one TF32 pass would lose 2^-11 (tests/test_torch_kernels.py
// shows it break the float32 gate). A tensor-core instruction rounds its
// f32 sum toward zero, and that bias adds up over the instructions that
// share an accumulator: 48 for a score at D = 128, 3 Tk / 8 for an
// output. So the wgmma kernel sums two k8 steps of S (6 instructions) and
// one kv tile of P V (12) in a fresh accumulator, and adds each into S or
// O on the CUDA cores, rounding to nearest. On an H100 at the LM's prefill
// shape that took the largest error against float64 from 1.6e-5 to
// 1.1e-6, under the plain float32 version's 1.6e-6, for about 4% more
// time (PERF.md). The mma.sync kernel (D = 256) does the same: two k8
// steps of S and one kv tile of P V (6 instructions each) from zero, P V
// two dimension tiles at a time, added as O corr + P V in one rounding,
// with the passes of independent products issued side by side
// (mma3_m16n8k8). At q [1, 16, 2048, 256] on an H100 80GB HBM3 (700 W)
// that took its largest error against float64 from 6.9e-6 to 6.8e-7
// (plain float32 1.5e-6) at the same time; issued a product at a time it
// cost 8% (PERF.md). Softmax runs in f32 on the CUDA cores, exp as the
// SFU's 2^x of s log2(e) - m log2(e).
//
// Bound on the H100: operations. 4 B H Tq Tk D flops (halved by the causal
// mask) over 495 TFLOP/s TF32, times 3 for the passes: 1.67 ms at the LM's
// prefill shape (q [4, 16, 4096, 128]), against 4.10 ms for one pass on the
// CUDA cores at 67 TFLOP/s. q, k, v and out are read or written once each
// (0.12 ms).
//
// D <= 128: wgmma (flash_attention_wgmma). mma.sync versions of this
// kernel ran slower than this one on an H100, the tensor pipe idle
// through each tile's softmax and staging. One block per (q tile of 128
// rows, b*h), heaviest (last) q tiles first; two warpgroups of 64 rows,
// each with its O, m and l in registers; kv tiles of 32 rows in two
// buffers.
//   - A pre-pass (kv_split) splits K and V once into each kv tile's
//     shared-memory image, which every block that reads the tile copies as
//     it stands (cp.async, under the current tile's products). Splitting in
//     each block instead repeated the work 64 times per kv head (32 q tiles
//     of 2 query heads) and cost about a third of the kernel's time.
//   - S = Q K^T, m64n32k8, K-major operands: q_lo . k_hi takes q_lo from
//     registers (each thread's A fragments, split once), q_hi . k_lo and
//     q_hi . k_hi take q_hi from shared memory; so the q tile costs 64 KB
//     (q_hi only) and 64 registers instead of 128 KB.
//   - O += P V, m64nDk8 with P from registers. TF32 wgmma takes no
//     transposed operand, so the image holds V transposed, [dimension]
//     [key]. The k index t of each 8 keys is key 2t and t + 4 is key 2t + 1
//     (a permutation of the sum's index that the product does not see): a
//     thread's S accumulator holds keys 2t and 2t + 1 of rows g and g + 8,
//     which is then exactly its A fragment of P, with no shuffle.
//   - Operands live in 32-byte swizzled K-major panels of 8 TF32 a row, one
//     per k8 step (tf32x3.cuh); K hi and lo and V^T hi and lo take 64 KB a
//     buffer at D = 128. Shared memory: 193 KB at D = 128, 97 KB at 64.
//   - No branch around the wgmma instructions or their waits: ptxas then
//     serializes every one of them; so a tile above a warpgroup's diagonal
//     is computed (p = 0 there).
// D = 256: mma.sync (flash_attention_mma), whose q tile fits: four warps
// of 16 q rows, the q tile in shared memory as f32, K and V tiles of 16
// rows split once per block into (hi, hi, lo, lo) quads that a thread
// reads with one 16-byte load (K as [key][dimension pair], V as [key
// pair][dimension], with the same index permutations), two buffers.
//
// Rows past Tq or Tk and columns past D are zero-filled; masked scores are
// -inf. A warp of the mma.sync kernel skips a kv tile that lies wholly
// above its rows' diagonal.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "device_guard.cuh"

#include "tf32x3.cuh"

namespace {

using namespace hopper;
using namespace tf32x3;

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as a dtype cast does
}
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// Rows r0 + 8h of a thread, h = 0, 1: the online softmax of one tile's
// scores s[4j + 2h + {0, 1}] (columns k0 + 8j + 2t + {0, 1}) against the
// running max m[h] and sum l[h]; s becomes p, corr[h] the factor for O.
template <int kNT>
__device__ __forceinline__ void softmax_tile(float (&s)[4 * kNT], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             int r0, int k0, int t, int Tk,
                                             bool causal, bool masked) {
  if (masked) {
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * j + 2 * t + (e & 1);
        const int row = r0 + (e < 2 ? 0 : 8);
        if (col >= Tk || (causal && col > row)) s[4 * j + e] = -INFINITY;
      }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kNT; ++j)
      mx = fmaxf(mx, fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[h], mx);
    const float ms = isfinite(m_new) ? m_new : 0.0f;
    corr[h] = isfinite(m[h]) ? ex2((m[h] - ms) * kLog2e) : 0.0f;
    m[h] = m_new;
    const float mb = ms * kLog2e;
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 2 * h; e < 2 * h + 2; ++e) {
        float& x = s[4 * j + e];
        x = isfinite(x) ? ex2(fmaf(x, kLog2e, -mb)) : 0.0f;
        sum += x;
      }
    l[h] = l[h] * corr[h] + sum;
  }
}

// out rows r0 and r0 + 8 of the thread: o[4i + 2h + {0, 1}] / l[h] at
// columns 8i + 2t + {0, 1} (l summed over the quad first).
template <typename T, int kDT>
__device__ __forceinline__ void write_rows(T* out, const float (&o)[4 * kDT],
                                           float (&l)[2], int r0, int t,
                                           int Tq, int D) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const float inv = 1.0f / fmaxf(l[h], 1e-30f);
    const int row = r0 + 8 * h;
    if (row >= Tq) continue;
    T* orow = out + (size_t)row * D;
#pragma unroll
    for (int i = 0; i < kDT; ++i) {
      const int c = 8 * i + 2 * t;
      const float x = o[4 * i + 2 * h] * inv, y = o[4 * i + 2 * h + 1] * inv;
      if (c + 1 < D && D % 2 == 0) {   // aligned pairs
        store2(orow + c, x, y);
      } else {
        if (c < D) store(orow + c, x);
        if (c + 1 < D) store(orow + c + 1, y);
      }
    }
  }
}

// ---- D <= 128: both products on wgmma --------------------------------------

template <int kD>
struct WgLayout {
  static constexpr int kBQ = 128, kBK = 32, kThreads = 256;
  static constexpr int kKP = kD / 8;              // k8 panels over D
  static constexpr int kQPanel = kBQ * 32;        // bytes: rows of 8 TF32
  static constexpr int kKPanel = kBK * 32;
  static constexpr int kVPanel = kD * 32;         // V^T: D rows of 8 keys
  static constexpr int kKPart = kKP * kKPanel;    // K hi or lo
  static constexpr int kVPart = kBK / 8 * kVPanel;   // V^T hi or lo
  static constexpr int kBuf = 2 * (kKPart + kVPart);
  static constexpr int kSmem = kKP * kQPanel + 2 * kBuf + 1024;
  // a thread's share of a kv tile: K chunks of (key, 4 dimensions), V
  // chunks of (8 keys, 1 dimension)
  static constexpr int kKChunks = kBK * kD / 4, kVChunks = kBK / 8 * kD;
  static constexpr int kKC = (kKChunks + kThreads - 1) / kThreads;
  static constexpr int kVC = (kVChunks + kThreads - 1) / kThreads;
};

template <int kD>
__device__ __forceinline__ void pv_mma(float (&o)[kD / 2],
                                       const uint32_t (&a)[4], uint64_t db,
                                       int scale_d = 1) {
  if constexpr (kD == 32) wgmma_m64n32k8(o, a, db, scale_d);
  else if constexpr (kD == 64) wgmma_m64n64k8(o, a, db, scale_d);
  else wgmma_m64n128k8(o, a, db, scale_d);
}

// Chunk e of a panel layout with kRows rows: panel e / (2 kRows), row e %
// (2 kRows) / 2, half e % 2 (values 8 panel + 4 half .. + 3). A warp's 32
// chunks are 16 rows of one panel, 512 contiguous bytes: its 16-byte stores
// meet no bank conflict.
template <int kRows>
__device__ __forceinline__ void panel_chunk(int e, int& row, int& c,
                                            uint32_t& off) {
  const int panel = e / (2 * kRows), h = e % 2;
  row = e % (2 * kRows) / 2;
  c = 8 * panel + 4 * h;
  off = panel * kRows * 32 + sw32_offset(row, h);
}

template <int kD>
struct WgRegs {
  float4 k[WgLayout<kD>::kKC];
  float v[WgLayout<kD>::kVC][8];
};

template <typename T, int kD>
__device__ __forceinline__ void wg_load_kv(WgRegs<kD>& r, const T* kp,
                                           const T* vp, int k0, int Tk,
                                           int D, bool vec) {
  using L = WgLayout<kD>;
#pragma unroll
  for (int i = 0; i < L::kKC; ++i) {
    const int e = threadIdx.x + i * L::kThreads;
    int key, c;
    uint32_t off;
    panel_chunk<L::kBK>(e, key, c, off);
    r.k[i] = e < L::kKChunks && k0 + key < Tk
                 ? load4(kp + (size_t)(k0 + key) * D, c, D, vec)
                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
#pragma unroll
  for (int i = 0; i < L::kVC; ++i) {
    const int e = threadIdx.x + i * L::kThreads;
    const int key0 = k0 + 8 * (e / kD), dim = e % kD;
    const bool in = e < L::kVChunks && dim < D;
#pragma unroll
    for (int u = 0; u < 8; ++u)
      r.v[i][u] = in && key0 + u < Tk ? to_f32(vp[(size_t)(key0 + u) * D + dim])
                                      : 0.0f;
  }
}

// Split the registers into the buffer: K at (panel c / 8, row key); V^T at
// (panel key / 8, row dimension), the 8 keys of a panel row in the order
// 0, 2, 4, 6 | 1, 3, 5, 7 (k index t = key 2t). A warp's V^T stores are 32
// consecutive rows, which the swizzle spreads over all banks.
template <int kD>
__device__ __forceinline__ void wg_store_kv(const WgRegs<kD>& r,
                                            uint8_t* buf) {
  using L = WgLayout<kD>;
  uint8_t* k_hi = buf;
  uint8_t* k_lo = k_hi + L::kKPart;
  uint8_t* v_hi = k_lo + L::kKPart;
  uint8_t* v_lo = v_hi + L::kVPart;
#pragma unroll
  for (int i = 0; i < L::kKC; ++i) {
    const int e = threadIdx.x + i * L::kThreads;
    if (e < L::kKChunks) {
      int key, c;
      uint32_t off;
      panel_chunk<L::kBK>(e, key, c, off);
      uint4 h, l;
      split(r.k[i].x, h.x, l.x);
      split(r.k[i].y, h.y, l.y);
      split(r.k[i].z, h.z, l.z);
      split(r.k[i].w, h.w, l.w);
      *reinterpret_cast<uint4*>(k_hi + off) = h;
      *reinterpret_cast<uint4*>(k_lo + off) = l;
    }
  }
#pragma unroll
  for (int i = 0; i < L::kVC; ++i) {
    const int e = threadIdx.x + i * L::kThreads;
    if (e < L::kVChunks) {
      const int grp = e / kD, dim = e % kD;
      const float* x = r.v[i];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint4 h, l;
        split(x[half + 0], h.x, l.x);
        split(x[half + 2], h.y, l.y);
        split(x[half + 4], h.z, l.z);
        split(x[half + 6], h.w, l.w);
        const uint32_t off = grp * L::kVPanel + sw32_offset(dim, half);
        *reinterpret_cast<uint4*>(v_hi + off) = h;
        *reinterpret_cast<uint4*>(v_lo + off) = l;
      }
    }
  }
}

// The pre-pass: kv tile blockIdx.x of kv head h0 + blockIdx.y, split once
// into its shared-memory image (img: [B*Hkv][n_tiles][kBuf] bytes), which
// every block that reads the tile then copies as it stands.
template <typename T, int kD>
__global__ void __launch_bounds__(256)
kv_split(const T* __restrict__ k, const T* __restrict__ v,
         uint8_t* __restrict__ img, int Tk, int D, int h0) {
  using L = WgLayout<kD>;
  const int h = h0 + blockIdx.y;
  const uintptr_t a4 = 4 * sizeof(T);
  const bool vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(k) % a4 == 0;
  WgRegs<kD> r;
  wg_load_kv<T, kD>(r, k + (size_t)h * Tk * D, v + (size_t)h * Tk * D,
                    blockIdx.x * L::kBK, Tk, D, vec);
  wg_store_kv<kD>(r, img + ((size_t)h * gridDim.x + blockIdx.x) * L::kBuf);
}

template <typename T, int kD>
__global__ void __launch_bounds__(256, 1)
flash_attention_wgmma(const T* __restrict__ q,
                      const uint8_t* __restrict__ img, T* __restrict__ out,
                      int H, int G, int Tq, int Tk, int D, int causal,
                      float scale, int h0) {
  using L = WgLayout<kD>;
  constexpr int kBQ = L::kBQ, kBK = L::kBK, kKP = L::kKP, kNT = kBK / 8;
  constexpr int kSG = 2;   // k8 steps of S summed on the tensor cores
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_hi =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* bufs = q_hi + kKP * L::kQPanel;

  const int tid = threadIdx.x, wg = tid / 128;
  const int w = (tid % 128) / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int bh = h0 + blockIdx.y;   // see for_head_chunks
  const int kvh = (bh / H) * (H / G) + (bh % H) / G;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const T* qp = q + (size_t)bh * Tq * D;
  const uintptr_t a4 = 4 * sizeof(T);
  const bool vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(q) % a4 == 0;
  const uint8_t* tiles =
      img + (size_t)kvh * ((Tk + kBK - 1) / kBK) * L::kBuf;
  auto copy_tile = [&](int kt, uint8_t* dst) {   // tile kt's image
    const uint8_t* src = tiles + (size_t)kt * L::kBuf;
    for (int i = 16 * tid; i < L::kBuf; i += 16 * L::kThreads)
      cp_async16(dst + i, src + i);
    cp_commit();
  };

  int n_kt = (Tk + kBK - 1) / kBK;
  if (causal) n_kt = min(n_kt, (min(q0 + kBQ, Tq) - 1) / kBK + 1);

  // q_hi of the tile into its panels; q_lo into each thread's A fragments
  for (int e = tid; e < kBQ * kD / 4; e += L::kThreads) {
    int r, c;
    uint32_t off;
    panel_chunk<kBQ>(e, r, c, off);
    const float4 x = q0 + r < Tq ? load4(qp + (size_t)(q0 + r) * D, c, D, vec)
                                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    *reinterpret_cast<uint4*>(q_hi + off) =
        make_uint4(to_tf32(x.x * scale), to_tf32(x.y * scale),
                   to_tf32(x.z * scale), to_tf32(x.w * scale));
  }
  const int r0 = q0 + 64 * wg + 16 * w + g;   // the thread's rows r0, r0 + 8
  uint32_t q_lo[kKP][4];
#pragma unroll
  for (int kk = 0; kk < kKP; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {   // a0 (g, t) a1 (g+8, t) a2 (g, t+4) a3
      const int row = r0 + 8 * (e & 1), col = 8 * kk + t + 4 * (e >> 1);
      const float x = row < Tq && col < D
                          ? to_f32(qp[(size_t)row * D + col]) * scale
                          : 0.0f;
      uint32_t hi;
      split(x, hi, q_lo[kk][e]);
    }

  if (n_kt > 0) copy_tile(0, bufs);
  cp_wait_all();
  fence_async_smem();
  __syncthreads();

  const int wrow0 = q0 + 64 * wg;              // the warpgroup's first row
  const uint32_t qa_s = smem_u32(q_hi) + wg * 64 * 32;
  float o[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) o[i] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  uint32_t p_hi[kNT][4], p_lo[kNT][4];
  float pvt[kD / 2], corr[2];   // the tile's P.V; O's factor

  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt) copy_tile(kt + 1, bufs + ((kt + 1) & 1) * L::kBuf);
    const int k0 = kt * kBK;
    uint8_t* buf = bufs + (kt & 1) * L::kBuf;
    {
      const uint32_t kh = smem_u32(buf), kl = kh + L::kKPart;
      // S: each kSG k8 steps' passes from a fresh accumulator st, added
      // into s on the CUDA cores
      float s[kBK / 2];
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) s[i] = 0.0f;
#pragma unroll
      for (int k1 = 0; k1 < kKP; k1 += kSG) {
        float st[kBK / 2];
        pin(st);
        wg_fence();
#pragma unroll
        for (int kk = k1; kk < k1 + kSG && kk < kKP; ++kk) {
          const uint64_t dq = sw32_desc(qa_s + kk * L::kQPanel);
          const uint32_t ko = kk * L::kKPanel;
          wgmma_m64n32k8(st, q_lo[kk], sw32_desc(kh + ko), kk > k1);
          wgmma_m64n32k8(st, dq, sw32_desc(kl + ko), 1);
          wgmma_m64n32k8(st, dq, sw32_desc(kh + ko), 1);
        }
        wg_commit();
        wg_wait<0>();
        pin(st);
#pragma unroll
        for (int i = 0; i < kBK / 2; ++i) s[i] += st[i];
      }

      softmax_tile<kNT>(s, m, l, corr, r0, k0, t, Tk, causal,
                        k0 + kBK > Tk || (causal && k0 + kBK - 1 > wrow0));
      // P's A fragment of key step j: a0 (g, key 2t), a1 (g+8, 2t), a2 (g,
      // 2t+1), a3 (g+8, 2t+1) = s[4j + {0, 2, 1, 3}]
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        split(s[4 * j], p_hi[j][0], p_lo[j][0]);
        split(s[4 * j + 2], p_hi[j][1], p_lo[j][1]);
        split(s[4 * j + 1], p_hi[j][2], p_lo[j][2]);
        split(s[4 * j + 3], p_hi[j][3], p_lo[j][3]);
      }
      const uint32_t vh = kl + L::kKPart, vl = vh + L::kVPart;
      pin(pvt);
      wg_fence();
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        pv_mma<kD>(pvt, p_lo[j], sw32_desc(vh + j * L::kVPanel), j > 0);
        pv_mma<kD>(pvt, p_hi[j], sw32_desc(vl + j * L::kVPanel));
        pv_mma<kD>(pvt, p_hi[j], sw32_desc(vh + j * L::kVPanel));
      }
      wg_commit();
    }
    wg_wait<0>();
    pin(pvt);
#pragma unroll
    for (int i = 0; i < kD / 8; ++i) {   // O = O corr + P.V, rounded once
      o[4 * i] = fmaf(o[4 * i], corr[0], pvt[4 * i]);
      o[4 * i + 1] = fmaf(o[4 * i + 1], corr[0], pvt[4 * i + 1]);
      o[4 * i + 2] = fmaf(o[4 * i + 2], corr[1], pvt[4 * i + 2]);
      o[4 * i + 3] = fmaf(o[4 * i + 3], corr[1], pvt[4 * i + 3]);
    }
    pin(p_hi);
    pin(p_lo);
    cp_wait_all();
    fence_async_smem();
    __syncthreads();   // the next tile is in; this one is free
  }
  write_rows<T, kD / 8>(out + (size_t)bh * Tq * D, o, l, r0, t, Tq, D);
}

// ---- D = 256: both products on mma.sync -------------------------------------

template <int kD>
struct MmaLayout {
  static constexpr int kBQ = 64, kBK = 16;
  static constexpr int kThreads = 2 * kBQ;       // a warp per 16 q rows
  static constexpr int kQS = kD + 8;             // floats
  static constexpr int kKS = kD / 2 + 4;         // 16-byte units, 4 mod 8
  static constexpr int kVS = kD + 2;             // 16-byte units, 2 mod 8
  static constexpr int kK = kBK * kKS, kV = kBK / 2 * kVS;   // units
  static constexpr int kSmem = kBQ * kQS * 4 + 2 * (kK + kV) * 16;
  static constexpr int kKC = (kBK * kD / 4 + kThreads - 1) / kThreads;
  static constexpr int kVC = (kBK / 2 * kD / 4 + kThreads - 1) / kThreads;
};

__device__ __forceinline__ uint4 quad(float a, float b) {
  uint4 u;
  split(a, u.x, u.z);
  split(b, u.y, u.w);
  return u;
}

// One kv tile's raw values in a thread's registers.
template <int kD>
struct MmaRegs {
  float4 k[MmaLayout<kD>::kKC];
  float4 v[MmaLayout<kD>::kVC][2];
};

template <typename T, int kD>
__device__ __forceinline__ void mma_load_kv(MmaRegs<kD>& r, const T* kp,
                                            const T* vp, int k0, int Tk,
                                            int D, bool vec) {
  using L = MmaLayout<kD>;
  constexpr int kC = kD / 4;
#pragma unroll
  for (int i = 0; i < L::kKC; ++i) {
    const int e = threadIdx.x + i * L::kThreads;
    const int key = k0 + e / kC, c = 4 * (e % kC);
    r.k[i] = e < L::kBK * kC && key < Tk
                 ? load4(kp + (size_t)key * D, c, D, vec)
                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
#pragma unroll
  for (int i = 0; i < L::kVC; ++i) {
    const int e = threadIdx.x + i * L::kThreads;
    const int key = k0 + 2 * (e / kC), c = 4 * (e % kC);
    const bool in = e < L::kBK / 2 * kC;
    r.v[i][0] = in && key < Tk ? load4(vp + (size_t)key * D, c, D, vec)
                               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    r.v[i][1] = in && key + 1 < Tk
                    ? load4(vp + (size_t)(key + 1) * D, c, D, vec)
                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

template <int kD>
__device__ __forceinline__ void mma_store_kv(const MmaRegs<kD>& r,
                                             uint4* kb, uint4* vb) {
  using L = MmaLayout<kD>;
  constexpr int kC = kD / 4;
#pragma unroll
  for (int i = 0; i < L::kKC; ++i) {
    const int e = threadIdx.x + i * L::kThreads;
    if (e < L::kBK * kC) {
      uint4* dst = kb + (e / kC) * L::kKS + 2 * (e % kC);
      dst[0] = quad(r.k[i].x, r.k[i].y);
      dst[1] = quad(r.k[i].z, r.k[i].w);
    }
  }
#pragma unroll
  for (int i = 0; i < L::kVC; ++i) {
    const int e = threadIdx.x + i * L::kThreads;
    if (e < L::kBK / 2 * kC) {
      uint4* dst = vb + (e / kC) * L::kVS + 4 * (e % kC);
      const float4 a = r.v[i][0], b = r.v[i][1];
      dst[0] = quad(a.x, b.x);
      dst[1] = quad(a.y, b.y);
      dst[2] = quad(a.z, b.z);
      dst[3] = quad(a.w, b.w);
    }
  }
}

template <typename T, int kD>
__global__ void __launch_bounds__(MmaLayout<kD>::kThreads, 1)
flash_attention_mma(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ out, int H,
                    int G, int Tq, int Tk, int D, int causal, float scale,
                    int h0) {
  using L = MmaLayout<kD>;
  constexpr int kBQ = L::kBQ, kBK = L::kBK, kThreads = L::kThreads;
  constexpr int kQS = L::kQS, kKS = L::kKS, kVS = L::kVS;
  constexpr int kNT = kBK / 8;   // key tiles of 8 in a kv tile
  constexpr int kDT = kD / 8;    // dimension tiles of 8
  constexpr int kSG = 2;         // k8 steps of S summed on the tensor cores
  constexpr int kDG = 2;         // dimension tiles of P V issued together
  extern __shared__ uint4 smem[];
  float* qs = reinterpret_cast<float*>(smem);              // [kBQ][kQS]
  uint4* ks = smem + kBQ * kQS / 4;                        // [2][kK]
  uint4* vs = ks + 2 * L::kK;                              // [2][kV]

  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = h0 + blockIdx.y;   // see for_head_chunks
  const int kvh = (bh / H) * (H / G) + (bh % H) / G;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const T* qp = q + (size_t)bh * Tq * D;
  const T* kp = k + (size_t)kvh * Tk * D;
  const T* vp = v + (size_t)kvh * Tk * D;
  const uintptr_t align = 4 * sizeof(T);
  const bool vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(q) % align == 0 &&
                   reinterpret_cast<uintptr_t>(k) % align == 0 &&
                   reinterpret_cast<uintptr_t>(v) % align == 0;

  int n_kt = (Tk + kBK - 1) / kBK;
  if (causal) n_kt = min(n_kt, (min(q0 + kBQ, Tq) - 1) / kBK + 1);

  // the q tile, scaled as it is loaded
  for (int e = threadIdx.x; e < kBQ * kD / 4; e += kThreads) {
    const int r = e / (kD / 4), c = 4 * (e % (kD / 4));
    float4 x = q0 + r < Tq ? load4(qp + (size_t)(q0 + r) * D, c, D, vec)
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    x.x *= scale;
    x.y *= scale;
    x.z *= scale;
    x.w *= scale;
    *reinterpret_cast<float4*>(qs + r * kQS + c) = x;
  }
  MmaRegs<kD> regs;
  if (n_kt > 0) {
    mma_load_kv<T, kD>(regs, kp, vp, 0, Tk, D, vec);
    mma_store_kv<kD>(regs, ks, vs);
  }
  __syncthreads();

  const int lr = 16 * w + g;               // the thread's rows lr, lr + 8
  const int ra = q0 + lr;
  const int wrow0 = q0 + 16 * w;           // the warp's first row
  float o[4 * kDT];
#pragma unroll
  for (int i = 0; i < 4 * kDT; ++i) o[i] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};

  for (int kt = 0; kt < n_kt; ++kt) {
    const bool more = kt + 1 < n_kt;
    if (more) mma_load_kv<T, kD>(regs, kp, vp, (kt + 1) * kBK, Tk, D, vec);
    const int k0 = kt * kBK;
    if (!(causal && k0 > wrow0 + 15)) {
      const uint4* kb = ks + (kt & 1) * L::kK;
      const uint4* vb = vs + (kt & 1) * L::kV;

      // S = (q scale) K^T: each kSG k8 steps' passes from a fresh
      // accumulator st, added into s on the CUDA cores
      float s[4 * kNT];
#pragma unroll
      for (int i = 0; i < 4 * kNT; ++i) s[i] = 0.0f;
#pragma unroll 2
      for (int k1 = 0; k1 < kDT; k1 += kSG) {
        float st[4 * kNT];
#pragma unroll
        for (int i = 0; i < 4 * kNT; ++i) st[i] = 0.0f;
#pragma unroll
        for (int kk = k1; kk < k1 + kSG; ++kk) {
          const float2 qa = *reinterpret_cast<const float2*>(
              qs + lr * kQS + 8 * kk + 2 * t);
          const float2 qb = *reinterpret_cast<const float2*>(
              qs + (lr + 8) * kQS + 8 * kk + 2 * t);
          uint32_t a_hi[4], a_lo[4];
          split(qa.x, a_hi[0], a_lo[0]);
          split(qb.x, a_hi[1], a_lo[1]);
          split(qa.y, a_hi[2], a_lo[2]);
          split(qb.y, a_hi[3], a_lo[3]);
          uint4 f[kNT];
#pragma unroll
          for (int j = 0; j < kNT; ++j)
            f[j] = kb[(8 * j + g) * kKS + 4 * kk + t];
          mma3_m16n8k8<kNT>(st, a_hi, a_lo, f);
        }
#pragma unroll
        for (int i = 0; i < 4 * kNT; ++i) s[i] += st[i];
      }

      float corr[2];
      softmax_tile<kNT>(s, m, l, corr, ra, k0, t, Tk, causal,
                        k0 + kBK > Tk || (causal && k0 + kBK - 1 > wrow0));

      // O = O corr + P V: the kv tile's P V from a fresh accumulator pv,
      // kDG dimension tiles at a time, added on the CUDA cores. s[4j..] is
      // the A fragment of key tile j as it stands (k index t = key 8j +
      // 2t, t + 4 = key 8j + 2t + 1)
      uint32_t p_hi[kNT][4], p_lo[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        split(s[4 * j], p_hi[j][0], p_lo[j][0]);
        split(s[4 * j + 2], p_hi[j][1], p_lo[j][1]);
        split(s[4 * j + 1], p_hi[j][2], p_lo[j][2]);
        split(s[4 * j + 3], p_hi[j][3], p_lo[j][3]);
      }
#pragma unroll
      for (int i0 = 0; i0 < kDT; i0 += kDG) {
        float pv[4 * kDG];
#pragma unroll
        for (int e = 0; e < 4 * kDG; ++e) pv[e] = 0.0f;
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          uint4 f[kDG];
#pragma unroll
          for (int u = 0; u < kDG; ++u)
            f[u] = vb[(4 * j + t) * kVS + g + 8 * (i0 + u)];
          mma3_m16n8k8<kDG>(pv, p_hi[j], p_lo[j], f);
        }
#pragma unroll
        for (int e = 0; e < 4 * kDG; ++e) {
          const int i = 4 * i0 + e;   // o[i]: row r + 8 (e % 4 / 2)
          o[i] = fmaf(o[i], corr[(e & 3) >> 1], pv[e]);
        }
      }
    }
    if (more)
      mma_store_kv<kD>(regs, ks + ((kt + 1) & 1) * L::kK,
                       vs + ((kt + 1) & 1) * L::kV);
    __syncthreads();   // the next tile is in; this one is free
  }
  write_rows<T, kDT>(out + (size_t)bh * Tq * D, o, l, ra, t, Tq, D);
}

// Launches over `heads` heads in chunks of at most 65535, the cap of grid
// y, which holds the head (h0 + blockIdx.y): launch(h0, heads in the
// chunk) enqueues one chunk. Up to 65535 heads take one launch, as a grid
// of (q tiles, B * H) did; each further 65535 take one more. The kernels
// only add h0, so their registers stay as they were.
template <typename F>
int for_head_chunks(int heads, F&& launch) {
  constexpr int kMaxY = 65535;
  for (int h0 = 0; h0 < heads; h0 += kMaxY) {
    launch(h0, heads - h0 < kMaxY ? heads - h0 : kMaxY);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

template <int kD>
size_t image_bytes(int B, int Hkv, int Tk) {
  using L = WgLayout<kD>;
  return (size_t)B * Hkv * ((Tk + L::kBK - 1) / L::kBK) * L::kBuf;
}

template <typename T, int kD>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 void* img, int B, int H, int Hkv, int Tq, int Tk, int D,
                 int causal, float scale, cudaStream_t stream) {
  using L = WgLayout<kD>;
  const int n_tiles = (Tk + L::kBK - 1) / L::kBK;
  if (n_tiles > 0) {
    const int rc = for_head_chunks(B * Hkv, [&](int h0, int n) {
      kv_split<T, kD><<<dim3(n_tiles, n), L::kThreads, 0, stream>>>(
          static_cast<const T*>(k), static_cast<const T*>(v),
          static_cast<uint8_t*>(img), Tk, D, h0);
    });
    if (rc != 0) return rc;
  }
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_wgmma<T, kD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qt = (Tq + L::kBQ - 1) / L::kBQ;
  return for_head_chunks(B * H, [&](int h0, int n) {
    flash_attention_wgmma<T, kD><<<dim3(n_qt, n), L::kThreads, L::kSmem,
                                   stream>>>(
        static_cast<const T*>(q), static_cast<const uint8_t*>(img),
        static_cast<T*>(out), H, H / Hkv, Tq, Tk, D, causal, scale, h0);
  });
}

template <typename T>
int launch_mma(const void* q, const void* k, const void* v, void* out, int B,
               int H, int Hkv, int Tq, int Tk, int D, int causal, float scale,
               cudaStream_t stream) {
  using L = MmaLayout<256>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_mma<T, 256>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qt = (Tq + L::kBQ - 1) / L::kBQ;
  return for_head_chunks(B * H, [&](int h0, int n) {
    flash_attention_mma<T, 256><<<dim3(n_qt, n), L::kThreads, L::kSmem,
                                  stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out), H, H / Hkv, Tq, Tk,
        D, causal, scale, h0);
  });
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* out,
             void* img, int B, int H, int Hkv, int Tq, int Tk, int D,
             int causal, float scale, cudaStream_t s) {
  if (D <= 32) return launch_wgmma<T, 32>(q, k, v, out, img, B, H, Hkv, Tq, Tk, D, causal, scale, s);
  if (D <= 64) return launch_wgmma<T, 64>(q, k, v, out, img, B, H, Hkv, Tq, Tk, D, causal, scale, s);
  if (D <= 128) return launch_wgmma<T, 128>(q, k, v, out, img, B, H, Hkv, Tq, Tk, D, causal, scale, s);
  if (D <= 256) return launch_mma<T>(q, k, v, out, B, H, Hkv, Tq, Tk, D, causal, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Bytes of scratch that flash_attention_f32 needs for these shapes: the
// split kv tiles' images at D <= 128, none above.
extern "C" long long flash_attention_f32_scratch(int B, int Hkv, int Tk,
                                                 int D) {
  if (D <= 32) return static_cast<long long>(image_bytes<32>(B, Hkv, Tk));
  if (D <= 64) return static_cast<long long>(image_bytes<64>(B, Hkv, Tk));
  if (D <= 128) return static_cast<long long>(image_bytes<128>(B, Hkv, Tk));
  return 0;
}

// bf16: 0 if q, k, v and out are f32, 1 if all are bf16. scratch: at least
// flash_attention_f32_scratch(B, Hkv, Tk, D) bytes, 16-byte aligned.
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v,
                                   void* out, void* scratch, int B, int H,
                                   int Hkv, int Tq, int Tk, int D, int causal,
                                   int bf16, float scale, int device,
                                   void* stream) {
  if (B == 0 || H == 0 || Tq == 0) return 0;
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_d<__nv_bfloat16>(q, k, v, out, scratch, B, H, Hkv, Tq,
                                        Tk, D, causal, scale, s)
              : launch_d<float>(q, k, v, out, scratch, B, H, Hkv, Tq, Tk, D,
                                causal, scale, s);
}
