// The fused 2D-RoPE attention core for Hopper (sm_90a): tile loaders,
// mma.sync helpers, the bf16 tensor-core kernel and the fp32 FMA kernel.
// `fused_attention.cu` instantiates it with the exact softmax and the
// softmax variants, `attention_floor.cu` with the floors' codes. What each
// kernel serves: this core, G = 1, 2 or 4 heads a block (the wrapper runs a
// call's G at the largest of those dividing it), takes fp32, d < 64 (the
// softmax variants too), and with core="mma" the bf16 d = 64 calls, the
// softmax variants and row 3's five floors (attention_floor.cu: the
// baseline of the sm90 kernel's). fused_attention_sm90.cu (TMA + wgmma)
// takes bf16 d = 64 at any G dividing the heads, exact, as the softmax
// variants or as row 3's five floors, and shares this header's Args,
// make_args, Softmax codes and bf16 packing and exp2 helpers.
//
// Per (batch, head):  O = softmax((R_q q)(R_k k)^T * d^-1/2) v
// RoPE in fp32 (head dim halves [y | x], rotate-half within each half), q
// scaled before rounding back to the input type, matmul operands in the
// input type with fp32 accumulation, P rounded to the input type before
// P.v, the output divided by the fp32 row sum of P.
//
// What bounds it on an H100: at DUSt3R's sizes (N <= ~1200 tokens, d = 64)
// the two products are 4*N*N*d FLOPs against 4*N*d input/output elements,
// about N/2 FLOPs per byte in bf16 (384 at N = 768), above the card's
// ~295 FLOP/byte ridge: the bf16 tensor-core rate is the bound, and the
// (N, N) logits must never reach device memory. The design:
//   * one block per (batch entry, group of G heads, 64-row query tile),
//     four warps of 16 query rows for each of the G heads (G = 1, 2, 4: 128
//     threads a head, so G = 8 would take 1024 threads at 64 registers);
//   * K and V streamed through shared memory in 64-key tiles with 16-byte
//     loads, RoPE applied to Q and to each K tile as it is loaded (the
//     tables are precomputed in fp32 by the wrapper, as the JAX version
//     builds them outside pallas_call); a thread loads a (row, 8-column)
//     unit of the cos/sin tables once and rotates that unit of all G heads
//     with it, so a block reads the tables once for its G heads;
//   * q.k^T and P.v on bf16 tensor cores with mma.sync m16n8k16, the logits
//     tile of a warp (16 x 64) living in registers, the P fragments reused
//     in registers as the A operand of P.v, V's B fragments read transposed
//     from its row-major tile by ldmatrix;
//   * an online softmax in fp32 (running max and row sum per query row);
//   * the ragged last query and key tiles masked (672 and 196 tokens are
//     not multiples of 64).
// Addressing is strided: q, k, v and o are (B, H, N, d) views with unit
// stride in d and their own batch, head and row strides (in elements), so
// the kernel reads the heads straight out of a (B, N, 3C) qkv projection
// or (B, N, C) projections and writes (B, N, C) -- the head gathers that
// the TPU experiments (scripts/exp_attn_dma_r2.py, exp_attn_layout_r2.py)
// did with BlockSpec index maps. The RoPE tables are (B, N, d) fp32.
// The heads of a block share nothing but the tables and the barriers:
// each head's arithmetic is the same for every G and every stride, so the
// results are bit-identical.
// fp32 inputs take a plain FMA kernel of the same structure (one thread per
// query row, one head per block for any G); it is for parity checks.
// Not carried over from the TPU design: the whole (N, N) tile in VMEM and
// the ones-column row-sum fold (it got the sum out of the MXU; here the
// sum is an fp32 register add of the unrounded P).
//
// A kernel launches on the caller's stream, allocates nothing and does not
// synchronise; a launcher returns cudaGetLastError() after the launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "device_attr.cuh"

namespace attn {

constexpr int kRowsPerBlock = 64;  // query rows of each head in a block
constexpr int kKeysPerTile = 64;   // keys per shared-memory tile
constexpr int kWarpsPerHead = kRowsPerBlock / 16;
constexpr int kThreadsPerHead = kWarpsPerHead * 32;
constexpr int kF32Chunk = 16;      // keys scored at a time by the fp32 kernel
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kRowsPerBlock == kKeysPerTile, "one tile loader serves Q, K and V");

// How P is made from a logits tile s (fp32 from the mma):
//   kExact      p = exp(s - running max), in fp32 (TPU row 1);
//   kNoMax      p = exp(s), no max and no rescale: overflows where a logit
//               passes ~88 (row 9's safe=False);
//   kBf16Logits s rounded to bf16, then as kBf16Exp (row 4's kern_bf16s,
//               whose softmax after the mma is all bf16);
//   kBf16Exp    p = 2^bf16((s - max) log2 e) on bf16x2 pairs (one
//               ex2.approx.ftz.bf16x2 a pair), P already bf16 (row 4's
//               kern_bf16exp).
// The row sum is always the fp32 sum of P as the exp made it. Two floors
// of row 3 (scripts/exp_attn_r2.py) make no softmax at all:
//   kNoSoftmax  P = bf16(s): no max, no exp, no row sum, no divide
//               (`nosmax`; not kNoMax, which keeps the exp and the sum);
//   kQkOnly     no P.v: the output is the fp32 logits of key tile 0
//               (columns 0 .. D-1, as the script's s[:, :d]) rounded to
//               bf16 (`qkonly`); every tile's logits and a value of each V
//               tile are folded into a sink stored only when
//               Args::store_sink is set, so no q.k^T and no load is
//               compiled away.
// The copy floors of row 3 make no logits either; only
// fused_attention_sm90.cu takes their codes (attention_floor.cu keeps
// its own Floor codes, the wrapper's MODES order):
//   kFloorCopy    bf16(rope(q) + v), q unscaled (`copy`);
//   kFloorCopyNr  bf16(q + v) (`copynr`);
//   kFloorCopyMm  bf16(q cos + (q P) sin + v), P the signed permutation
//                 with t P = rotate-half(t) (`copymm`).
enum Softmax : int {
  kExact = 0, kNoMax = 1, kBf16Logits = 2, kBf16Exp = 3, kNoSoftmax = 4, kQkOnly = 5,
  kFloorCopy = 6, kFloorCopyNr = 7, kFloorCopyMm = 8
};

// Element (b, h, n, c) of a view lies at b * b + h * h + n * n + c. Head
// and row strides are 32-bit (the wrapper checks that one batch entry's
// offsets fit), so the addresses in the key loop cost no 64-bit registers.
struct Strides {
  long long b;
  int h, n;
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* cos_q;  // (B, nq, d) fp32, or null without RoPE
  const float* sin_q;
  const float* cos_k;  // (B, nk, d)
  const float* sin_k;
  void* o;
  Strides sq, sk, sv, so;
  int heads, nq, nk;
  float scale;
  int use_rope;
  int store_sink;  // nonzero: a floor kernel stores its sink (the wrappers pass 0)
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// Element c of a RoPE-rotated row of length D, in fp32.
template <int D, typename T>
__device__ __forceinline__ float rope_elem(const T* row, const float* cos_row,
                                           const float* sin_row, int c) {
  constexpr int kHalf = D / 2;
  constexpr int kQuarter = D / 4;
  const int base = c < kHalf ? 0 : kHalf;
  const int cc = c - base;
  const float partner = cc < kQuarter ? -to_f32(row[base + cc + kQuarter])
                                      : to_f32(row[base + cc - kQuarter]);
  return to_f32(row[c]) * cos_row[c] + partner * sin_row[c];
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return bits(__floats2bfloat162_rn(lo, hi));
}

// 2^x of a bf16 pair in one instruction (sm_90's bf16x2 ex2; cuda_bf16.h's
// h2exp2 goes through fp32 there)
__device__ __forceinline__ uint32_t exp2_bf16x2(uint32_t x) {
  uint32_t y;
  asm("ex2.approx.ftz.bf16x2 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// 8 bf16 <-> 8 fp32, through one 16-byte load or store
__device__ __forceinline__ void unpack8(uint4 u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  return make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]), pack_bf16(f[4], f[5]),
                    pack_bf16(f[6], f[7]));
}

__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// acc (16x8 fp32) += a (16x16 bf16, row-major) * b (16x8 bf16, col-major)
__device__ __forceinline__ void mma_bf16(float (&acc)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The B fragment (b0, b1) of mma m16n8k16 from a row-major (16 k-rows,
// 8 n-columns) bf16 tile in shared memory: lane i < 16 passes the address
// of k-row i (lanes 16-31 repeat them), and .trans hands each lane the
// k-pairs of its column.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& b0, uint32_t& b1,
                                                  const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b0), "=r"(b1)
               : "r"(addr)
               : "memory");
}

// Rows [row0, row0 + 64) of G heads' (n, D) bf16 matrices into G shared
// tiles kTile elements apart (row stride kStride): head h's rows start at
// src + h * head_stride, row r at + r * row_stride. Rotated by RoPE in
// fp32 when cos is not null, times scale, rounded to bf16. Rows past n
// and columns in [D, kDK) are zero.
template <int D, int kDK, int kStride, int G>
__device__ __forceinline__ void load_rope_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                               int head_stride, int row_stride,
                                               const float* cos, const float* sin,
                                               int row0, int n, float scale) {
  constexpr int kThreads = G * kThreadsPerHead;
  constexpr int kTile = kRowsPerBlock * kStride;
  constexpr int kHalf = D / 2;
  constexpr int kQuarter = D / 4;
  if constexpr (kQuarter % 8 == 0) {
    // 16-byte loads: a unit is 8 columns c0 of the first quarter of a half
    // and their rotate-half partners c1 = c0 + D/4. The tables repeat with
    // period D/4 within each half (rope_cos_sin concatenates the
    // frequencies twice), so cos[c1] == cos[c0] and sin[c1] == sin[c0].
    constexpr int kChunks = kQuarter / 8;
    constexpr int kUnits = 2 * kChunks;
    for (int i = threadIdx.x; i < kRowsPerBlock * kUnits; i += kThreads) {
      const int r = i / kUnits, u = i % kUnits;
      const int c0 = (u / kChunks) * kHalf + (u % kChunks) * 8;
      const int c1 = c0 + kQuarter;
      const int row = row0 + r;
      const bool rope = row < n && cos != nullptr;
      float cs[8], sn[8];
      if (rope) {  // once for the G heads
        load8(cos + (size_t)row * D + c0, cs);
        load8(sin + (size_t)row * D + c0, sn);
      }
#pragma unroll
      for (int h = 0; h < G; ++h) {
        float a[8] = {}, b[8] = {};
        if (row < n) {
          const __nv_bfloat16* s = src + h * head_stride + row * row_stride;
          unpack8(*reinterpret_cast<const uint4*>(s + c0), a);
          unpack8(*reinterpret_cast<const uint4*>(s + c1), b);
          if (rope) {
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const float x = a[j] * cs[j] + (-b[j]) * sn[j];
              const float y = b[j] * cs[j] + a[j] * sn[j];
              a[j] = x;
              b[j] = y;
            }
          }
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            a[j] *= scale;
            b[j] *= scale;
          }
        }
        *reinterpret_cast<uint4*>(dst + h * kTile + r * kStride + c0) = pack8(a);
        *reinterpret_cast<uint4*>(dst + h * kTile + r * kStride + c1) = pack8(b);
      }
    }
  } else {
    for (int i = threadIdx.x; i < kRowsPerBlock * kDK; i += kThreads) {
      const int r = i / kDK, c = i % kDK;
      const int row = row0 + r;
#pragma unroll
      for (int h = 0; h < G; ++h) {
        float val = 0.f;
        if (row < n && c < D) {
          const __nv_bfloat16* s = src + h * head_stride + row * row_stride;
          const size_t t = (size_t)row * D;
          val = cos != nullptr ? rope_elem<D>(s, cos + t, sin + t, c) : __bfloat162float(s[c]);
          val *= scale;
        }
        dst[h * kTile + r * kStride + c] = __float2bfloat16(val);
      }
    }
  }
}

// Rows [row0, row0 + 64) of G heads' (n, D) bf16 matrices copied into G
// shared tiles (row stride kStride) with 16-byte accesses; rows past n are
// zero. Strides as for load_rope_tile.
template <int D, int kStride, int G>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int head_stride, int row_stride,
                                          int row0, int n) {
  constexpr int kThreads = G * kThreadsPerHead;
  constexpr int kTile = kKeysPerTile * kStride;
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < kRowsPerBlock * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const int row = row0 + r;
#pragma unroll
    for (int h = 0; h < G; ++h) {
      uint4 val = make_uint4(0, 0, 0, 0);
      if (row < n) {
        val = *reinterpret_cast<const uint4*>(src + h * head_stride + row * row_stride + c);
      }
      *reinterpret_cast<uint4*>(dst + h * kTile + r * kStride + c) = val;
    }
  }
}

template <int D>
struct Tiles {
  static constexpr int kDK = (D + 15) / 16 * 16;  // q.k^T depth, zero-padded to the mma k
  static constexpr int kStride = kDK + 8;         // row strides padded by 16 bytes so that
  static constexpr int kVStride = D + 8;          // fragment and ldmatrix rows hit 32 banks
  static constexpr int kKTile = kRowsPerBlock * kStride;
  static constexpr int kVTile = kKeysPerTile * kVStride;
  // dynamic shared memory of a block of G heads: G Q/K tiles (Q is loaded
  // into the K tiles, and read into registers before the first K tile),
  // G V tiles
  static constexpr size_t smem_bytes(int G) {
    return (size_t)G * (kKTile + kVTile) * sizeof(__nv_bfloat16);
  }
};

// At most 128 registers a thread for every G (4 / G blocks of 128 * G
// threads on an SM): 16 warps an SM, enough to hide the mma latency.
template <int D, int G, int S>
__global__ void __launch_bounds__(G * kThreadsPerHead, 4 / G)
attn_bf16_kernel(const Args args) {
  using T = Tiles<D>;
  constexpr int kDK = T::kDK;
  constexpr int kStride = T::kStride;
  constexpr int kVStride = T::kVStride;
  constexpr int kNT = kKeysPerTile / 8;  // 8-key column tiles of the logits
  constexpr int kDT = D / 8;             // 8-wide column tiles of the output
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);  // G tiles: Q, then K
  __nv_bfloat16* vs = ks + G * T::kKTile;                      // G tiles, row-major

  const int nq = args.nq, nk = args.nk;
  const int groups = args.heads / G;
  const int b = blockIdx.y / groups;
  const int h0 = (blockIdx.y % groups) * G;  // the block's first head
  const int q0 = blockIdx.x * kRowsPerBlock;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;  // fragment row group
  const int t = lane % 4;  // thread within the group
  const int hw = warp / kWarpsPerHead;          // this warp's head in the block
  const int wr = (warp % kWarpsPerHead) * 16;   // and its 16 rows of the tile

  const __nv_bfloat16* qb =
      static_cast<const __nv_bfloat16*>(args.q) + b * args.sq.b + h0 * args.sq.h;
  const __nv_bfloat16* kb =
      static_cast<const __nv_bfloat16*>(args.k) + b * args.sk.b + h0 * args.sk.h;
  const __nv_bfloat16* vb =
      static_cast<const __nv_bfloat16*>(args.v) + b * args.sv.b + h0 * args.sv.h;
  const float* cos_q = args.use_rope ? args.cos_q + (size_t)b * nq * D : nullptr;
  const float* sin_q = args.use_rope ? args.sin_q + (size_t)b * nq * D : nullptr;
  const float* cos_k = args.use_rope ? args.cos_k + (size_t)b * nk * D : nullptr;
  const float* sin_k = args.use_rope ? args.sin_k + (size_t)b * nk * D : nullptr;

  // Q tiles: RoPE in fp32, scaled, rounded to bf16 (as the TPU kernel does)
  load_rope_tile<D, kDK, kStride, G>(ks, qb, args.sq.h, args.sq.n, cos_q, sin_q, q0, nq,
                                     args.scale);
  __syncthreads();

  uint32_t qa[kDK / 16][4];
  {
    const __nv_bfloat16* qs = ks + hw * T::kKTile;
#pragma unroll
    for (int kc = 0; kc < kDK / 16; ++kc) {
      const __nv_bfloat16* base = qs + (wr + g) * kStride + kc * 16 + 2 * t;
      qa[kc][0] = ld_u32(base);
      qa[kc][1] = ld_u32(base + 8 * kStride);
      qa[kc][2] = ld_u32(base + 8);
      qa[kc][3] = ld_u32(base + 8 * kStride + 8);
    }
  }
  const __nv_bfloat16* kt = ks + hw * T::kKTile;
  const __nv_bfloat16* vt = vs + hw * T::kVTile;

  float oacc[kDT][4];
#pragma unroll
  for (int n = 0; n < kDT; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows g and g + 8
  float l0 = 0.f, l1 = 0.f;              // this thread's share of the row sums
  [[maybe_unused]] uint32_t sink = 0;    // kQkOnly's fold of the work it discards

  for (int k0 = 0; k0 < nk; k0 += kKeysPerTile) {
    __syncthreads();  // the Q fragments are read / the previous tile is consumed
    load_rope_tile<D, kDK, kStride, G>(ks, kb, args.sk.h, args.sk.n, cos_k, sin_k, k0, nk,
                                       1.f);
    load_tile<D, kVStride, G>(vs, vb, args.sv.h, args.sv.n, k0, nk);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys
    float s[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < kDK / 16; ++kc) {
        const __nv_bfloat16* base = kt + (n * 8 + g) * kStride + kc * 16 + 2 * t;
        mma_bf16(s[n], qa[kc], ld_u32(base), ld_u32(base + 8));
      }
    }
    if constexpr (S == kBf16Logits) {
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[n][j] = __bfloat162float(__float2bfloat16(s[n][j]));
      }
    }
    if constexpr (S == kQkOnly) {
      static_assert(kDT <= kNT, "the output's D columns lie in key tile 0");
      if (k0 == 0) {
#pragma unroll
        for (int n = 0; n < kDT; ++n) {
#pragma unroll
          for (int j = 0; j < 4; ++j) oacc[n][j] = s[n][j];
        }
      }
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
#pragma unroll
        for (int j = 0; j < 4; ++j) sink ^= __float_as_uint(s[n][j]);
      }
      sink ^= ld_u32(vt + (wr + g) * kVStride + 2 * t);
      continue;
    }
    const int valid = nk - k0;
    // kNoSoftmax: the zero K rows past nk give logits of 0, so P = 0 there
    if (S != kNoSoftmax && valid < kKeysPerTile) {
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (n * 8 + 2 * t + (j & 1) >= valid) s[n][j] = -INFINITY;
        }
      }
    }

    // P, packed in bf16 pairs as the A operand of P.v (rows g and g + 8)
    uint32_t pp[kNT][2];
    if constexpr (S == kNoSoftmax) {
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        pp[n][0] = pack_bf16(s[n][0], s[n][1]);
        pp[n][1] = pack_bf16(s[n][2], s[n][3]);
      }
    } else if constexpr (S == kNoMax) {
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[n][j] = __expf(s[n][j]);
        l0 += s[n][0] + s[n][1];
        l1 += s[n][2] + s[n][3];
        pp[n][0] = pack_bf16(s[n][0], s[n][1]);
        pp[n][1] = pack_bf16(s[n][2], s[n][3]);
      }
    } else {
      // online softmax: the four threads of a group share rows g and g + 8
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
        mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
      }
#pragma unroll
      for (int sh = 1; sh <= 2; sh *= 2) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, sh));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, sh));
      }
      const float corr0 = __expf(m0 - mx0);
      const float corr1 = __expf(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      l0 *= corr0;
      l1 *= corr1;
#pragma unroll
      for (int n = 0; n < kDT; ++n) {
        oacc[n][0] *= corr0;
        oacc[n][1] *= corr0;
        oacc[n][2] *= corr1;
        oacc[n][3] *= corr1;
      }
      if constexpr (S == kExact) {
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          s[n][0] = __expf(s[n][0] - m0);
          s[n][1] = __expf(s[n][1] - m0);
          s[n][2] = __expf(s[n][2] - m1);
          s[n][3] = __expf(s[n][3] - m1);
          l0 += s[n][0] + s[n][1];
          l1 += s[n][2] + s[n][3];
          pp[n][0] = pack_bf16(s[n][0], s[n][1]);
          pp[n][1] = pack_bf16(s[n][2], s[n][3]);
        }
      } else {  // kBf16Exp, kBf16Logits: bf16x2 exp2 of bf16((s - m) log2 e)
        const float nm0 = -m0 * kLog2e, nm1 = -m1 * kLog2e;
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          pp[n][0] = exp2_bf16x2(pack_bf16(fmaf(s[n][0], kLog2e, nm0),
                                           fmaf(s[n][1], kLog2e, nm0)));
          pp[n][1] = exp2_bf16x2(pack_bf16(fmaf(s[n][2], kLog2e, nm1),
                                           fmaf(s[n][3], kLog2e, nm1)));
          const float2 f01 = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&pp[n][0]));
          const float2 f23 = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&pp[n][1]));
          l0 += f01.x + f01.y;
          l1 += f23.x + f23.y;
        }
      }
    }

    // O += P V: the logits' accumulator layout is the A-operand layout; V's
    // B fragments come transposed out of its row-major tile
#pragma unroll
    for (int kc = 0; kc < kKeysPerTile / 16; ++kc) {
      const uint32_t pa[4] = {pp[2 * kc][0], pp[2 * kc][1], pp[2 * kc + 1][0],
                              pp[2 * kc + 1][1]};
#pragma unroll
      for (int n = 0; n < kDT; ++n) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, vt + (kc * 16 + (lane & 15)) * kVStride + n * 8);
        mma_bf16(oacc[n], pa, b0, b1);
      }
    }
  }

  if constexpr (S == kNoSoftmax || S == kQkOnly) {  // no row sum to divide by
    l0 = l1 = 1.f;
  } else {
#pragma unroll
    for (int sh = 1; sh <= 2; sh *= 2) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, sh);
      l1 += __shfl_xor_sync(0xffffffffu, l1, sh);
    }
  }
  __nv_bfloat16* ob =
      static_cast<__nv_bfloat16*>(args.o) + b * args.so.b + (h0 + hw) * args.so.h;
  if (S == kQkOnly && args.store_sink) *reinterpret_cast<uint32_t*>(ob) = sink;
  const int row0 = q0 + wr + g;
  const int row1 = row0 + 8;
#pragma unroll
  for (int n = 0; n < kDT; ++n) {
    const int col = n * 8 + 2 * t;
    if (row0 < nq) {
      *reinterpret_cast<__nv_bfloat162*>(ob + row0 * args.so.n + col) =
          __floats2bfloat162_rn(oacc[n][0] / l0, oacc[n][1] / l0);
    }
    if (row1 < nq) {
      *reinterpret_cast<__nv_bfloat162*>(ob + row1 * args.so.n + col) =
          __floats2bfloat162_rn(oacc[n][2] / l1, oacc[n][3] / l1);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kRowsPerBlock)
attn_f32_kernel(const Args args) {
  __shared__ float ks[kKeysPerTile][D];
  __shared__ float vs[kKeysPerTile][D];

  const int nq = args.nq, nk = args.nk;
  const int bh = blockIdx.y;
  const int b = bh / args.heads;
  const int h = bh % args.heads;
  const int tid = threadIdx.x;
  const int row = blockIdx.x * kRowsPerBlock + tid;
  const bool active = row < nq;

  const float* qb = static_cast<const float*>(args.q) + b * args.sq.b + h * args.sq.h;
  const float* kb = static_cast<const float*>(args.k) + b * args.sk.b + h * args.sk.h;
  const float* vb = static_cast<const float*>(args.v) + b * args.sv.b + h * args.sv.h;
  const size_t tq = (size_t)b * nq * D;
  const size_t tk = (size_t)b * nk * D;
  const bool use_rope = args.use_rope;

  float qr[D];
#pragma unroll
  for (int c = 0; c < D; ++c) {
    float val = 0.f;
    if (active) {
      const float* src = qb + row * args.sq.n;
      const size_t t = tq + (size_t)row * D;
      val = use_rope ? rope_elem<D>(src, args.cos_q + t, args.sin_q + t, c) : src[c];
    }
    qr[c] = val * args.scale;
  }
  float oacc[D];
#pragma unroll
  for (int c = 0; c < D; ++c) oacc[c] = 0.f;
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < nk; k0 += kKeysPerTile) {
    __syncthreads();
    for (int i = tid; i < kKeysPerTile * D; i += kRowsPerBlock) {
      const int r = i / D, c = i % D;
      const int key = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (key < nk) {
        const float* ksrc = kb + key * args.sk.n;
        const size_t t = tk + (size_t)key * D;
        kv = use_rope ? rope_elem<D>(ksrc, args.cos_k + t, args.sin_k + t, c) : ksrc[c];
        vv = vb[key * args.sv.n + c];
      }
      ks[r][c] = kv;
      vs[r][c] = vv;
    }
    __syncthreads();

    const int valid = min(kKeysPerTile, nk - k0);
    for (int j0 = 0; j0 < valid; j0 += kF32Chunk) {
      float s[kF32Chunk];
      float mx = m;
#pragma unroll
      for (int j = 0; j < kF32Chunk; ++j) {
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < D; ++c) dot = fmaf(qr[c], ks[j0 + j][c], dot);
        s[j] = j0 + j < valid ? dot : -INFINITY;
        mx = fmaxf(mx, s[j]);
      }
      const float corr = expf(m - mx);
      m = mx;
      l *= corr;
#pragma unroll
      for (int c = 0; c < D; ++c) oacc[c] *= corr;
#pragma unroll
      for (int j = 0; j < kF32Chunk; ++j) {
        const float p = expf(s[j] - m);
        l += p;
#pragma unroll
        for (int c = 0; c < D; ++c) oacc[c] = fmaf(p, vs[j0 + j][c], oacc[c]);
      }
    }
  }

  if (active) {
    float* orow = static_cast<float*>(args.o) + b * args.so.b + h * args.so.h + row * args.so.n;
#pragma unroll
    for (int c = 0; c < D; ++c) orow[c] = oacc[c] / l;
  }
}

// One launch of the bf16 kernel over `batch` entries, in groups of G heads.
template <int D, int G, int S>
int launch_bf16(const Args& a, int batch, cudaStream_t stream) {
  constexpr size_t kSmem = Tiles<D>::smem_bytes(G);
  if constexpr (kSmem > 48 * 1024) {  // above 48 KB only when asked for
    static devattr::SmemLimit limit;
    const cudaError_t attr =
        limit.raise_on_current_device(attn_bf16_kernel<D, G, S>, static_cast<int>(kSmem));
    if (attr != cudaSuccess) return static_cast<int>(attr);
  }
  const dim3 grid((a.nq + kRowsPerBlock - 1) / kRowsPerBlock, batch * (a.heads / G));
  attn_bf16_kernel<D, G, S><<<grid, G * kThreadsPerHead, kSmem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_f32(const Args& a, int batch, cudaStream_t stream) {
  const dim3 grid((a.nq + kRowsPerBlock - 1) / kRowsPerBlock, batch * a.heads);
  attn_f32_kernel<D><<<grid, kRowsPerBlock, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The kernel arguments from the C entry point's flat ones; strides holds
// the (batch, head, row) strides of q, k, v and o, 12 values in elements.
inline Args make_args(const void* q, const void* k, const void* v, const float* cos_q,
                      const float* sin_q, const float* cos_k, const float* sin_k, void* o,
                      const long long* strides, int heads, int nq, int nk, int use_rope,
                      float scale) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.cos_q = cos_q;
  a.sin_q = sin_q;
  a.cos_k = cos_k;
  a.sin_k = sin_k;
  a.o = o;
  Strides* s[4] = {&a.sq, &a.sk, &a.sv, &a.so};
  for (int i = 0; i < 4; ++i) {
    *s[i] = Strides{strides[3 * i], static_cast<int>(strides[3 * i + 1]),
                    static_cast<int>(strides[3 * i + 2])};
  }
  a.heads = heads;
  a.nq = nq;
  a.nk = nk;
  a.scale = scale;
  a.use_rope = use_rope;
  a.store_sink = 0;
  return a;
}

}  // namespace attn
