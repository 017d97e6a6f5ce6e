// The mma.sync implicit GEMM of conv3x3_taps_mma.cu (sm_90a): the mma.sync /
// ldmatrix helpers (dpt_tail.cu uses these too), the double-buffered tiles
// and the k-loop that accumulates one block's (128 output pixels x BN output
// columns) tile, generic over the loader of its A tile.
//
// Each k-step takes 32 rows of K: a 128 x 32 A slice (from the caller's
// loader: conv3x3_taps_mma.cu's loaders read bf16 x with the tap's shift and
// the zero halo applied in the load) and the matching 32 x BN slice of the
// packed bf16 B go through registers into a double-buffered shared-memory
// tile, so the global loads of step k+1 are in flight while the tensor cores
// work on step k. Four warps, 2 (pixels) x 2 (channels), each 64 x BN/2 of
// m16n8k16 tiles; A fragments by ldmatrix, B fragments by ldmatrix.trans,
// rows padded by 8 elements so the fragment loads hit distinct banks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace conv3x3_igemm {

constexpr int kBM = 128;            // output pixels per block
constexpr int kBK = 32;             // input channels per k-step (one tap)
constexpr int kThreads = 128;       // four warps: 2 (pixels) x 2 (channels)
constexpr int kMT = 4;              // 16-row mma tiles per warp (64 rows)
constexpr int kAStride = kBK + 8;   // bf16 per A row in shared memory (80 bytes)

// acc (16x8 fp32) += a (16x16 bf16, row-major) * b (16x8 bf16, col-major)
__device__ __forceinline__ void mma_bf16(float (&acc)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of a 16x16 tile: lane i passes row (i % 16), column
// 8 * (i / 16) of the tile.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// B fragments of two adjacent 8-column tiles of a row-major (16 k-rows,
// 16 n-columns) tile: lane i passes k-row (i % 16), column 8 * (i / 16);
// r[0], r[1] are the first tile's (b0, b1), r[2], r[3] the second's.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ uint2 to_bf16x4(float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  return u;
}

// The block's shared-memory tiles: A (pixels x channels) and B (channels x
// BN), double-buffered.
template <int BN>
struct Tiles {
  __nv_bfloat16 a[2][kBM][kAStride];
  __nv_bfloat16 b[2][kBK][BN + 8];
};

// The accumulators of one warp: kMT x (BN / 16) tiles of 16 x 8. Lane
// (g = lane / 4, t = lane % 4) holds rows g and g + 8, columns 2t and 2t + 1
// of each tile; the warp's tile (mt, nt) covers pixels
// m0 + warp_m * 64 + mt * 16 and channels n0 + warp_n * BN / 2 + nt * 8.
template <int BN>
using Acc = float[kMT][BN / 16][4];

// The k-loop of a block's (128 pixels x BN columns) tile, over nk k-steps
// of 32 rows of K each. The A tile (128 pixels x 32 K-rows, bf16) comes from
// `al`, which stages it in two steps so that its global loads overlap the
// products: al.load(kc) issues step kc's loads into registers, al.store(a)
// writes them to a shared (kBM x kAStride) tile. B is the packed bf16
// (K, ldb) matrix wp: step kc reads its rows [32 kc, 32 kc + 32), columns
// [n0, n0 + BN), by 16-byte loads. acc is zeroed here; returns after a
// __syncthreads(), so the caller may reuse the tiles.
template <int BN, class ALoader>
__device__ __forceinline__ void gemm_loop(ALoader& al, const __nv_bfloat16* __restrict__ wp,
                                          int ldb, int nk, int n0, Tiles<BN>& sm,
                                          Acc<BN>& acc) {
  constexpr int kWN = BN / 2;                      // channels per warp
  constexpr int kNT = kWN / 8;                     // 8-column mma tiles per warp
  constexpr int kBVecs = kBK * BN / 8 / kThreads;  // 16-byte B loads per thread
  static_assert(kNT % 2 == 0 && kBVecs >= 1 && kBK * BN % (8 * kThreads) == 0, "tile shape");

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warp_m = warp >> 1;
  const int warp_n = warp & 1;
  uint4 breg[kBVecs];

  auto load = [&](int kc) {
    al.load(kc);
#pragma unroll
    for (int i = 0; i < kBVecs; ++i) {
      const int v = tid + i * kThreads;
      const int row = v / (BN / 8);
      const int col = (v % (BN / 8)) * 8;
      breg[i] = *reinterpret_cast<const uint4*>(wp + (size_t)(kc * kBK + row) * ldb + n0 + col);
    }
  };

  auto store = [&](int buf) {
    al.store(sm.a[buf]);
#pragma unroll
    for (int i = 0; i < kBVecs; ++i) {
      const int v = tid + i * kThreads;
      *reinterpret_cast<uint4*>(&sm.b[buf][v / (BN / 8)][(v % (BN / 8)) * 8]) = breg[i];
    }
  };

#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  load(0);
  store(0);
  __syncthreads();
  for (int kc = 0; kc < nk; ++kc) {
    const int cur = kc & 1;
    if (kc + 1 < nk) load(kc + 1);  // in flight during the products below
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t a[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        ldmatrix_x4(a[mt], &sm.a[cur][warp_m * 64 + mt * 16 + (lane & 15)]
                               [ks * 16 + (lane >> 4) * 8]);
      }
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, &sm.b[cur][ks * 16 + (lane & 15)]
                                   [warp_n * kWN + np * 16 + (lane >> 4) * 8]);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          mma_bf16(acc[mt][2 * np], a[mt], b[0], b[1]);
          mma_bf16(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }
    if (kc + 1 < nk) store(cur ^ 1);
    __syncthreads();
  }
}

}  // namespace conv3x3_igemm
