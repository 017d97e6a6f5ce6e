// The measurement floors of the fused attention for Hopper (sm_90a), with a
// plain C interface: kernels that do part of the attention kernel's work,
// so that its time on the card can be split into parts.
//
// Replaces the floor modes of scripts/exp_attn_r2.py::attn_g (TPU row 3;
// its attention modes are fused_attention_sm90.cu's at any G, with
// fused_attention.cu's G = 1, 2, 4 as the baseline). All five floors are
// modes of fused_attention_sm90.cu (the wrapper's default route); this file
// is their baseline (core="mma"): nosmax and qkonly on the mma.sync core,
// the copy floors on the small kernel below. Per (batch,
// head), with q and k rotated by RoPE in fp32 from the tables, q scaled by
// d^-1/2, both rounded to bf16, v and the output bf16:
//   nosmax  O = bf16(q k^T) v: both products, no softmax (attn::kNoSoftmax
//           of attention_core.cuh: no max, exp, row sum or divide);
//   qkonly  O = bf16((q k^T)[:, :d]): q.k^T over every key tile, no P.v
//           (attn::kQkOnly);
//   copy    O = bf16(rope(q) + v), q unscaled: the I/O plus RoPE;
//   copynr  O = bf16(q + v): the I/O alone;
//   copymm  O = bf16(q cos + (q P) sin + v), P the signed permutation with
//           t P = rotate-half(t): RoPE through a tensor-core product (one
//           mma.sync a 16 x 8 tile), as the TPU floor put it on the MXU.
// The TPU call streams q, k, v and all four tables in every mode
// (exp_attn_r2.py:156-174), and the floors exist to measure that I/O. So
// every mode reads what the attention kernel reads: q, k and v once each,
// the tables by the core's loaders' units (each (row, 8-column) unit of a
// table once for the G heads of a block). What a mode does not use (k and
// its tables in the copy modes; the query tables too in copynr) is folded
// into a sink (XOR of the bits) that is stored only when Args::store_sink
// is set, which the wrapper never does: the loads are live, the store
// never happens. qkonly folds the logits of every key tile past the first
// the same way (attention_core.cuh).
//
// What bounds them on an H100: copynr moves 2 bytes a value of q, k, v and
// o (copy and copymm also the tables), and does no work worth counting:
// memory. qkonly does 2*N*N*d and nosmax 4*N*N*d bf16 tensor-core FLOPs a
// head: operations at N = 768. The design: nosmax and qkonly are the
// attention kernel's core with another softmax code (its loaders, its
// fragments, its 64-key tiles); the copy modes are one small kernel of the
// same grid (a block a 64-row query tile of G heads of one batch entry),
// with copy and copynr on the core loaders' 16-byte units in registers
// (fp32 adds, one rounding), and copymm staging the Q tile and P in shared
// memory for the mma. Every G gives the same bits: a head's arithmetic
// does not depend on the heads beside it.
//
// A kernel launches on the caller's stream, allocates nothing and does not
// synchronise; the entry point returns cudaGetLastError() after the launch.

#include "attention_core.cuh"

namespace {

using namespace attn;

// The floor codes of the C entry, in the order of the wrapper's MODES.
enum Floor : int { kNosmax = 0, kQkonly = 1, kCopy = 2, kCopyNoRope = 3, kCopyMm = 4 };

__device__ __forceinline__ uint32_t fold(uint4 u) { return u.x ^ u.y ^ u.z ^ u.w; }

__device__ __forceinline__ uint32_t fold(const float (&f)[8]) {
  uint32_t r = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) r ^= __float_as_uint(f[j]);
  return r;
}

// k and its tables, streamed through the core loaders' units and folded:
// the key tiles blockIdx.x, blockIdx.x + gridDim.x, ... of this block's G
// heads, so that the grid reads every key row once.
template <int D, int G>
__device__ __forceinline__ uint32_t stream_keys(const __nv_bfloat16* kb, int head_stride,
                                                int row_stride, const float* cos_k,
                                                const float* sin_k, int nk) {
  constexpr int kThreads = G * kThreadsPerHead;
  constexpr int kQuarter = D / 4;
  constexpr int kChunks = kQuarter / 8;
  constexpr int kUnits = 2 * kChunks;
  uint32_t sink = 0;
  for (int k0 = blockIdx.x * kKeysPerTile; k0 < nk; k0 += gridDim.x * kKeysPerTile) {
    for (int i = threadIdx.x; i < kKeysPerTile * kUnits; i += kThreads) {
      const int r = i / kUnits, u = i % kUnits;
      const int c0 = (u / kChunks) * (D / 2) + (u % kChunks) * 8;
      const int row = k0 + r;
      if (row >= nk) continue;
      float cs[8], sn[8];
      load8(cos_k + (size_t)row * D + c0, cs);
      load8(sin_k + (size_t)row * D + c0, sn);
      sink ^= fold(cs) ^ fold(sn);
#pragma unroll
      for (int h = 0; h < G; ++h) {
        const __nv_bfloat16* s = kb + h * head_stride + row * row_stride;
        sink ^= fold(*reinterpret_cast<const uint4*>(s + c0)) ^
                fold(*reinterpret_cast<const uint4*>(s + c0 + kQuarter));
      }
    }
  }
  return sink;
}

// copy and copynr: each (row, 8-column) unit of the block's 64 query rows
// and its rotate-half partner, for the G heads, in registers: q (rotated in
// fp32 for copy) plus v in fp32, rounded once to bf16.
template <int D, int G, int M>
__device__ __forceinline__ uint32_t copy_rows(const Args& a, const __nv_bfloat16* qb,
                                              const __nv_bfloat16* vb, __nv_bfloat16* ob,
                                              const float* cos_q, const float* sin_q,
                                              int q0) {
  constexpr int kThreads = G * kThreadsPerHead;
  constexpr int kQuarter = D / 4;
  constexpr int kChunks = kQuarter / 8;
  constexpr int kUnits = 2 * kChunks;
  uint32_t sink = 0;
  for (int i = threadIdx.x; i < kRowsPerBlock * kUnits; i += kThreads) {
    const int r = i / kUnits, u = i % kUnits;
    const int c0 = (u / kChunks) * (D / 2) + (u % kChunks) * 8;
    const int c1 = c0 + kQuarter;
    const int row = q0 + r;
    if (row >= a.nq) continue;
    float cs[8], sn[8];  // once for the G heads
    load8(cos_q + (size_t)row * D + c0, cs);
    load8(sin_q + (size_t)row * D + c0, sn);
    if constexpr (M == kCopyNoRope) sink ^= fold(cs) ^ fold(sn);
#pragma unroll
    for (int h = 0; h < G; ++h) {
      const __nv_bfloat16* qs = qb + h * a.sq.h + row * a.sq.n;
      const __nv_bfloat16* vs = vb + h * a.sv.h + row * a.sv.n;
      float x0[8], x1[8], v0[8], v1[8];
      unpack8(*reinterpret_cast<const uint4*>(qs + c0), x0);
      unpack8(*reinterpret_cast<const uint4*>(qs + c1), x1);
      unpack8(*reinterpret_cast<const uint4*>(vs + c0), v0);
      unpack8(*reinterpret_cast<const uint4*>(vs + c1), v1);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if constexpr (M == kCopy) {  // as load_rope_tile rotates
          const float y0 = x0[j] * cs[j] + (-x1[j]) * sn[j];
          const float y1 = x1[j] * cs[j] + x0[j] * sn[j];
          x0[j] = y0;
          x1[j] = y1;
        }
        x0[j] += v0[j];
        x1[j] += v1[j];
      }
      __nv_bfloat16* os = ob + h * a.so.h + row * a.so.n;
      *reinterpret_cast<uint4*>(os + c0) = pack8(x0);
      *reinterpret_cast<uint4*>(os + c1) = pack8(x1);
    }
  }
  return sink;
}

// copymm: the block's G Q tiles and P in shared memory; each warp takes 16
// rows of its head: rot = Q P on the tensor cores (a signed permutation:
// every sum has one nonzero term, so rot is exact), then q cos + rot sin + v
// at the accumulator fragment's elements.
template <int D, int G>
__device__ __forceinline__ void copymm_rows(const Args& a, const __nv_bfloat16* qb,
                                            const __nv_bfloat16* vb, __nv_bfloat16* ob,
                                            const float* cos_q, const float* sin_q, int q0) {
  using T = Tiles<D>;
  constexpr int kThreads = G * kThreadsPerHead;
  constexpr int kStride = T::kStride;
  constexpr int kVStride = T::kVStride;
  constexpr int kHalf = D / 2;
  constexpr int kQuarter = D / 4;
  static_assert(T::kDK == D, "P is D x D");
  __shared__ __align__(16) __nv_bfloat16 qs[G * T::kKTile];
  __shared__ __align__(16) __nv_bfloat16 ps[D * kVStride];
  load_tile<D, kStride, G>(qs, qb, a.sq.h, a.sq.n, q0, a.nq);
  // P[r, c] = -1 where c = r - D/4 in the second quarter of a half, +1
  // where c = r + D/4 in the first, else 0 (exp_attn_r2.py:51-60)
  for (int i = threadIdx.x; i < D * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const bool first = r % kHalf < kQuarter;
    const float p = (first && c == r + kQuarter) ? 1.f : (!first && c == r - kQuarter) ? -1.f
                                                                                     : 0.f;
    ps[r * kVStride + c] = __float2bfloat16(p);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int hw = warp / kWarpsPerHead;
  const int wr = (warp % kWarpsPerHead) * 16;
  const __nv_bfloat16* qt = qs + hw * T::kKTile;
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const __nv_bfloat16* base = qt + (wr + g) * kStride + kc * 16 + 2 * t;
    qa[kc][0] = ld_u32(base);
    qa[kc][1] = ld_u32(base + 8 * kStride);
    qa[kc][2] = ld_u32(base + 8);
    qa[kc][3] = ld_u32(base + 8 * kStride + 8);
  }
  float rot[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    rot[n][0] = rot[n][1] = rot[n][2] = rot[n][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t b0, b1;
      ldmatrix_x2_trans(b0, b1, ps + (kc * 16 + (lane & 15)) * kVStride + n * 8);
      mma_bf16(rot[n], qa[kc], b0, b1);
    }
  }
  const __nv_bfloat16* vh = vb + hw * a.sv.h;
  __nv_bfloat16* oh = ob + hw * a.so.h;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int rl = wr + g + 8 * half;
      const int row = q0 + rl;
      if (row >= a.nq) continue;
      const float2 qv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(qt + rl * kStride + col));
      const float2 vv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(vh + row * a.sv.n + col));
      const float2 cs = *reinterpret_cast<const float2*>(cos_q + (size_t)row * D + col);
      const float2 sn = *reinterpret_cast<const float2*>(sin_q + (size_t)row * D + col);
      const float r0 = qv.x * cs.x + rot[n][2 * half] * sn.x;
      const float r1 = qv.y * cs.y + rot[n][2 * half + 1] * sn.y;
      *reinterpret_cast<__nv_bfloat162*>(oh + row * a.so.n + col) =
          __floats2bfloat162_rn(r0 + vv.x, r1 + vv.y);
    }
  }
}

template <int D, int G, int M>
__global__ void __launch_bounds__(G * kThreadsPerHead)
attn_copy_kernel(const Args args) {
  const int groups = args.heads / G;
  const int b = blockIdx.y / groups;
  const int h0 = (blockIdx.y % groups) * G;
  const int q0 = blockIdx.x * kRowsPerBlock;
  const auto* qb = static_cast<const __nv_bfloat16*>(args.q) + b * args.sq.b + h0 * args.sq.h;
  const auto* kb = static_cast<const __nv_bfloat16*>(args.k) + b * args.sk.b + h0 * args.sk.h;
  const auto* vb = static_cast<const __nv_bfloat16*>(args.v) + b * args.sv.b + h0 * args.sv.h;
  auto* ob = static_cast<__nv_bfloat16*>(args.o) + b * args.so.b + h0 * args.so.h;
  const float* cos_q = args.cos_q + (size_t)b * args.nq * D;
  const float* sin_q = args.sin_q + (size_t)b * args.nq * D;
  uint32_t sink = 0;
  if constexpr (M == kCopyMm) {
    copymm_rows<D, G>(args, qb, vb, ob, cos_q, sin_q, q0);
  } else {
    sink = copy_rows<D, G, M>(args, qb, vb, ob, cos_q, sin_q, q0);
  }
  sink ^= stream_keys<D, G>(kb, args.sk.h, args.sk.n, args.cos_k + (size_t)b * args.nk * D,
                            args.sin_k + (size_t)b * args.nk * D, args.nk);
  if (args.store_sink) *reinterpret_cast<uint32_t*>(ob) = sink;
}

template <int D, int G, int M>
int launch_copy(const Args& a, int batch, cudaStream_t stream) {
  const dim3 grid((a.nq + kRowsPerBlock - 1) / kRowsPerBlock, batch * (a.heads / G));
  attn_copy_kernel<D, G, M><<<grid, G * kThreadsPerHead, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int G>
int launch_floor(const Args& a, int batch, int mode, cudaStream_t stream) {
  switch (mode) {
    case kNosmax:
      return launch_bf16<64, G, kNoSoftmax>(a, batch, stream);
    case kQkonly:
      return launch_bf16<64, G, kQkOnly>(a, batch, stream);
    case kCopy:
      return launch_copy<64, G, kCopy>(a, batch, stream);
    case kCopyNoRope:
      return launch_copy<64, G, kCopyNoRope>(a, batch, stream);
    case kCopyMm:
      return launch_copy<64, G, kCopyMm>(a, batch, stream);
    default:
      return -1;
  }
}

}  // namespace

// Arguments as dust3r_fused_attention's (fused_attention.cu), with `mode` a
// Floor code in the place of the softmax code: q, k, v (batch, heads, n,
// d) bf16 views with unit stride in d and 16-byte aligned strides, o like
// q, the (batch, head, row) strides of q, k, v, o in `strides` (12 values,
// elements), the four (batch, n, d) fp32 RoPE tables. d = 64, bf16, RoPE;
// G = heads_per_block in 1, 2, 4, dividing heads; the copy modes need
// nq == nk, qkonly nk >= d. Returns the CUDA error code of the launch; -1
// for what it does not take.
extern "C" int dust3r_attention_floor(const void* q, const void* k, const void* v,
                                      const float* cos_q, const float* sin_q,
                                      const float* cos_k, const float* sin_k, void* o,
                                      const long long* strides, int batch, int heads, int nq,
                                      int nk, int d, int heads_per_block, int mode,
                                      int is_bf16, int use_rope, float scale, void* stream) {
  if (d != 64 || !is_bf16 || !use_rope || heads_per_block < 1 || heads % heads_per_block) {
    return -1;
  }
  if ((mode >= kCopy && nq != nk) || (mode == kQkonly && nk < d)) return -1;
  const Args a = make_args(q, k, v, cos_q, sin_q, cos_k, sin_k, o, strides, heads, nq, nk,
                           use_rope, scale);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (heads_per_block) {
    case 1:
      return launch_floor<1>(a, batch, mode, s);
    case 2:
      return launch_floor<2>(a, batch, mode, s);
    case 4:
      return launch_floor<4>(a, batch, mode, s);
    default:
      return -1;
  }
}
