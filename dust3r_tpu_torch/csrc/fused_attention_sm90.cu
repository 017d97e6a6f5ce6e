// Fused 2D-RoPE attention for Hopper (sm_90a) built on TMA and wgmma, with a
// plain C interface: the main path's attention (bf16, head dim 64, exact
// softmax, one head a block).
//
// Replaces dust3r_tpu/ops/pallas_attention.py::fused_attention (the Pallas
// TPU kernel _attn_kernel with _apply_rope_tile, row 1 of the repo's TPU
// kernels) and, through its strides, the head-packed TPU experiments that
// read q, k and v out of the (B, N, 3C) qkv projection or (B, N, C)
// projections and write (B, N, C) (rows 6 and 7). It computes what the
// mma.sync core of attention_core.cuh computes (its header, lines 6-11):
// RoPE in fp32 from the wrapper's fp32 tables, q scaled and then rounded to
// bf16, k rotated and rounded to bf16, logits and the online softmax in
// fp32, P rounded to bf16 before P.v, the output divided by the fp32 row
// sum. Only the order of the fp32 sums inside the products differs. That
// core stays the kernel of every other case (fp32, d < 64, G > 1, the
// softmax variants, the floors) and the baseline they are held to.
//
// What bounds it on an H100: at DUSt3R's sizes (N = 672-768, d = 64) the
// two products are 4*N*N*d FLOPs against 4*N*d bf16 values in and out, some
// 380 FLOPs a byte, above the card's ~295 ridge: the tensor cores bound it,
// and at d = 64 so does the exp (one a logit: 16 a cycle an SM against
// 256 tensor-core FLOPs a logit). The logits never reach device memory.
// The design:
//   * a block holds 192 query rows of one (batch, head) in three consumer
//     warpgroups of 64 rows, and a producer warpgroup;
//   * the producer's warp 0 keeps a 4-stage ring of 64-key K and V tiles
//     in flight with TMA, straight from the strided (B, H, N, d) views (a
//     4-D tensor map each, 128-byte swizzle; keys past Nk arrive as zeros);
//     its warps 1-3 rotate each K tile in fp32 (RoPE, from the fp32 tables,
//     a tile's loaded while the one before is rotated) into a second,
//     rotated stage in the same swizzled layout, then fence it for the async
//     proxy; the tables repeat with period d/4 within each half, so a
//     rotated pair (c, c + d/4) shares one cos and one sin;
//   * each consumer warpgroup rotates and scales its 64 query rows once, in
//     fp32, into a bf16 tile of that layout (held in registers instead, as
//     the A operand of the register form of wgmma across the key loop, Q
//     gave wrong logits from the second key tile on, under ptxas -O3 only);
//   * S = Q K^T by four wgmma m64n64k16 (Q and the rotated K from shared
//     memory, both K-major); the online softmax runs on the accumulator in
//     registers, keys past Nk masked to -inf; P, rounded to bf16, is
//     re-packed from the accumulator in place as the A operand of O += P V,
//     four wgmma m64n64k16 with V from its stage as an MN-major B; then the
//     stage goes back to the producer;
//   * the three consumer warpgroups run out of step, so one's softmax
//     overlaps the others' products; a K tile's rotation serves 192 rows;
//   * one block an SM walks the (query tile, head) items in turn, the ring
//     running on from one item to the next, so an item's first tiles load
//     while the one before finishes.
// Not carried over from the TPU design: the whole (N, N) logits tile in
// VMEM and the ones-column row-sum fold. Without RoPE the rotating warps
// idle and the products read the TMA stage of K itself.
//
// The kernel launches on the caller's stream, allocates nothing and does
// not synchronise; the entry point returns cudaGetLastError() after the
// launch.

#include "attention_core.cuh"
#include "sm90.cuh"

namespace {

using attn::Args;

constexpr int kD = 64;                        // head dim: one 128-byte row a key
constexpr int kConsumers = 3;                 // consumer warpgroups, 64 query rows each
constexpr int kBlockRows = 64 * kConsumers;   // query rows a block
constexpr int kKeys = 64;                     // keys a stage
constexpr int kStages = 4;
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kTileBytes = kKeys * kD * 2;    // 8 KB
constexpr int kRotators = 96;                 // warps 1-3 of the producer warpgroup
constexpr int kUnits = kKeys * 4;             // (row, 8-column chunk) units of a 64-row tile
constexpr int kRotUnits = (kUnits + kRotators - 1) / kRotators;  // units a rotator takes

struct Smem {  // 1024-byte aligned: every tile keeps the 128-byte swizzle's pattern
  __nv_bfloat16 q[kConsumers][64 * kD];  // each consumer warpgroup's rotated, scaled rows
  __nv_bfloat16 k_raw[kStages][kKeys * kD];
  __nv_bfloat16 k_rot[kStages][kKeys * kD];
  __nv_bfloat16 v[kStages][kKeys * kD];
  uint64_t full[kStages];     // K and V of the stage landed (TMA bytes)
  uint64_t rotated[kStages];  // K rotated into k_rot (one arrival a rotating warp)
  uint64_t empty[kStages];    // the stage consumed (one arrival a consumer warp)
};
constexpr size_t kSmemBytes = sizeof(Smem) + 1024;

// byte offset of 16-byte chunk c of row r in a tile of 128-byte rows with the
// 128-byte swizzle
__device__ __forceinline__ int swizzled(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

// Unit u of a 64-row tile: row u / 4 and the 8-column chunk c0 in {0, 1, 4,
// 5} (the first quarter of each half) with its partner c0 + 2 (columns
// + d/4).
__device__ __forceinline__ int unit_row(int u) { return u >> 2; }
__device__ __forceinline__ int unit_chunk(int u) { return ((u >> 1) & 1) * 4 + (u & 1); }

// RoPE of one unit in fp32 (attention_core.cuh's arithmetic): a, b are the
// chunk and its partner, cs, sn the chunk's cos and sin (the partner's are
// the same), then the scale; both rounded to bf16 into x0, x1.
__device__ __forceinline__ void rope_unit(uint4 a8, uint4 b8, const float (&cs)[8],
                                          const float (&sn)[8], float scale, uint4& x0,
                                          uint4& x1) {
  float a[8], b[8];
  attn::unpack8(a8, a);
  attn::unpack8(b8, b);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float x = a[i] * cs[i] + (-b[i]) * sn[i];
    const float y = b[i] * cs[i] + a[i] * sn[i];
    a[i] = x * scale;
    b[i] = y * scale;
  }
  x0 = attn::pack8(a);
  x1 = attn::pack8(b);
}

// A consumer warpgroup's 64 query rows from row0 on, rotated by RoPE in fp32
// (kRope), scaled, rounded to bf16, into its 128-byte swizzled tile; rows past
// nq are zero. Two units a thread, 16-byte loads.
template <bool kRope>
__device__ __forceinline__ void stage_q(unsigned char* tile, const __nv_bfloat16* qb,
                                        int row_stride, const float* cos_q, const float* sin_q,
                                        int row0, int nq, int tid, float scale) {
#pragma unroll
  for (int i = 0; i < kUnits / 128; ++i) {
    const int u = tid + 128 * i;
    const int r = unit_row(u), c0 = unit_chunk(u);
    const int n = row0 + r;
    uint4 x0 = make_uint4(0, 0, 0, 0), x1 = x0;
    if (n < nq) {
      const __nv_bfloat16* src = qb + (size_t)n * row_stride;
      const uint4 a = *reinterpret_cast<const uint4*>(src + c0 * 8);
      const uint4 b = *reinterpret_cast<const uint4*>(src + (c0 + 2) * 8);
      if (kRope) {
        float cs[8], sn[8];
        attn::load8(cos_q + (size_t)n * kD + c0 * 8, cs);
        attn::load8(sin_q + (size_t)n * kD + c0 * 8, sn);
        rope_unit(a, b, cs, sn, scale, x0, x1);
      } else {
        float fa[8], fb[8];
        attn::unpack8(a, fa);
        attn::unpack8(b, fb);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          fa[k] *= scale;
          fb[k] *= scale;
        }
        x0 = attn::pack8(fa);
        x1 = attn::pack8(fb);
      }
    }
    *reinterpret_cast<uint4*>(tile + swizzled(r, c0)) = x0;
    *reinterpret_cast<uint4*>(tile + swizzled(r, c0 + 2)) = x1;
  }
}

// The rotating warps: the K tiles of one work item, once their TMA landed,
// rotated into k_rot; `it` counts the ring's tiles across items. A
// thread's units rt + 96 i, with the tables of tile j + 1 loaded while tile
// j is rotated.
__device__ __forceinline__ void rotate_keys(Smem& sm, int rt, int lane, const float* cos_k,
                                            const float* sin_k, int nk, int ntiles, int& it) {
  float cs[kRotUnits][8], sn[kRotUnits][8];
  auto load_tables = [&](int j) {
#pragma unroll
    for (int i = 0; i < kRotUnits; ++i) {
      const int u = rt + kRotators * i;
      const int key = j * kKeys + unit_row(u);
      if (u < kUnits && key < nk) {
        attn::load8(cos_k + (size_t)key * kD + unit_chunk(u) * 8, cs[i]);
        attn::load8(sin_k + (size_t)key * kD + unit_chunk(u) * 8, sn[i]);
      }
    }
  };
  load_tables(0);
  for (int j = 0; j < ntiles; ++j, ++it) {
    const int s = it % kStages;
    sm90::mbar_wait(&sm.full[s], (it / kStages) & 1);
    const unsigned char* raw = reinterpret_cast<const unsigned char*>(sm.k_raw[s]);
    unsigned char* rot = reinterpret_cast<unsigned char*>(sm.k_rot[s]);
#pragma unroll
    for (int i = 0; i < kRotUnits; ++i) {
      const int u = rt + kRotators * i;
      if (u < kUnits) {
        const int r = unit_row(u), c0 = unit_chunk(u);
        const int p0 = swizzled(r, c0), p1 = swizzled(r, c0 + 2);
        uint4 x0 = make_uint4(0, 0, 0, 0), x1 = x0;
        if (j * kKeys + r < nk) {
          rope_unit(*reinterpret_cast<const uint4*>(raw + p0),
                    *reinterpret_cast<const uint4*>(raw + p1), cs[i], sn[i], 1.f, x0, x1);
        }
        *reinterpret_cast<uint4*>(rot + p0) = x0;
        *reinterpret_cast<uint4*>(rot + p1) = x1;
      }
    }
    if (j + 1 < ntiles) load_tables(j + 1);
    sm90::fence_proxy_async();
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&sm.rotated[s]);
  }
}

// One block an SM walks the work items blockIdx.x, blockIdx.x + gridDim.x,
// ...: item i is query tile i % qtiles (192 rows) of head (i / qtiles) %
// heads of batch entry i / (qtiles * heads). The ring runs on across items,
// so the next item's K and V tiles load while this item's last ones are
// consumed.
template <bool kRope>
__global__ void __launch_bounds__(kThreads, 1)
attn_sm90_kernel(const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap, const Args args, int items) {
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                      ~static_cast<uintptr_t>(1023));
  const int nq = args.nq, nk = args.nk;
  const int ntiles = (nk + kKeys - 1) / kKeys;
  const int qtiles = (nq + kBlockRows - 1) / kBlockRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&sm.full[s], 1);
      sm90::mbar_init(&sm.rotated[s], kRotators / 32);
      sm90::mbar_init(&sm.empty[s], 4 * kConsumers);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  int it = 0;  // the ring's tiles so far: stage it % kStages, phase (it / kStages) & 1
  if (warp >= 4 * kConsumers) {  // the producer warpgroup
    const int pw = warp - 4 * kConsumers;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int b = item / qtiles / args.heads, h = (item / qtiles) % args.heads;
      if (pw == 0) {
        if (lane == 0) {
          for (int j = 0; j < ntiles; ++j, ++it) {
            const int s = it % kStages;
            if (it >= kStages) sm90::mbar_wait(&sm.empty[s], ((it / kStages) & 1) ^ 1);
            sm90::mbar_arrive_expect_tx(&sm.full[s], 2 * kTileBytes);
            sm90::tma_load_4d(sm.k_raw[s], &kmap, &sm.full[s], 0, j * kKeys, h, b);
            sm90::tma_load_4d(sm.v[s], &vmap, &sm.full[s], 0, j * kKeys, h, b);
          }
        }
      } else if (kRope) {
        rotate_keys(sm, threadIdx.x - 128 * kConsumers - 32, lane,
                    args.cos_k + (size_t)b * nk * kD, args.sin_k + (size_t)b * nk * kD, nk,
                    ntiles, it);
      }
    }
    return;
  }

  // a consumer warpgroup: this thread holds rows row and row + 8 of S and O
  const int cw = warp / 4;
  const int g = lane / 4, t = lane % 4;
  const uint64_t qdesc = sm90::smem_desc(sm.q[cw], 16, 1024, sm90::kSwizzle128B);
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int q0 = (item % qtiles) * kBlockRows;
    const int b = item / qtiles / args.heads, h = (item / qtiles) % args.heads;
    // the previous item's products have read this warpgroup's Q; then its 64
    // query rows go into shared memory
    sm90::named_barrier_sync(1 + cw, 128);
    stage_q<kRope>(reinterpret_cast<unsigned char*>(sm.q[cw]),
                   static_cast<const __nv_bfloat16*>(args.q) + b * args.sq.b + h * args.sq.h,
                   args.sq.n, kRope ? args.cos_q + (size_t)b * nq * kD : nullptr,
                   kRope ? args.sin_q + (size_t)b * nq * kD : nullptr, q0 + cw * 64, nq,
                   threadIdx.x % 128, args.scale);
    sm90::fence_proxy_async();
    sm90::named_barrier_sync(1 + cw, 128);
    const int row = q0 + warp * 16 + g;

    float o[32], sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = sc[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows g and g + 8
    float l0 = 0.f, l1 = 0.f;              // this thread's share of their row sums

    for (int j = 0; j < ntiles; ++j, ++it) {
      const int s = it % kStages;
      const uint32_t parity = (it / kStages) & 1;
      sm90::mbar_wait(&sm.full[s], parity);
      if (kRope) sm90::mbar_wait(&sm.rotated[s], parity);

      // S = Q K^T: Q rows are the queries, K rows the 64 keys, both K-major
      // with the 128-byte swizzle
      const uint64_t kdesc = sm90::smem_desc(kRope ? sm.k_rot[s] : sm.k_raw[s], 16, 1024,
                                             sm90::kSwizzle128B);
      sm90::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        sm90::wgmma_ss<0, 0>(sc, sm90::desc_advance(qdesc, 32 * kc),
                             sm90::desc_advance(kdesc, 32 * kc), kc > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_operand(sc);

      const int valid = nk - j * kKeys;
      if (valid < kKeys) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          if ((i / 4) * 8 + 2 * t + (i & 1) >= valid) sc[i] = -INFINITY;
        }
      }
      // the online softmax of attention_core.cuh's kExact: the four threads
      // of a group share rows g and g + 8
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        mx0 = fmaxf(mx0, fmaxf(sc[4 * n], sc[4 * n + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * n + 2], sc[4 * n + 3]));
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
      for (int n = 0; n < 8; ++n) {
        o[4 * n] *= corr0;
        o[4 * n + 1] *= corr0;
        o[4 * n + 2] *= corr1;
        o[4 * n + 3] *= corr1;
      }
      // P in bf16 pairs: the accumulator's (row, key) layout is the A layout
      // of P.v, 16 keys (two 8-column blocks) a k-chunk
      uint32_t pa[4][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float p0 = __expf(sc[4 * n] - m0), p1 = __expf(sc[4 * n + 1] - m0);
        const float p2 = __expf(sc[4 * n + 2] - m1), p3 = __expf(sc[4 * n + 3] - m1);
        l0 += p0 + p1;
        l1 += p2 + p3;
        pa[n / 2][2 * (n % 2)] = attn::pack_bf16(p0, p1);
        pa[n / 2][2 * (n % 2) + 1] = attn::pack_bf16(p2, p3);
      }

      // O += P V: V rows are the keys, its 64 columns contiguous (MN-major)
      const uint64_t vdesc = sm90::smem_desc(sm.v[s], kTileBytes, 1024, sm90::kSwizzle128B);
      sm90::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        sm90::wgmma_rs<1>(o, pa[kc], sm90::desc_advance(vdesc, 2048 * kc), 1);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_operand(o);
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) sm90::fence_operand(pa[kc]);
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&sm.empty[s]);
    }

#pragma unroll
    for (int sh = 1; sh <= 2; sh *= 2) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, sh);
      l1 += __shfl_xor_sync(0xffffffffu, l1, sh);
    }
    __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(args.o) + b * args.so.b + h * args.so.h;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = n * 8 + 2 * t;
      if (row < nq) {
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row * args.so.n + col) =
            __floats2bfloat162_rn(o[4 * n] / l0, o[4 * n + 1] / l0);
      }
      if (row + 8 < nq) {
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)(row + 8) * args.so.n + col) =
            __floats2bfloat162_rn(o[4 * n + 2] / l1, o[4 * n + 3] / l1);
      }
    }
  }
}

// The 4-D tensor map (d, n, head, batch) of a bf16 (B, H, N, 64) view with
// element strides (sb, sh, sn), boxes of 64 keys of one head.
int kv_map(CUtensorMap* map, const void* base, const attn::Strides& st, int batch, int heads,
           int n) {
  // the dims follow the view's logical order, whatever its strides' order
  const uint64_t dims[4] = {kD, (uint64_t)n, (uint64_t)heads, (uint64_t)batch};
  const uint64_t strides[3] = {2ull * st.n, 2ull * st.h, 2ull * st.b};
  const uint32_t box[4] = {kD, kKeys, 1, 1};
  return sm90::encode_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims, strides,
                                 box, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <bool kRope>
int launch(const CUtensorMap& kmap, const CUtensorMap& vmap, const Args& a, int batch,
           cudaStream_t stream) {
  static const cudaError_t attr =
      cudaFuncSetAttribute(attn_sm90_kernel<kRope>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(kSmemBytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int items = (a.nq + kBlockRows - 1) / kBlockRows * batch * a.heads;
  attn_sm90_kernel<kRope><<<items < sms ? items : sms, kThreads, kSmemBytes, stream>>>(
      kmap, vmap, a, items);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Arguments as dust3r_fused_attention's (fused_attention.cu) for bf16, d =
// 64, one head a block and the exact softmax: q (batch, heads, nq, 64), k
// and v (batch, heads, nk, 64) and o like q, bf16 views with unit stride in
// d and the (batch, head, row) strides of q, k, v and o in `strides` (12
// values, elements; each a multiple of 8 where its dim exceeds 1, every base
// 16-byte aligned: TMA's rules); cos/sin tables (batch, n, 64) fp32
// contiguous as rope_tables builds them, ignored (may be null) without
// RoPE. Returns the CUDA error code of the launch, or of encoding a tensor
// map offset by 1000 (1000 + CUresult; sm90::kNoEncoder when the runtime
// gives no encoder).
extern "C" int dust3r_fused_attention_sm90(const void* q, const void* k, const void* v,
                                           const float* cos_q, const float* sin_q,
                                           const float* cos_k, const float* sin_k, void* o,
                                           const long long* strides, int batch, int heads, int nq,
                                           int nk, int use_rope, float scale, void* stream) {
  const Args a = attn::make_args(q, k, v, cos_q, sin_q, cos_k, sin_k, o, strides, heads, nq, nk,
                                 use_rope, scale);
  CUtensorMap kmap, vmap;
  int err = kv_map(&kmap, k, a.sk, batch, heads, nk);
  if (err == 0) err = kv_map(&vmap, v, a.sv, batch, heads, nk);
  if (err != 0) return err == sm90::kNoEncoder ? err : 1000 + err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return use_rope ? launch<true>(kmap, vmap, a, batch, s) : launch<false>(kmap, vmap, a, batch, s);
}
