// Fused 2D-RoPE attention for Hopper (sm_90a) built on TMA and wgmma, with a
// plain C interface: the main path's attention (bf16, head dim 64, exact
// softmax), its grouped form (G heads a block), the softmax variants and the
// five floors of TPU row 3.
//
// Replaces dust3r_tpu/ops/pallas_attention.py::fused_attention (the Pallas
// TPU kernel _attn_kernel with _apply_rope_tile, row 1 of the repo's TPU
// kernels) and, through its strides, the head-packed TPU experiments that
// read q, k and v out of the (B, N, 3C) qkv projection or (B, N, C)
// projections and write (B, N, C) (rows 6 and 7); with G heads a block,
// the TPU experiments that group heads (scripts/exp_attn_r2.py::attn_g and
// exp_attn_vmem_r2.py, rows 3 and 5), at any G that divides the heads.
// Modes of the same consumer loop, an attn::Softmax code each, serve the
// TPU experiments that vary row 1's softmax (attention_core.cuh's header
// says what each computes):
//   nomax        scripts/exp_softmax_r2.py::attn with safe=False (row 9):
//                P = exp(s), keys past Nk masked to -inf first; no running
//                max, no rescale. It overflows past logits of ~88, as row
//                9 does;
//   bf16_exp     scripts/exp_attn_variants.py's kern_bf16exp (row 4): the
//                online max in fp32, then P = 2^bf16((s - m) log2 e), one
//                ex2.approx.ftz.bf16x2 a pair, straight into P.v's A
//                operand;
//   bf16_logits  kern_bf16s (row 4): the logits rounded to bf16, then as
//                bf16_exp;
// each with the fp32 row sum of P as its exp made it, and with RoPE or
// without; and row 3's floors (scripts/exp_attn_r2.py:82-115), with RoPE,
// which split this loop's time into parts because they run on its ring:
//   nosmax  P = bf16(S): both products, no max, exp, row sum or divide;
//   qkonly  no P.v: the output is key tile 0's logits (the script's
//           s[:, :d]); every tile's logits and a value of each V tile are
//           folded into a sink that is stored only when Args::store_sink is
//           set, which the wrappers never do, so no product is compiled
//           away (as csrc/attention_floor.cu keeps its discarded work);
//   copynr  O = bf16(q + v): the ring's I/O alone, no tables read;
//   copy    O = bf16(rope(q) + v), q unscaled: the I/O and Q's rotation
//           (rope_unit's arithmetic without the scale, in fp32 to the one
//           rounding);
//   copymm  O = bf16(q cos + (q P) sin + v), P the signed permutation with
//           t P = rotate-half(t) (the script's rot_matrix): rot = Q P by the
//           four wgmma m64n64k16 that make S = Q K^T elsewhere, against a
//           P^T tile built once a block in a K stage's layout (k_rot[0], free
//           while the rotating warps idle); every sum of the product has one
//           nonzero term, so rot is exact and lands in O's accumulator layout.
// The copy floors keep the ring as it is: the producer streams every K and
// V tile of a unit as in every mode, because the TPU call DMAs q, k and v in
// every mode (exp_attn_r2.py:156-174); a TMA load cannot be compiled away,
// so k needs no sink. The rotating warps idle and the key tables are not
// read: the TPU floors never rotate k. A consumer warpgroup's 64 rows are
// exactly key tile row0 / 64 (the item's first row is a multiple of 192,
// and the mode needs Nq = Nk), so it reads v at its own accumulator elements
// from that V stage and only waits on and releases the others. q is staged
// raw (scale 1: exact) as the Q tile; the output is fp32 until the
// epilogue's one rounding. What bounds them: bytes, q, v and o once each and
// K and V through L2 once for each 192-row item (4 times a head at N =
// 768); floor_bound in tools/attn_variants.py counts the TPU call's bytes,
// q, k, v and o once (copy and copymm: and the tables).
// It computes what the mma.sync core of attention_core.cuh computes (its
// header's "Per (batch, head)" lines): RoPE in fp32 from the wrapper's fp32 tables, q
// scaled and then rounded to bf16, k rotated and rounded to bf16, logits
// and the online softmax in fp32, P rounded to bf16 before P.v, the output
// divided by the fp32 row sum. Only the order of the fp32 sums inside the
// products differs. That core stays the kernel of fp32 and of d < 64, and
// the baseline (core="mma") the grouped calls, the softmax variants and the
// floors (csrc/attention_floor.cu) are held to.
//
// What bounds it on an H100: at DUSt3R's sizes (N = 672-768, d = 64) the
// two products are 4*N*N*d FLOPs against 4*N*d bf16 values in and out, some
// 380 FLOPs a byte, above the card's ~295 ridge: the tensor cores bound it,
// and at d = 64 so does the exp (one a logit: 16 a cycle an SM against
// 256 tensor-core FLOPs a logit). The logits never reach device memory.
// The design:
//   * a block holds 192 query rows of one (batch, head) at a time in three
//     consumer warpgroups of 64 rows, and a producer warpgroup;
//   * the producer's warp 0 keeps a 4-stage ring of 64-key K and V tiles
//     in flight with TMA, straight from the strided (B, H, N, d) views (a
//     4-D tensor map each, 128-byte swizzle; keys past Nk arrive as zeros);
//     its warps 1-3 rotate each K tile in fp32 (RoPE, from the fp32 tables,
//     a tile's loaded while the one before is rotated) into a second,
//     rotated stage in the same swizzled layout, then fence it for the async
//     proxy; the tables repeat with period d/4 within each half, so a
//     rotated pair (c, c + d/4) shares one cos and one sin;
//   * each consumer warpgroup rotates and scales its 64 query rows once a
//     head, in fp32, into a bf16 tile of that layout (held in registers
//     instead, as the A operand of the register form of wgmma across the key
//     loop, Q gave wrong logits from the second key tile on, under ptxas -O3
//     only);
//   * S = Q K^T by four wgmma m64n64k16 (Q and the rotated K from shared
//     memory, both K-major); the online softmax runs on the accumulator in
//     registers, keys past Nk masked to -inf; P, rounded to bf16, is
//     re-packed from the accumulator in place as the A operand of O += P V,
//     four wgmma m64n64k16 with V from its stage as an MN-major B; then the
//     stage goes back to the producer;
//   * the three consumer warpgroups run out of step, so one's softmax
//     overlaps the others' products; a K tile's rotation serves 192 rows;
//   * one block an SM walks the work items in turn, an item being a 192-row
//     query tile of a group of G heads of one batch entry, and the group's
//     heads one after another within it; the ring runs on from head to head
//     and from item to item, so the next head's first tiles load while the
//     one before finishes. Threads, registers and shared memory do not
//     depend on G (taken at run time): every G that divides the heads fits,
//     and each head's arithmetic is the G = 1 kernel's, so every G gives
//     the same bits; G only orders the work.
// Not carried over from the TPU design: the whole (N, N) logits tile in
// VMEM, the ones-column row-sum fold, and what grouping bought there: G
// heads of a program shared one VMEM fetch of the RoPE tables. Here the
// tables come from L2 (fp32, 6.3 MB at B = 16, N = 768), and a K tile's
// rotation already serves 192 query rows; the rotating warps read 16 KB of
// tables a 64-key tile against 8 KB of K. Without RoPE the rotating warps
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

// copymm's P^T tile, the B operand of rot = Q P in a K stage's layout (K-major,
// 128-byte swizzle): row n holds column n of P, so P^T[n, c] = +1 where n = c
// + d/4 for c in the first quarter of a half, -1 where n = c - d/4 for c in
// the second, else 0 (ops/attention_floors.py::rot_tile mirrors it).
__device__ __forceinline__ void build_rot_tile(unsigned char* tile) {
  for (int i = threadIdx.x; i < kKeys * 8; i += kThreads) {
    const int n = i / 8, chunk = i % 8;
    float p[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int c = chunk * 8 + e;
      const bool first = c % (kD / 2) < kD / 4;
      p[e] = first ? (n == c + kD / 4 ? 1.f : 0.f) : (n == c - kD / 4 ? -1.f : 0.f);
    }
    *reinterpret_cast<uint4*>(tile + swizzled(n, chunk)) = attn::pack8(p);
  }
}

// bf16 pair at (row r, columns 8 n + 2 t, + 1) of a 128-byte swizzled tile, in
// fp32
__device__ __forceinline__ float2 tile_pair(const unsigned char* tile, int r, int n, int t) {
  return __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(tile + swizzled(r, n) + 4 * t));
}

// t cos + p sin + v of a copy floor, p the signed rotate-half partner (copy)
// or rot (copymm): fma(t, cos, p sin), then v added, the form
// csrc/attention_floor.cu compiles to. Written with the rounding intrinsics
// because the compiler may fuse either product, and where t cos and p sin
// nearly cancel the two forms lie many bf16 units apart.
__device__ __forceinline__ float rope_add(float t, float cs, float p, float sn, float v) {
  return __fadd_rn(__fmaf_rn(t, cs, __fmul_rn(p, sn)), v);
}

// A copy floor's output at this thread's elements of the accumulator layout
// (o[4 n + 2 half + e] at local row r + 8 half, column 8 n + 2 t + e), in
// fp32: q from the warpgroup's raw Q tile, v from the V stage that holds its
// rows, the tables (copy, copymm) at global row `row` + 8 half; rot is
// copymm's Q P in the same layout. A thread holds a column's rotate-half
// partner (column + d/4, chunk n + 2) at the same offset, and the tables
// repeat with period d/4 within a half, so both take chunk n's cos and sin
// for the partner too, as rope_unit does (half the table reads; the same
// values as each column's own).
template <int S>
__device__ __forceinline__ void copy_out(float (&o)[32], const float (&rot)[32],
                                         const unsigned char* qt, const unsigned char* vt,
                                         const float* cos_q, const float* sin_q, int r, int row,
                                         int nq, int t) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int lr = r + 8 * half, n_row = row + 8 * half;
    float2 q[8], v[8];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      q[n] = tile_pair(qt, lr, n, t);
      v[n] = tile_pair(vt, lr, n, t);
    }
    float* out = o + 2 * half;
    if constexpr (S == attn::kFloorCopyNr) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        out[4 * n] = q[n].x + v[n].x;
        out[4 * n + 1] = q[n].y + v[n].y;
      }
    } else {
      const float* cos_row = cos_q + (size_t)n_row * kD + 2 * t;
      const float* sin_row = sin_q + (size_t)n_row * kD + 2 * t;
      const float2 zero = make_float2(0.f, 0.f);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = i / 2 * 4 + i % 2;  // chunks 0, 1, 4, 5: the first quarter of each half
        const float2 cs = n_row < nq ? *reinterpret_cast<const float2*>(cos_row + 8 * n) : zero;
        const float2 sn = n_row < nq ? *reinterpret_cast<const float2*>(sin_row + 8 * n) : zero;
        const float2 a = q[n], b = q[n + 2];
        // the signed partners of chunks n and n + 2: -b and a by rotate-half
        // (copy), or Q P's, the same values (copymm)
        float2 pa = make_float2(-b.x, -b.y), pb = a;
        if constexpr (S == attn::kFloorCopyMm) {
          pa = make_float2(rot[4 * n + 2 * half], rot[4 * n + 2 * half + 1]);
          pb = make_float2(rot[4 * (n + 2) + 2 * half], rot[4 * (n + 2) + 2 * half + 1]);
        }
        out[4 * n] = rope_add(a.x, cs.x, pa.x, sn.x, v[n].x);
        out[4 * n + 1] = rope_add(a.y, cs.y, pa.y, sn.y, v[n].y);
        out[4 * (n + 2)] = rope_add(b.x, cs.x, pb.x, sn.x, v[n + 2].x);
        out[4 * (n + 2) + 1] = rope_add(b.y, cs.y, pb.y, sn.y, v[n + 2].y);
      }
    }
  }
}

// The rotating warps: the K tiles of one unit (a head of a work item), once
// their TMA landed, rotated into k_rot; `it` counts the ring's tiles across
// units. A
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

// acc = A B^T by four wgmma m64n64k16: A the warpgroup's 64 x 64 Q tile
// (its descriptor), B a 64 x 64 tile of rows (a K stage, or copymm's P^T),
// both K-major with the 128-byte swizzle; acc in the accumulator layout of
// O. S = Q K^T, or copymm's rot = Q P. kWait: wait for the products here
// (else the caller waits before it reads acc).
template <bool kWait = true>
__device__ __forceinline__ void qk_product(float (&acc)[32], uint64_t qdesc, const void* b) {
  const uint64_t bdesc = sm90::smem_desc(b, 16, 1024, sm90::kSwizzle128B);
  sm90::wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    sm90::wgmma_ss<0, 0>(acc, sm90::desc_advance(qdesc, 32 * kc),
                         sm90::desc_advance(bdesc, 32 * kc), kc > 0);
  }
  sm90::wgmma_commit();
  if constexpr (kWait) {
    sm90::wgmma_wait<0>();
    sm90::fence_operand(acc);
  }
}

// A consumer warpgroup's share of one head: its 64 query rows of the
// 192-row query tile q0 of head h of batch entry b, against every key tile;
// `it` counts the ring's tiles across units. S makes P of the logits:
// attn::kExact by the online softmax; kNoMax, kBf16Exp and kBf16Logits as
// the header's variants; kNoSoftmax P = bf16(S); kQkOnly no P.v, the output
// key tile 0's logits and every tile's folded into `sink` (see the header);
// the copy floors make no logits (copy_out).
template <bool kRope, int S>
__device__ __forceinline__ void consume(Smem& sm, const Args& args, int b, int h, int q0,
                                        int ntiles, int& it, uint32_t& sink) {
  const int nq = args.nq;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int cw = warp / 4;
  const int g = lane / 4, t = lane % 4;  // this thread holds rows row and row + 8 of S and O
  constexpr bool kCopy = S >= attn::kFloorCopy;
  // the previous head's products have read this warpgroup's Q; then its 64
  // query rows go into shared memory (the copy floors': raw, scale 1)
  sm90::named_barrier_sync(1 + cw, 128);
  const float* cos_q = kRope ? args.cos_q + (size_t)b * nq * kD : nullptr;
  const float* sin_q = kRope ? args.sin_q + (size_t)b * nq * kD : nullptr;
  stage_q<kRope && !kCopy>(
      reinterpret_cast<unsigned char*>(sm.q[cw]),
      static_cast<const __nv_bfloat16*>(args.q) + b * args.sq.b + h * args.sq.h, args.sq.n,
      cos_q, sin_q, q0 + cw * 64, nq, threadIdx.x % 128, kCopy ? 1.f : args.scale);
  sm90::fence_proxy_async();
  sm90::named_barrier_sync(1 + cw, 128);
  const uint64_t qdesc = sm90::smem_desc(sm.q[cw], 16, 1024, sm90::kSwizzle128B);
  const int row = q0 + warp * 16 + g;

  float o[32], sc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = sc[i] = 0.f;
  if constexpr (S == attn::kFloorCopyMm) {  // rot = Q P into sc, waited for at own_tile
    qk_product<false>(sc, qdesc, sm.k_rot[0]);
  }
  // the key tile that holds this warpgroup's rows (the copy floors' v)
  [[maybe_unused]] const int own_tile = (q0 + cw * 64) / kKeys;
  // running max of rows g and g + 8 (kNoMax: 0)
  [[maybe_unused]] float m0 = S == attn::kNoMax ? 0.f : -INFINITY, m1 = m0;
  float l0 = 0.f, l1 = 0.f;  // this thread's share of their row sums

  for (int j = 0; j < ntiles; ++j, ++it) {
    const int s = it % kStages;
    const uint32_t parity = (it / kStages) & 1;
    sm90::mbar_wait(&sm.full[s], parity);
    if (kRope && !kCopy) sm90::mbar_wait(&sm.rotated[s], parity);

    if constexpr (kCopy) {
      if (j == own_tile) {
        if constexpr (S == attn::kFloorCopyMm) {
          sm90::wgmma_wait<0>();
          sm90::fence_operand(sc);
        }
        copy_out<S>(o, sc, reinterpret_cast<const unsigned char*>(sm.q[cw]),
                    reinterpret_cast<const unsigned char*>(sm.v[s]), cos_q, sin_q,
                    (warp % 4) * 16 + g, row, nq, t);
      }
    } else if constexpr (S == attn::kQkOnly) {
      qk_product(sc, qdesc, kRope ? sm.k_rot[s] : sm.k_raw[s]);
      // the accumulators of S and O share one (row, column) layout
      if (j == 0) {
#pragma unroll
        for (int i = 0; i < 32; ++i) o[i] = sc[i];
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) sink ^= __float_as_uint(sc[i]);
      sink ^= reinterpret_cast<const uint32_t*>(sm.v[s])[threadIdx.x % 128];
    } else {
      qk_product(sc, qdesc, kRope ? sm.k_rot[s] : sm.k_raw[s]);
      // P in bf16 pairs: the accumulator's (row, key) layout is the A layout
      // of P.v, 16 keys (two 8-column blocks) a k-chunk
      uint32_t pa[4][4];
      if constexpr (S == attn::kNoSoftmax) {
        // the zero K rows past Nk give logits of 0, so P = 0 there
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          pa[n / 2][2 * (n % 2)] = attn::pack_bf16(sc[4 * n], sc[4 * n + 1]);
          pa[n / 2][2 * (n % 2) + 1] = attn::pack_bf16(sc[4 * n + 2], sc[4 * n + 3]);
        }
      } else {
        if constexpr (S == attn::kBf16Logits) {  // rounded a pair at a time: one cvt a pair
#pragma unroll
          for (int i = 0; i < 32; i += 2) {
            const float2 r = __bfloat1622float2(__floats2bfloat162_rn(sc[i], sc[i + 1]));
            sc[i] = r.x;
            sc[i + 1] = r.y;
          }
        }
        const int valid = args.nk - j * kKeys;
        if (valid < kKeys) {
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            if ((i / 4) * 8 + 2 * t + (i & 1) >= valid) sc[i] = -INFINITY;
          }
        }
        if constexpr (S != attn::kNoMax) {  // kNoMax: no running max (m stays 0)
          // the online softmax of attention_core.cuh: the four threads of a
          // group share rows g and g + 8
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
        }
        if constexpr (S == attn::kExact || S == attn::kNoMax) {
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            const float p0 = __expf(sc[4 * n] - m0), p1 = __expf(sc[4 * n + 1] - m0);
            const float p2 = __expf(sc[4 * n + 2] - m1), p3 = __expf(sc[4 * n + 3] - m1);
            l0 += p0 + p1;
            l1 += p2 + p3;
            pa[n / 2][2 * (n % 2)] = attn::pack_bf16(p0, p1);
            pa[n / 2][2 * (n % 2) + 1] = attn::pack_bf16(p2, p3);
          }
        } else {  // kBf16Exp, kBf16Logits: bf16x2 exp2 of bf16((s - m) log2 e)
          const float nm0 = -m0 * attn::kLog2e, nm1 = -m1 * attn::kLog2e;
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            const uint32_t p01 = attn::exp2_bf16x2(attn::pack_bf16(
                fmaf(sc[4 * n], attn::kLog2e, nm0), fmaf(sc[4 * n + 1], attn::kLog2e, nm0)));
            const uint32_t p23 = attn::exp2_bf16x2(attn::pack_bf16(
                fmaf(sc[4 * n + 2], attn::kLog2e, nm1), fmaf(sc[4 * n + 3], attn::kLog2e, nm1)));
            const float2 f01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&p01));
            const float2 f23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&p23));
            l0 += f01.x + f01.y;
            l1 += f23.x + f23.y;
            pa[n / 2][2 * (n % 2)] = p01;
            pa[n / 2][2 * (n % 2) + 1] = p23;
          }
        }
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
    }
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&sm.empty[s]);
  }

  // copymm: a warpgroup whose rows start at or past Nq has no own tile; Q P
  // must be done before the next unit stages Q
  if constexpr (S == attn::kFloorCopyMm) sm90::wgmma_wait<0>();
  if constexpr (S == attn::kNoSoftmax || S == attn::kQkOnly || kCopy) {  // no row sum
    l0 = l1 = 1.f;
  } else {
#pragma unroll
    for (int sh = 1; sh <= 2; sh *= 2) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, sh);
      l1 += __shfl_xor_sync(0xffffffffu, l1, sh);
    }
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

// One block an SM walks the work items blockIdx.x, blockIdx.x + gridDim.x,
// ...: item i is query tile i % qtiles (192 rows) of the group of `group`
// heads (i / qtiles) % groups of batch entry i / (qtiles * groups), and
// within it the group's heads in turn. A unit is one head of an item, u =
// item * group + its place in the group; one counter walks them, so the
// key loop keeps no more state live than at G = 1.
struct Unit {
  int b, h, q0;  // batch entry, head, first query row
};

__device__ __forceinline__ Unit unit_of(int u, int group, int groups, int qtiles) {
  const int item = u / group, bg = item / qtiles;
  return Unit{bg / groups, bg % groups * group + u % group, item % qtiles * kBlockRows};
}

// the unit after u in this block's walk
__device__ __forceinline__ int next_unit(int u, int group) {
  return (u + 1) % group ? u + 1 : u + 1 + (static_cast<int>(gridDim.x) - 1) * group;
}

// Every role of the block walks the same units; the ring runs on across
// them, so the next head's K and V tiles load while this head's last ones
// are consumed.
template <bool kRope, int S>
__global__ void __launch_bounds__(kThreads, 1)
attn_sm90_kernel(const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap, const Args args, int group,
                 int units) {
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                      ~static_cast<uintptr_t>(1023));
  const int nq = args.nq, nk = args.nk;
  const int ntiles = (nk + kKeys - 1) / kKeys;
  const int qtiles = (nq + kBlockRows - 1) / kBlockRows;
  const int groups = args.heads / group;
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
  if constexpr (S == attn::kFloorCopyMm) {  // k_rot is free: no K is rotated
    build_rot_tile(reinterpret_cast<unsigned char*>(sm.k_rot[0]));
    sm90::fence_proxy_async();
  }
  __syncthreads();

  int it = 0;  // the ring's tiles so far: stage it % kStages, phase (it / kStages) & 1
  if (warp >= 4 * kConsumers) {  // the producer warpgroup
    const int pw = warp - 4 * kConsumers;
    for (int u = blockIdx.x * group; u < units; u = next_unit(u, group)) {
      const Unit w = unit_of(u, group, groups, qtiles);
      if (pw == 0) {
        if (lane == 0) {
          for (int j = 0; j < ntiles; ++j, ++it) {
            const int s = it % kStages;
            if (it >= kStages) sm90::mbar_wait(&sm.empty[s], ((it / kStages) & 1) ^ 1);
            sm90::mbar_arrive_expect_tx(&sm.full[s], 2 * kTileBytes);
            sm90::tma_load_4d(sm.k_raw[s], &kmap, &sm.full[s], 0, j * kKeys, w.h, w.b);
            sm90::tma_load_4d(sm.v[s], &vmap, &sm.full[s], 0, j * kKeys, w.h, w.b);
          }
        }
      } else if (kRope && S < attn::kFloorCopy) {  // the copy floors rotate no K
        rotate_keys(sm, threadIdx.x - 128 * kConsumers - 32, lane,
                    args.cos_k + (size_t)w.b * nk * kD, args.sin_k + (size_t)w.b * nk * kD, nk,
                    ntiles, it);
      }
    }
    return;
  }

  [[maybe_unused]] uint32_t sink = 0;  // kQkOnly's fold of the work it discards
  for (int u = blockIdx.x * group; u < units; u = next_unit(u, group)) {
    const Unit w = unit_of(u, group, groups, qtiles);
    consume<kRope, S>(sm, args, w.b, w.h, w.q0, ntiles, it, sink);
  }
  if (S == attn::kQkOnly && args.store_sink) *static_cast<uint32_t*>(args.o) = sink;
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

template <bool kRope, int S>
int launch(const CUtensorMap& kmap, const CUtensorMap& vmap, const Args& a, int batch, int group,
           cudaStream_t stream) {
  static devattr::SmemLimit limit;
  const cudaError_t attr =
      limit.raise_on_current_device(attn_sm90_kernel<kRope, S>, static_cast<int>(kSmemBytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int items = (a.nq + kBlockRows - 1) / kBlockRows * batch * (a.heads / group);
  attn_sm90_kernel<kRope, S><<<items < sms ? items : sms, kThreads, kSmemBytes, stream>>>(
      kmap, vmap, a, group, items * group);
  return static_cast<int>(cudaGetLastError());
}

// launch<kRope, S> with kRope taken at run time
template <int S>
int launch_rope(bool rope, const CUtensorMap& kmap, const CUtensorMap& vmap, const Args& a,
                int batch, int group, cudaStream_t stream) {
  return rope ? launch<true, S>(kmap, vmap, a, batch, group, stream)
              : launch<false, S>(kmap, vmap, a, batch, group, stream);
}

}  // namespace

// Arguments as dust3r_fused_attention's (fused_attention.cu) for bf16 and d
// = 64: q (batch, heads, nq, 64), k and v (batch, heads, nk, 64) and o like
// q, bf16 views with unit stride in d and the (batch, head, row) strides of
// q, k, v and o in `strides` (12 values, elements; each a multiple of 8
// where its dim exceeds 1, every base 16-byte aligned: TMA's rules); cos/sin
// tables (batch, n, 64) fp32 contiguous as rope_tables builds them, ignored
// (may be null) without RoPE; heads_per_block G, any divisor of heads;
// `mode` an attn::Softmax code: kExact or the softmax variants kNoMax
// (nomax), kBf16Logits (bf16_logits) and kBf16Exp (bf16_exp), with RoPE or
// without; with RoPE the floors kNoSoftmax (nosmax), kQkOnly (qkonly, nk
// >= 64), kFloorCopy (copy), kFloorCopyNr (copynr; it reads no tables) and
// kFloorCopyMm (copymm), the copy floors with nq == nk. Returns the CUDA error code of the launch, or of encoding a
// tensor map offset by 1000 (1000 + CUresult; sm90::kNoEncoder when the
// runtime gives no encoder); -1 for what it does not take.
extern "C" int dust3r_fused_attention_sm90(const void* q, const void* k, const void* v,
                                           const float* cos_q, const float* sin_q,
                                           const float* cos_k, const float* sin_k, void* o,
                                           const long long* strides, int batch, int heads, int nq,
                                           int nk, int heads_per_block, int mode, int use_rope,
                                           float scale, void* stream) {
  if (heads_per_block < 1 || heads % heads_per_block) return -1;
  const bool floor = mode >= attn::kNoSoftmax;
  if (mode < attn::kExact || mode > attn::kFloorCopyMm || (floor && !use_rope) ||
      (mode == attn::kQkOnly && nk < kD) || (mode >= attn::kFloorCopy && nq != nk)) {
    return -1;
  }
  const Args a = attn::make_args(q, k, v, cos_q, sin_q, cos_k, sin_k, o, strides, heads, nq, nk,
                                 use_rope, scale);
  CUtensorMap kmap, vmap;
  int err = kv_map(&kmap, k, a.sk, batch, heads, nk);
  if (err == 0) err = kv_map(&vmap, v, a.sv, batch, heads, nk);
  if (err != 0) return err == sm90::kNoEncoder ? err : 1000 + err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int g = heads_per_block;
  switch (mode) {
    case attn::kNoMax:
      return launch_rope<attn::kNoMax>(use_rope, kmap, vmap, a, batch, g, s);
    case attn::kBf16Logits:
      return launch_rope<attn::kBf16Logits>(use_rope, kmap, vmap, a, batch, g, s);
    case attn::kBf16Exp:
      return launch_rope<attn::kBf16Exp>(use_rope, kmap, vmap, a, batch, g, s);
    case attn::kNoSoftmax:
      return launch<true, attn::kNoSoftmax>(kmap, vmap, a, batch, g, s);
    case attn::kQkOnly:
      return launch<true, attn::kQkOnly>(kmap, vmap, a, batch, g, s);
    case attn::kFloorCopy:
      return launch<true, attn::kFloorCopy>(kmap, vmap, a, batch, g, s);
    case attn::kFloorCopyNr:
      return launch<true, attn::kFloorCopyNr>(kmap, vmap, a, batch, g, s);
    case attn::kFloorCopyMm:
      return launch<true, attn::kFloorCopyMm>(kmap, vmap, a, batch, g, s);
    default:
      return launch_rope<attn::kExact>(use_rope, kmap, vmap, a, batch, g, s);
  }
}
