// Fused 2D-RoPE attention for Hopper (sm_90a), with a plain C interface.
//
// Replaces dust3r_tpu/ops/pallas_attention.py::fused_attention (the Pallas
// TPU kernel _attn_kernel, row 1 of the repo's TPU kernels) and, through
// its strides, the head-packed TPU experiments that read q, k and v out of
// the (B, N, 3C) qkv projection or (B, N, C) projections and write
// (B, N, C): scripts/exp_attn_dma_r2.py::attn_dma (row 6) and
// scripts/exp_attn_layout_r2.py::attn_qkv_layout (row 7). With G = 2 or 4
// heads a block it is the baseline (core="mma") of the heads-per-program
// experiments scripts/exp_attn_r2.py::attn_g (row 3) and
// exp_attn_vmem_r2.py (row 5), which fused_attention_sm90.cu serves at any
// G; the wrapper runs a G here at the largest of 1, 2, 4 dividing it.
//
// With a softmax other than the exact one (one head a block, bf16) it
// runs the TPU experiments that vary row 1's softmax: at d = 64 as the
// baseline (core="mma") of fused_attention_sm90.cu, which serves them as
// modes of its consumer loop, and at d < 64 as their only kernel:
//   * scripts/exp_softmax_r2.py::attn with safe=False (row 9): "nomax",
//     p = exp(s) with no running max and no rescale of the accumulator. It
//     overflows where a logit passes ~88, as row 9 does; nothing in the
//     model asks for it;
//   * scripts/exp_attn_variants.py's kern_bf16s and kern_bf16exp (row 4):
//     "bf16_logits" (the logits tile rounded to bf16 after the fp32 mma,
//     then the bf16 exp) and "bf16_exp" (fp32 logits and max, then
//     exp2 of bf16((s - m) log2 e) on bf16 pairs, one sm_90
//     ex2.approx.ftz.bf16x2 a pair; P comes out of it in bf16).
// Row 4's kern_base and row 9's safe=True are the exact softmax. Every
// variant divides by the fp32 row sum of P as its exp made it; the TPU's
// ones-column fold is not carried over. What the variants buy is measured
// on both kernels by tools/attn_variants.py: on this core each carries its
// whole deficit against the sm90 kernel.
// The kernels and what bounds them are in attention_core.cuh.

#include "attention_core.cuh"

namespace {

template <int D>
int launch_softmax(const attn::Args& a, int batch, int softmax, cudaStream_t stream) {
  switch (softmax) {
    case attn::kNoMax:
      return attn::launch_bf16<D, 1, attn::kNoMax>(a, batch, stream);
    case attn::kBf16Logits:
      return attn::launch_bf16<D, 1, attn::kBf16Logits>(a, batch, stream);
    case attn::kBf16Exp:
      return attn::launch_bf16<D, 1, attn::kBf16Exp>(a, batch, stream);
    default:
      return -1;
  }
}

template <int D>
int launch(const attn::Args& a, int batch, int heads_per_block, int softmax, int is_bf16,
           cudaStream_t stream) {
  if (!is_bf16) return softmax == attn::kExact ? attn::launch_f32<D>(a, batch, stream) : -1;
  if (softmax != attn::kExact) {
    return heads_per_block == 1 ? launch_softmax<D>(a, batch, softmax, stream) : -1;
  }
  switch (heads_per_block) {
    case 1:
      return attn::launch_bf16<D, 1, attn::kExact>(a, batch, stream);
    case 2:
      return attn::launch_bf16<D, 2, attn::kExact>(a, batch, stream);
    case 4:
      return attn::launch_bf16<D, 4, attn::kExact>(a, batch, stream);
    default:
      return -1;
  }
}

}  // namespace

// q: (batch, heads, nq, d) and k, v: (batch, heads, nk, d) views, o like
// q; bf16 (is_bf16 = 1) or fp32; unit stride in d, the (batch, head, row)
// strides of q, k, v and o in `strides` (12 values, elements), every
// stride and base 16-byte aligned. cos/sin tables: (batch, n, d) fp32
// contiguous, laid out as rope_tables builds them (each half repeats with
// period d/4); ignored (may be null) without RoPE. heads_per_block (G)
// divides heads and is 1, 2 or 4 (the fp32 kernel takes one head a block
// for any G). softmax is attn::Softmax: kExact (0) for any G and dtype;
// kNoMax (1), kBf16Logits (2) and kBf16Exp (3) for bf16 with G = 1.
// Returns the CUDA error code of the launch; -1 for an unsupported d, G or
// softmax.
extern "C" int dust3r_fused_attention(const void* q, const void* k, const void* v,
                                      const float* cos_q, const float* sin_q,
                                      const float* cos_k, const float* sin_k, void* o,
                                      const long long* strides, int batch, int heads, int nq,
                                      int nk, int d, int heads_per_block, int softmax,
                                      int is_bf16, int use_rope, float scale, void* stream) {
  if (heads_per_block < 1 || heads % heads_per_block) return -1;
  const attn::Args a = attn::make_args(q, k, v, cos_q, sin_q, cos_k, sin_k, o, strides, heads,
                                       nq, nk, use_rope, scale);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16:
      return launch<16>(a, batch, heads_per_block, softmax, is_bf16, s);
    case 24:
      return launch<24>(a, batch, heads_per_block, softmax, is_bf16, s);
    case 32:
      return launch<32>(a, batch, heads_per_block, softmax, is_bf16, s);
    case 64:
      return launch<64>(a, batch, heads_per_block, softmax, is_bf16, s);
    default:
      return -1;
  }
}
