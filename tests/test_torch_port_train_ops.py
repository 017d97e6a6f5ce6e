"""The backwards of the port's four kernels against the JAX package, on the
CPU.

Each kernel route (`impl="kernel"`) is a `torch.autograd.Function`; on CPU
tensors its forward is the kernel's plain version and its backward the
plain recompute the card runs too. The same seeded numpy inputs and output
gradient go through the JAX backward:
* attention: `_attention_pallas_bwd` (the custom VJP's XLA backward, called
  directly) and `jax.vjp(attention_ref)`, with RoPE and without, Nq != Nk,
  and q, k, v read as strided views of one (B, N, 3C) qkv projection;
  tolerance 1e-4 relative / 1e-5 absolute (tests/test_attention_vjp.py's);
* conv3x3: `_conv3x3_bwd` (XLA's transpose convs) for dx and dw, and the
  vjp of the JAX conv with its bias for db;
* up2x and the DPT tail: `jax.vjp` of the JAX head's
  `upsample2x_align_corners` and of its last lines (conv, ReLU, 1x1,
  postprocess); tolerance 1e-5 of the largest gradient.
Each test also checks that the route went through the Function.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dust3r_tpu.models import heads as jheads
from dust3r_tpu.ops import conv3x3 as jconv
from dust3r_tpu.ops.attention import _attention_pallas_bwd, attention_ref as jax_attention_ref
from dust3r_tpu_torch.models.blocks import token_positions
from dust3r_tpu_torch.ops.attention import KernelAttention, attention
from dust3r_tpu_torch.ops.conv3x3 import KernelConv3x3, conv3x3
from dust3r_tpu_torch.ops.dpt_tail import KernelDptTail, dpt_tail
from dust3r_tpu_torch.ops.upsample import KernelUp2x, up2x

ATOL, RTOL = 1e-5, 1e-4


def _through(out, fn):
    return type(out.grad_fn).__name__ == fn.__name__ + "Backward"


def _rel_close(got, want, tol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-12)


@pytest.mark.parametrize("rope", [True, False])
@pytest.mark.parametrize("nq,nk", [(12, 12), (12, 20)])
def test_attention_backward_matches_jax(rope, nq, nk):
    rng = np.random.default_rng(nq + nk + rope)
    B, H, d = 2, 3, 16
    q, k, v = (rng.standard_normal((B, H, n, d)).astype(np.float32) for n in (nq, nk, nk))
    g = rng.standard_normal((B, H, nq, d)).astype(np.float32)
    pq = rng.integers(0, 8, (B, nq, 2)).astype(np.int32) if rope else None
    pk = rng.integers(0, 8, (B, nk, 2)).astype(np.int32) if rope else None
    jpq, jpk = (None if p is None else jnp.asarray(p) for p in (pq, pk))
    _, vjp = jax.vjp(lambda q, k, v: jax_attention_ref(q, k, v, jpq, jpk), q, k, v)
    want_vjp = vjp(jnp.asarray(g))
    want_bwd = _attention_pallas_bwd(100.0, (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                             jpq, jpk), jnp.asarray(g))[:3]
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tpq, tpk = (None if p is None else torch.from_numpy(p) for p in (pq, pk))
    out = attention(tq, tk, tv, tpq, tpk, 100.0, impl="kernel")
    assert _through(out, KernelAttention)
    assert not _through(attention(tq, tk, tv, tpq, tpk, 100.0, impl="plain"), KernelAttention)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    for a, b, c in zip(got, want_bwd, want_vjp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=RTOL, atol=ATOL)


def test_attention_backward_through_strided_qkv_views():
    """Self-attention reads q, k and v out of one (B, N, 3C) projection and
    cross-attention head-packed (B, N, C) ones, as the model's blocks do:
    the gradient lands in those bases."""
    rng = np.random.default_rng(5)
    B, Ht, Wt, H, d = 2, 3, 4, 2, 16
    N, C = Ht * Wt, H * d
    qkv = rng.standard_normal((B, N, 3 * C)).astype(np.float32)
    g = rng.standard_normal((B, H, N, d)).astype(np.float32)
    pos = token_positions(B, Ht, Wt)

    def jax_fn(qkv):
        q, k, v = qkv.reshape(B, N, 3, H, d).transpose(2, 0, 3, 1, 4)
        return jax_attention_ref(q, k, v, jnp.asarray(pos.numpy()), jnp.asarray(pos.numpy()))

    _, vjp = jax.vjp(jax_fn, jnp.asarray(qkv))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    tqkv = torch.from_numpy(qkv).requires_grad_()
    q, k, v = tqkv.view(B, N, 3, H, d).permute(2, 0, 3, 1, 4)
    assert q.stride(-1) == 1 and not q.is_contiguous()
    out = attention(q, k, v, pos, pos, 100.0, impl="kernel")
    assert _through(out, KernelAttention)
    got = torch.autograd.grad(out, tqkv, torch.from_numpy(g))[0].numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # cross-attention: head views of (B, N, C) tensors, Nk != Nq
    xq = torch.from_numpy(qkv[:, :, :C].copy()).requires_grad_()
    xk = torch.from_numpy(qkv[:, :7, C:2 * C].copy()).requires_grad_()
    heads = [t.view(B, -1, H, d).transpose(1, 2) for t in (xq, xk, xk)]
    out = attention(*heads, impl="kernel")
    got = torch.autograd.grad(out, (xq, xk), torch.from_numpy(g))
    _, vjp = jax.vjp(lambda a, b: jax_attention_ref(
        a.reshape(B, N, H, d).transpose(0, 2, 1, 3), b.reshape(B, 7, H, d).transpose(0, 2, 1, 3),
        b.reshape(B, 7, H, d).transpose(0, 2, 1, 3)), jnp.asarray(xq.detach().numpy()),
        jnp.asarray(xk.detach().numpy()))
    for a, b in zip(got, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("bias", [True, False])
def test_conv3x3_backward_matches_jax(bias):
    rng = np.random.default_rng(int(bias))
    B, H, W, cin, cout = 2, 6, 7, 32, 64
    x = rng.standard_normal((B, H, W, cin)).astype(np.float32)
    w = (rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32) if bias else None
    g = rng.standard_normal((B, H, W, cout)).astype(np.float32)
    dx, dw = jconv._conv3x3_bwd((jnp.asarray(x), jnp.asarray(w)), jnp.asarray(g))
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()  # channels_last memory
    tw = torch.from_numpy(w).permute(3, 2, 0, 1).contiguous().requires_grad_()
    tb = None if b is None else torch.from_numpy(b).requires_grad_()
    out = conv3x3(tx, tw, tb, impl="kernel")
    assert _through(out, KernelConv3x3)
    leaves = (tx, tw) + ((tb,) if bias else ())
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g).permute(0, 3, 1, 2))
    _rel_close(got[0].permute(0, 2, 3, 1).numpy(), dx)
    _rel_close(got[1].permute(2, 3, 1, 0).numpy(), dw)
    if bias:
        _, vjp = jax.vjp(lambda bb: jconv.conv3x3(jnp.asarray(x), jnp.asarray(w), bb, "ref"),
                         jnp.asarray(b))
        _rel_close(got[2].numpy(), vjp(jnp.asarray(g))[0])


@pytest.mark.parametrize("hw", [(5, 7), (12, 16)])
def test_up2x_backward_matches_jax(hw):
    rng = np.random.default_rng(hw[0])
    x = rng.standard_normal((2, *hw, 8)).astype(np.float32)
    g = rng.standard_normal((2, 2 * hw[0], 2 * hw[1], 8)).astype(np.float32)
    _, vjp = jax.vjp(jheads.upsample2x_align_corners, jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    out = up2x(tx, impl="kernel")
    assert _through(out, KernelUp2x)
    got = torch.autograd.grad(out, tx, torch.from_numpy(g).permute(0, 3, 1, 2))[0]
    _rel_close(got.permute(0, 2, 3, 1).numpy(), want)


def _jax_tail(y, w2, b2, w3, b3):
    """The JAX DPT head's last lines: head_conv2, ReLU, head_conv3 (1x1),
    postprocess."""
    h = jax.nn.relu(jconv.conv3x3_ref(y, w2, b2))
    out = jnp.einsum("bhwc,cn->bhwn", h, w3[0, 0]) + b3
    res = jheads.postprocess(out, ("exp", -np.inf, np.inf), ("exp", 1.0, np.inf))
    return res["pts3d"], res["conf"]


def test_dpt_tail_backward_matches_jax():
    rng = np.random.default_rng(9)
    B, H, W = 2, 6, 5
    y = (0.3 * rng.standard_normal((B, H, W, 128))).astype(np.float32)
    w2 = (rng.standard_normal((3, 3, 128, 32)) / np.sqrt(9 * 128)).astype(np.float32)
    b2 = (0.1 * rng.standard_normal(32)).astype(np.float32)
    w3 = (0.2 * rng.standard_normal((1, 1, 32, 4))).astype(np.float32)
    b3 = (0.1 * rng.standard_normal(4)).astype(np.float32)
    gp = rng.standard_normal((B, H, W, 3)).astype(np.float32)
    gc = rng.standard_normal((B, H, W)).astype(np.float32)
    _, vjp = jax.vjp(_jax_tail, *(jnp.asarray(a) for a in (y, w2, b2, w3, b3)))
    want = vjp((jnp.asarray(gp), jnp.asarray(gc)))
    ty = torch.from_numpy(y).permute(0, 3, 1, 2).requires_grad_()
    tw2 = torch.from_numpy(w2).permute(3, 2, 0, 1).contiguous().requires_grad_()
    tw3 = torch.from_numpy(w3).permute(3, 2, 0, 1).contiguous().requires_grad_()
    tb2, tb3 = (torch.from_numpy(a).requires_grad_() for a in (b2, b3))
    pts, conf = dpt_tail(ty, tw2, tb2, tw3, tb3, 1.0, impl="kernel")
    assert _through(pts, KernelDptTail)
    got = torch.autograd.grad((pts, conf), (ty, tw2, tb2, tw3, tb3),
                              (torch.from_numpy(gp), torch.from_numpy(gc)))
    _rel_close(got[0].permute(0, 2, 3, 1).numpy(), want[0])
    _rel_close(got[1].permute(2, 3, 1, 0).numpy(), want[1])
    _rel_close(got[2].numpy(), want[2])
    _rel_close(got[3].permute(2, 3, 1, 0).numpy(), want[3])
    _rel_close(got[4].numpy(), want[4])


def test_kernel_routes_add_no_graph_under_inference_mode():
    """Serving runs under inference_mode: the Functions' outputs carry no
    graph there."""
    x = torch.randn(1, 32, 4, 4).contiguous(memory_format=torch.channels_last)
    w = torch.randn(32, 32, 3, 3, requires_grad=True)
    with torch.inference_mode():
        assert conv3x3(x, w, None, impl="kernel").grad_fn is None
        assert up2x(x, impl="kernel").grad_fn is None
