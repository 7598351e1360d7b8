"""The folded self-attention kernels K3/K4 of the port against the JAX
package.

On the CPU each wrapper runs its kernel's plain version; here it is held to
the Pallas kernel run in interpret mode, at the shapes of
``tests/test_flash_attention.py``, with that file's fp32 tolerance (1e-5).
The port's ``CrossAttention`` in each folded mode is held to the JAX module
(which takes its default path off the TPU) at fp32, 1e-5: the same function,
summed in another order.  The CUDA kernels themselves are compared with
these plain versions on the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cyclediffusion_tpu.models.transformer import CrossAttention as JCrossAttention
from cyclediffusion_tpu.ops import flash_attention as jfa
from cyclediffusion_tpu_torch.convert.from_jax import load_flax_params
from cyclediffusion_tpu_torch.models.transformer import BasicTransformerBlock, CrossAttention
from cyclediffusion_tpu_torch.models.unet_gd import GDUNet, GDUNetConfig
from cyclediffusion_tpu_torch.ops import flash_attention as fa
from test_torch_common import fill_flax_tree, to_torch


def _block_inputs(t, c, heads, d, seed):
    """x (2, t, c) and Flax-layout weights wq/wk/wv (c, h*d), wo (h*d, c), bo."""
    rng = np.random.default_rng(seed)
    hd = heads * d
    x = rng.standard_normal((2, t, c)).astype(np.float32)
    wq, wk, wv = (rng.standard_normal((c, hd)).astype(np.float32) / np.sqrt(c)
                  for _ in range(3))
    wo = rng.standard_normal((hd, c)).astype(np.float32) / np.sqrt(hd)
    bo = rng.standard_normal((c,)).astype(np.float32)
    return x, wq, wk, wv, wo, bo


def _linear(w):
    """A Flax kernel (in, out) as the port's nn.Linear weight (out, in)."""
    return to_torch(np.ascontiguousarray(w.T))


@pytest.mark.parametrize("t,c,heads,d,bq,bk", [
    (2048, 320, 8, 40, 512, 2048),   # SD 64x64 geometry
    (512, 64, 4, 16, 128, 256),      # several q and k blocks
    (1000, 64, 4, 16, 512, 2048),    # ragged T: key masking
])
def test_fused_plain_matches_pallas_fp32(t, c, heads, d, bq, bk):
    x, wq, wk, wv, wo, bo = _block_inputs(t, c, heads, d, 0)
    want = jfa.fused_self_attention_block(
        *(jnp.asarray(a) for a in (x, wq, wk, wv, wo, bo)), heads,
        block_q=bq, block_k=bk, interpret=True)
    got = fa.fused_self_attention_block(to_torch(x), _linear(wq), _linear(wk),
                                        _linear(wv), _linear(wo), to_torch(bo), heads)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert fa.launch_counts["fused_self_attention_block"] == 0   # plain, not a launch


@pytest.mark.parametrize("t,tk,c,heads,d,bq,bk", [
    (512, 512, 64, 4, 16, 128, 256),     # several q and k blocks
    (1000, 1000, 64, 4, 16, 512, 2048),  # ragged T: key masking
    (300, 200, 64, 4, 16, 128, 128),     # Tq != Tk
])
def test_qout_plain_matches_pallas_fp32(t, tk, c, heads, d, bq, bk):
    x, wq, wk, wv, wo, bo = _block_inputs(t, c, heads, d, 3)
    x_kv = np.random.default_rng(4).standard_normal((2, tk, c)).astype(np.float32)
    k, v = x_kv @ wk, x_kv @ wv
    want = jfa.qout_self_attention_block(
        *(jnp.asarray(a) for a in (x, wq, k, v, wo, bo)), heads,
        block_q=bq, block_k=bk, interpret=True)
    got = fa.qout_self_attention_block(to_torch(x), _linear(wq), to_torch(k), to_torch(v),
                                       _linear(wo), to_torch(bo), heads)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert fa.launch_counts["qout_self_attention_block"] == 0


def test_plain_versions_round_where_the_kernels_do():
    """bf16: q, the softmax weights, the attention and the output are
    rounded to bf16 once each; the output stays within the JAX bf16 module
    test's 3e-2 of the fp32 function."""
    x, wq, wk, wv, wo, bo = _block_inputs(256, 64, 4, 16, 5)
    args32 = (to_torch(x), _linear(wq), _linear(wk), _linear(wv), _linear(wo),
              to_torch(bo))
    ref = fa.fused_self_attention_block(*args32, 4)
    out = fa.fused_self_attention_block(*(a.to(torch.bfloat16) for a in args32), 4)
    assert out.dtype == torch.bfloat16
    assert float((out.float() - ref).abs().max()) < 3e-2


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2 ** -7)])
def test_linear_reference_rounds_as_the_pallas_kernels_project(dtype, tol, bias):
    """The projection kernel's plain version against the Pallas kernels'
    in-body projections (``_qout_kernel``'s q, ``_project_flush``'s output):
    a dot accumulated in fp32, + the bias in fp32, cast once.  fp32: the
    summation order differs; bf16: at most one bf16 ulp (2^-7 relative)."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 64, 96)).astype(np.float32)
    w = (rng.standard_normal((96, 128)) / np.sqrt(96)).astype(np.float32)   # Flax (in, out)
    b = rng.standard_normal((128,)).astype(np.float32)
    xj, wj, bj = (jnp.asarray(a).astype(dtype) for a in (x, w, b))
    want = jax.lax.dot_general(xj, wj, (((2,), (0,)), ((), ())),
                               preferred_element_type=jnp.float32)
    if bias:
        want = want + bj.astype(jnp.float32)
    want = np.asarray(want.astype(dtype).astype(jnp.float32))
    tdt = getattr(torch, dtype)
    got = fa.linear_reference(to_torch(x).to(tdt), _linear(w).to(tdt),
                              to_torch(b).to(tdt) if bias else None)
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=1e-6)


@pytest.mark.parametrize("bias", [False, True])
def test_linear_wrapper_on_cpu_is_its_plain_version(bias):
    """On CPU tensors the projection kernel's wrapper is linear_reference,
    for any leading shape; it counts no launches."""
    gen = torch.Generator().manual_seed(9)
    x = torch.randn(2, 3, 64, generator=gen).to(torch.bfloat16)
    w = torch.randn(128, 64, generator=gen).to(torch.bfloat16)
    b = torch.randn(128, generator=gen).to(torch.bfloat16) if bias else None
    before = dict(fa.launch_counts)
    got = fa.linear(x, w, b)
    assert got.shape == (2, 3, 128) and got.dtype == torch.bfloat16
    assert torch.equal(got, fa.linear_reference(x, w, b))
    assert fa.launch_counts == before


@pytest.mark.parametrize("bad", ["x", "bias"])
def test_linear_wrapper_rejects_bad_shapes(bad):
    x, w, b = torch.zeros(4, 64), torch.zeros(128, 64), torch.zeros(128)
    if bad == "x":
        x = torch.zeros(4, 32)
    else:
        b = torch.zeros(64)
    with pytest.raises(ValueError, match="shapes"):
        fa.linear(x, w, b)


def test_linear_wrapper_refuses_non_cuda_tensors():
    x, w = torch.zeros(4, 64, device="meta"), torch.zeros(128, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fa.linear(x, w)


@pytest.mark.parametrize("dtype,b,t,c,hd,d,heads,ok", [
    (torch.bfloat16, 4, 4096, 320, 320, 40, 8, True),       # the SD 64x64 level
    (torch.bfloat16, 2, 300, 256, 256, 64, 4, True),        # chip_smoke's ragged shape
    (torch.bfloat16, 1, 64, 448, 448, 64, 7, True),         # the widest the bf16 path takes
    (torch.bfloat16, 1, 64, 512, 320, 40, 8, False),        # C past the projection's X tile
    (torch.bfloat16, 1, 64, 320, 512, 64, 8, False),        # H*D past it
    (torch.bfloat16, 8192, 64, 320, 320, 40, 8, False),     # B*H past the grid's y axis
    (torch.float32, 1, 64, 512, 512, 64, 8, True),          # fp32 has no width limit
    (torch.float32, 1, 65535 * 64 + 1, 64, 64, 64, 1, False),  # fp32 [k | v] grid
    (torch.bfloat16, 1, 64, 320, 320, 32, 10, False),       # head dim 32
    (torch.float32, 1, 64, 96, 96, 48, 2, False),           # widths not multiples of 64
])
def test_folded_kernel_limits(dtype, b, t, c, hd, d, heads, ok):
    """The folded kernels' shape limits by dtype: bf16 runs the projection
    kernel (C, H*D <= LINEAR_MAX_K) and the attention kernel (B*H <= 65535);
    fp32 its own kernels (B*T <= 65535 * 64)."""
    args = ("fused_self_attention_block", dtype, b, t, c, hd, d, heads)
    if ok:
        fa._check_folded_limits(*args)
    else:
        with pytest.raises(ValueError):
            fa._check_folded_limits(*args)


@pytest.mark.parametrize("mode", ["qo", "1"])
def test_cross_attention_folded_matches_jax_module(mode):
    """Self-attention over 2048 tokens (the folded threshold) in each folded
    mode against the JAX module with the same weights."""
    b, t, c, heads, d = 1, 2048, 64, 4, 16
    jmod = JCrossAttention(heads=heads, dim_head=d)
    x = np.random.default_rng(6).standard_normal((b, t, c)).astype(np.float32)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, c)))
    tree = fill_flax_tree(shapes, 7)
    want = jmod.apply(jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    mod = CrossAttention(c, heads, d, folded_attn=mode)
    load_flax_params(mod, tree)
    with torch.no_grad():
        got = mod(to_torch(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_cross_attention_folds_only_long_self_attention(monkeypatch):
    """The folded kernels see self-attention of >= 2048 tokens only; cross-
    attention and shorter sequences keep the separate projections."""
    calls = []
    monkeypatch.setattr(fa, "qout_self_attention_block",
                        lambda *a: calls.append(a[0].shape) or a[0])
    # frozen, as the core freezes its modules: the kernels refuse a gradient
    mod = CrossAttention(32, 2, 16, folded_attn="qo").requires_grad_(False)
    mod(torch.zeros(1, 2048, 32))
    mod(torch.zeros(1, 1024, 32))
    mod(torch.zeros(1, 2048, 32), context=torch.zeros(1, 77, 32))
    assert calls == [(1, 2048, 32)]


def test_cross_attention_rejects_unknown_mode():
    with pytest.raises(ValueError, match="folded_attn"):
        CrossAttention(32, 2, 16, folded_attn="yes")


def test_unet_passes_folded_attn_to_every_self_attention():
    unet = GDUNet(GDUNetConfig.tiny(), folded_attn="1")
    blocks = [m for m in unet.modules() if isinstance(m, BasicTransformerBlock)]
    assert blocks
    assert all(b.attn1.folded_attn == "1" and b.attn2.folded_attn is None for b in blocks)


@pytest.mark.parametrize("bad", ["heads", "wo", "kv", "empty"])
def test_folded_wrappers_reject_bad_shapes(bad):
    x = torch.zeros(1, 64, 32)
    w, wo, bo = torch.zeros(32, 32), torch.zeros(32, 32), torch.zeros(32)
    k = v = torch.zeros(1, 16, 32)
    heads = 3 if bad == "heads" else 2
    if bad == "wo":
        wo = torch.zeros(32, 16)
    if bad == "kv":
        v = torch.zeros(1, 15, 32)
    if bad == "empty":
        k = v = torch.zeros(1, 0, 32)
    with pytest.raises(ValueError):
        fa.qout_self_attention_block(x, w, k, v, wo, bo, heads)
    if bad in ("heads", "wo"):
        with pytest.raises(ValueError):
            fa.fused_self_attention_block(x, w, w, w, wo, bo, heads)


def test_folded_kernel_checks_refuse_non_cuda_tensors():
    """The kernel path is taken only for CUDA tensors; its checks refuse any
    other device rather than fall back."""
    x = torch.zeros(1, 64, 320, device="meta")
    w, b = torch.zeros(320, 320, device="meta"), torch.zeros(320, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fa.fused_self_attention_block(x, w, w, w, w, b, 8)
    with pytest.raises(ValueError, match="CUDA"):
        fa.qout_self_attention_block(x, w, x, x, w, b, 8)
