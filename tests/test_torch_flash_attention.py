"""The port's flash-attention module against the JAX package's Pallas kernels.

On the CPU each wrapper runs its kernel's plain version; here it is held to
the Pallas kernel run in interpret mode, at the shapes of
``tests/test_flash_attention.py``, with that file's fp32 tolerance (1e-5).
The CUDA kernels themselves are compared with these plain versions on the
card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cyclediffusion_tpu.ops import flash_attention as jfa
from cyclediffusion_tpu_torch.ops import flash_attention as fa
from cyclediffusion_tpu_torch.ops import launches
from test_torch_common import to_torch


def _qkv(shape_q, shape_kv, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal(shape_q).astype(np.float32)
    k = rng.standard_normal(shape_kv).astype(np.float32)
    v = rng.standard_normal(shape_kv).astype(np.float32)
    return q, k, v


# then: chip_smoke.py's ragged K1 shapes, Tq and Tk off the CUDA kernel's
# 128-row q and key tiles, one key axis shorter than a tile; d = 32 at the
# FFHQ/CelebA LDM's 1024 tokens and at a ragged length
@pytest.mark.parametrize("tq,tk,d", [(300, 512, 40), (1024, 512, 80),
                                     (1024, 77, 40), (512, 200, 64),
                                     (300, 333, 40), (200, 77, 64), (333, 515, 80),
                                     (1024, 1024, 32), (300, 333, 32)])
def test_bhtd_plain_matches_pallas_fp32(tq, tk, d):
    b, h = 1, 2
    q, k, v = _qkv((b, h, tq, d), (b, h, tk, d))
    scale = 1.0 / np.sqrt(d)
    want = jfa.flash_attention_bhtd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    scale, interpret=True)
    got = fa.flash_attention_bhtd(to_torch(q), to_torch(k), to_torch(v), scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert launches.counts["flash_attention_bhtd"] == 0   # plain, not a launch


# (1000, 1100, 40, 8): chip_smoke.py's ragged K2 shape, off the 128-row tiles
@pytest.mark.parametrize("tq,tk,d,heads", [(2048, 2048, 40, 8), (1024, 77, 40, 8),
                                           (300, 200, 64, 4), (1000, 1100, 40, 8),
                                           (300, 200, 32, 14)])
def test_packed_plain_matches_pallas_fp32(tq, tk, d, heads):
    b = 2
    q, k, v = _qkv((b, tq, heads * d), (b, tk, heads * d))
    scale = 1.0 / np.sqrt(d)
    want = jfa.flash_attention_packed(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      heads, scale, interpret=True)
    got = fa.flash_attention_packed(to_torch(q), to_torch(k), to_torch(v), heads, scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert launches.counts["flash_attention_packed"] == 0


def test_bhtd_takes_strided_head_views():
    """The dispatcher hands K1 head-transposed views of token-major tensors."""
    b, t, h, d = 1, 64, 2, 40
    q, k, v = (to_torch(x) for x in _qkv((b, t, h * d), (b, t, h * d), seed=1))
    views = [x.reshape(b, t, h, d).transpose(1, 2) for x in (q, k, v)]
    got = fa.flash_attention_bhtd(*views, 0.2)
    want = fa.attention_reference(*[x.contiguous() for x in views], 0.2)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("tq,tk,route", [(4096, 4096, "packed"), (1024, 1024, "bhtd"),
                                         (256, 256, "plain"), (4096, 77, "plain"),
                                         (1024, 77, "plain"), (2048, 512, "packed")])
def test_dispatch_routes_sd_shapes(tq, tk, route):
    assert fa.attention_route(tq, tk) == route


def test_dispatcher_matches_jax_einsum_path_fp32():
    """Through the dispatcher (K1 route at T=1024, H=8, d=80: the SD 32x32
    level) the port agrees with the JAX dispatcher's CPU einsum path."""
    b, t, heads, d = 1, 1024, 8, 80
    q, k, v = _qkv((b, t, heads * d), (b, t, heads * d), seed=2)
    want = jfa.multi_head_attention_fused(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), heads)
    got = fa.multi_head_attention_fused(to_torch(q), to_torch(k), to_torch(v), heads)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_plain_bf16_within_tolerance():
    """bf16 plain attention (weights rounded to bf16 before P.V) stays
    within the JAX bf16 kernel test's 2e-2 of the fp32 result."""
    b, h, t, d = 1, 2, 512, 40
    q, k, v = (to_torch(x, torch.bfloat16) for x in _qkv((b, h, t, d), (b, h, t, d)))
    out = fa.flash_attention_bhtd(q, k, v, 1.0 / np.sqrt(d))
    ref = fa.attention_reference(q.float(), k.float(), v.float(), 1.0 / np.sqrt(d))
    assert out.dtype == torch.bfloat16
    assert float((out.float() - ref).abs().max()) < 2e-2


@pytest.mark.parametrize("bad", ["heads", "kv_shape", "empty"])
def test_wrappers_reject_bad_shapes(bad):
    q = torch.zeros(1, 64, 80)
    k = torch.zeros(1, 32, 80)
    v = torch.zeros(1, 32, 80)
    if bad == "heads":
        args = (q, k, v, 3, 1.0)
    elif bad == "kv_shape":
        args = (q, k, torch.zeros(1, 31, 80), 2, 1.0)
    else:
        args = (q, k[:, :0], v[:, :0], 2, 1.0)
    with pytest.raises(ValueError):
        fa.flash_attention_packed(*args)


@pytest.mark.parametrize("case,copied", [
    ("contiguous", False), ("head_view", False), ("broadcast", True),
    ("size_one_zero_stride", False), ("misaligned_rows", True)])
def test_kernel_ready_copies_what_the_tensor_maps_refuse(case, copied):
    """A bf16 operand reaches the kernel as it is when TMA can map it:
    16-byte aligned, strides in multiples of 8 elements and nonzero (a dim
    of size 1 takes any); otherwise as a contiguous copy."""
    x = torch.zeros(2, 64, 4 * 40, dtype=torch.bfloat16)
    view = {
        "contiguous": x.view(2, 64, 4, 40).transpose(1, 2).contiguous(),
        "head_view": x.view(2, 64, 4, 40).transpose(1, 2),
        "broadcast": x[:1, :, :40].view(1, 1, 64, 40).expand(2, 4, 64, 40),
        "size_one_zero_stride": x[:1, :, :40].view(1, 1, 64, 40).expand(1, 1, 64, 40)
                                 .as_strided((1, 1, 64, 40), (0, 0, 160, 1)),
        "misaligned_rows": torch.zeros(1, 1, 64, 44, dtype=torch.bfloat16)[..., :40],
    }[case]
    ready = fa._kernel_ready(view, contiguous=False)
    assert (ready is not view) == copied
    assert torch.equal(ready, view)
    if copied:
        assert ready.is_contiguous()


def test_kernel_input_checks_refuse_non_cuda_tensors():
    """The kernel path is taken only for CUDA tensors; its checks refuse any
    other device rather than fall back."""
    q = torch.zeros(1, 2, 64, 40, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_bhtd(q, q, q, 1.0)


def test_dispatcher_at_the_ffhq_level_matches_jax_fp32():
    """The FFHQ/CelebA LDM's ds-2 attention through the dispatcher: 1024
    tokens of 14 heads x 32 (the K1 route) against the JAX dispatcher."""
    b, t, heads, d = 1, 1024, 14, 32
    q, k, v = _qkv((b, t, heads * d), (b, t, heads * d), seed=3)
    assert fa.attention_route(t, t) == "bhtd"
    want = jfa.multi_head_attention_fused(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), heads)
    got = fa.multi_head_attention_fused(to_torch(q), to_torch(k), to_torch(v), heads)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d,accepted", [(32, True), (40, True), (48, False), (96, False)])
def test_head_dims_the_wrappers_take(d, accepted):
    """K1/K2 take d in SUPPORTED_HEAD_DIMS (32 for the FFHQ/CelebA LDM);
    K3/K4 keep 40, 64, 80, the dims phase 3 holds them at on the card, and
    refuse any other before a launch."""
    assert (d in fa.SUPPORTED_HEAD_DIMS) == accepted
    assert set(fa.FOLDED_HEAD_DIMS) == {40, 64, 80}
    if d not in fa.FOLDED_HEAD_DIMS:
        with pytest.raises(ValueError, match=f"head dim {d}"):
            fa._check_folded_limits("qout_self_attention_block", torch.bfloat16, 1, 64, 64,
                                    64, d, 2)
