"""The probes' host-side pieces: the step probe's kernel kinds, the
alternating order of its runs, and the swap of the four kernels' entry
points for their plain versions (undone on leaving, also on an error); the
flash-variants tool's edits of the kernel header and its library swap; the
pixel probe's settings and inputs."""

import pytest

from cyclediffusion_tpu_torch.ops import cuda_build
from cyclediffusion_tpu_torch.ops import flash_attention as fa
from cyclediffusion_tpu_torch.tools import flash_variants, pixel_probe, step_probe


@pytest.mark.parametrize("name,kind", [
    ("void (anonymous namespace)::flash_fwd_bf16_kernel<40>(__nv_bfloat16 const*)",
     "flash kernels (K1, K2)"),
    ("void (anonymous namespace)::qout_bf16_kernel<40>(__nv_bfloat16 const*)",
     "folded kernels (K3, K4)"),
    ("(anonymous namespace)::kv_proj_bf16_kernel(__nv_bfloat16 const*)",
     "folded kernels (K3, K4)"),
    ("(anonymous namespace)::hopper::linear_bf16_kernel(CUtensorMap, CUtensorMap)",
     "folded kernels (K3, K4)"),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel<__nv_bfloat16>", "cuDNN layout conversions"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc", "convolutions"),
    ("nvjet_tst_168x128_64x5_1x2_h_bz_coopA_bias_TNN", "GEMMs"),
    ("void at::native::(anonymous namespace)::RowwiseMomentsCUDAKernel<c10::BFloat16>", "GroupNorm"),
    ("void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<c10::BFloat16>",
     "LayerNorm"),
    ("void at::native::elementwise_kernel<128, 4, direct_copy_kernel_cuda>", "copies"),
    ("void at::native::elementwise_kernel<128, 4, CUDAFunctor_add<c10::BFloat16>>", "elementwise"),
    ("some_new_kernel", "other"),
])
def test_kernel_kind(name, kind):
    assert step_probe.kernel_kind(name) == kind


def test_alternating_order():
    assert list(step_probe.alternating(3)) == [
        "kernels", "plain", "plain", "kernels", "kernels", "plain"]
    assert list(step_probe.alternating(2, step_probe.FOLDED_MODES)) == [
        "default", "qo", "1", "1", "qo", "default"]


def test_attention_swap_is_undone():
    """All four kernels' entry points go to their plain versions inside the
    block and come back on leaving, also on an error."""
    names = list(step_probe.PLAIN_VERSIONS)
    kernels = [getattr(fa, n) for n in names]
    with step_probe.attention("kernels"):
        assert [getattr(fa, n) for n in names] == kernels
    with pytest.raises(RuntimeError):
        with step_probe.attention("plain"):
            for name, plain in step_probe.PLAIN_VERSIONS.items():
                assert getattr(fa, name) is getattr(fa, plain)
            raise RuntimeError("inside")
    assert [getattr(fa, n) for n in names] == kernels
    assert len(names) == 4


@pytest.mark.parametrize("name", list(flash_variants.VARIANTS))
def test_flash_variants_edit_the_shipped_header_once(name):
    """Each variant of the flash-variants tool is the shipped header with
    each of its substitutions found exactly once (a changed header that a
    variant no longer matches fails here, not on the card)."""
    text = (cuda_build.CSRC_DIR / flash_variants.HEADER).read_text()
    for old, new in flash_variants.VARIANTS[name]:
        assert old != new and text.count(old) == 1


def test_flash_variants_library_swap_is_undone():
    saved = fa._library
    with pytest.raises(RuntimeError):
        with flash_variants.kernels_of("handle"):
            assert fa._library("flash_attention")[1] == "handle"
            raise RuntimeError("inside")
    assert fa._library is saved


def test_pixel_probe_settings_and_inputs():
    """Every precision x layout x determinism once; the ``nchw`` input is an
    NHWC view of a contiguous NCHW tensor, the ``nhwc`` one is contiguous
    NHWC, both holding the same values; the flags follow the setting."""
    import torch

    assert len(set(pixel_probe.SETTINGS)) == len(pixel_probe.SETTINGS) == 12
    models = {"fp32": lambda x, t: x, "bf16": lambda x, t: x}
    x = torch.randn(2, 4, 4, 3)
    nhwc = pixel_probe._step(models, x, None, ("fp32", "nhwc", False))()
    nchw = pixel_probe._step(models, x, None, ("tf32", "nchw", False))()
    assert nhwc.is_contiguous() and nchw.permute(0, 3, 1, 2).is_contiguous()
    assert torch.equal(nhwc, nchw)
    assert pixel_probe._step(models, x, None, ("bf16", "nhwc", True))().dtype == torch.bfloat16
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic)
    try:
        pixel_probe._apply(("tf32", "nchw", True))
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cudnn.deterministic
        pixel_probe._apply(("fp32", "nhwc", False))
        assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cudnn.deterministic
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic = saved
