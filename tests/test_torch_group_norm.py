"""``ops/group_norm.py``: the plain version on the CPU, the launch shape the
wrapper picks, the models' channels-last layout, and (marked ``card``) the
CUDA kernels against the plain version and on the main path.

This file imports no JAX: on the card it runs alone,

    python3 -m pytest tests/test_torch_group_norm.py --noconftest -m card -p no:cacheprovider

and the ``card`` tests skip wherever ``torch.cuda.is_available()`` is false
(decided inside the ``card`` fixture, when a test runs).  The models'
parity with the JAX package, GroupNorm's included, is
``test_torch_models.py``'s and the other parity files'.
"""

import dataclasses
import types

import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from cyclediffusion_tpu_torch.models import nn as tnn
from cyclediffusion_tpu_torch.models.autoencoder import AutoencoderKL, DDConfig, VQModel
from cyclediffusion_tpu_torch.models.unet_ddpm import DDPMUNet, DDPMUNetConfig
from cyclediffusion_tpu_torch.models.unet_gd import GDResBlock, GDUNet, GDUNetConfig
from cyclediffusion_tpu_torch.ops import group_norm as gn
from cyclediffusion_tpu_torch.ops import launches
from cyclediffusion_tpu_torch.runtime import graphs

CL = torch.channels_last


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (on the card: pytest tests/test_torch_group_norm.py "
                    "--noconftest -m card)")
    return torch.device("cuda")


def _is_channels_last(t) -> bool:
    return t.movedim(1, -1).is_contiguous()


def _input(shape, dtype=torch.float32, layout="channels_last", seed=0, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn(shape, generator=gen) * 2.0 + 0.7).to(dtype)
    if layout == "channels_last":
        x = x.movedim(1, -1).contiguous().movedim(-1, 1)
    return x.to(device)


def _affine(c, dtype=torch.float32, seed=1, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    w = (1.0 + 0.1 * torch.randn(c, generator=gen)).to(dtype).to(device)
    b = (0.1 * torch.randn(c, generator=gen)).to(dtype).to(device)
    return w, b


def _gn_launches():
    """(forwards, gradients) of the GroupNorm kernels counted since the last
    reset."""
    return launches.counts["group_norm"], launches.counts["group_norm_backward"]


# ---- the plain version on the CPU ----------------------------------------- #

@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,groups,layout", [
    ((2, 64, 6, 5), 32, "channels_last"),
    ((2, 64, 6, 5), 32, "contiguous"),
    ((3, 40, 17), 4, "channels_last"),          # GDAttentionBlock's (b, c, tokens)
    ((1, 16, 4, 4), 16, "channels_last"),       # a tiny config's clamped groups
])
def test_plain_matches_functional_group_norm(shape, groups, layout, dtype, silu):
    """The plain version is F.group_norm (+ F.silu) up to the order of the
    statistics' sums, and gives a channels-last view whatever the input's
    layout.  Tolerance: fp32 1e-5; bf16 one rounding of the result (2^-8
    relative, on values up to ~5)."""
    x = _input(shape, dtype, layout)
    w, b = _affine(shape[1], dtype)
    got = gn.group_norm(x, w, b, groups, 1e-5, silu=silu)
    want = F.group_norm(x.float(), groups, w.float(), b.float(), 1e-5).to(dtype)
    want = F.silu(want) if silu else want
    assert got.shape == x.shape and got.dtype == dtype and _is_channels_last(got)
    tol = 1e-5 if dtype == torch.float32 else 5 * 2.0 ** -8
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert _gn_launches() == (0, 0)


def test_plain_gradients_match_functional_group_norm():
    """Autograd through the plain version (the CPU's path) gives
    F.group_norm's gradients, input and weights, with the SiLU fused."""
    x = _input((2, 32, 5, 4)).requires_grad_(True)
    w, b = (t.requires_grad_(True) for t in _affine(32))
    dy = _input((2, 32, 5, 4), seed=2)
    got = torch.autograd.grad(gn.group_norm(x, w, b, 8, 1e-6, silu=True), (x, w, b), dy)
    want = torch.autograd.grad(F.silu(F.group_norm(x, 8, w, b, 1e-6)), (x, w, b), dy)
    for g, h in zip(got, want):
        torch.testing.assert_close(g, h, rtol=1e-4, atol=1e-5)


def _shift(n, c, dtype=torch.float32, seed=4, device="cpu"):
    """A per-sample, per-channel shift on the scale of ``_input``'s values."""
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn(n, c, generator=gen) * 1.5 - 0.3).to(dtype).to(device)


def _shifted(x, shift):
    """``x + shift`` broadcast over the spatial axes, in fp32 (not rounded)."""
    return x.float() + shift.float().view(*shift.shape, *[1] * (x.ndim - 2))


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,groups,layout", [
    ((2, 64, 6, 5), 32, "channels_last"),
    ((2, 64, 6, 5), 32, "contiguous"),
    ((3, 40, 17), 4, "channels_last"),
    ((1, 16, 4, 4), 16, "channels_last"),
])
def test_plain_with_shift_matches_functional_group_norm(shape, groups, layout, dtype, silu):
    """With a shift the plain version is F.group_norm of x + shift formed in
    fp32 (the sum not rounded to x's dtype), then the one rounding and the
    SiLU; tolerances as without a shift."""
    x = _input(shape, dtype, layout)
    w, b = _affine(shape[1], dtype)
    shift = _shift(shape[0], shape[1], dtype)
    got = gn.group_norm(x, w, b, groups, 1e-5, silu=silu, shift=shift)
    want = F.group_norm(_shifted(x, shift), groups, w.float(), b.float(), 1e-5).to(dtype)
    want = F.silu(want) if silu else want
    assert got.shape == x.shape and got.dtype == dtype and _is_channels_last(got)
    tol = 1e-5 if dtype == torch.float32 else 5 * 2.0 ** -8
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert launches.counts["group_norm_shift"] == 0


@pytest.mark.parametrize("silu", [False, True])
def test_plain_shift_gradients_match_autograd(silu):
    """Gradients of x, the shift and the weights through the plain version
    with a shift equal autograd's through the composition."""
    x = _input((2, 32, 5, 4)).requires_grad_(True)
    w, b = (t.requires_grad_(True) for t in _affine(32))
    shift = _shift(2, 32).requires_grad_(True)
    dy = _input((2, 32, 5, 4), seed=2)
    got = torch.autograd.grad(gn.group_norm(x, w, b, 8, 1e-6, silu=silu, shift=shift),
                              (x, shift, w, b), dy)
    want = F.group_norm(x + shift[:, :, None, None], 8, w, b, 1e-6)
    want = torch.autograd.grad(F.silu(want) if silu else want, (x, shift, w, b), dy)
    for g, h in zip(got, want):
        torch.testing.assert_close(g, h, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("shape", [(2,), (2, 4), (1, 8), (2, 8, 1, 1), (8, 2)])
def test_refuses_a_shift_of_the_wrong_shape(shape, device):
    """A shift is (N, C) exactly; anything else is refused before any
    arithmetic, whatever the device (the card's path runs the same check
    first)."""
    x, (w, b) = _input((2, 8, 3, 3), device=device), _affine(8, device=device)
    with pytest.raises(ValueError, match="shift"):
        gn.group_norm(x, w, b, 4, 1e-5, shift=torch.zeros(shape, device=device))


@pytest.mark.parametrize("bad", ["groups", "weight", "empty", "rank"])
def test_refuses_bad_shapes_on_every_device(bad):
    x, (w, b), groups = _input((2, 8, 3, 3)), _affine(8), 4
    if bad == "groups":
        groups = 3
    elif bad == "weight":
        w = w[:4]
    elif bad == "empty":
        x = x[:0]
    else:
        x = x.flatten(1)
    with pytest.raises(ValueError):
        gn.group_norm(x, w, b, groups, 1e-5)


def test_module_fuses_silu_as_the_composition():
    """``GroupNorm(..., silu=True)`` equals ``silu(GroupNorm(x))`` bit for bit
    on the CPU, in bf16 too (SiLU of the already-rounded value)."""
    mod = tnn.GroupNorm(32, 64, 1e-6)
    tnn.fill_random_(mod, torch.Generator().manual_seed(0))
    for dtype in (torch.float32, torch.bfloat16):
        m = mod.to(dtype)
        x = _input((2, 64, 4, 4), dtype)
        assert torch.equal(m(x, silu=True), F.silu(m(x)))


# ---- the launch shape ------------------------------------------------------ #

@pytest.mark.parametrize("shape,dtype,groups", [
    ((1, 262144, 128), torch.bfloat16, 32),     # the KL-f8 decoder's 512 px level
    ((1, 4096, 512), torch.bfloat16, 32),       # its mid block
    ((8, 4096, 320), torch.bfloat16, 32),       # the SD UNet's 64x64 level
    ((8, 64, 1280), torch.bfloat16, 32),        # its 8x8 level
    ((8, 64, 2560), torch.bfloat16, 32),        # its 8x8 output blocks' concatenation
    ((8, 1024, 320), torch.bfloat16, 32),
    ((2, 65536, 256), torch.float32, 32),       # a pixel UNet's 256 px level
    ((2, 64, 2560), torch.float32, 32),         # SD's 2560 channels in fp32: two vectors
    ((2, 64, 16), torch.float32, 16),           # a tiny config's clamped groups
    ((3, 100, 40), torch.float16, 8),
])
def test_launch_shape_fills_the_card_and_covers_every_pixel(shape, dtype, groups,
                                                            monkeypatch):
    """16-byte vectors where C allows, at most 512 threads a block, shared
    memory under 48 KiB, every chunk non-empty and the chunks covering the
    pixels; at least two blocks an SM where the pixels allow."""
    monkeypatch.setattr(gn, "_sm_count", lambda index: 132)
    n, hw, c = shape
    x3 = torch.empty(shape, dtype=dtype, device="meta")
    vec, rows, chunks, per_chunk = gn._geometry(x3, groups)
    wide = dtype == torch.float32 and c // 4 > gn.MAX_THREADS
    assert vec == (8 if wide else 16 // x3.element_size()) and c % vec == 0
    assert (c // vec) * rows <= gn.MAX_THREADS
    assert (2 * rows * c + rows) * 4 <= 48 * 1024
    assert (chunks - 1) * per_chunk < hw <= chunks * per_chunk
    if hw >= 2 * 132 * rows * gn.MIN_PIXELS_PER_ROW:
        assert n * chunks >= 2 * 132


def test_launch_shape_takes_scalars_off_16_byte_boundaries(monkeypatch):
    monkeypatch.setattr(gn, "_sm_count", lambda index: 132)
    base = torch.empty(2 * 64 * 40 + 8, dtype=torch.bfloat16)
    aligned, off = base[:-8].view(2, 64, 40), base[1:-7].view(2, 64, 40)
    assert gn._geometry(aligned, 4)[0] == 8
    assert gn._geometry(off, 4)[0] == 1
    assert gn._geometry(aligned, 4, off)[0] == 1


@pytest.mark.parametrize("shape,dtype", [((1, 16, 8192), torch.float32),
                                         ((70000, 4, 32), torch.bfloat16),
                                         ((1, 64, 1028), torch.bfloat16)])
def test_launch_shape_refuses_what_the_kernel_cannot_take(shape, dtype, monkeypatch):
    """Over 512 vectors of channels (float32 8192; bfloat16 1028, not a whole
    number of 16-byte vectors, so one channel a thread) and over the grid's
    65535 samples."""
    monkeypatch.setattr(gn, "_sm_count", lambda index: 132)
    with pytest.raises(ValueError):
        gn._geometry(torch.empty(shape, dtype=dtype, device="meta"), 32)


@pytest.mark.parametrize("shape,groups", [((1, 1 << 20, 512), 32),   # 2^24 a group
                                          ((600, 1 << 21, 8), 1),    # one chunk a sample
                                          ((2, 4096, 320), 32)])
def test_launch_shape_keeps_each_chunk_count_exact_in_fp32(shape, groups, monkeypatch):
    """A group may hold 2^24 elements or more (the kernels merge the chunks'
    counts in double); each chunk holds fewer, so its fp32 count is exact."""
    monkeypatch.setattr(gn, "_sm_count", lambda index: 132)
    n, hw, c = shape
    _, _, chunks, per_chunk = gn._geometry(
        torch.empty(shape, dtype=torch.bfloat16, device="meta"), groups)
    assert per_chunk * (c // groups) < gn.MAX_CHUNK_ELEMENTS
    assert (chunks - 1) * per_chunk < hw <= chunks * per_chunk


def test_token_major_copies_off_16_byte_boundaries():
    """The kernels' (N, HW, C) array is a view of channels-last memory that
    starts on a 16-byte boundary, a copy of the same values otherwise."""
    x = _input((2, 40, 4, 4), torch.bfloat16)
    assert gn._token_major(x).data_ptr() == x.data_ptr()
    base = torch.empty(2 * 16 * 40 + 8, dtype=torch.bfloat16)
    off = base[1:-7].view(2, 16, 40).movedim(-1, 1).view(2, 40, 4, 4)
    off.copy_(x)
    t3 = gn._token_major(off)
    assert t3.data_ptr() % 16 == 0 and t3.data_ptr() != off.data_ptr()
    assert torch.equal(t3, x.movedim(1, -1).reshape(2, 16, 40))


def test_a_replay_adds_the_group_norm_launches_its_capture_counted(monkeypatch):
    counts = dict.fromkeys(launches.counts, 0)
    monkeypatch.setattr(launches, "counts", counts)
    before = dict(counts)
    counts["group_norm"] += 61
    delta = graphs.count_delta(before, counts)
    assert delta["group_norm"] == 61 and delta["group_norm_backward"] == 0
    counts.update({"group_norm": 0})
    captured = graphs.Captured(types.SimpleNamespace(replay=lambda: None), [], None, delta,
                               0.0)
    captured.replay()
    captured.replay()
    assert counts == {**dict.fromkeys(counts, 0), "group_norm": 122}


# ---- the models' layout ---------------------------------------------------- #

def _tiny_models():
    kl = AutoencoderKL(DDConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1, resolution=16,
                                z_channels=4))
    ddpm = DDPMUNet(DDPMUNetConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1,
                                   attn_resolutions=(8,), resolution=16))
    return {"gd_unet": GDUNet(GDUNetConfig.tiny()), "gd_unet_attn": GDUNet(GDUNetConfig.tiny(None)),
            "kl": kl, "ddpm": ddpm}


@pytest.mark.parametrize("name", ["gd_unet", "gd_unet_attn", "kl", "ddpm"])
def test_models_stay_channels_last_from_first_conv_to_last(name):
    """Every conv weight is channels-last from construction and stays so
    through a load and a cast, and every 2-d convolution's input, every
    GroupNorm's input and output, is a view of channels-last memory."""
    model = _tiny_models()[name]
    tnn.fill_random_(model, torch.Generator().manual_seed(0))
    model.load_state_dict({k: v.contiguous() for k, v in model.state_dict().items()})
    model = model.to(torch.bfloat16).float().eval()
    convs = [m for m in model.modules() if isinstance(m, torch.nn.Conv2d)]
    assert convs and all(m.weight.is_contiguous(memory_format=CL) for m in convs)
    seen = []

    def hook(mod, args, out):
        seen.append((type(mod).__name__, _is_channels_last(args[0]), _is_channels_last(out)))

    for m in model.modules():
        if isinstance(m, (torch.nn.Conv2d, tnn.GroupNorm)):
            m.register_forward_hook(hook)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        if name == "kl":
            z = model.encode_moments(torch.randn(2, 16, 16, 3, generator=gen))
            model.decode(z[..., :4])
        elif name == "ddpm":
            model(torch.randn(2, 16, 16, 3, generator=gen), torch.tensor([3, 500]))
        else:
            ctx = torch.randn(2, 7, 24, generator=gen) if name == "gd_unet" else None
            model(torch.randn(2, 8, 8, 4, generator=gen), torch.tensor([3, 500]), ctx)
    assert {k for k, _, _ in seen} == {"Conv2d", "GroupNorm"}
    assert all(a and b for _, a, b in seen), [s for s in seen if not (s[1] and s[2])]


def test_spatial_transformer_takes_its_tokens_as_a_view():
    """The (b, c, h, w) <-> (b, hw, c) moves of a SpatialTransformer copy
    nothing: proj_out reads the last block's own output."""
    unet = GDUNet(GDUNetConfig.tiny())
    st = next(m for m in unet.modules() if type(m).__name__ == "SpatialTransformer")
    blocks_out, proj_in = [], []
    st.transformer_blocks[-1].register_forward_hook(lambda m, a, o: blocks_out.append(o))
    st.proj_out.register_forward_hook(lambda m, a, o: proj_in.append(a[0]))
    x = _input((2, 32, 8, 8))
    with torch.no_grad():
        st(x, torch.randn(2, 7, 24))
    assert proj_in[0].data_ptr() == blocks_out[0].data_ptr()


class _Adds(TorchDispatchMode):
    """Records the shapes of every ``aten.add`` operand outside GroupNorm
    (whose plain version adds the shift itself, as the kernels do in
    registers), and each convolution's kernel size and whether it was given
    a bias (on the card, a separate broadcasting pass over its output)."""

    def __init__(self):
        super().__init__()
        self.inside_norm = False
        self.adds = []
        self.convs = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket is torch.ops.aten.add and not self.inside_norm:
            self.adds.append([tuple(a.shape) for a in args if isinstance(a, torch.Tensor)])
        if func.overloadpacket is torch.ops.aten.convolution:
            self.convs.append((tuple(args[1].shape[2:]), args[2] is not None))
        return func(*args, **(kwargs or {}))


def _count_shifted_norms(model, monkeypatch, *inputs):
    """(GroupNorm calls given a shift, calls without, the add operands'
    shapes outside GroupNorm, the convolutions' (kernel, biased)) over one
    forward of ``model``."""
    calls = {"shift": 0, "plain": 0}
    mode = _Adds()
    real = tnn.group_norm

    def counted(*args, shift=None, **kwargs):
        calls["shift" if shift is not None else "plain"] += 1
        mode.inside_norm = True
        try:
            return real(*args, shift=shift, **kwargs)
        finally:
            mode.inside_norm = False

    monkeypatch.setattr(tnn, "group_norm", counted)
    with torch.no_grad(), mode:
        model(*inputs)
    return calls["shift"], calls["plain"], mode.adds, mode.convs


def _embedding_adds(adds):
    """The adds that broadcast a (B, C, 1, 1) operand over another's pixels:
    a timestep embedding's."""
    return [a for a in adds
            if len(set(a)) > 1 and any(len(s) == 4 and s[2:] == (1, 1) for s in a)]


@pytest.mark.parametrize("name,want", [("sd_v1", 22), ("sdxl_base", 17)])
def test_full_width_unets_fold_every_embedding_into_a_norm(name, want, monkeypatch):
    """On the meta device (shapes alone; an 8x8 latent keeps every attention
    on the plain route): the published UNets call GroupNorm with a shift once
    per ResBlock, 22 for SD v1 (LDM text2img-large shares its topology) and
    17 for SDXL base, and add no embedding anywhere else."""
    cfg = getattr(GDUNetConfig, name)()
    with torch.device("meta"):
        unet = GDUNet(cfg).to(torch.bfloat16)
        x = torch.zeros(2, 8, 8, 4, dtype=torch.bfloat16)
        t = torch.zeros(2, dtype=torch.int64)
        ctx = torch.zeros(2, 77, cfg.context_dim, dtype=torch.bfloat16)
        y = (torch.zeros(2, cfg.adm_in_channels, dtype=torch.bfloat16)
             if cfg.adm_in_channels else None)
    assert sum(isinstance(m, GDResBlock) for m in unet.modules()) == want
    shifted, plain, adds, _ = _count_shifted_norms(unet, monkeypatch, x, t, ctx, None, False,
                                                   y)
    assert shifted == want and plain > 0
    assert not _embedding_adds(adds), _embedding_adds(adds)


@pytest.mark.parametrize("name,biased", [("sd_v1", 52), ("sdxl_base", 40)])
def test_full_width_unets_run_no_pointwise_convolution(name, biased, monkeypatch):
    """On the meta device: no 1x1 convolution runs (the ResBlocks' skips and
    SD v1's transformer projections are GEMMs); the convolutions, each with
    its own bias, are the input conv, the resamplers, the output conv and
    each ResBlock's two (SD v1 1 + 3 + 3 + 1 + 2 x 22, SDXL
    1 + 2 + 2 + 1 + 2 x 17)."""
    cfg = getattr(GDUNetConfig, name)()
    with torch.device("meta"):
        unet = GDUNet(cfg).to(torch.bfloat16)
        x = torch.zeros(2, 8, 8, 4, dtype=torch.bfloat16)
        t = torch.zeros(2, dtype=torch.int64)
        ctx = torch.zeros(2, 77, cfg.context_dim, dtype=torch.bfloat16)
        y = (torch.zeros(2, cfg.adm_in_channels, dtype=torch.bfloat16)
             if cfg.adm_in_channels else None)
    *_, convs = _count_shifted_norms(unet, monkeypatch, x, t, ctx, None, False, y)
    assert all(k == (3, 3) for k, _ in convs), sorted(set(convs))
    assert len(convs) == biased and all(b for _, b in convs)


@pytest.mark.parametrize("name", ["gd_unet", "gd_unet_attn", "kl", "ddpm", "vq"])
def test_tiny_models_run_every_pointwise_conv_as_a_gemm(name):
    """Every 1x1 conv of the channels-last models (the UNets' skips and
    projections, KL-f8's and VQ-f4's shortcuts, quant convs and mid-block
    attention, the DDPM UNet's shortcuts and attention) is a
    ``models.nn.Conv2d``, and a forward runs no 1x1 convolution."""
    model = (VQModel(DDConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1, resolution=16,
                              z_channels=3, double_z=False), n_embed=16)
             if name == "vq" else _tiny_models()[name]).eval()
    tnn.fill_random_(model, torch.Generator().manual_seed(0))
    pointwise = [m for m in model.modules()
                 if isinstance(m, torch.nn.Conv2d) and m.kernel_size == (1, 1)]
    assert pointwise and all(type(m) is tnn.Conv2d for m in pointwise)
    gen = torch.Generator().manual_seed(1)
    mode = _Adds()
    with torch.no_grad(), mode:
        if name in ("kl", "vq"):
            h = (model.encode_moments if name == "kl" else model.encode)(
                torch.randn(2, 16, 16, 3, generator=gen))
            model.decode(h[..., :4] if name == "kl" else h)
        elif name == "ddpm":
            model(torch.randn(2, 16, 16, 3, generator=gen), torch.tensor([3, 500]))
        else:
            ctx = torch.randn(2, 7, 24, generator=gen) if name == "gd_unet" else None
            model(torch.randn(2, 8, 8, 4, generator=gen), torch.tensor([3, 500]), ctx)
    assert mode.convs and all(k != (1, 1) for k, _ in mode.convs), mode.convs


@pytest.mark.parametrize("name", ["tiny", "tiny_unconditional", "tiny_sdxl", "scale_shift"])
def test_tiny_unets_fold_every_embedding_into_a_norm(name, monkeypatch):
    """On the CPU, once per ResBlock for the tiny configurations; under
    ``use_scale_shift_norm`` (the pixel models) none, and the embedding's
    scale and shift stay outside the norm."""
    cfg = {"tiny": GDUNetConfig.tiny(), "tiny_unconditional": GDUNetConfig.tiny(None),
           "tiny_sdxl": GDUNetConfig.tiny_sdxl(24, 16),
           "scale_shift": dataclasses.replace(GDUNetConfig.tiny(None),
                                              use_scale_shift_norm=True)}[name]
    unet = GDUNet(cfg).eval()
    tnn.fill_random_(unet, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(2, 8, 8, 4, generator=gen)
    ctx = torch.randn(2, 7, cfg.context_dim, generator=gen) if cfg.context_dim else None
    y = torch.randn(2, cfg.adm_in_channels, generator=gen) if cfg.adm_in_channels else None
    blocks = sum(isinstance(m, GDResBlock) for m in unet.modules())
    shifted, _, adds, _ = _count_shifted_norms(unet, monkeypatch, x,
                                               torch.tensor([3, 500]), ctx, None, False, y)
    if cfg.use_scale_shift_norm:
        assert shifted == 0 and len(_embedding_adds(adds)) == blocks
    else:
        assert blocks > 0 and shifted == blocks and not _embedding_adds(adds)


@pytest.mark.parametrize("cin,cout,updown", [(32, 64, {}), (32, 32, {}),
                                              (32, 64, {"down": True}),
                                              (32, 32, {"up": True})])
def test_resblock_with_a_folded_shift_equals_the_add_then_norm(cin, cout, updown):
    """The ResBlock's output through the folded shift equals, in fp32, the
    reference's order: the first conv, the embedding added, then the norm
    (+SiLU), the second conv and the skip (a 1x1 conv, here a GEMM, or the
    identity), each conv as ``F.conv2d`` with its bias."""
    block = GDResBlock(cin, cout, 48, **updown).eval()
    tnn.fill_random_(block, torch.Generator().manual_seed(2))
    x = _input((2, cin, 6, 6), seed=3)
    emb = torch.randn(2, 48, generator=torch.Generator().manual_seed(4))
    conv1, conv2, skip = block.in_layers[2], block.out_layers[3], block.skip_connection

    def conv(m, h):
        return F.conv2d(h, m.weight, m.bias, m.stride, m.padding)

    with torch.no_grad():
        h = block.in_layers[0](x, silu=True)
        if block.resample is not None:
            h, x_skip = block.resample(h), block.resample(x)
        else:
            x_skip = x
        h = conv(conv1, h) + block.emb_layers(emb)[:, :, None, None]
        h = conv(conv2, F.silu(F.group_norm(h, 32, block.out_layers[0].weight,
                                            block.out_layers[0].bias, 1e-5)))
        want = (x_skip if cin == cout else conv(skip, x_skip)) + h
        got = block(x, emb)
    assert isinstance(skip, torch.nn.Identity) == (cin == cout)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("layout", ["channels_last", "contiguous"])
@pytest.mark.parametrize("bias", ["own", "none", "given"])
@pytest.mark.parametrize("kernel,stride,padding", [(1, 1, 0), (3, 1, 1), (3, 2, 1)])
def test_conv2d_moves_its_bias_and_runs_pointwise_as_a_gemm(kernel, stride, padding, bias,
                                                           layout):
    """``models.nn.Conv2d`` equals ``F.conv2d`` with its own bias, with
    none (``bias=False``), and with one loaded from an ``nn.Conv2d``'s state
    dict (a checkpoint's); a pointwise one runs as a GEMM (no convolution),
    its bias added in the GEMM, and returns a view of channels-last
    memory."""
    conv = tnn.Conv2d(16, 24, kernel, stride=stride, padding=padding, bias=bias != "none")
    if bias == "given":
        ref = torch.nn.Conv2d(16, 24, kernel, stride=stride, padding=padding)
        torch.nn.init.normal_(ref.bias, generator=torch.Generator().manual_seed(6))
        conv.load_state_dict(ref.state_dict())
        assert torch.equal(conv.bias, ref.bias)
    tnn.channels_last_(conv)
    x = _input((2, 16, 7, 6), seed=5, layout=layout)
    mode = _Adds()
    with torch.no_grad(), mode:
        got = conv(x)
    want = F.conv2d(x, conv.weight, conv.bias, stride, padding)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert (mode.convs == []) == (kernel == 1)
    if kernel == 1:
        assert _is_channels_last(got)


# ---- the kernels on the card ----------------------------------------------- #

MAIN_SHAPES = [(1, 128, 512, 512), (1, 512, 64, 64), (8, 320, 64, 64), (8, 1280, 8, 8),
               (8, 320, 32, 32), (8, 2560, 8, 8)]
TINY = (2, 16, 8, 8)        # GroupNorm(32, 16): 16 groups of one channel


def _bound(dtype):
    """Relative to the plain result's peak: bf16 one rounding of the
    result plus the sums' order; fp32 the sums' order."""
    return {torch.bfloat16: 1e-2, torch.float16: 2e-3, torch.float32: 1e-5}[dtype]


def _rel(a, b):
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.card
@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", MAIN_SHAPES + [TINY])
def test_kernel_matches_plain(card, shape, dtype, silu):
    """Forward, forward + SiLU and the backward (input gradient) against the
    plain version on the card, and each repeated bit for bit."""
    groups = min(32, shape[1])
    x = _input(shape, dtype, device=card)
    w, b = _affine(shape[1], dtype, device=card)
    dy = _input(shape, dtype, seed=3, device=card)
    launches.reset()
    xg = x.clone().requires_grad_(True)
    out = gn.group_norm(xg, w, b, groups, 1e-6, silu=silu)
    (dx,) = torch.autograd.grad(out, xg, dy)
    assert _gn_launches() == (1, 1)
    assert _is_channels_last(out) and _is_channels_last(dx) and dx.dtype == dtype
    xr = x.clone().requires_grad_(True)
    want = gn.group_norm_reference(xr, w, b, groups, 1e-6, silu=silu)
    (want_dx,) = torch.autograd.grad(want, xr, dy)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and torch.isfinite(dx).all()
    assert _rel(out, want) <= _bound(dtype), _rel(out, want)
    assert _rel(dx, want_dx) <= 2 * _bound(dtype), _rel(dx, want_dx)
    xg2 = x.clone().requires_grad_(True)
    out2 = gn.group_norm(xg2, w, b, groups, 1e-6, silu=silu)
    (dx2,) = torch.autograd.grad(out2, xg2, dy)
    assert torch.equal(out, out2) and torch.equal(dx, dx2)


@pytest.mark.card
@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", MAIN_SHAPES + [TINY])
def test_kernel_with_shift_matches_plain(card, shape, dtype, silu):
    """With a per-sample, per-channel shift: the forward, the input's and
    the shift's gradients against the plain version on the card, each
    repeated bit for bit, one launch of each kernel and one shift counted.
    The shift's gradient is the input's summed over the pixels and rounded
    once to the dtype: its bound is that rounding plus the input gradient's
    bound over sqrt(pixels) independent roundings."""
    groups, (n, c), hw = min(32, shape[1]), shape[:2], shape[2] * shape[3]
    x = _input(shape, dtype, device=card)
    w, b = _affine(c, dtype, device=card)
    shift = _shift(n, c, dtype, device=card)
    dy = _input(shape, dtype, seed=3, device=card)

    def run(fn):
        xg, sg = x.clone().requires_grad_(True), shift.clone().requires_grad_(True)
        out = fn(xg, w, b, groups, 1e-6, silu=silu, shift=sg)
        return (out, *torch.autograd.grad(out, (xg, sg), dy))

    launches.reset()
    out, dx, dshift = run(gn.group_norm)
    assert _gn_launches() == (1, 1) and launches.counts["group_norm_shift"] == 1
    assert _is_channels_last(out) and _is_channels_last(dx)
    assert dx.dtype == dshift.dtype == dtype and dshift.shape == (n, c)
    want, want_dx, want_dshift = run(gn.group_norm_reference)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and torch.isfinite(dx).all()
    assert _rel(out, want) <= _bound(dtype), _rel(out, want)
    assert _rel(dx, want_dx) <= 2 * _bound(dtype), _rel(dx, want_dx)
    gap = float((dshift.float() - want_dshift.float()).abs().max())
    scale = float(want_dshift.abs().max()) + 2 * float(want_dx.abs().max()) * hw ** 0.5
    assert gap <= _bound(dtype) * scale, (gap, scale)
    again = run(gn.group_norm)
    assert all(torch.equal(p_, q) for p_, q in zip((out, dx, dshift), again))


@pytest.mark.card
@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", MAIN_SHAPES)
def test_kernel_zero_shift_gives_the_bits_of_no_shift(card, shape, dtype, silu):
    """A zero shift changes no constant: forward and input gradient equal
    the call without a shift bit for bit."""
    x = _input(shape, dtype, device=card)
    w, b = _affine(shape[1], dtype, device=card)
    dy = _input(shape, dtype, seed=3, device=card)
    zero = torch.zeros(shape[:2], dtype=dtype, device=card)

    def run(shift):
        xg = x.clone().requires_grad_(True)
        out = gn.group_norm(xg, w, b, 32, 1e-6, silu=silu, shift=shift)
        return out, torch.autograd.grad(out, xg, dy)[0]

    assert all(torch.equal(p_, q) for p_, q in zip(run(None), run(zero)))


@pytest.mark.card
def test_tiny_unet_replay_counts_its_shifts(card):
    """A CUDA-graph replay of a tiny UNet adds one ``group_norm_shift`` per
    ResBlock, as its capture counted, and gives the eager call's bits."""
    unet = GDUNet(GDUNetConfig.tiny()).to(card, torch.bfloat16).eval()
    tnn.fill_random_(unet, torch.Generator(device=card).manual_seed(0))
    blocks = sum(isinstance(m, GDResBlock) for m in unet.modules())
    gen = torch.Generator(device=card).manual_seed(1)
    x = torch.randn((2, 8, 8, 4), generator=gen, device=card).to(torch.bfloat16)
    t = torch.tensor([3, 500], device=card)
    ctx = torch.randn((2, 7, 24), generator=gen, device=card).to(torch.bfloat16)

    def fn(x):
        with torch.no_grad():
            return unet(x, t, ctx)

    graphs.warm_up(fn, (x.clone(),), calls=2)
    launches.reset()
    captured = graphs.capture(fn, (x.clone(),))
    assert captured.launches["group_norm_shift"] == blocks > 0
    assert launches.counts["group_norm_shift"] == 0
    captured.inputs[0].copy_(x)
    captured.replay()
    captured.replay()
    torch.cuda.synchronize()
    assert launches.counts["group_norm_shift"] == 2 * blocks
    assert torch.equal(captured.output, fn(x))


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16])
@pytest.mark.parametrize("layout", ["channels_last", "contiguous"])
def test_kernel_weight_gradients_when_asked(card, dtype, layout):
    """dgamma and dbeta against the plain version's (asked for), none
    computed when the weights are frozen; an NCHW-contiguous input is read
    through a copy and gives the same result as its channels-last twin."""
    shape = (4, 64, 24, 20)
    x = _input(shape, dtype, layout, device=card)
    w, b = _affine(64, dtype, device=card)
    dy = _input(shape, dtype, seed=5, device=card)
    wg, bg = w.clone().requires_grad_(True), b.clone().requires_grad_(True)
    got = torch.autograd.grad(gn.group_norm(x, wg, bg, 32, 1e-5, silu=True), (wg, bg), dy)
    wr, br = w.clone().requires_grad_(True), b.clone().requires_grad_(True)
    want = torch.autograd.grad(gn.group_norm_reference(x, wr, br, 32, 1e-5, silu=True),
                               (wr, br), dy)
    for g, h in zip(got, want):
        assert g.dtype == dtype and _rel(g, h) <= 4 * _bound(dtype), _rel(g, h)
    twin = x.movedim(1, -1).contiguous().movedim(-1, 1)
    assert torch.equal(gn.group_norm(x, w, b, 32, 1e-5), gn.group_norm(twin, w, b, 32, 1e-5))


@pytest.mark.card
def test_kernel_captures_and_replays_in_a_cuda_graph(card):
    """Forward and backward captured together replay the eager call bit
    for bit on a new input, and a replay counts the capture's launches."""
    shape, dtype = (2, 320, 32, 32), torch.bfloat16
    w, b = _affine(320, dtype, device=card)
    dy = _input(shape, dtype, seed=7, device=card)

    def fn(x):
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            y = gn.group_norm(x, w, b, 32, 1e-6, silu=True)
            return y.detach(), torch.autograd.grad(y, x, dy)[0]

    x0, x1 = _input(shape, dtype, device=card), _input(shape, dtype, seed=9, device=card)
    graphs.warm_up(fn, (x0.clone(),), calls=2)
    launches.reset()
    captured = graphs.capture(fn, (x0,))
    assert captured.launches["group_norm"] == 1 and captured.launches["group_norm_backward"] == 1
    assert _gn_launches() == (0, 0)
    captured.inputs[0].copy_(x1)
    captured.replay()
    torch.cuda.synchronize()
    want = fn(x1.clone())
    assert all(torch.equal(a, c) for a, c in zip(captured.output, want))
    assert _gn_launches() == (2, 2)


@pytest.mark.card
@pytest.mark.parametrize("case", ["group_of_2_24", "unaligned_wide"])
def test_kernel_takes_large_groups_and_unaligned_inputs(card, case):
    """A group of 2^24 elements (4 channels of 2048 x 2048 pixels), and 640
    bfloat16 channels whose memory starts off a 16-byte boundary (copied to
    one that does): forward + SiLU and backward against the plain version."""
    if case == "group_of_2_24":
        shape, groups = (1, 4, 2048, 2048), 1
        x = _input(shape, torch.bfloat16, device=card)
    else:
        shape, groups = (2, 640, 8, 8), 32
        base = torch.empty(2 * 64 * 640 + 8, dtype=torch.bfloat16, device=card)
        x = base[1:-7].view(2, 64, 640).movedim(-1, 1).view(shape)
        x.copy_(_input(shape, torch.bfloat16, device=card))
        assert x.data_ptr() % 16
    w, b = _affine(shape[1], torch.bfloat16, device=card)
    dy = _input(shape, torch.bfloat16, seed=3, device=card)
    xg, xr = x.detach().requires_grad_(True), x.detach().clone().requires_grad_(True)
    out = gn.group_norm(xg, w, b, groups, 1e-6, silu=True)
    (dx,) = torch.autograd.grad(out, xg, dy)
    want = gn.group_norm_reference(xr, w, b, groups, 1e-6, silu=True)
    (want_dx,) = torch.autograd.grad(want, xr, dy)
    torch.cuda.synchronize()
    assert _rel(out, want) <= _bound(torch.bfloat16), _rel(out, want)
    assert _rel(dx, want_dx) <= 2 * _bound(torch.bfloat16), _rel(dx, want_dx)


@pytest.mark.card
@pytest.mark.parametrize("bad", ["float64", "too_wide", "weight_on_cpu"])
def test_kernel_refuses_cuda_inputs_it_cannot_take(card, bad):
    # too wide: 8192 float32 channels are 1024 vectors of 32 bytes, over 512
    dtype, c = (torch.float64, 64) if bad == "float64" else (torch.float32, 8192)
    if bad == "weight_on_cpu":
        c = 64
    x = _input((1, c, 4, 4), dtype, device=card)
    w, b = _affine(c, dtype, device="cpu" if bad == "weight_on_cpu" else card)
    with pytest.raises(ValueError):
        gn.group_norm(x, w, b, 32, 1e-5)


LAYOUT_KERNELS = ("RowwiseMoments", "ComputeInternalGradients", "nchwToNhwc", "nhwcToNchw")


def _device_kernels(fn):
    """Names of the device kernels ``fn()`` runs, under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA}


@pytest.mark.card
def test_main_path_runs_no_layout_conversion(card):
    """One captured SD v1 UNet replay (batch 8, 512 px), one KL-f8 decode and
    one CLIP-energy gradient: no PyTorch GroupNorm kernel and no cuDNN
    layout conversion runs, every GroupNorm is one launch of the kernel
    (and one of its backward in the gradient), each of the UNet's 22
    ResBlocks folds its timestep embedding into one of them as a shift, and
    the gradient repeats bit for bit."""
    from cyclediffusion_tpu_torch.models.clip import CLIPConfig
    from cyclediffusion_tpu_torch.pipelines.latent import LatentCoreSpec
    from cyclediffusion_tpu_torch.tools import guided_probe

    setup = guided_probe.build(LatentCoreSpec.sd_v1(), CLIPConfig.vit_b_32(), steps=2,
                               device=card)
    core = setup.core
    norms = {name: sum(isinstance(m, tnn.GroupNorm) for m in mod.modules())
             for name, mod in (("unet", core.unet), ("decoder", core.first_stage.decoder))}
    gen = torch.Generator(device=card).manual_seed(0)
    lat = torch.randn((8, 64, 64, 4), generator=gen, device=card)
    t = torch.full((8,), 500, dtype=torch.int64, device=card)
    ctx = torch.randn((8, 77, 768), generator=gen, device=card)
    x, p, tt = guided_probe.first_step_point(setup)
    energy = setup.energy_fn
    calls = {"unet": lambda: core.apply_model(lat, t, ctx),
             "decode": lambda: core.decode_first_stage(lat[:1]),
             "energy": lambda: energy.grad(x, p, tt)}
    want = {"unet": (norms["unet"], 0), "decode": (norms["decoder"], 0),
            "energy": (norms["decoder"], norms["decoder"])}
    # the UNet's ResBlocks fold their timestep embedding into a norm
    shifts = {"unet": sum(isinstance(m, GDResBlock) for m in core.unet.modules()),
              "decode": 0, "energy": 0}
    for name, fn in calls.items():
        fn()                                    # warm-up and capture
        launches.reset()
        kernels = _device_kernels(fn)           # a replay
        bad = sorted(k for k in kernels if any(p_ in k for p_ in LAYOUT_KERNELS))
        assert not bad, (name, bad)
        assert any("group_norm_apply_kernel" in k for k in kernels), name
        got = _gn_launches()
        assert got == want[name], (name, got, want[name])
        assert launches.counts["group_norm_shift"] == shifts[name], name
    first = energy.grad(x, p, tt)
    assert torch.equal(first, energy.grad(x, p, tt))
    assert torch.equal(first, energy.grad_eager(x, p, tt))
