"""Design variants of the bf16 flash-attention kernel (K1/K2) side by side on
one NVIDIA GPU: each variant is a copy of ``csrc/`` with text substitutions
in ``hopper_attention.cuh``, built by nvcc in parallel into
``csrc/build/variants/`` and swapped under the wrappers in turn.

    python -m cyclediffusion_tpu_torch.tools.flash_variants [variant ...]

Variants (``VARIANTS``; all when none is named): ``shipped``, the sources as
they are; ``no_pingpong``, the two consumer warpgroups issue their products
without taking turns; ``stages_2``, a ring of 2 K/V stages instead of 4;
``consumers_3``, three consumer warpgroups (192-row q tiles, no turns).
Two ablations give wrong output and are timed only, to show where the
loop's time goes: ``no_exp`` (p = the exponent instead of its power of 2)
and ``no_softmax`` (no softmax after the first tile).

For each variant: ptxas's spills, and the max abs error / max|plain| of K2
and K1 at the main-path shapes in bf16.  Then, in alternating order over
``ROUNDS`` rounds, the device ms per call of the kernel alone
(``torch.profiler`` over ``REPS`` calls) for K2 (4, 4096, 320, H 8, d 40),
K2 at the encode chain's batch 2, K1 (4, 8, 1024, 80), K1 at LDM
text2img-large's d = 40 (4, 8, 1024, 40) and at the FFHQ LDM's d = 32 (head
views of (3, 1024, 448), 14 heads), beside
``scaled_dot_product_attention`` on the same inputs (timed only), each
line ending with the card's SM clock, power and throttle reasons.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import ctypes
import re
import shutil
import subprocess
import sys

import torch
import torch.nn.functional as F

from cyclediffusion_tpu_torch.ops import cuda_build
from cyclediffusion_tpu_torch.ops import flash_attention as fa
from cyclediffusion_tpu_torch.tools.step_probe import alternating, card_state

HEADER = "hopper_attention.cuh"
NO_PINGPONG = [
    ('  static_assert(kConsumerWGs == 2, "the turns alternate between two warpgroups");\n', ""),
    ('  asm volatile("bar.sync %0, %1;\\n" ::"r"(1 + wg), "n"(kConsumers) : "memory");\n', ""),
    ('  asm volatile("bar.arrive %0, %1;\\n" ::"r"(2 - wg), "n"(kConsumers) : "memory");\n', ""),
]
VARIANTS = {  # name -> [(old text, new text)] in HEADER
    "shipped": [],
    "no_pingpong": NO_PINGPONG,
    "stages_2": [("constexpr int kStages = 4;", "constexpr int kStages = 2;")],
    # 192-row q tiles; the registers split as 65,536 / 512 threads allows
    "consumers_3": NO_PINGPONG + [
        ("constexpr int kConsumerWGs = 2;", "constexpr int kConsumerWGs = 3;"),
        ("constexpr int kProducerRegs = 40;", "constexpr int kProducerRegs = 24;"),
        ("constexpr int kConsumerRegs = 232;", "constexpr int kConsumerRegs = 160;"),
    ],
    # ablations, wrong output and timed only: where the loop's time goes
    "no_exp": [("sa[i] = ex2(fmaf(sa[i], scale_log2, -msc[(i >> 1) & 1]));",
                "sa[i] = fmaf(sa[i], scale_log2, -msc[(i >> 1) & 1]);")],
    "no_softmax": [("    softmax_exp(sa, Tk - j * kBlockN, c2, scale_log2, m, l, alpha);\n", "")],
}
ROUNDS = 2
REPS = 20


def build(name: str):
    """(ptxas spill lines, loaded library) of one variant."""
    out = cuda_build.BUILD_DIR / "variants" / name
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    for src in cuda_build.CSRC_DIR.glob("*.cu*"):
        text = src.read_text()
        if src.name == HEADER:
            for old, new in VARIANTS[name]:
                if old not in text:
                    raise RuntimeError(f"variant {name}: {old!r} not in {HEADER}")
                text = text.replace(old, new)
        (out / src.name).write_text(text)
    lib = out / "libflash_attention.so"
    cmd = [cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(lib),
           str(out / "flash_attention.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"variant {name}: nvcc failed\n{log}")
    spills = [line.strip() for line in log.splitlines() if re.search(r"[1-9]\d* bytes spill", line)]
    handle = ctypes.CDLL(str(lib))
    for fn_name, argtypes in fa._LIBRARIES["flash_attention"][1].items():
        fn = getattr(handle, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return spills, handle


@contextlib.contextmanager
def kernels_of(handle):
    """The wrappers launch from ``handle`` inside the block."""
    saved = fa._library
    info = cuda_build.BuildInfo(cuda_build.BUILD_DIR, False, 0.0, "")
    fa._library = lambda name: (info, handle)
    try:
        yield
    finally:
        fa._library = saved


def device_ms(fn, reps: int = REPS) -> float:
    """Device ms per call of the kernels ``fn`` launches (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for row in prof.key_averages():
        if row.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(row, "self_device_time_total", None)
            total_us += row.self_cuda_time_total if us is None else us
    return total_us / 1e3 / reps


def main(names) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("flash_variants needs a CUDA device")
    unknown = set(names) - set(VARIANTS)
    if unknown:
        raise SystemExit(f"unknown variants {sorted(unknown)}; known: {list(VARIANTS)}")
    names = list(names) or list(VARIANTS)
    print(f"card: {torch.cuda.get_device_name(0)}; {card_state()}", flush=True)
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(build, names)))

    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    def heads(x):
        return x.view(x.shape[0], x.shape[1], 8, 40).transpose(1, 2)

    k2 = [rand(4, 4096, 320) for _ in range(3)]
    k2_b2 = [rand(2, 4096, 320) for _ in range(3)]
    k1 = [rand(4, 8, 1024, 80) for _ in range(3)]
    k1_d40 = [rand(4, 8, 1024, 40) for _ in range(3)]
    k1_d32 = [rand(3, 1024, 448).view(3, 1024, 14, 32).transpose(1, 2) for _ in range(3)]
    cases = {
        "K2": (lambda: fa.flash_attention_packed(*k2, 8, 40 ** -0.5),
               lambda: F.scaled_dot_product_attention(*map(heads, k2))),
        "K2 batch 2": (lambda: fa.flash_attention_packed(*k2_b2, 8, 40 ** -0.5),
                       lambda: F.scaled_dot_product_attention(*map(heads, k2_b2))),
        "K1": (lambda: fa.flash_attention_bhtd(*k1, 80 ** -0.5),
               lambda: F.scaled_dot_product_attention(*k1)),
        "K1 d40": (lambda: fa.flash_attention_bhtd(*k1_d40, 40 ** -0.5),
                   lambda: F.scaled_dot_product_attention(*k1_d40)),
        "K1 d32": (lambda: fa.flash_attention_bhtd(*k1_d32, 32 ** -0.5),
                   lambda: F.scaled_dot_product_attention(*k1_d32)),
    }
    want2 = fa.attention_packed_reference(*k2, 8, 40 ** -0.5).float()
    want1 = fa.attention_reference(*k1, 80 ** -0.5).float()
    for name in names:
        spills, handle = built[name]
        with kernels_of(handle):
            got2 = cases["K2"][0]().float()
            got1 = cases["K1"][0]().float()
        e2 = float((got2 - want2).abs().max() / want2.abs().max())
        e1 = float((got1 - want1).abs().max() / want1.abs().max())
        print(f"variant {name}: spills {spills or 'none'}; max abs err / max|plain| "
              f"K2 {e2:.3e}, K1 {e1:.3e}", flush=True)

    for i, name in enumerate(alternating(ROUNDS, tuple(names))):
        with kernels_of(built[name][1]):
            times = {case: (device_ms(kernel), device_ms(library))
                     for case, (kernel, library) in cases.items()}
        line = ", ".join(f"{case} {ms:.4f} ms (SDPA {lib:.4f})"
                         for case, (ms, lib) in times.items())
        print(f"run {i} [{name}]: {line}; card after: {card_state()}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
