"""The folded self-attention kernels K3/K4 against the default path they can
replace, on one NVIDIA GPU, at the SD 64x64 shape (batch 4, 4096 tokens,
320 channels, 8 heads, bf16, seeded random weights).

    python -m cyclediffusion_tpu_torch.tools.folded_probe

* bitwise: K3 and K4 against the default path (cuBLAS q/k/v projections,
  K2, cuBLAS output projection with bias), and the q projection of cuBLAS's
  bf16 GEMM and of K3/K4's projection kernel against the plain versions'
  fp32-accumulated one and each other;
* times: the default path's attention block (K2 with its q and output
  projections; with its k and v projections too, K4's split path), K2
  alone, K3, K4, and K3/K4's projection kernel alone beside ``F.linear``
  for q (N = 320, with the bias) and [q | k | v] (N = 960): medians of 20
  CUDA-event-timed calls and the device ms per call of the kernels they
  launch (``torch.profiler``), in rotating order over three rounds, each
  with the card's SM clock, power and throttle reasons read just after it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cyclediffusion_tpu_torch.ops import flash_attention as fa
from cyclediffusion_tpu_torch.tools.flash_variants import device_ms
from cyclediffusion_tpu_torch.tools.step_probe import alternating, card_state

B, T, C, H = 4, 4096, 320, 8
ROUNDS = 3


def median_ms(fn, reps: int = 20) -> float:
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[reps // 2]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("folded_probe needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    fa.load_kernels()
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    x = rand((B, T, C))
    wq, wk, wv, wo = (rand((C, C), C ** -0.5) for _ in range(4))
    bo = rand((C,), 0.1)
    k, v = F.linear(x, wk), F.linear(x, wv)
    scale = (C // H) ** -0.5

    def default():
        return F.linear(fa.flash_attention_packed(F.linear(x, wq), k, v, H, scale), wo, bo)

    ref = default()
    k3 = fa.qout_self_attention_block(x, wq, k, v, wo, bo, H)
    k4 = fa.fused_self_attention_block(x, wq, wk, wv, wo, bo, H)
    q_lib, q_fp32, q_kernel = F.linear(x, wq), fa.linear_reference(x, wq), fa.linear(x, wq)
    print(f"card: {torch.cuda.get_device_name(0)}; {card_state()}", flush=True)
    print(f"K3 vs the default path: {int((k3 != ref).sum())} of {ref.numel()} elements "
          f"differ", flush=True)
    print(f"K4 vs the default path: {int((k4 != ref).sum())} of {ref.numel()} elements "
          f"differ", flush=True)
    for name, a, b in (("cuBLAS bf16 GEMM vs fp32-accumulated", q_lib, q_fp32),
                       ("projection kernel vs fp32-accumulated", q_kernel, q_fp32),
                       ("projection kernel vs cuBLAS bf16 GEMM", q_kernel, q_lib)):
        print(f"q projection, {name}: {int((a != b).sum())} of {a.numel()} elements "
              f"differ", flush=True)

    q = F.linear(x, wq)
    wqkv = torch.cat([wq, wk, wv])
    fns = {"default block (K2 + projections)": default,
           "K4's split path (K2 + q, k, v, output projections)": lambda: F.linear(
               fa.flash_attention_packed(F.linear(x, wq), F.linear(x, wk), F.linear(x, wv),
                                         H, scale), wo, bo),
           "K2": lambda: fa.flash_attention_packed(q, k, v, H, scale),
           "K3": lambda: fa.qout_self_attention_block(x, wq, k, v, wo, bo, H),
           "K4": lambda: fa.fused_self_attention_block(x, wq, wk, wv, wo, bo, H),
           "projection kernel N=320 + bias": lambda: fa.linear(x, wq, bo),
           "F.linear N=320 + bias": lambda: F.linear(x, wq, bo),
           "projection kernel N=960": lambda: fa.linear(x, wqkv),
           "F.linear N=960": lambda: F.linear(x, wqkv)}
    for i, name in enumerate(alternating(ROUNDS, tuple(fns))):
        ms, dev = median_ms(fns[name]), device_ms(fns[name])
        print(f"run {i} {name}: {ms:.4f} ms event-timed, {dev:.4f} ms on the device; "
              f"card after: {card_state()}", flush=True)


if __name__ == "__main__":
    main()
