#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``cyclediffusion_tpu_torch``) on one
NVIDIA GPU — the quickest proof that the port builds and runs on the card.

    python3 chip_smoke.py

Phases (each prints its results; any failure exits non-zero):

1. Device: refuses to run without CUDA; prints the card's name and power
   limit (nvidia-smi).
2. Build: compiles the two kernel libraries from ``csrc/`` with nvcc, one
   process each, started together; prints ptxas's registers and spills
   and, from ``cuobjdump -sass``, the count of Hopper's tensor-core
   (``HGMMA``) and TMA-load (``UTMALDG``) instructions in the bf16 wgmma
   kernels: the attention kernel in both libraries (K1/K2, and K3/K4's
   attention step; 4 head dims each, 32 to 80) and the folded library's projection
   kernel (7 widths K), which must have both and spill nothing; ptxas may
   not fence their products (warning C7519).
3. Kernel against plain: each of the four kernels (K1, K2 flash attention;
   K3, K4 folded self-attention) and its plain PyTorch version on the same
   inputs, at the main-path shapes in bf16 (and K2 at the encode chain's
   batch 2, K1 at LDM text2img-large's 32x32 level, d = 40, and at the
   FFHQ/CelebA LDM's, d = 32 over 14 heads, head views of token-major
   tensors, also in fp32; K1 and K2 at SDXL base's 1024 px levels, the
   CFG pair at d = 64: 20 heads over 1,024 tokens, 10 over 4,096), at ragged
   shapes (K1/K2 at every supported head dim, in bf16 and fp32, the
   sequence lengths off the kernel's 128-row tiles, one key axis shorter
   than a tile; K3/K4 off the tiles in bf16), and in fp32 with TF32 off;
   then K3/K4's projection kernel alone at its two main-path shapes, q (16384 x 320 x 320, with the bias as for the output) and
   [q | k | v] (16384 x 960 x 320), and one ragged shape (600 x 256 x 256);
   max abs error relative to max|plain| against a stated bound; median
   times of the kernel, the plain version and a library comparison
   (``scaled_dot_product_attention`` for K1/K2, the split path Linear ->
   SDPA -> Linear for K3/K4, ``F.linear`` for the projection), timed only
   and never on the path; each kernel's bound from its work at the
   main-path shape, and beside K1/K2's the floor that their exponentials
   alone set.
3b. GroupNorm: builds ``csrc/group_norm.cu`` (ptxas's registers, spills and
   stack frames), then the kernels with the SiLU fused against the plain
   version at the KL-f8 decoder's (1, 128, 512, 512) and the SD UNet's
   (8, 320, 64, 64) in bf16, channels-last: forward and backward (the
   input's gradient), max abs error relative to max|plain|, median ms of
   the kernel, the plain version and ``F.silu(F.group_norm(...))``
   (``library_ms``), the byte bound; two launches equal bit for bit.
4. The translate slice: SD-v1 at 512 px (full widths, seeded random
   weights, bf16), 2 translate requests through ``StochasticTextPipeline``
   — 50 DDIM steps, eta 0.1, encoder scale 1, decoder scale 5 — with the
   kernels' launch counts checked (5 of K1 and of K2 per UNet call), and one
   UNet call checked against the same call with plain attention.
4b. The folded modes: one batch-4 UNet call each with ``folded_attn="qo"``
   and ``"1"`` (same weights): 5 launches of K3 (or K4) and of K1, none of
   K2; eps against the default mode's; the step's ms in each mode.
5. Round trip: encode, then decode under the same text and scale 1, with
   deterministic cuDNN; with the UNet in fp32 the replay must give back the
   encoded latent (the bf16 round trip is printed, not bounded), exactly
   and in fast mode (``fast_key_every=2`` on both chains).
6. The ensemble: the task model (``TextUnsupervisedTranslation`` through the
   factory, ``CYCLEDIFFUSION_FOLDED_ATTN=qo``) encodes and ranks one 512 px
   image: SD-v1 bf16 loaded from phase 7's synthetic checkpoint, its
   full-width ViT-B/32 scorer with random weights, 2
   trials x skips [10, 25] x decoder scales [1, 5] = 8 candidates in chunks
   of 4.  Checks the UNet call count, 5 K3 launches per UNet call, the
   returned image against the winning candidate (bit-equal), the winner
   against the argmax of the scores recomputed candidate by candidate with
   ``DirectionalCLIP.__call__``, and the winning combo.
7. The CLI: SD v1 written as a CompVis checkpoint and loaded bit for bit
   through the factory, ``main`` on a cut SD experiment (2 real images).
8. Fast mode (encoder caching) on SD v1 at full width, phase 7's weights:
   ``ddim_decode_cached`` at ``key_every=1`` against ``ddim_decode``; the
   2-request translate exact and with ``fast_key_every=2`` alternating
   (UNet calls and K1/K2 launches by kind: 5/5 per key call, 3/3 per reuse
   call); a full and a reuse UNet call eager, graph-replayed and profiled;
   the CLI on a cut ``..._stochastic_fast.cfg``.
9. LDM text2img-large at its published widths (LDM-BERT 32 x 1280, the UNet
   with a 1280-d context, 256 px): a seeded CompVis checkpoint and a
   synthetic WordPiece vocab, loaded bit for bit through the factory;
   ``main`` on a cut ``..._latentdiff_stochastic_1.cfg`` (5 K1 launches at
   d = 40 per UNet call, no K2-K4); the batch-4 UNet step eager and
   graph-replayed, beside SD v1's in turns.
10. Unpaired translation, FFHQ -> CelebA-HQ (``LatentDiffStochastic``) at
   the published widths (UNet 274,056,163 params, VQ-f4 55,322,782): two
   seeded CompVis ``use_ema`` checkpoints (distinct raw UNet and EMA
   shadows) loaded bit for bit through the factory, three synthetic 1024 px
   FFHQ PNGs, ``main`` on the cut shipped experiment at batch 3 (100 encode
   + 100 replay + 40 refine UNet calls, 5 K1 launches at d = 32 each, none
   of K2-K4), an fp32 round trip on the latent (bounded at 50 steps as
   phase 5's, read at 100), the batch-3 UNet step eager and graph-replayed.
11. Unpaired translation in pixel space, AFHQ cat -> dog (``DDPM_DDIM``),
   at the published widths (the improved-DDPM ``afhq256`` UNet, 93,563,910
   params, fp32): two seeded improved-diffusion checkpoints (cat, dog)
   loaded bit for bit through the factory, a seeded pytorch-fid Inception,
   the committed 512 px JPEG cats (``tests/data_torch/jpeg/``, baseline
   4:2:0 as the AFHQ release) and synthetic dog PNGs, ``main`` on the shipped experiment
   cut to 100 encode steps of its 1000-step grid and refine 20 (99 source
   + 120 target UNet calls at batch 2, no kernel launch: its attention is
   at 256 tokens and fewer), under PyTorch's default flags as a user runs
   it (cuDNN's convolutions in TF32), ``translate_to_dog``'s PSNR / SSIM /
   L2 / FID / KID; the cats the CLI read against the fixtures' committed
   Pillow decode, resized; the card's Inception against the CPU's; an fp32 round
   trip with TF32 off (the replay's states against the encode chain's);
   the batch-2 UNet call eager and graph-replayed in fp32 (TF32 off and
   on) and bf16 beside its operation bound; 33 images through the FID's
   padded batches (one graph at 32).
12. Guided sampling (tracked config 5) and the rest of the latent surface:
   (a) SD v1 in bf16 at full width with a seeded ViT-B/32 scorer
   (``tools/guided_probe.py``'s problem): a 50-step eps replay at eta 0.1,
   CFG 5.0, batch 1, plain and CLIP-energy guided (weight 0.05, a gradient
   through the 512 px decoder and the vision tower every step) in turns,
   s/chain, ms/step, their ratio, mean|dz0| and the chains' peak memory,
   with a third chain in the turns that takes the energy's gradient eagerly
   (the four guided chains equal bit for bit); 50 UNet calls per chain
   with their K1/K2 launches and none in the energy's forward and backward;
   the ops PyTorch's deterministic mode flags in one eager gradient; the
   energy's profile (``guided_probe.energy_profile``: eager host and device
   ms, launches and device ms by kernel kind, operations and bound, the
   graph's capture and replay), four eager gradients at one input equal and
   the graphed gradient equal to them; a plain energy callable in two cut
   chains: one capture in the first, none in the second; weight 0 equal to
   the plain replay; K2 refusing an input that requires a gradient; the
   gradient, core and scorer in fp32, against a central difference along a
   seeded direction.  (c) The tiled decode of the 64x64 latent: one tile
   equal to the untiled decode, 3 x 3 patches in one decode call, the
   graphed tiled decode equal to the eager one, an energy gradient through
   it, eager and graphed (another graph: the tiling is in its signature).
   (b) The plain-inversion pipeline on the FFHQ LDM
   in fp32, 50 steps, 3 images, with K1 against plain attention.
13. Data and metrics (no kernel of K1-K4): every committed JPEG fixture
   decoded on the host against Pillow's stored decode (0 values may
   differ) and the ms per 512 px image; ``data/device_transforms``'s
   ``preprocess_batch`` on the card against the CPU, 8 images 512 -> 256
   and 256 -> 512 for each resize method, and its ms per batch; the seeded
   random-feature LPIPS (fp32, TF32 off) on the card against the CPU on 8
   pairs at 256 px, d(a, a) = 0, a small change closer than a large one,
   its ms per batch; ``LatentCoreSpec.from_yaml`` on SD v1's inference
   YAML (written by the phase in the reference's layout) against the
   ``sd_v1`` preset, and ``pixel_spec_from_yml`` on an AFHQ ``.yml``
   against the zoo.
14. The driver across processes and devices, on the one card (each child
   process of this script, ``--child``, bounded by a timeout): (a) phase 7's
   cut SD experiment on 3 images at batch 1, first in one process, then in
   two processes on ``cuda:0`` joined over gloo with a ``file://`` init
   (ragged shards: the second wrap-pads), with rank 0's metrics against the
   one process's (JAX's bound, 1e-4 + 1e-3 |x|), the gathered ``temp_gen``
   images bit for bit, each process's K1/K2 launches; (b) a one-rank NCCL
   group: an all-gather, an all-reduce and one ``Driver.train`` step through
   its gradient all-reduce; (c) SD v1's UNet (bf16) sharded at ``n_model``
   2, ``min_size`` 512 (JAX's 206 parameters) over two ranks on ``cuda:0``
   against the whole call (phase 4's bound), both timed; (d) one AdamW and
   one Adafactor step over SD v1's UNet shapes (859,520,964 fp32 parameters)
   with seeded gradients, ms and peak memory beside the bytes bound; JAX's
   toy regression through ``Driver.train`` on the card and the CPU; the
   port's optimisers against optax's trajectories
   (``tests/data_torch/flax/optax_trajectories.npz``); (e) the Flax
   msgpack fixture read against its npz twin, bit for bit.
15. Inputs: every image file the JAX package's loader reads, and the JAX
   driver's checkpoint.  (a) Every committed image fixture
   (``tests/data_torch/images/``: palette, grey + alpha, 1/2/4/16-bit and
   Adam7 PNGs, GIFs, progressive JPEGs, complete and cut after an early
   scan (libjpeg-turbo's block smoothing), CMYK and YCCK JPEGs; and the baseline
   JPEGs of ``tests/data_torch/jpeg/``) decoded on the card's host by
   ``load_image`` against Pillow's stored decode (0 values may differ),
   and the median host ms per 512 px image of each kind.  (b) Phase 7's cut
   SD experiment on a data root whose ``data/translate-text.json`` names
   seven of them (a palette PNG, a 16-bit RGB PNG, an Adam7 PNG, a GIF, a
   progressive, a CMYK and a 512 px cut progressive JPEG) at batch 2: each
   ``original_image`` the
   task model receives equals the 512 px preprocess of Pillow's stored
   decode bit for bit, K1 and K2 launch as in phase 7 (250 each per
   sample), the run leaves its files.  (c) SD v1's seeded bf16 core written
   by ``Driver.save_model`` as ``model_params.msgpack`` and read back by
   ``Driver.load_model`` into another core bit for bit; the file's bytes
   and the write and read seconds on the host.

Graphs: on the card every pipeline's UNet call replays a CUDA graph
captured at its first call (``runtime.graphs``), the kernels inside, and so
do the text encoders, the first stage's encode and decode, the CLIP
scorer's towers, the FID's Inception features and the guided energy's
gradient, so the phases above run graphed.  Phases 4 (the SD translate), 6
(the ensemble in chunks of 3, a padded tail, ranked), 8 (fast mode's key
and reuse calls), 9 (LDM text2img-large), 10 (the FFHQ LDM's encode,
replay and refine), 11 (the AFHQ pixel chains, TF32 convolutions) and 12
(the guided chain's UNet calls and energy, and the plain-inversion
pipeline) each run a cut chain of their path (10 steps) at full width
graphed, eager (every graphed entry point it reaches swapped for its
``*_eager`` twin), graphed, from the same inputs and noise, and fail unless
every call of every entry point in the last run was a replay and the
graphed results equal the eager ones bit for bit; each
prints host ms per UNet call graphed and eager, each graph's replay ms,
launches and capture seconds, the card's busy share (every replay's device
time over the chain's host time; the UNet replays' alone beside it) and
peak memory.  Each program is also held against its eager twin at its
path's shapes (``graphed_program``): CLIP ViT-L/14 text and the KL-f8
encode and decode at 512 px (phase 4), the ViT-B/32 towers (6), LDM-BERT
and the KL-f8 first stage at 256 px (9), the VQ-f4 first stage (10),
Inception at the FID's batch of 32 (11), the energy gradient and the tiled
decode (12), with replay, eager and capture times.  UNet calls that
compare a kernel with plain attention, and the probes that time one call,
use the eager entry points (``apply_model_eager``, ``_model_fn_eager``).

Each phase prints its peak device memory.  The last three lines of output
are the card's name and power limit, the kernels' JSON record and the
result ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import types

ROOT = os.path.dirname(os.path.abspath(__file__))

# kernel vs plain, max abs error / max|plain output|.  bf16: the kernel
# rounds its output once after normalising, the plain version rounds the
# softmax weights before P.V, so the two differ by about one bf16 ulp, at
# most 2^-7 (7.8e-3) of the largest output.  A kernel that dropped one
# 128-key tile of 4096 would miss by ~3% of it.
BF16_REL_BOUND = 1e-2
FP32_REL_BOUND = 1e-4  # fp32, TF32 off: only the summation order differs
UNET_REL_BOUND = 5e-2  # whole bf16 UNet, kernels vs plain attention, / max|eps|
ROUND_TRIP_BOUND = 1e-3  # max|replay - x0| on the latent, fp32 UNet (|x0| ~ 2.5)
# fp32 DirectionalCLIP scores, the batched ranking vs one candidate at a time
# (the GEMMs may sum in another order at another batch size)
SCORE_BOUND = 1e-4
STEPS = 50
ETA = 0.1
FAST_KEY_EVERY = 2  # the shipped fast config's
# fast mode at key_every=1 against the exact replay: the key call runs the
# exact call's operations, so bit for bit is expected; this bounds it
KEY1_REL_BOUND = 1e-6
# the card's published peaks (H100 SXM, dense): bf16 tensor cores, fp32 CUDA
# cores, HBM bandwidth
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}
TF32_FLOPS = 495e12     # TF32 tensor cores, dense
PEAK_BYTES = 3.35e12
# exponentials per second of the H100 SXM's special-function units (FA3
# paper, Shah et al. 2024, sec. 3): one per logit sets a floor under K1/K2
EXP_RATE = 3.9e12

# the bf16 wgmma/TMA kernels whose SASS phase 2 checks: library -> (kernel
# name, instantiations); the folded library carries its own copy of the
# attention kernel
SASS_KERNELS = {
    "libflash_attention": (("flash_fwd_bf16_kernel", 4),),
    "libfolded_attention": (("flash_fwd_bf16_kernel", 4), ("linear_bf16_kernel", 7)),
}

KERNELS = {  # name -> (id, source under the repo, the TPU kernel it replaces)
    "flash_attention_bhtd": ("K1", "cyclediffusion_tpu_torch/csrc/flash_attention.cu",
                             "cyclediffusion_tpu/ops/flash_attention.py:187"),
    "flash_attention_packed": ("K2", "cyclediffusion_tpu_torch/csrc/flash_attention.cu",
                               "cyclediffusion_tpu/ops/flash_attention.py:267"),
    "qout_self_attention_block": ("K3", "cyclediffusion_tpu_torch/csrc/folded_attention.cu",
                                  "cyclediffusion_tpu/ops/flash_attention.py:421"),
    "fused_self_attention_block": ("K4", "cyclediffusion_tpu_torch/csrc/folded_attention.cu",
                                   "cyclediffusion_tpu/ops/flash_attention.py:482"),
}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


# the attention kernels K1-K4 and the GroupNorm kernels, by their names in
# ``ops.launches.counts``
ATTENTION_KERNELS = ("flash_attention_packed", "flash_attention_bhtd",
                     "qout_self_attention_block", "fused_self_attention_block")
GROUP_NORM_KERNELS = ("group_norm", "group_norm_backward", "group_norm_shift")


def reset_launches() -> None:
    """Set every kernel's launch count to zero."""
    from cyclediffusion_tpu_torch.ops import launches

    launches.reset()


def launched(names=ATTENTION_KERNELS) -> dict:
    """The launches of the kernels ``names`` (K1-K4 by default) counted
    since the last reset."""
    from cyclediffusion_tpu_torch.ops import launches

    return {name: launches.counts[name] for name in names}


# the device memory peak since the last reset_peak, kept across the resets
# that graphed_chain makes to read each of its runs' own peak
_PEAK_HELD = [0]


def reset_peak(torch) -> None:
    """Start a new peak of device memory."""
    _PEAK_HELD[0] = 0
    torch.cuda.reset_peak_memory_stats()


def say_peak(torch, phase: str) -> None:
    """The phase's peak device memory (since its last reset_peak)."""
    peak = max(_PEAK_HELD[0], torch.cuda.max_memory_allocated())
    say(f"{phase}: peak device memory {peak / 2**30:.2f} GiB")


def cuda_time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds per call, CUDA events around each call."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"


def flat_tensors(out) -> list:
    """A chain's result (a tensor, or nested lists and tuples of them) as a
    flat list."""
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in flat_tensors(o)]
    return [out]


def rel_diff(torch, got: list, want: list) -> float:
    """max |got - want| / max |want| over paired tensors."""
    num = max(float((a - b).abs().max()) for a, b in zip(got, want))
    return num / max(float(b.abs().max()) for b in want)


# each graphed entry point -> the GraphedCall attributes of its owner that it
# replays (a core, a pixel pipeline, a CLIP scorer, a guided energy)
GRAPHS_OF = {"apply_model": ("_graphed_apply",),
             "apply_model_cached": ("_graphed_key", "_graphed_reuse"),
             "_model_fn": ("_graphed",),
             "get_learned_conditioning": ("_graphed_cond",),
             "encode_first_stage": ("_graphed_encode",),
             "decode_first_stage": ("_graphed_decode",),
             "embed_image": ("_graphed_image",), "embed_text": ("_graphed_text",),
             "grad": ("_graphed_grad",), "inception": ("_graphed",)}
# a text core's first stage and conditioning, as a chain reaches them
TEXT_PROGRAMS = ("get_learned_conditioning", "encode_first_stage", "decode_first_stage")
FIRST_STAGE = ("encode_first_stage", "decode_first_stage")


def graphs_of(owner, name) -> list:
    """The captured graphs behind ``owner.name``."""
    return [c for attr in GRAPHS_OF[name] if getattr(owner, attr, None) is not None
            for c in getattr(owner, attr).graphs.values()]


def graphed_chain(torch, label, target, names, run, calls, programs=()) -> dict:
    """A chain whose UNet calls and other programs replay CUDA graphs
    against the same chain eager.  ``target`` (a core or a pixel pipeline)
    has the graphed UNet entry points ``names`` (``apply_model``,
    ``apply_model_cached``, ``_model_fn``) and ``programs`` lists ``(owner,
    names)`` of the other graphed entry points the chain reaches (a core's
    ``get_learned_conditioning``, ``encode_first_stage`` and
    ``decode_first_stage``, a scorer's ``embed_image`` and ``embed_text``, a
    guided energy's ``grad``), each with its ``*_eager`` twin that the eager
    run puts in its place; ``run()`` builds the chain from them and runs it on
    the same inputs and noise each time -> its result; ``calls`` is its UNet
    calls.  Runs graphed (a signature's first call warms up and captures:
    set-up), eager (counting each entry point's calls), graphed again; fails
    unless the results are equal bit for bit (the replays run the eager
    calls' kernels on the same inputs, and the step arithmetic between calls
    is the same eager code) and every call of every entry point in the
    second graphed run was a replay.  Busy share: every replay's device time (each graph's
    replay timed alone by CUDA events) over the chain's host time; the UNet
    replays' alone beside it (the share before the other programs were
    graphed)."""
    swaps = [(target, names)] + list(programs)

    def every():
        return [(owner, name, c) for owner, ns in swaps for name in ns
                for c in graphs_of(owner, name)]

    def timed():
        torch.cuda.synchronize()
        _PEAK_HELD[0] = max(_PEAK_HELD[0], torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        return (flat_tensors(out), time.perf_counter() - t0,
                torch.cuda.max_memory_allocated() / 2 ** 30)

    known = {id(c) for _, _, c in every()}
    first, first_s, first_peak = timed()
    new = [c for _, _, c in every() if id(c) not in known]
    eager_calls = {}

    def counting(owner, name):
        fn = getattr(owner, name + "_eager")

        def call(*a, **kw):
            eager_calls[(id(owner), name)] = eager_calls.get((id(owner), name), 0) + 1
            return fn(*a, **kw)
        return call

    for owner, ns in swaps:
        for name in ns:
            setattr(owner, name, counting(owner, name))
    try:
        eager, eager_s, eager_peak = timed()
        counted = dict(eager_calls)
    finally:
        for owner, ns in swaps:
            for name in ns:
                delattr(owner, name)
    before = {id(c): c.replays for _, _, c in every()}
    again, graphed_s, _ = timed()
    used = [(owner, name, c, c.replays - before[id(c)]) for owner, name, c in every()
            if c.replays > before[id(c)]]
    if len(first) != len(eager) or len(again) != len(eager):
        fail(f"{label}: the graphed chain gave {len(again)} tensors, the eager {len(eager)}")
    if not all(torch.equal(a, e) and torch.equal(b, e) for a, b, e in zip(first, again, eager)):
        rel = max(rel_diff(torch, first, eager), rel_diff(torch, again, eager))
        fail(f"{label}: the graphed chain differs from the eager chain: {rel:.3e} of "
             "max|eager|")
    per_entry = {}
    for owner, ns in swaps:
        for name in ns:
            n = sum(k for o, nm, _, k in used if o is owner and nm == name)
            want = counted.get((id(owner), name), 0)
            if n != want:
                fail(f"{label}: {n} graph replays of {name} where the eager chain made "
                     f"{want} calls")
            per_entry[name] = per_entry.get(name, 0) + n
    unet = sum(per_entry.get(name, 0) for name in names)
    if unet != calls:
        fail(f"{label}: {unet} UNet graph replays in a chain of {calls} UNet calls")
    replay_ms = [cuda_time_ms(c.replay, reps=10, warmup=1) for _, _, c, _ in used]
    busy_ms = sum(k * ms for (_, _, _, k), ms in zip(used, replay_ms))
    unet_ms = sum(k * ms for (_, name, _, k), ms in zip(used, replay_ms) if name in names)
    graphs_rec = [{"entry": name, "replays": k, "replay_ms": ms,
                   "launches": {kk: n for kk, n in c.launches.items() if n},
                   "capture_s": c.seconds}
                  for (_, name, c, k), ms in zip(used, replay_ms)]
    rec = {"path": label, "calls": calls, "replays": per_entry,
           "graphed_ms_per_call": 1e3 * graphed_s / calls,
           "eager_ms_per_call": 1e3 * eager_s / calls,
           "graphs": len(used), "graph_records": graphs_rec,
           "busy_graphed": busy_ms / (1e3 * graphed_s),
           "busy_eager": busy_ms / (1e3 * eager_s),
           "unet_busy_graphed": unet_ms / (1e3 * graphed_s),
           "unet_graphs": sum(1 for _, name, _, _ in used if name in names),
           "capture_s_this_run": sum(c.seconds for c in new),
           "capture_s": sum(c.seconds for _, _, c, _ in used), "first_run_s": first_s,
           "chain_s": {"graphed": graphed_s, "eager": eager_s},
           "peak_graphed_gib": first_peak, "peak_eager_gib": eager_peak}
    say(f"{label}: graphed chain == eager chain bit for bit ({calls} UNet calls; replays by "
        f"entry point {per_entry}, every call a replay, {len(used)} graph(s)); host ms "
        f"per UNet call graphed {rec['graphed_ms_per_call']:.3f}, eager "
        f"{rec['eager_ms_per_call']:.3f} (chain {graphed_s:.4f} s graphed, {eager_s:.4f} s "
        f"eager); card busy (every replay / chain) graphed {rec['busy_graphed']:.3f}, eager "
        f"{rec['busy_eager']:.3f}; UNet replays alone "
        f"{rec['unet_busy_graphed']:.3f}; capture {rec['capture_s']:.3f} s for the graphs "
        f"it replays ({rec['capture_s_this_run']:.3f} s in this run, whose first chain took "
        f"{first_s:.3f} s); peak device memory graphed {first_peak:.2f} GiB, eager "
        f"{eager_peak:.2f} GiB ({card_name()})")
    for g in graphs_rec:
        say(f"{label}:   graph of {g['entry']}: {g['replays']} replays, replay "
            f"{g['replay_ms']:.4f} ms, launches per replay {g['launches']}, capture "
            f"{g['capture_s']:.3f} s")
    return rec


def first_calls(owners) -> dict:
    """{id: (warm-up host s, capture s)} of every graph the owners hold."""
    return {id(c): (c.warm_up_seconds, c.seconds) for owner in owners
            for name in GRAPHS_OF for c in graphs_of(owner, name)}


def say_setup(label, owners, known: dict) -> None:
    """The first calls of graphs made since ``known`` (a :func:`first_calls`)
    among ``owners``: how much of a CLI's time was set-up."""
    new = [v for k, v in first_calls(owners).items() if k not in known]
    say(f"{label}: set-up inside the run: {len(new)} graphs made, warm-ups "
        f"{sum(w for w, _ in new):.3f} s of host time, captures {sum(c for _, c in new):.3f} s")


def graphed_program(torch, label, owner, name, args) -> dict:
    """One graphed entry point (``owner.name``, see ``GRAPHS_OF``) at a
    path's real shapes against its ``*_eager`` twin: the graphed call twice
    (the first may warm up and capture; the second replays), the eager
    once; fails unless both graphed results equal the eager one bit for
    bit.  -> replay ms (CUDA events), eager ms, host ms per graphed call, capture
    s, launches per replay."""
    graphed, eager = getattr(owner, name), getattr(owner, name + "_eager")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first = flat_tensors(graphed(*args))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    before = {id(c): c.replays for c in graphs_of(owner, name)}
    again = flat_tensors(graphed(*args))
    used = [c for c in graphs_of(owner, name) if c.replays > before.get(id(c), c.replays)]
    want = flat_tensors(eager(*args))
    if len(used) != 1:
        fail(f"{label}: the second graphed call replayed {len(used)} graphs, not 1")
    rel = max(rel_diff(torch, first, want), rel_diff(torch, again, want))
    if not all(torch.equal(a, w) and torch.equal(b, w) for a, b, w in zip(first, again, want)):
        fail(f"{label}: the graphed call differs from the eager one: {rel:.3e} of max")
    c = used[0]
    rec = {"program": label, "replay_ms": cuda_time_ms(c.replay, reps=10, warmup=1),
           "eager_ms": cuda_time_ms(lambda: eager(*args), reps=5, warmup=1),
           "graphed_call_ms": cuda_time_ms(lambda: graphed(*args), reps=5, warmup=1),
           "capture_s": c.seconds, "first_call_s": first_s,
           "launches": {k: n for k, n in c.launches.items() if n}, "rel": rel}
    say(f"{label}: graphed == eager bit for bit; replay {rec['replay_ms']:.4f} ms, eager "
        f"{rec['eager_ms']:.4f} ms, graphed call (copies in and out) "
        f"{rec['graphed_call_ms']:.4f} ms by CUDA events; capture {c.seconds:.3f} s (first "
        f"call {first_s:.3f} s); kernel launches per replay {rec['launches']} "
        f"({card_name()})")
    return rec


def work(name: str, shp, dtype_name: str):
    """(flops, bytes) of one call: the matrix products' operations and each
    input read once, each output written once.  Shapes as in ``cases``."""
    elt = 2 if dtype_name == "bf16" else 4
    if name == "linear":
        m, n, k, bias = shp
        return 2 * m * n * k, elt * (m * k + n * k + m * n + (n if bias else 0))
    if name == "flash_attention_packed":
        b, tq, tk, h, d = shp
        return 4 * b * h * tq * tk * d, elt * b * h * d * (2 * tq + 2 * tk)
    if name == "flash_attention_bhtd":
        b, h, tq, tk, d = shp
        return 4 * b * h * tq * tk * d, elt * b * h * d * (2 * tq + 2 * tk)
    if name == "qout_self_attention_block":
        b, tq, tk, c, h = shp     # H*D = C
        flops = 4 * b * tq * tk * c + 2 * (2 * b * tq * c * c)
        return flops, elt * (2 * b * tq * c + 2 * b * tk * c + 2 * c * c + c)
    b, t, c, h = shp              # fused_self_attention_block
    flops = 4 * b * t * t * c + 4 * (2 * b * t * c * c)
    return flops, elt * (2 * b * t * c + 4 * c * c + c)


def bound_of(name: str, shp, dtype_name: str):
    """(least ms on the card, "operations" or "bytes")."""
    flops, nbytes = work(name, shp, dtype_name)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype_name], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def exp_floor_ms(name: str, shp) -> float:
    """K1/K2: the ms the exponentials alone take, one per logit (B*H*Tq*Tk)
    at ``EXP_RATE``.  Shapes as in ``cases``."""
    if name == "flash_attention_packed":
        b, tq, tk, h, _ = shp
    else:
        b, h, tq, tk, _ = shp
    return 1e3 * b * h * tq * tk / EXP_RATE


def build_report(infos) -> None:
    """Phase 2: ptxas's registers and spills from the build logs, and the
    Hopper instructions in the bf16 wgmma kernels' SASS (``SASS_KERNELS``);
    fails if those kernels spill or lack wgmma (HGMMA) or TMA loads
    (UTMALDG)."""
    from cyclediffusion_tpu_torch.ops import cuda_build

    names = {name for kernels in SASS_KERNELS.values() for name, _ in kernels}
    for info in infos:
        entry = ""
        for line in info.log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line
            if "registers" in line or "spill" in line:
                say(f"build: {line.strip()}")
            if (any(n in entry for n in names) and "spill" in line
                    and "0 bytes spill stores, 0 bytes spill loads" not in line):
                fail(f"{entry} spills registers: {line.strip()}")
            if "C7519" in line and any(n in line for n in names):
                fail(f"ptxas serialises the products of a wgmma kernel: {line.strip()}")
    cuobjdump = os.path.join(os.path.dirname(cuda_build.find_nvcc()), "cuobjdump")
    for info in infos:
        lib = info.path.name.split("-")[0]
        cmd = [cuobjdump, "-sass", str(info.path)]
        sass = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if sass.returncode != 0:
            fail(f"{' '.join(cmd)} failed: {sass.stderr.strip()[:500]}")
        counts, fn = {}, None
        for line in sass.stdout.splitlines():
            if "Function :" in line:
                fn = line.split("Function :")[1].strip()
                counts[fn] = {"HGMMA": 0, "UTMALDG": 0}
            elif fn is not None:
                for op in ("HGMMA", "UTMALDG"):
                    if f" {op}." in line or f" {op} " in line:
                        counts[fn][op] += 1
        for name, n in SASS_KERNELS[lib]:
            kernels = [f for f in counts if name in f]
            for f in kernels:
                say(f"build: cuobjdump -sass {info.path.name}: {f}: {counts[f]['HGMMA']} "
                    f"HGMMA, {counts[f]['UTMALDG']} UTMALDG")
            if len(kernels) != n or not all(counts[f]["HGMMA"] and counts[f]["UTMALDG"]
                                            for f in kernels):
                fail(f"{lib}: {n} instantiation(s) of {name} must hold HGMMA and UTMALDG: "
                     f"{ {f: counts[f] for f in kernels} }")


def phase_kernels(torch, fa):
    """Phase 3: every kernel against its plain version on the card."""
    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

    def heads(x, h):
        b, t, w = x.shape
        return x.view(b, t, h, w // h).transpose(1, 2)

    def split_path(x, wq, k, v, wo, bo, h):
        """Linear -> SDPA -> Linear: the library's way to the folded block."""
        o = F.scaled_dot_product_attention(heads(F.linear(x, wq), h), heads(k, h),
                                           heads(v, h))
        return F.linear(o.transpose(1, 2).reshape(x.shape[0], x.shape[1], -1), wo, bo)

    bf16, f32 = torch.bfloat16, torch.float32
    # (kernel, label, dtype, shape); packed: (B, Tq, Tk, H, d), bhtd:
    # (B, H, Tq, Tk, d), qout: (B, Tq, Tk, C, H), fused: (B, T, C, H), with
    # H*d = C.  "main path": what the slices below give the kernels (2
    # requests, or one image's 2 candidates, x the CFG pair); its numbers go
    # to the JSON record.  K1/K2's ragged shapes: every supported head dim,
    # Tq and Tk off the 128-row q and key tiles, one key axis (77) shorter
    # than a tile, and K2's own layout at d = 40, H = 8
    ragged_flash = [
        ("flash_attention_bhtd", (1, 2, 1024, 77, 40)),
        ("flash_attention_bhtd", (2, 3, 300, 333, 40)),
        ("flash_attention_bhtd", (1, 2, 200, 77, 64)),
        ("flash_attention_bhtd", (2, 2, 333, 515, 80)),
        ("flash_attention_bhtd", (2, 14, 300, 333, 32)),
        ("flash_attention_packed", (2, 300, 200, 4, 64)),
        ("flash_attention_packed", (2, 1000, 1100, 8, 40)),
        ("flash_attention_packed", (2, 300, 200, 14, 32)),
    ]
    cases = [
        ("flash_attention_packed", "main path", bf16, (4, 4096, 4096, 8, 40)),
        ("flash_attention_bhtd", "main path", bf16, (4, 8, 1024, 1024, 80)),
        ("qout_self_attention_block", "main path", bf16, (4, 4096, 4096, 320, 8)),
        ("fused_self_attention_block", "main path", bf16, (4, 4096, 320, 8)),
        ("flash_attention_packed", "encode chain", bf16, (2, 4096, 4096, 8, 40)),
        ("flash_attention_bhtd", "ldm 32x32", bf16, (4, 8, 1024, 1024, 40)),
        ("flash_attention_bhtd", "ffhq 32x32", bf16, (3, 14, 1024, 1024, 32)),
        # SDXL base at 1024 px, the CFG pair: 20 heads of 64 at 32x32, 10 at 64x64
        ("flash_attention_bhtd", "sdxl 32x32", bf16, (2, 20, 1024, 1024, 64)),
        ("flash_attention_packed", "sdxl 64x64", bf16, (2, 4096, 4096, 10, 64)),
        *[(name, "ragged", dtype, shp) for dtype in (bf16, f32) for name, shp in ragged_flash],
        ("qout_self_attention_block", "ragged", bf16, (2, 300, 200, 256, 4)),
        ("fused_self_attention_block", "ragged", bf16, (2, 300, 256, 4)),
        ("flash_attention_packed", "sd 64x64", f32, (2, 4096, 4096, 8, 40)),
        ("flash_attention_bhtd", "sd 32x32", f32, (2, 8, 1024, 1024, 80)),
        ("flash_attention_bhtd", "ffhq 32x32", f32, (3, 14, 1024, 1024, 32)),
        ("qout_self_attention_block", "sd 64x64", f32, (2, 4096, 4096, 320, 8)),
        ("fused_self_attention_block", "sd 64x64", f32, (2, 4096, 320, 8)),
        # K3/K4's projection kernel alone, (M, N, K, bias): q with the bias
        # the output projection adds, [q | k | v], and a ragged M
        ("linear", "projection", bf16, (16384, 320, 320, True)),
        ("linear", "projection", bf16, (16384, 960, 320, False)),
        ("linear", "ragged", bf16, (600, 256, 256, True)),
    ]
    reset_peak(torch)
    record = {}
    for name, label, dtype, shp in cases:
        if name == "flash_attention_packed":
            b, tq, tk, h, d = shp
            q, k, v = rand((b, tq, h * d), dtype), rand((b, tk, h * d), dtype), rand((b, tk, h * d), dtype)
            kernel = functools.partial(fa.flash_attention_packed, q, k, v, h, d ** -0.5)
            plain = functools.partial(fa.attention_packed_reference, q, k, v, h, d ** -0.5)
            library = functools.partial(F.scaled_dot_product_attention, heads(q, h),
                                        heads(k, h), heads(v, h))
        elif name == "flash_attention_bhtd":
            b, h, tq, tk, d = shp
            if label == "ffhq 32x32":   # as the UNet hands them: head views of (B, T, H*d)
                q, k, v = (heads(rand((b, t, h * d), dtype), h) for t in (tq, tk, tk))
            else:
                q, k, v = (rand((b, h, t, d), dtype) for t in (tq, tk, tk))
            kernel = functools.partial(fa.flash_attention_bhtd, q, k, v, d ** -0.5)
            plain = functools.partial(fa.attention_reference, q, k, v, d ** -0.5)
            library = functools.partial(F.scaled_dot_product_attention, q, k, v)
        elif name == "linear":
            m, n, kk, has_bias = shp
            x, w = rand((m, kk), dtype), rand((n, kk), dtype, kk ** -0.5)
            bias = rand((n,), dtype, 0.1) if has_bias else None
            kernel = functools.partial(fa.linear, x, w, bias)
            plain = functools.partial(fa.linear_reference, x, w, bias)
            library = functools.partial(F.linear, x, w, bias)
        else:
            if name == "qout_self_attention_block":
                b, tq, tk, c, h = shp
            else:
                b, tq, c, h = shp
                tk = tq
            x = rand((b, tq, c), dtype)
            wq, wk, wv = (rand((c, c), dtype, c ** -0.5) for _ in range(3))
            wo, bo = rand((c, c), dtype, c ** -0.5), rand((c,), dtype, 0.1)
            if name == "qout_self_attention_block":
                x_kv = rand((b, tk, c), dtype)
                k, v = F.linear(x_kv, wk), F.linear(x_kv, wv)
                kernel = functools.partial(fa.qout_self_attention_block, x, wq, k, v, wo, bo, h)
                plain = functools.partial(fa.qout_self_attention_reference, x, wq, k, v, wo, bo, h)
                library = functools.partial(split_path, x, wq, k, v, wo, bo, h)
            else:
                kernel = functools.partial(fa.fused_self_attention_block, x, wq, wk, wv, wo, bo, h)
                plain = functools.partial(fa.fused_self_attention_reference, x, wq, wk, wv, wo, bo, h)
                library = lambda x=x, wq=wq, wk=wk, wv=wv, wo=wo, bo=bo, h=h: split_path(
                    x, wq, F.linear(x, wk), F.linear(x, wv), wo, bo, h)
        out = kernel()
        torch.cuda.synchronize()
        want = plain()
        err = float((out.float() - want.float()).abs().max())
        peak = float(want.float().abs().max())
        rel = err / peak
        bound = BF16_REL_BOUND if dtype == bf16 else FP32_REL_BOUND
        if not torch.isfinite(out).all():
            fail(f"{name} {label} {dtype}: non-finite output")
        # the kernel is deterministic: a second launch gives the same bits
        again = kernel()
        if not torch.equal(out, again):
            fail(f"{name} {label} {dtype}: two launches differ")
        dname = "bf16" if dtype == bf16 else "fp32"
        ms, plain_ms, library_ms = (cuda_time_ms(fn) for fn in (kernel, plain, library))
        bound_ms, bound_by = bound_of(name, shp, dname)
        floor = (f"; exp floor {exp_floor_ms(name, shp):.4f} ms"
                 if name in ("flash_attention_packed", "flash_attention_bhtd") else "")
        kid = KERNELS[name][0] if name in KERNELS else "K3/K4 part"
        say(f"kernel {kid} {name} [{label}] {dname} shape={shp}: "
            f"max_abs_err={err:.3e}, max|plain|={peak:.3e}, ratio {rel:.3e} "
            f"(bound {bound:.3e}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"library {library_ms:.4f} ms; least time {bound_ms:.4f} ms ({bound_by})"
            f"{floor}")
        if not rel <= bound:
            fail(f"{name} {label} {dtype}: max_abs_err / max|plain| = {rel} > {bound}")
        if label == "main path":
            record[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                            "bound_ms": bound_ms, "bound_by": bound_by,
                            "library_ms": library_ms}
    say_peak(torch, "kernels")
    return record


# the GroupNorm kernels' main-path shapes (bf16, channels-last): the KL-f8
# decoder's 512 px level at batch 1 (the energy's decode) and the SD UNet's
# 64x64 level at batch 8 (4 images x the CFG pair)
GN_CASES = (("decoder 512 px", (1, 128, 512, 512)), ("unet 64x64", (8, 320, 64, 64)))
# the case at which the main path also folds a shift into the norm (each
# ResBlock's second norm takes the timestep embedding, (N, C))
GN_SHIFT_CASE = "unet 64x64"


def group_norm_bound_ms(shape, backward: bool) -> float:
    """Least ms of a bf16 GroupNorm call on the card: x read and y written
    once (forward), x and dy read and dx written once (backward)."""
    return 1e3 * (3 if backward else 2) * math.prod(shape) * 2 / PEAK_BYTES


def device_ms(torch, fn, calls: int = 10) -> float:
    """Device ms per call of ``fn``: the kernels' own time under
    torch.profiler over ``calls`` calls (host gaps left out)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / 1e3 / calls


def phase_group_norm(torch) -> list:
    """Phase 3b: the GroupNorm kernels with the SiLU fused against the plain
    version and ``F.silu(F.group_norm(...))`` (``library_ms``) at
    ``GN_CASES``, forward and backward (the input's gradient, and the
    shift's), each beside its byte bound; at ``GN_SHIFT_CASE`` also with the
    per-channel shift that the main path folds in there."""
    from cyclediffusion_tpu_torch.ops import group_norm as gn

    F = torch.nn.functional
    info = gn.load_kernels()
    say(f"build: {info.path.name} {'built' if info.built else 'found'} in "
        f"{info.seconds:.2f} s")
    for line in info.log.splitlines():
        if "registers" in line or "spill" in line or "stack frame" in line:
            say(f"build: {line.strip()}")
    bf16 = torch.bfloat16
    record = []
    for label, shape in GN_CASES:
        gen = torch.Generator(device="cuda").manual_seed(0)
        c = shape[1]

        def rand(scale=1.0, shift=0.0, shp=shape):
            t = torch.randn(shp, generator=gen, device="cuda") * scale + shift
            return t.to(bf16).contiguous(memory_format=torch.channels_last) if len(shp) == 4 \
                else t.to(bf16)

        x, dy = rand(2.0, 0.7), rand()
        w, b = rand(0.1, 1.0, (c,)), rand(0.1, 0.0, (c,))
        shifts = (None, rand(shp=shape[:2])) if label == GN_SHIFT_CASE else (None,)
        for s in shifts:
            case = label if s is None else f"{label} + shift"
            fns = {"kernel": lambda t, sh: gn.group_norm(t, w, b, 32, 1e-6, silu=True,
                                                         shift=sh),
                   "plain": lambda t, sh: gn.group_norm_reference(t, w, b, 32, 1e-6,
                                                                  silu=True, shift=sh),
                   "library": lambda t, sh: F.silu(F.group_norm(
                       t if sh is None else t + sh[:, :, None, None], 32, w, b, 1e-6))}
            outs, grads, ms = {}, {}, {}
            for kind, fn in fns.items():
                outs[kind] = fn(x, s)
                ms[("forward", kind)] = cuda_time_ms(functools.partial(fn, x, s))
                ms[("forward", kind, "device")] = device_ms(torch, functools.partial(fn, x, s))
                # the gradients of x and, where there is one, of the shift
                xg, *sg = (t.detach().requires_grad_(True) for t in (x, s) if t is not None)
                y = fn(xg, sg[0] if sg else None)
                grad = functools.partial(torch.autograd.grad, y, (xg, *sg), dy,
                                         retain_graph=True)
                grads[kind] = grad()
                ms[("backward", kind)] = cuda_time_ms(grad)
                ms[("backward", kind, "device")] = device_ms(torch, grad)
                del y, grad
            torch.cuda.synchronize()
            for pass_, got, want in (("forward", (outs["kernel"],), (outs["plain"],)),
                                     ("backward", grads["kernel"], grads["plain"])):
                errs = [float((got[0].float() - want[0].float()).abs().max()
                              / want[0].float().abs().max())]
                if len(got) == 2:
                    # the shift's gradient, the input's summed over the pixels:
                    # beside its peak, the input gradient's over sqrt(pixels)
                    # independent roundings (as the card tests hold it)
                    scale = (float(want[1].abs().max()) + 2 * float(want[0].abs().max())
                             * math.sqrt(math.prod(shape[2:])))
                    errs.append(float((got[1].float() - want[1].float()).abs().max()) / scale)
                rel = max(errs)
                bound_ms = group_norm_bound_ms(shape, pass_ == "backward")
                rec = {"shape": list(shape), "case": case, "shift": s is not None,
                       "pass": pass_, "dtype": "bf16",
                       "ms": ms[(pass_, "kernel")], "plain_ms": ms[(pass_, "plain")],
                       "library_ms": ms[(pass_, "library")], "bound_ms": bound_ms,
                       "bound_by": "bytes", "rel_err": rel,
                       **{f"{k}device_ms": ms[(pass_, kind, "device")]
                          for k, kind in (("", "kernel"), ("plain_", "plain"),
                                          ("library_", "library"))}}
                say(f"kernel GroupNorm+SiLU [{case}] bf16 shape={shape} {pass_}: kernel "
                    f"{rec['ms']:.4f} ms (device {rec['device_ms']:.4f}), plain "
                    f"{rec['plain_ms']:.4f} ms (device {rec['plain_device_ms']:.4f}), library "
                    f"{rec['library_ms']:.4f} ms (device {rec['library_device_ms']:.4f}); least "
                    f"time {bound_ms:.4f} ms (bytes); max_abs_err / max|plain| {rel:.3e}")
                if not rel <= (1 if pass_ == "forward" else 2) * BF16_REL_BOUND:
                    fail(f"group_norm {case} {pass_}: max_abs_err / max|plain| = {rel}")
                record.append(rec)
            again = gn.group_norm(x, w, b, 32, 1e-6, silu=True, shift=s)
            if not torch.equal(again, outs["kernel"]):
                fail(f"group_norm {case}: two launches differ")
            del outs, grads
    return record


def phase_slice(torch, fa, attention, HashTokenizer, LatentCoreSpec,
                LatentDiffusionCore, StochasticTextPipeline):
    """Phase 4 (+5): the SD-v1 translate path at 512 px."""
    from cyclediffusion_tpu_torch.models.nn import GroupNorm
    from cyclediffusion_tpu_torch.models.unet_gd import GDResBlock

    t0 = time.perf_counter()
    spec = LatentCoreSpec.sd_v1()
    core = LatentDiffusionCore.random_init(spec, seed=0, device="cuda",
                                           dtype=torch.bfloat16)
    torch.cuda.synchronize()
    say(f"slice: SD-v1 core (UNet {sum(p.numel() for p in core.unet.parameters()):,} "
        f"params, VAE {sum(p.numel() for p in core.first_stage.parameters()):,}, "
        f"CLIP {sum(p.numel() for p in core.cond_model.parameters()):,}) in bf16, "
        f"random init {time.perf_counter() - t0:.2f} s")
    tok = HashTokenizer(49408, 77)
    kw = dict(custom_steps=STEPS, eta=ETA, white_box_steps=STEPS + 1, skip_steps=[0],
              encoder_unconditional_guidance_scales=[1.0], n_trials=1)
    pipe = StochasticTextPipeline(core, tok, decoder_unconditional_guidance_scales=[5.0], **kw)
    gen = torch.Generator(device="cuda").manual_seed(1)
    # two requests: smooth random images (upsampled 8x8 noise) in [0, 1]
    small = torch.rand((2, 3, 8, 8), generator=gen, device="cuda")
    images = torch.nn.functional.interpolate(small, size=(512, 512), mode="bilinear",
                                             align_corners=False).permute(0, 2, 3, 1)
    src = ["a photo of a cat", "a painting of a house"]
    dst = ["a photo of a dog", "a painting of a castle"]

    # warm-up: one UNet call per batch shape, off the counted run; it
    # captures the call's CUDA graph (set-up)
    x_warm = torch.zeros((4, 64, 64, 4), device="cuda")
    ctx = pipe.get_condition(src + dst)
    t_warm = torch.full((4,), 981, dtype=torch.int64, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    core.apply_model(x_warm, t_warm, ctx)
    torch.cuda.synchronize()
    say(f"slice: first UNet call at batch 4 (the eager warm-up and the graph's capture) "
        f"{time.perf_counter() - t0:.3f} s, the capture "
        f"{core._graphed_apply.capture_seconds:.3f} s: set-up, once per process")

    reset_peak(torch)
    unet_calls = [0]
    apply_model = core.apply_model

    def counted(*a):
        unet_calls[0] += 1
        return apply_model(*a)

    core.apply_model = counted
    # the GroupNorms of each model, and the GroupNorm launches of each call
    # of the first stage (a first call of a graph's signature warms up
    # eagerly, so it may run the model more than once)
    norms = {name: sum(isinstance(m, GroupNorm) for m in mod.modules())
             for name, mod in (("unet", core.unet), ("encode_first_stage",
                                                      core.first_stage.encoder),
                               ("decode_first_stage", core.first_stage.decoder))}
    stage_fns = {name: getattr(core, name)
                 for name in ("encode_first_stage", "decode_first_stage")}
    stage_launches = {name: [] for name in stage_fns}

    def counting(name):
        def call(*a):
            before = launched(GROUP_NORM_KERNELS)
            out = stage_fns[name](*a)
            after = launched(GROUP_NORM_KERNELS)
            stage_launches[name].append({k: after[k] - before[k] for k in after})
            return out
        return call

    for name in stage_fns:
        setattr(core, name, counting(name))
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    z = pipe.encode(images, src, gen)
    torch.cuda.synchronize()
    t_enc = time.perf_counter() - t0
    out = pipe.generate(z, dst, gen)
    torch.cuda.synchronize()
    t_all = time.perf_counter() - t0
    counts, gn_counts = launched(), launched(GROUP_NORM_KERNELS)
    core.apply_model = apply_model
    for name, fn in stage_fns.items():
        setattr(core, name, fn)
    peak = torch.cuda.max_memory_allocated()

    say(f"slice: 2 requests in {t_all:.3f} s (encode {t_enc:.3f} s, generate "
        f"{t_all - t_enc:.3f} s) = {t_all / 2:.3f} s/request; {unet_calls[0]} UNet "
        f"calls, graph replays, {1e3 * t_all / unet_calls[0]:.3f} ms of host time per "
        f"call with the steps and decodes around them; peak device memory "
        f"{peak / 2**30:.2f} GiB")
    if len(out) != 1:
        fail(f"expected 1 image batch (1 z x 1 decoder scale), got {len(out)}")
    img = out[0]
    if tuple(img.shape) != (2, 512, 512, 3):
        fail(f"image shape {tuple(img.shape)}")
    if not torch.isfinite(img).all():
        fail("non-finite image values")
    lo, hi = float(img.min()), float(img.max())
    shown = img.clamp(0.0, 1.0)   # as the repo's evaluators clip before saving
    say(f"slice: images {tuple(img.shape)} finite, raw range [{lo:.4f}, {hi:.4f}], "
        f"{float(((img < 0) | (img > 1)).float().mean()):.4%} of values outside "
        f"[0, 1] before clipping; clipped range [{float(shown.min()):.4f}, "
        f"{float(shown.max()):.4f}]")
    if unet_calls[0] != 2 * STEPS:
        fail(f"expected {2 * STEPS} UNet calls, got {unet_calls[0]}")
    for name in ("flash_attention_packed", "flash_attention_bhtd"):
        if counts[name] != 5 * unet_calls[0]:
            fail(f"{name}: {counts[name]} launches, expected 5 per UNet call "
                 f"({5 * unet_calls[0]})")
    if counts["qout_self_attention_block"] or counts["fused_self_attention_block"]:
        fail(f"default mode launched a folded kernel: {counts}")
    say(f"slice: launches {counts} = 5 per UNet call of K1 and of K2")
    # every GroupNorm of the UNet (graph replays: once a call) and of each
    # first-stage call (a whole number of runs of the model) through the
    # kernel, and no gradient
    # and each ResBlock's second norm with the timestep embedding as its shift
    stage = {name: [d["group_norm"] for d in ds] for name, ds in stage_launches.items()}
    gn_want = unet_calls[0] * norms["unet"] + sum(map(sum, stage.values()))
    resblocks = sum(isinstance(m, GDResBlock) for m in core.unet.modules())
    want = {"group_norm": gn_want, "group_norm_backward": 0,
            "group_norm_shift": unet_calls[0] * resblocks}
    if (not all(stage.values()) or gn_counts != want
            or any(n <= 0 or n % norms[name] for name, ns in stage.items() for n in ns)):
        fail(f"slice: GroupNorm launches {gn_counts}; expected {want} ({norms} GroupNorms, "
             f"{resblocks} ResBlocks, {unet_calls[0]} UNet calls, first-stage calls' "
             f"launches {stage})")
    say(f"slice: GroupNorm launches {gn_counts} = {unet_calls[0]} UNet calls x "
        f"{norms['unet']} + the first stage's calls {stage} (runs of {norms}), "
        f"{resblocks} shifts a UNet call: every GroupNorm of the path through the kernel")

    # per-UNet-step time at the CFG dual batch of the 2 requests
    step_ms = cuda_time_ms(lambda: core.apply_model(x_warm, t_warm, ctx), reps=10)
    say(f"slice: UNet step (batch 4 = 2 requests x CFG pair, 64x64x4 latent) "
        f"{step_ms:.3f} ms median, graph-replayed (inputs copied in, eps copied out)")

    # the translate chains cut to 10 steps, graphed against eager
    cut = StochasticTextPipeline(core, tok, decoder_unconditional_guidance_scales=[5.0],
                                 **dict(kw, custom_steps=10, white_box_steps=11))

    def translate():
        g = torch.Generator(device="cuda").manual_seed(3)
        z = cut.encode(images, src, g)
        return z, cut.generate(z, dst, g)

    graphed_chain(torch, "graphs [SD translate]", core, ("apply_model",), translate, 20,
                  programs=[(core, TEXT_PROGRAMS)])
    # each program at the translate's shapes: CLIP ViT-L/14 over the 2
    # prompts, the KL-f8 encode and decode of the 2 images at 512 px
    noise = torch.randn((2, 64, 64, 4), generator=gen, device="cuda")
    z_chk = torch.randn((2, 64, 64, 4), generator=gen, device="cuda")
    graphed_program(torch, "program [SD: CLIP ViT-L/14 text, 2 x 77 tokens]", core,
                    "get_learned_conditioning", (tok(src),))
    graphed_program(torch, "program [SD: KL-f8 encode, 2 x 512 px]", core,
                    "encode_first_stage", ((images - 0.5) * 2.0, noise))
    graphed_program(torch, "program [SD: KL-f8 decode, 2 x 64x64x4]", core,
                    "decode_first_stage", (z_chk,))

    # one UNet call with the kernels against the same call on plain attention
    # (eager both: a graph replays the kernels it captured)
    x_chk = torch.randn((4, 64, 64, 4), generator=gen, device="cuda")
    eps_kernel = core.apply_model_eager(x_chk, t_warm, ctx)
    if not torch.equal(core.apply_model(x_chk, t_warm, ctx), eps_kernel):
        fail("slice: the graphed UNet call differs from its eager call")
    with attention("plain"):
        eps_plain = core.apply_model_eager(x_chk, t_warm, ctx)
    rel = float((eps_kernel - eps_plain).abs().max() / eps_plain.abs().max())
    say(f"slice: UNet eps with kernels vs plain attention: max abs diff / max|eps| "
        f"= {rel:.3e} (bound {UNET_REL_BOUND:.0e})")
    if not rel <= UNET_REL_BOUND:
        fail(f"UNet with kernels disagrees with plain attention: {rel}")

    folded_counts = phase_folded_modes(torch, fa, spec, LatentDiffusionCore, x_chk,
                                       t_warm, ctx, eps_kernel, step_ms)

    rt_bf16 = round_trip(torch, core, pipe, images, src)
    say(f"round trip, bf16 UNet: max|replay - x0| = {rt_bf16:.3e} (not bounded: a "
        f"bf16 cast of the replayed latent that rounds one element the other way "
        f"than the encoder's gives a different eps, and the random-weight UNet "
        f"amplifies it)")
    del core, pipe
    torch.cuda.empty_cache()
    core = LatentDiffusionCore.random_init(spec, seed=0, device="cuda",
                                           dtype=torch.float32)
    pipe = StochasticTextPipeline(core, tok, decoder_unconditional_guidance_scales=[1.0], **kw)
    err = round_trip(torch, core, pipe, images, src)
    say(f"round trip, fp32 UNet (TF32 off): max|replay - x0| = {err:.3e} "
        f"(bound {ROUND_TRIP_BOUND:.0e})")
    if not err <= ROUND_TRIP_BOUND:
        fail(f"round trip error {err} > {ROUND_TRIP_BOUND}")
    # fast mode: the same key schedule on both chains visits the same x_t,
    # so the key steps make the same caches and the replay inverts again
    fast = StochasticTextPipeline(core, tok, decoder_unconditional_guidance_scales=[1.0],
                                  fast_key_every=FAST_KEY_EVERY, **kw)
    err = round_trip(torch, core, fast, images, src)
    say(f"round trip, fp32 UNet, fast mode (fast_key_every={FAST_KEY_EVERY} on both "
        f"chains): max|replay - x0| = {err:.3e} (bound {ROUND_TRIP_BOUND:.0e})")
    if not err <= ROUND_TRIP_BOUND:
        fail(f"fast-mode round trip error {err} > {ROUND_TRIP_BOUND}")
    del core, pipe, fast
    torch.cuda.empty_cache()
    return counts, folded_counts, gn_counts


def phase_folded_modes(torch, fa, spec, LatentDiffusionCore, x, t, ctx, eps_default,
                       default_ms):
    """Phase 4b: one batch-4 UNet call in each folded mode -> the launch
    counts of the ``"1"`` call (the path that runs K4)."""
    counts = {}
    for mode, kernel in (("qo", "qout_self_attention_block"),
                         ("1", "fused_self_attention_block")):
        core = LatentDiffusionCore.random_init(spec, seed=0, device="cuda",
                                               dtype=torch.bfloat16, folded_attn=mode)
        core.apply_model(x, t, ctx)      # warm-up, off the counted call
        torch.cuda.synchronize()
        reset_launches()
        eps = core.apply_model(x, t, ctx)
        torch.cuda.synchronize()
        counts[mode] = launched()
        c = counts[mode]
        others = {"qout_self_attention_block", "fused_self_attention_block"} - {kernel}
        if (c[kernel] != 5 or c["flash_attention_bhtd"] != 5
                or c["flash_attention_packed"] != 0 or any(c[o] for o in others)):
            fail(f"folded_attn={mode!r}: launches {c}, expected 5 of {kernel}, 5 of "
                 f"flash_attention_bhtd and none of the others per UNet call")
        rel = float((eps - eps_default).abs().max() / eps_default.abs().max())
        ms = cuda_time_ms(lambda: core.apply_model(x, t, ctx), reps=10)
        say(f"folded mode {mode!r}: launches {c} in one UNet call; eps vs the default "
            f"mode: max abs diff / max|eps| = {rel:.3e} (bound {UNET_REL_BOUND:.0e}); "
            f"UNet step {ms:.3f} ms median (default mode {default_ms:.3f} ms)")
        if not rel <= UNET_REL_BOUND:
            fail(f"folded_attn={mode!r} disagrees with the default mode: {rel}")
        del core
        torch.cuda.empty_cache()
    return counts["1"]


# phase 7: the shipped SD experiment, cut to a smoke run ((section, key) -> value)
CLI_CFG = "experiments/translate_text2img256_stable_diffusion_stochastic_1.cfg"
CLI_CUTS = {
    ("gan", "custom_steps"): "50", ("gan", "white_box_steps"): "51", ("gan", "eta"): "0.1",
    ("gan", "encoder_unconditional_guidance_scales"): "[1]",
    ("gan", "decoder_unconditional_guidance_scales"): "[1, 5]", ("gan", "n_trials"): "1",
    ("gan", "skip_steps"): "[25]", ("gan", "candidate_chunk"): "4",
    ("raw_data", "range"): "[4, 6]",
}
CLI_SAMPLES = 2
# phases 8 and 9: the fast-mode SD experiment and the LDM text2img-large one,
# with the same cuts
FAST_CLI_CFG = "experiments/translate_text2img256_stable_diffusion_stochastic_fast.cfg"
LDM_CLI_CFG = "experiments/translate_text2img256_latentdiff_stochastic_1.cfg"
METRIC_KEYS = ["eval_translate/psnr", "eval_translate/ssim", "eval_translate/l2",
               "eval_translate/clip", "eval_translate/d-clip", "eval_avr"]


def cut_config(text: str, cuts: dict, adds: dict = None) -> str:
    """An experiment cfg's text with each ``(section, key)`` of ``cuts`` set
    to its value, each of ``adds`` appended to its section, and every other
    line kept; raises if a key of ``cuts`` is absent or one of ``adds``
    present, or a section of ``adds`` is absent."""
    adds = dict(adds or {})
    out, section, seen = [], None, set()

    def flush(sec):
        for (s, key), value in list(adds.items()):
            if s == sec:
                out.append(f"{key} = {value}")
                del adds[(s, key)]

    for line in text.splitlines():
        stripped = line.strip()
        if stripped.startswith("[") and stripped.endswith("]"):
            flush(section)
            section = stripped[1:-1]
        elif "=" in stripped and not stripped.startswith("#"):
            key = stripped.split("=", 1)[0].strip()
            if (section, key) in adds:
                raise ValueError(f"{(section, key)} is in the config already")
            if (section, key) in cuts:
                line = f"{key} = {cuts[(section, key)]}"
                seen.add((section, key))
        out.append(line)
    flush(section)
    if set(cuts) - seen or adds:
        raise ValueError(f"keys not in the config: {sorted(set(cuts) - seen)}; sections "
                         f"not in it: {sorted(adds)}")
    return "\n".join(out) + "\n"


def expected_cli_files(n_samples: int, per_sample: bool = True, csv: bool = True) -> list:
    """The files an eval run of the CLI writes under its output directory;
    without ``per_sample`` (the ``empty`` task evaluator of the unpaired
    experiments) no CSV and no sample PNGs; without ``csv`` (the AFHQ
    experiments' ``translate_to_dog``) the sample PNGs and no CSV."""
    files = ["all_results.json", "eval_results.json",
             "visualization/eval_000000.png", "visualization/eval_256_000000.png"]
    if per_sample:
        files += [f"temp_gen/{i}.png" for i in range(n_samples)]
        files += ["eval_results.csv"] if csv else []
    return sorted(files)


def chain_lengths(pipe, num_recovered_eps) -> list:
    """UNet calls of each chain that one encode + generate runs: per skip,
    its encode chunks (the recovered eps) and its decode chunks (the
    refine steps)."""
    S, D = pipe.sched.num_steps, len(pipe.dec_scales)
    combos = pipe._combos()
    chunk = pipe.candidate_chunk
    lengths = []
    for skip in sorted(set(pipe.skip_steps)):
        k = sum(1 for _, _, sk in combos if sk == skip)
        n = num_recovered_eps(S, pipe.white_box_steps, skip)
        lengths += [n] * -(-k // (chunk or k)) + [S - skip] * -(-k * D // (chunk or k * D))
    return lengths


def expected_unet_calls(pipe, num_recovered_eps) -> int:
    """UNet calls of one encode + generate."""
    return sum(chain_lengths(pipe, num_recovered_eps))


def expected_calls_by_kind(pipe, num_recovered_eps) -> dict:
    """UNet calls of one encode + generate by kind: ``full`` (the exact
    path), or in fast mode ``key`` (every ``fast_key_every``-th step of a
    chain, its first included) and ``reuse``."""
    lengths = chain_lengths(pipe, num_recovered_eps)
    every = pipe.fast_key_every or 1
    if every <= 1:
        return {"full": sum(lengths), "key": 0, "reuse": 0}
    key = sum(-(-n // every) for n in lengths)
    return {"full": 0, "key": key, "reuse": sum(lengths) - key}


# the kernels the dispatcher picks for a self-attention route
ROUTE_KERNELS = {"bhtd": "flash_attention_bhtd", "packed": "flash_attention_packed"}


def launches_per_call(spec, attention_route, reuse: bool = False) -> dict:
    """K1 and K2 launches of one UNet call on ``spec``'s latent (default
    self-attention mode): one per attention layer (a spatial transformer's
    block, or an attention block) whose self-attention ``attention_route``
    sends to a kernel — ``num_res_blocks`` layers in each attention level of
    the input blocks, one more than that in the output blocks, one in the
    middle block at the deepest level.  A reuse call of the fast mode runs
    the output blocks only."""
    cfg = spec.unet
    depth = cfg.transformer_depth if cfg.use_spatial_transformer else 1
    counts = dict.fromkeys(ROUTE_KERNELS.values(), 0)
    levels = len(cfg.channel_mult)
    blocks = [(2 ** lvl, (0 if reuse else cfg.num_res_blocks) + cfg.num_res_blocks + 1)
              for lvl in range(levels) if 2 ** lvl in cfg.attention_resolutions]
    if not reuse:
        blocks.append((2 ** (levels - 1), 1))
    for ds, n in blocks:
        tokens = (spec.image_size // ds) ** 2
        route = attention_route(tokens, tokens)
        if route in ROUTE_KERNELS:
            counts[ROUTE_KERNELS[route]] += n * depth
    return counts


def phase_ensemble(torch, fa, Args, TextUnsupervisedTranslation, num_recovered_eps):
    """Phase 6: one image through the task model's encode + ranked forward;
    the chains with a padded tail chunk, graphed against eager."""
    from cyclediffusion_tpu_torch.pipelines.latent_text import StochasticTextPipeline

    gan = Args(gan_type="SDStochasticText", source_model_type="sd-v1-4.ckpt",
               custom_steps=STEPS, white_box_steps=STEPS + 1,
               eta=ETA, encoder_unconditional_guidance_scales=[1],
               decoder_unconditional_guidance_scales=[1, 5], n_trials=2,
               skip_steps=[10, 25], candidate_chunk=4)
    os.environ["CYCLEDIFFUSION_FOLDED_ATTN"] = "qo"
    t0 = time.perf_counter()
    try:
        model = TextUnsupervisedTranslation(Args(gan=gan), base_seed=0, device="cuda")
    finally:
        del os.environ["CYCLEDIFFUSION_FOLDED_ATTN"]
    torch.cuda.synchronize()
    say(f"ensemble: task model built from the synthetic checkpoint in "
        f"{time.perf_counter() - t0:.2f} s")
    pipe = model.gan_wrapper
    core, dclip = pipe.core, pipe.directional_clip
    say(f"ensemble: SD-v1 {core.dtype} folded_attn={core.folded_attn!r}, scorer ViT-B/32 "
        f"({sum(p.numel() for p in dclip.scorer.model.parameters()):,} params, "
        f"{dclip.scorer.dtype}); {pipe.n_trials} trials x enc {pipe.enc_scales} x skips "
        f"{pipe.skip_steps} x dec {pipe.dec_scales}, candidate_chunk {pipe.candidate_chunk}")
    gen = torch.Generator(device="cuda").manual_seed(7)
    small = torch.rand((1, 3, 8, 8), generator=gen, device="cuda")
    image = torch.nn.functional.interpolate(small, size=(512, 512), mode="bilinear",
                                            align_corners=False).permute(0, 2, 3, 1)
    src, dst = ["a photo of a cat"], ["a photo of a dog"]
    # warm-up: one UNet call at each chain batch (2 or 4 candidates x the
    # CFG pair), off the counted run
    ctx = pipe.get_condition(src)
    for bsz in (4, 8):
        core.apply_model(torch.zeros((bsz, 64, 64, 4), device="cuda"),
                         torch.full((bsz,), 981, dtype=torch.int64, device="cuda"),
                         ctx.expand(bsz, -1, -1))
    torch.cuda.synchronize()

    # spies: what the ranked forward generated and how it scored it
    seen = {}
    apply_model, generate, rank, forward = (core.apply_model, pipe.generate, pipe.rank,
                                            pipe.forward)
    unet_calls = [0]

    def counted(*a):
        unet_calls[0] += 1
        return apply_model(*a)

    def spy_generate(*a, **k):
        seen["candidates"] = generate(*a, **k)
        return seen["candidates"]

    def spy_rank(*a, **k):
        seen["scores"], seen["best"] = rank(*a, **k)
        return seen["scores"], seen["best"]

    def spy_forward(*a, **k):
        seen["image"], seen["combos"] = forward(*a, **k)
        return seen["image"], seen["combos"]

    core.apply_model, pipe.generate, pipe.rank, pipe.forward = (
        counted, spy_generate, spy_rank, spy_forward)
    torch.cuda.synchronize()
    reset_peak(torch)
    reset_launches()
    t0 = time.perf_counter()
    (_, img), _, _ = model.forward([0], image.cpu().numpy(), src, dst)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = launched()
    for name in ("generate", "rank", "forward"):
        delattr(pipe, name)      # the spies were instance attributes
    core.apply_model = apply_model
    peak = torch.cuda.max_memory_allocated()

    want_calls = expected_unet_calls(pipe, num_recovered_eps)
    say(f"ensemble: 1 sample in {secs:.3f} s, {unet_calls[0]} UNet calls (expected "
        f"{want_calls}), launches {counts}; peak device memory {peak / 2**30:.2f} GiB")
    if unet_calls[0] != want_calls:
        fail(f"ensemble ran {unet_calls[0]} UNet calls, expected {want_calls}")
    if (counts["qout_self_attention_block"] != 5 * unet_calls[0]
            or counts["flash_attention_bhtd"] != 5 * unet_calls[0]
            or counts["flash_attention_packed"] or counts["fused_self_attention_block"]):
        fail(f"ensemble launches {counts}: expected 5 of K3 and of K1 per UNet call")
    cands = seen["candidates"]
    n_cand = len(pipe._combos()) * len(pipe.dec_scales)
    if len(cands) != n_cand or tuple(img.shape) != (1, 512, 512, 3):
        fail(f"{len(cands)} candidates (expected {n_cand}), image {tuple(img.shape)}")
    if not torch.isfinite(img).all():
        fail("ensemble image has non-finite values")
    best = int(seen["best"][0])
    if not torch.equal(img[0], cands[best][0]):
        fail(f"the returned image is not candidate {best}, the winner")

    # every candidate scored alone through DirectionalCLIP.__call__
    single = torch.stack([dclip(c, image, src, dst)[1][0] for c in cands])
    batched = seen["scores"][0]
    diff = float((single - batched).abs().max())
    order = torch.argsort(single, descending=True)
    gap = float(single[order[0]] - single[order[1]])
    say(f"ensemble: scores {[round(float(v), 5) for v in batched]}; winner {best}; "
        f"one-by-one scores differ by at most {diff:.3e} (bound {SCORE_BOUND:.0e}); "
        f"their top-two gap {gap:.3e}")
    if not diff <= SCORE_BOUND:
        fail(f"batched and one-by-one DirectionalCLIP scores differ by {diff}")
    if gap > SCORE_BOUND and best != int(order[0]):
        fail(f"winner {best} is not the one-by-one argmax {int(order[0])}")
    if float(single[best]) < float(single[order[0]]) - SCORE_BOUND:
        fail(f"winner {best} scores below the best by more than {SCORE_BOUND}")

    D = len(pipe.dec_scales)
    _, es, sk = pipe._combos()[best // D]
    combo = (es, pipe.dec_scales[best % D], sk)
    if seen["combos"][0] != combo:
        fail(f"forward reported combo {seen['combos'][0]}, the winner {best} "
             f"decodes to {combo}")
    say(f"ensemble: forward's winning combo (enc_scale, dec_scale, skip) "
        f"{seen['combos'][0]} decodes back to candidate {best}")

    # the chains cut to 10 steps with chunks of 3: each skip's 4 decode
    # candidates run as 3 + 1, the 1 padded to 3, so one graph at batch 6
    # (3 candidates x the CFG pair) serves both chunks and one at batch 4
    # the encode chains: 2 graphs in all
    cut = StochasticTextPipeline(
        core, pipe.tokenizer, dclip, custom_steps=10, eta=ETA, white_box_steps=11,
        skip_steps=[2, 5], encoder_unconditional_guidance_scales=[1],
        decoder_unconditional_guidance_scales=[1, 5], n_trials=2, candidate_chunk=3)

    def ensemble():
        g = torch.Generator(device="cuda").manual_seed(8)
        z = cut.encode(image, src, g)
        return z, cut.forward(z, image, src, dst, g)[0]

    rec = graphed_chain(torch, "graphs [ensemble, padded tail, ranked]", core,
                        ("apply_model",), ensemble,
                        expected_unet_calls(cut, num_recovered_eps),
                        programs=[(core, TEXT_PROGRAMS),
                                  (dclip.scorer, ("embed_image", "embed_text"))])
    if rec["unet_graphs"] != 2:
        fail(f"ensemble: the cut chains replayed {rec['unet_graphs']} UNet graphs, expected "
             f"2 (the tail chunk padded to the chunk's batch)")
    # the scorer's towers at the ranking's shapes: the 8 candidates at 512 px,
    # the original, the 2 prompts
    cands = torch.rand((8, 512, 512, 3), generator=gen, device="cuda")
    ids = pipe.tokenizer(src + dst)
    graphed_program(torch, "program [ViT-B/32 image, 8 x 512 px]", dclip.scorer,
                    "embed_image", (cands,))
    graphed_program(torch, "program [ViT-B/32 image, 1 x 512 px]", dclip.scorer,
                    "embed_image", (image,))
    graphed_program(torch, "program [ViT-B/32 text, 2 x 77 tokens]", dclip.scorer,
                    "embed_text", (ids,))
    return counts


def write_assets(torch, root):
    """Phase 7, first step: SD v1's synthetic checkpoint and BPE file under
    ``root``, the seeded scorer in ``runtime.context``, and the variables
    that point the factory at them -> the in-memory core that was written."""
    from cyclediffusion_tpu_torch.pipelines.latent import LatentCoreSpec, LatentDiffusionCore
    from cyclediffusion_tpu_torch.runtime import context
    from cyclediffusion_tpu_torch.text import CLIPBPETokenizer
    from cyclediffusion_tpu_torch.tools import sd_assets

    core = LatentDiffusionCore.random_init(LatentCoreSpec.sd_v1(), seed=0, device="cuda",
                                           dtype=torch.bfloat16)
    path = os.path.join(root, "ckpts", "stable_diffusion", "sd-v1-4.ckpt")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nbytes = sd_assets.write_compvis_checkpoint(core, path)
    say(f"assets: {path}: {nbytes:,} bytes (bf16, CompVis layout) written in "
        f"{time.perf_counter() - t0:.2f} s")
    bpe = sd_assets.write_bpe_merges(os.path.join(root, "bpe_merges.txt"))
    context.reset()
    dclip = sd_assets.seeded_scorer(1, CLIPBPETokenizer(bpe), "cuda")
    context.set_directional_clip(dclip)
    os.environ["CYCLEDIFFUSION_CKPT_ROOT"] = root
    os.environ["CYCLEDIFFUSION_CLIP_BPE"] = bpe
    say(f"assets: BPE merges {bpe}; scorer ViT-B/32 "
        f"({sum(p.numel() for p in dclip.scorer.model.parameters()):,} params) installed")
    return core


def phase_cli(torch, fa, ref_core, root, num_recovered_eps, cfg_name, head_dims, label):
    """Phases 7, 8 and 9: the port's CLI on ``cfg_name`` cut by
    ``CLI_CUTS``, in process, with the checkpoint of ``ref_core`` under
    ``root``; K1 must see only ``head_dims`` -> (launch counts, the core
    the factory loaded)."""
    import numpy as np

    from cyclediffusion_tpu_torch import main as cli
    from cyclediffusion_tpu_torch.data.png import read_png
    from cyclediffusion_tpu_torch.evaluation.utils import to_uint8
    from cyclediffusion_tpu_torch.pipelines.latent import LatentDiffusionCore
    from cyclediffusion_tpu_torch.runtime import context
    from cyclediffusion_tpu_torch.runtime.config import config_root
    from cyclediffusion_tpu_torch.tasks.text_unsupervised_translation import (
        TextUnsupervisedTranslation,
    )

    with open(os.path.join(config_root(), cfg_name)) as f:
        cfg_text = cut_config(f.read(), CLI_CUTS)
    cfg = os.path.join(root, f"{label}.cfg")
    with open(cfg, "w") as f:
        f.write(cfg_text)
    out_dir = os.path.join(root, label)
    os.environ["CYCLEDIFFUSION_DATA_ROOT"] = ROOT
    say(f"{label}: {cfg_name} cut to {CLI_CUTS}")

    # spies: the core the factory loads (its load time, its UNet calls by
    # kind), the images the task model returns, K1's head dims
    seen = {"cores": [], "images": [], "dims": set()}
    calls = {"full": 0, "key": 0, "reuse": 0}
    from_ckpt = LatentDiffusionCore.from_torch_ckpt
    forward = TextUnsupervisedTranslation.forward
    bhtd = fa.flash_attention_bhtd

    def spy_from_ckpt(*a, **k):
        t0 = time.perf_counter()
        core = from_ckpt(*a, **k)
        torch.cuda.synchronize()
        seen["load_s"] = time.perf_counter() - t0
        apply_model, apply_model_cached = core.apply_model, core.apply_model_cached

        def counted(*args):
            calls["full"] += 1
            return apply_model(*args)

        def counted_cached(x, t, c, encoder_cache=None):
            calls["key" if encoder_cache is None else "reuse"] += 1
            return apply_model_cached(x, t, c, encoder_cache)

        core.apply_model, core.apply_model_cached = counted, counted_cached
        seen["cores"].append(core)
        return core

    def spy_forward(self, *a, **k):
        out = forward(self, *a, **k)
        seen["pipe"] = self.gan_wrapper
        seen["images"].append(out[0][1].float().cpu().numpy())
        return out

    def spy_bhtd(q, k, v, sm_scale):
        seen["dims"].add(q.shape[-1])
        return bhtd(q, k, v, sm_scale)

    argv = ["--cfg", cfg, "--output_dir", out_dir, "--seed", "42", "--do_eval",
            "--per_device_eval_batch_size", "2"]
    LatentDiffusionCore.from_torch_ckpt = spy_from_ckpt
    TextUnsupervisedTranslation.forward = spy_forward
    fa.flash_attention_bhtd = spy_bhtd
    torch.cuda.synchronize()
    reset_peak(torch)
    reset_launches()
    scorer = context.get_directional_clip(required=False)
    scorers = [] if scorer is None else [scorer.scorer]
    known = first_calls(scorers)
    t0 = time.perf_counter()
    try:
        metrics = cli.main(argv)
        torch.cuda.synchronize()
    finally:
        LatentDiffusionCore.from_torch_ckpt = from_ckpt
        TextUnsupervisedTranslation.forward = forward
        fa.flash_attention_bhtd = bhtd
    secs = time.perf_counter() - t0
    counts = launched()
    peak = torch.cuda.max_memory_allocated()

    if len(seen["cores"]) != 1:
        fail(f"{label}: the CLI loaded {len(seen['cores'])} cores from checkpoints, "
             f"expected 1")
    core = seen["cores"][0]
    del core.apply_model, core.apply_model_cached       # the spies
    want_sd, got_sd = ref_core.state_dict(), core.state_dict()
    differ = [k for k in want_sd if not torch.equal(want_sd[k], got_sd[k])]
    n_params = sum(v.numel() for v in got_sd.values())
    if core.dtype != ref_core.dtype or want_sd.keys() != got_sd.keys() or differ:
        fail(f"{label}: the loaded core ({core.dtype}) differs from the written one "
             f"({ref_core.dtype}): {differ[:4]}")
    spec = core.spec
    gen = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn((2, spec.image_size, spec.image_size, spec.channels), generator=gen,
                    device="cuda")
    t = torch.full((2,), 500, dtype=torch.int64, device="cuda")
    ctx = torch.randn((2, spec.context_length, spec.unet.context_dim), generator=gen,
                      device="cuda")
    eps_ref, eps = ref_core.apply_model(x, t, ctx), core.apply_model(x, t, ctx)
    if not torch.equal(eps_ref, eps):
        fail(f"{label}: the loaded UNet's eps differs from the written core's by "
             f"{float((eps_ref - eps).abs().max())}")
    say(f"{label}: the checkpoint loaded in {seen['load_s']:.2f} s ({n_params:,} weights, "
        f"{core.dtype}) equals the written core bit for bit, and so does its UNet eps")

    pipe = seen["pipe"]
    want_calls = {kind: CLI_SAMPLES * n
                  for kind, n in expected_calls_by_kind(pipe, num_recovered_eps).items()}
    per_call = {kind: launches_per_call(spec, fa.attention_route, reuse=kind == "reuse")
                for kind in calls}
    want_launches = {name: sum(calls[kind] * per_call[kind][name] for kind in calls)
                     for name in ROUTE_KERNELS.values()}
    say(f"{label}: UNet calls {calls} (expected {want_calls}), launches {counts} "
        f"(K1/K2 per call by kind {per_call}); K1 head dims {sorted(seen['dims'])}")
    if calls != want_calls:
        fail(f"{label}: the CLI ran {calls} UNet calls, expected {want_calls}")
    for name, n in want_launches.items():
        if counts[name] != n:
            fail(f"{label}: {name}: {counts[name]} launches, expected {n}")
    if counts["qout_self_attention_block"] or counts["fused_self_attention_block"]:
        fail(f"{label}: the CLI's default mode launched a folded kernel: {counts}")
    if seen["dims"] != set(head_dims):
        fail(f"{label}: K1 ran at head dims {sorted(seen['dims'])}, expected {head_dims}")

    files = sorted(os.path.relpath(os.path.join(d, f), out_dir)
                   for d, _, fs in os.walk(out_dir) for f in fs)
    missing = sorted(set(expected_cli_files(CLI_SAMPLES)) - set(files))
    if missing:
        fail(f"{label}: the CLI did not write {missing}; it wrote {files}")
    with open(os.path.join(out_dir, "eval_results.json")) as f:
        results = json.load(f)
    bad = [k for k in METRIC_KEYS
           if not isinstance(results.get(k), float) or not math.isfinite(results[k])]
    if bad or results.get("eval_samples") != CLI_SAMPLES:
        fail(f"{label}: eval_results.json: non-finite or missing {bad}, eval_samples "
             f"{results.get('eval_samples')}: {results}")
    with open(os.path.join(out_dir, "eval_results.csv")) as f:
        rows = f.read().strip().splitlines()[1:]
    if len(rows) != CLI_SAMPLES:
        fail(f"{label}: eval_results.csv has {len(rows)} rows, expected {CLI_SAMPLES}")
    returned = np.concatenate(seen["images"])
    for i in range(CLI_SAMPLES):
        png = read_png(os.path.join(out_dir, "temp_gen", f"{i}.png"))
        want = to_uint8(np.clip(returned[i], 0, 1))
        if png.shape != (spec.resolution, spec.resolution, 3) or not np.array_equal(png, want):
            fail(f"{label}: temp_gen/{i}.png ({png.shape}) is not the returned image {i} "
                 f"in uint8")
    for name in ("eval_000000.png", "eval_256_000000.png"):
        grid = read_png(os.path.join(out_dir, "visualization", name))
        say(f"{label}: visualization/{name} {grid.shape}")
    runtime = results["eval_runtime"]
    say(f"{label}: metrics {{{', '.join(f'{k}: {results[k]:.6g}' for k in METRIC_KEYS)}}}")
    say(f"{label}: eval_runtime {runtime} s, eval_samples_per_second "
        f"{results['eval_samples_per_second']}, {runtime / CLI_SAMPLES:.4f} s/sample; "
        f"the whole CLI call {secs:.2f} s; peak device memory {peak / 2**30:.2f} GiB")
    say_setup(label, [core] + scorers, known)
    if metrics.get("eval_samples") != CLI_SAMPLES:
        fail(f"{label}: main() returned {metrics}")
    return counts, core


def phase_fast(torch, fa, core, StochasticTextPipeline, HashTokenizer, num_recovered_eps):
    """Phase 8 (a-c): fast mode on SD v1 in bf16 (phase 7's written core,
    the weights of phase 4)."""
    from cyclediffusion_tpu_torch.samplers import ddim_decode, ddim_decode_cached
    from cyclediffusion_tpu_torch.tools.step_probe import (
        eager_ms,
        graph_ms,
        graph_of,
        profile_kinds,
    )

    reset_peak(torch)
    spec = core.spec
    tok = HashTokenizer(49408, 77)
    kw = dict(custom_steps=STEPS, eta=ETA, white_box_steps=STEPS + 1, skip_steps=[0],
              encoder_unconditional_guidance_scales=[1.0],
              decoder_unconditional_guidance_scales=[5.0], n_trials=1)
    pipes = {"exact": StochasticTextPipeline(core, tok, **kw),
             "fast": StochasticTextPipeline(core, tok, fast_key_every=FAST_KEY_EVERY, **kw)}
    gen = torch.Generator(device="cuda").manual_seed(21)
    src = ["a photo of a cat", "a painting of a house"]
    dst = ["a photo of a dog", "a painting of a castle"]
    c, uc = pipes["exact"].get_condition(dst), pipes["exact"].uncond(2)

    # (a) every step a key step: the exact replay's operations
    sched = core.make_ddim_schedule(10, ETA)
    x_T = torch.randn((2, 64, 64, 4), generator=gen, device="cuda")
    eps = torch.randn((10, 2, 64, 64, 4), generator=gen, device="cuda")
    want = ddim_decode(pipes["exact"]._guided(c, uc, [5.0], 2), sched, x_T, eps)
    got = ddim_decode_cached(*pipes["fast"]._guided(c, uc, [5.0], 2), sched, x_T, eps,
                             key_every=1)
    diff = float((got - want).abs().max())
    say(f"fast: ddim_decode_cached(key_every=1) vs ddim_decode (10 steps, 2 requests x CFG "
        f"5): max abs diff {diff:.3e}, bit for bit {torch.equal(got, want)} (bound "
        f"{KEY1_REL_BOUND:.0e} of max|x| {float(want.abs().max()):.3e})")
    if not diff <= KEY1_REL_BOUND * float(want.abs().max()):
        fail(f"ddim_decode_cached at key_every=1 differs from ddim_decode by {diff}")

    # (c) the 2-request translate, exact and fast alternating, the same draws
    small = torch.rand((2, 3, 8, 8), generator=gen, device="cuda")
    images = torch.nn.functional.interpolate(small, size=(512, 512), mode="bilinear",
                                             align_corners=False).permute(0, 2, 3, 1)
    x4 = torch.randn((4, 64, 64, 4), generator=gen, device="cuda")
    t4 = torch.full((4,), 981, dtype=torch.int64, device="cuda")
    ctx4 = pipes["exact"].get_condition(src + dst)
    _, cache = core.apply_model_cached(x4, t4, ctx4)       # warm-up: each kind of call
    core.apply_model_cached(x4, t4, ctx4, cache)
    core.apply_model(x4, t4, ctx4)
    torch.cuda.synchronize()

    def translate(mode):
        pipe = pipes[mode]
        calls = dict.fromkeys(("full", "key", "reuse"), 0)
        launches = {kind: dict.fromkeys(ROUTE_KERNELS.values(), 0) for kind in calls}
        apply_model, apply_model_cached = core.apply_model, core.apply_model_cached

        def counted(kind, fn, *args):
            before = launched()
            out = fn(*args)
            calls[kind] += 1
            for name in ROUTE_KERNELS.values():
                launches[kind][name] += launched()[name] - before[name]
            return out

        core.apply_model = lambda *a: counted("full", apply_model, *a)
        core.apply_model_cached = lambda x, t, ctx, cache=None: counted(
            "key" if cache is None else "reuse", apply_model_cached, x, t, ctx, cache)
        g = torch.Generator(device="cuda").manual_seed(31)
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            z = pipe.encode(images, src, g)
            out = pipe.generate(z, dst, g)
            torch.cuda.synchronize()
        finally:
            del core.apply_model, core.apply_model_cached
        return (time.perf_counter() - t0) / 2, out[0], calls, launches

    runs = []
    for mode in ("exact", "fast", "fast", "exact"):
        secs, img, calls, launches = translate(mode)
        want_calls = expected_calls_by_kind(pipes[mode], num_recovered_eps)
        for kind, n in calls.items():
            per_call = launches_per_call(spec, fa.attention_route, reuse=kind == "reuse")
            if launches[kind] != {name: n * k for name, k in per_call.items()}:
                fail(f"fast: {mode} translate: {kind} calls {n}, launches {launches[kind]}, "
                     f"expected {per_call} per call")
        if calls != want_calls or not torch.isfinite(img).all():
            fail(f"fast: {mode} translate: UNet calls {calls} (expected {want_calls}), "
                 f"finite {bool(torch.isfinite(img).all())}")
        runs.append((mode, secs, img))
        say(f"fast: translate [{mode}] {secs:.4f} s/request; UNet calls {calls}; K1/K2 "
            f"launches by kind {launches}")
    by_mode = {m: sorted(r[1] for r in runs if r[0] == m) for m in pipes}
    exact_img = next(r[2] for r in runs if r[0] == "exact")
    fast_img = next(r[2] for r in runs if r[0] == "fast")
    rel = float((fast_img - exact_img).abs().max() / exact_img.abs().max())
    say(f"fast: s/request exact {by_mode['exact']}, fast {by_mode['fast']}: fast/exact "
        f"{sum(by_mode['fast']) / sum(by_mode['exact']):.4f}; images max|fast - exact| / "
        f"max|exact| = {rel:.4f} (a reading: random weights)")

    # the fast translate's chains cut to 10 steps, key and reuse calls
    # graphed, against eager
    cut = StochasticTextPipeline(core, tok, fast_key_every=FAST_KEY_EVERY,
                                 **dict(kw, custom_steps=10, white_box_steps=11))

    def translate_cut():
        g = torch.Generator(device="cuda").manual_seed(32)
        z = cut.encode(images, src, g)
        return z, cut.generate(z, dst, g)

    rec = graphed_chain(torch, "graphs [SD fast mode, key and reuse]", core,
                        ("apply_model_cached",), translate_cut, 20,
                        programs=[(core, TEXT_PROGRAMS)])
    if rec["unet_graphs"] != 2:
        fail(f"fast: the cut chains replayed {rec['unet_graphs']} UNet graphs, expected 2 "
             f"(key, reuse)")

    # a full and a reuse UNet call at batch 4: eager, graph replay, profile
    steps = {"full": lambda: core.apply_model_eager(x4, t4, ctx4),
             "reuse": lambda: core.apply_model_cached_eager(x4, t4, ctx4, cache)[0]}
    for kind, step in steps.items():
        host, dev = eager_ms(step, 10)
        graph, out = graph_of(step)
        graph.replay()
        torch.cuda.synchronize()
        if not torch.equal(out, step()):
            fail(f"fast: the {kind} call's graph replay differs from its eager call")
        rep = graph_ms(graph, 10)
        del graph, out
        kinds = profile_kinds(step, 3)
        say(f"fast: SD-v1 {kind} UNet call at batch 4: eager host {host:.3f} ms, device span "
            f"{dev:.3f} ms; graph replay {rep:.3f} ms; profile {sum(ms for ms, _ in kinds.values()):.3f} "
            f"device ms in {sum(n for _, n in kinds.values()):.0f} launches")
    say_peak(torch, "fast")


def write_ldm_assets(torch, root):
    """Phase 9, first step: LDM text2img-large's synthetic checkpoint and a
    WordPiece vocab covering the repo's prompts under ``root`` ->
    the in-memory core that was written."""
    from cyclediffusion_tpu_torch.pipelines.latent import LatentCoreSpec, LatentDiffusionCore
    from cyclediffusion_tpu_torch.tools import sd_assets

    reset_peak(torch)
    t0 = time.perf_counter()
    core = LatentDiffusionCore.random_init(LatentCoreSpec.ldm_text2img_large(), seed=0,
                                           device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    counts = {name: sum(p.numel() for p in m.parameters()) for name, m in core._named_modules()}
    say(f"ldm: LDM text2img-large core {', '.join(f'{k} {v:,}' for k, v in counts.items())} "
        f"= {sum(counts.values()):,} params in bf16, random init "
        f"{time.perf_counter() - t0:.2f} s")
    path = os.path.join(root, "ckpts", "ldm_models", "text2img-large", "model.ckpt")
    t0 = time.perf_counter()
    nbytes = sd_assets.write_compvis_checkpoint(core, path)
    say(f"ldm: {path}: {nbytes:,} bytes (bf16, CompVis layout, with the unused to_logits "
        f"head) written in {time.perf_counter() - t0:.2f} s")
    with open(os.path.join(ROOT, "data", "translate-text.json")) as f:
        entries = json.load(f)
    vocab = sd_assets.write_bert_vocab(os.path.join(root, "vocab.txt"),
                                       [e[k] for e in entries
                                        for k in ("encode_text", "decode_text")])
    os.environ["CYCLEDIFFUSION_BERT_VOCAB"] = vocab
    with open(vocab) as f:
        say(f"ldm: WordPiece vocab {vocab}: {len(f.read().splitlines())} tokens")
    return core


def phase_ldm(torch, fa, root, num_recovered_eps):
    """Phase 9: LDM text2img-large through the CLI, its chains graphed
    against eager, then its batch-4 UNet step beside SD v1's (a fresh seed-0
    core), alternating -> the CLI run's launch counts."""
    from cyclediffusion_tpu_torch.pipelines.latent import LatentCoreSpec, LatentDiffusionCore
    from cyclediffusion_tpu_torch.pipelines.latent_text import StochasticTextPipeline
    from cyclediffusion_tpu_torch.text import HashTokenizer
    from cyclediffusion_tpu_torch.tools.step_probe import (
        alternating,
        eager_ms,
        graph_ms,
        graph_of,
    )

    ref_core = write_ldm_assets(torch, root)
    counts, core = phase_cli(torch, fa, ref_core, root, num_recovered_eps, LDM_CLI_CFG,
                             (40,), "ldm_cli")
    del ref_core
    torch.cuda.empty_cache()

    # the CLI core's translate chains cut to 10 steps, graphed against eager
    spec = core.spec
    cut = StochasticTextPipeline(
        core, HashTokenizer(spec.cond_cfg.vocab_size, spec.context_length),
        custom_steps=10, eta=ETA, white_box_steps=11, skip_steps=[0],
        encoder_unconditional_guidance_scales=[1.0],
        decoder_unconditional_guidance_scales=[5.0], n_trials=1)
    gen = torch.Generator(device="cuda").manual_seed(42)
    small = torch.rand((2, 3, 8, 8), generator=gen, device="cuda")
    images = torch.nn.functional.interpolate(small, size=(256, 256), mode="bilinear",
                                             align_corners=False).permute(0, 2, 3, 1)
    src = ["a photo of a cat", "a painting of a house"]
    dst = ["a photo of a dog", "a painting of a castle"]

    def translate():
        g = torch.Generator(device="cuda").manual_seed(43)
        z = cut.encode(images, src, g)
        return z, cut.generate(z, dst, g)

    graphed_chain(torch, "graphs [LDM text2img-large translate]", core, ("apply_model",),
                  translate, 20, programs=[(core, TEXT_PROGRAMS)])
    gen = torch.Generator(device="cuda").manual_seed(44)
    graphed_program(torch, "program [LDM-BERT, 32 layers, 2 x 77 tokens]", core,
                    "get_learned_conditioning", (cut.tokenizer(src),))
    graphed_program(torch, "program [LDM: KL-f8 encode, 2 x 256 px]", core,
                    "encode_first_stage", ((images - 0.5) * 2.0, torch.randn(
                        (2, 32, 32, 4), generator=gen, device="cuda")))
    graphed_program(torch, "program [LDM: KL-f8 decode, 2 x 32x32x4]", core,
                    "decode_first_stage", (torch.randn((2, 32, 32, 4), generator=gen,
                                                       device="cuda"),))
    cores = {"ldm": core, "sd": LatentDiffusionCore.random_init(
        LatentCoreSpec.sd_v1(), seed=0, device="cuda", dtype=torch.bfloat16)}
    gen = torch.Generator(device="cuda").manual_seed(41)
    steps = {}
    for name, c in cores.items():
        spec = c.spec
        x = torch.randn((4, spec.image_size, spec.image_size, spec.channels), generator=gen,
                        device="cuda")
        t = torch.full((4,), 981, dtype=torch.int64, device="cuda")
        ctx = torch.randn((4, spec.context_length, spec.unet.context_dim), generator=gen,
                          device="cuda")
        step = functools.partial(c.apply_model_eager, x, t, ctx)
        graph, out = graph_of(step)
        graph.replay()
        torch.cuda.synchronize()
        if not torch.equal(out, step()):
            fail(f"ldm: the {name} UNet step's graph replay differs from its eager call")
        steps[name] = (step, graph)
    for name in alternating(2, tuple(steps)):
        step, graph = steps[name]
        host, dev = eager_ms(step, 10)
        rep = graph_ms(graph, 10)
        say(f"ldm: UNet step at batch 4 [{name}]: eager host {host:.3f} ms, device span "
            f"{dev:.3f} ms; graph replay {rep:.3f} ms")
    del steps, cores
    say_peak(torch, "ldm")
    return counts


# phase 10: the shipped FFHQ -> CelebA-HQ experiment, cut to a smoke run
UNPAIRED_CFG = "experiments/translate_ffhq256_to_celeba256_latentdiff_ddim_eta01.cfg"
UNPAIRED_CUTS = {("gan", "custom_steps"): "100", ("gan", "white_box_steps"): "101",
                 ("gan", "refine_steps"): "40", ("gan", "eta"): "0.1"}
UNPAIRED_SAMPLES = 3        # the task's three FFHQ picks, one batch
UNPAIRED_MODELS = {"ffhq256": 0, "celeba256": 1}    # model type -> weight seed
FFHQ_PICKS = (1, 11, 15)


def unpaired_unet_calls(pipe, num_recovered_eps) -> dict:
    """UNet calls of one batch through the unpaired task: the source
    model's encode chain, the target model's replay and refine."""
    sched_steps = pipe.sched.num_steps
    return {"source": num_recovered_eps(sched_steps, pipe.white_box_steps, 0),
            "target": sched_steps + pipe.refine_steps}


def write_unpaired_assets(torch, root):
    """Phase 10, first step: the two seeded LDMs as CompVis ``use_ema``
    checkpoints (the core's UNet in the EMA shadows, other raw weights) and
    three synthetic 1024 px FFHQ PNGs under ``root`` -> {model type: the
    written core}."""
    import numpy as np

    from cyclediffusion_tpu_torch.data.png import write_png
    from cyclediffusion_tpu_torch.pipelines.factory import LATENT_MODELS
    from cyclediffusion_tpu_torch.pipelines.latent import LatentDiffusionCore
    from cyclediffusion_tpu_torch.tools import ldm_assets

    reset_peak(torch)
    cores = {}
    for model_type, seed in UNPAIRED_MODELS.items():
        t0 = time.perf_counter()
        core = LatentDiffusionCore.random_init(LATENT_MODELS[model_type](), seed=seed,
                                               device="cuda", dtype=torch.bfloat16)
        torch.cuda.synchronize()
        counts = {name: sum(p.numel() for p in m.parameters())
                  for name, m in core._named_modules()}
        path = os.path.join(root, "ckpts", "ldm_models", "ldm", model_type, "model.ckpt")
        t1 = time.perf_counter()
        nbytes = ldm_assets.write_ema_checkpoint(core, path, raw_seed=100 + seed)
        say(f"unpaired: {model_type} {', '.join(f'{k} {v:,}' for k, v in counts.items())} "
            f"params in bf16 (codebook fp32), random init {t1 - t0:.2f} s; {path}: "
            f"{nbytes:,} bytes (raw UNet + EMA shadows + VQ) written in "
            f"{time.perf_counter() - t1:.2f} s")
        cores[model_type] = core
    data = os.path.join(root, "data", "images1024x1024")
    os.makedirs(data, exist_ok=True)
    gen = torch.Generator(device="cuda").manual_seed(51)
    for pick in FFHQ_PICKS:
        small = torch.rand((1, 3, 16, 16), generator=gen, device="cuda")
        img = torch.nn.functional.interpolate(small, size=(1024, 1024), mode="bilinear",
                                              align_corners=False)[0].permute(1, 2, 0)
        write_png(os.path.join(data, f"{pick:05d}.png"),
                  (img * 255).round().to(torch.uint8).cpu().numpy().astype(np.uint8))
    say(f"unpaired: {len(FFHQ_PICKS)} synthetic 1024x1024 PNGs in {data}")
    return cores


def phase_unpaired(torch, fa, root, num_recovered_eps):
    """Phase 10: the FFHQ -> CelebA-HQ experiment through the CLI on two
    seeded checkpoints, loaded bit for bit with their EMA shadows; an fp32
    round trip on the FFHQ latent; the batch-3 UNet step eager and
    graph-replayed -> the CLI run's launch counts."""
    import numpy as np

    from cyclediffusion_tpu_torch import main as cli
    from cyclediffusion_tpu_torch.pipelines.factory import LATENT_MODELS
    from cyclediffusion_tpu_torch.pipelines.latent import (
        LatentDiffStochasticPipeline,
        LatentDiffusionCore,
    )
    from cyclediffusion_tpu_torch.runtime.config import config_root
    from cyclediffusion_tpu_torch.tasks.unsupervised_translation import UnsupervisedTranslation
    from cyclediffusion_tpu_torch.tools.step_probe import eager_ms, graph_ms, graph_of

    written = write_unpaired_assets(torch, root)
    os.environ["CYCLEDIFFUSION_CKPT_ROOT"] = root
    os.environ["CYCLEDIFFUSION_DATA_ROOT"] = root
    with open(os.path.join(config_root(), UNPAIRED_CFG)) as f:
        cfg_text = cut_config(f.read(), UNPAIRED_CUTS)
    cfg = os.path.join(root, "unpaired.cfg")
    with open(cfg, "w") as f:
        f.write(cfg_text)
    out_dir = os.path.join(root, "unpaired")
    say(f"unpaired: {UNPAIRED_CFG} cut to {UNPAIRED_CUTS}, batch {UNPAIRED_SAMPLES}")

    # spies: the cores the factory loads (load time, UNet calls and batch
    # sizes per core), the task's images, K1's head dims
    seen = {"cores": [], "load_s": [], "dims": set(), "batches": set(), "images": []}
    calls = []
    from_ckpt = LatentDiffusionCore.from_torch_ckpt
    forward = UnsupervisedTranslation.forward
    bhtd = fa.flash_attention_bhtd

    def spy_from_ckpt(*a, **k):
        t0 = time.perf_counter()
        core = from_ckpt(*a, **k)
        torch.cuda.synchronize()
        seen["load_s"].append(time.perf_counter() - t0)
        apply_model, i = core.apply_model, len(calls)
        calls.append(0)

        def counted(x, *args):
            calls[i] += 1
            seen["batches"].add(x.shape[0])
            return apply_model(x, *args)

        core.apply_model = counted
        seen["cores"].append(core)
        return core

    def spy_forward(self, *a, **k):
        out = forward(self, *a, **k)
        seen["pipe"] = self.target_gan_wrapper
        seen["images"].append((out[0][0], out[0][1]))
        return out

    def spy_bhtd(q, k, v, sm_scale):
        seen["dims"].add(q.shape[-1])
        return bhtd(q, k, v, sm_scale)

    argv = ["--cfg", cfg, "--output_dir", out_dir, "--seed", "42", "--do_eval",
            "--per_device_eval_batch_size", str(UNPAIRED_SAMPLES)]
    LatentDiffusionCore.from_torch_ckpt = spy_from_ckpt
    UnsupervisedTranslation.forward = spy_forward
    fa.flash_attention_bhtd = spy_bhtd
    torch.cuda.synchronize()
    reset_peak(torch)
    reset_launches()
    t0 = time.perf_counter()
    try:
        metrics = cli.main(argv)
        torch.cuda.synchronize()
    finally:
        LatentDiffusionCore.from_torch_ckpt = from_ckpt
        UnsupervisedTranslation.forward = forward
        fa.flash_attention_bhtd = bhtd
    secs = time.perf_counter() - t0
    counts = launched()
    peak = torch.cuda.max_memory_allocated()

    if len(seen["cores"]) != 2:
        fail(f"unpaired: the CLI loaded {len(seen['cores'])} cores, expected 2")
    for (model_type, ref), core, load_s in zip(written.items(), seen["cores"],
                                               seen["load_s"]):
        del core.apply_model                             # the spy
        want_sd, got_sd = ref.state_dict(), core.state_dict()
        differ = [k for k in want_sd if not torch.equal(want_sd[k], got_sd[k])]
        if want_sd.keys() != got_sd.keys() or differ or core.spec != ref.spec:
            fail(f"unpaired: the loaded {model_type} core differs from the written one "
                 f"(EMA shadows expected): {differ[:4]}")
        say(f"unpaired: {model_type} loaded in {load_s:.2f} s "
            f"({sum(v.numel() for v in got_sd.values()):,} weights) equals the written "
            f"core bit for bit (the EMA shadows, not the raw UNet)")
    pipe = seen["pipe"]
    per_call = launches_per_call(pipe.core.spec, fa.attention_route)
    want_calls = unpaired_unet_calls(pipe, num_recovered_eps)
    got_calls = dict(zip(("source", "target"), calls))
    want_k1 = sum(want_calls.values()) * per_call["flash_attention_bhtd"]
    say(f"unpaired: UNet calls {got_calls} (expected {want_calls}) at batch "
        f"{sorted(seen['batches'])}, launches {counts} (K1/K2 per call {per_call}); K1 "
        f"head dims {sorted(seen['dims'])}")
    if got_calls != want_calls or seen["batches"] != {UNPAIRED_SAMPLES}:
        fail(f"unpaired: UNet calls {got_calls} at batch {seen['batches']}, expected "
             f"{want_calls} at {UNPAIRED_SAMPLES}")
    if (counts["flash_attention_bhtd"] != want_k1 or per_call["flash_attention_bhtd"] != 5
            or any(counts[n] for n in counts if n != "flash_attention_bhtd")):
        fail(f"unpaired: launches {counts}, expected {want_k1} of K1 (5 per UNet call) "
             f"and none of K2-K4")
    if seen["dims"] != {32}:
        fail(f"unpaired: K1 ran at head dims {sorted(seen['dims'])}, expected [32]")

    files = sorted(os.path.relpath(os.path.join(d, f), out_dir)
                   for d, _, fs in os.walk(out_dir) for f in fs)
    want_files = expected_cli_files(UNPAIRED_SAMPLES, per_sample=False)
    with open(os.path.join(out_dir, "eval_results.json")) as f:
        results = json.load(f)
    orig, img = seen["images"][0] if len(seen["images"]) == 1 else (None, None)
    if files != want_files or results.get("eval_samples") != UNPAIRED_SAMPLES or img is None:
        fail(f"unpaired: the CLI wrote {files} (expected {want_files}), results {results}, "
             f"{len(seen['images'])} batches")
    if tuple(img.shape) != (UNPAIRED_SAMPLES, 256, 256, 3) or not torch.isfinite(img).all():
        fail(f"unpaired: images {tuple(img.shape)}, finite {bool(torch.isfinite(img).all())}")
    say(f"unpaired: {files}; images {tuple(img.shape)} finite, range "
        f"[{float(img.min()):.4f}, {float(img.max()):.4f}]; eval_runtime "
        f"{results['eval_runtime']} s, eval_samples_per_second "
        f"{results['eval_samples_per_second']}; the whole CLI call {secs:.2f} s; peak "
        f"device memory {peak / 2**30:.2f} GiB")
    say_setup("unpaired", seen["cores"], {})
    if metrics.get("eval_samples") != UNPAIRED_SAMPLES:
        fail(f"unpaired: main() returned {metrics}")

    # the loaded FFHQ core's chains cut to 10 steps and refine 4, graphed
    # against eager
    core = seen["cores"][0]
    cut = LatentDiffStochasticPipeline(core, custom_steps=10, eta=ETA, white_box_steps=11,
                                       refine_steps=4)

    def translate():
        g = torch.Generator(device="cuda").manual_seed(63)
        z = cut.encode(orig.to("cuda", torch.float32), g)
        return z, cut.generate(z, g)

    graphed_chain(torch, "graphs [FFHQ LDM encode, replay, refine]", core, ("apply_model",),
                  translate, 10 + 10 + 4, programs=[(core, FIRST_STAGE)])
    image = orig.to("cuda", torch.float32)
    graphed_program(torch, f"program [FFHQ: VQ-f4 encode, {image.shape[0]} x 256 px]", core,
                    "encode_first_stage", ((image - 0.5) * 2.0,))
    graphed_program(torch, f"program [FFHQ: VQ-f4 decode, {image.shape[0]} x 64x64x3]", core,
                    "decode_first_stage", (core.encode_first_stage((image - 0.5) * 2.0),))

    # the batch-3 UNet step of the loaded FFHQ core, eager and graph-replayed
    gen = torch.Generator(device="cuda").manual_seed(61)
    x = torch.randn((UNPAIRED_SAMPLES, 64, 64, 3), generator=gen, device="cuda")
    t = torch.full((UNPAIRED_SAMPLES,), 981, dtype=torch.int64, device="cuda")
    step = functools.partial(core.apply_model_eager, x, t)
    graph, out = graph_of(step)
    graph.replay()
    torch.cuda.synchronize()
    if not torch.equal(out, step()):
        fail("unpaired: the UNet step's graph replay differs from its eager call")
    for _ in range(2):
        host, dev = eager_ms(step, 10)
        rep = graph_ms(graph, 10)
        say(f"unpaired: FFHQ UNet step at batch {UNPAIRED_SAMPLES}: eager host {host:.3f} "
            f"ms, device span {dev:.3f} ms; graph replay {rep:.3f} ms")
    del graph, out, step, core, seen, written, pipe, cut
    gc.collect()
    torch.cuda.empty_cache()

    # fp32 round trip on the FFHQ latent: encode, then replay (no refine);
    # bounded at phase 5's STEPS, read at the CLI's 100
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    core32 = LatentDiffusionCore.random_init(LATENT_MODELS["ffhq256"](),
                                             seed=UNPAIRED_MODELS["ffhq256"], device="cuda",
                                             dtype=torch.float32)
    images = orig.to("cuda", torch.float32)
    x0 = core32.encode_first_stage(images * 2.0 - 1.0)
    for steps in (STEPS, 100):
        pipe32 = LatentDiffStochasticPipeline(core32, custom_steps=steps, eta=ETA,
                                              white_box_steps=steps + 1)
        z = pipe32.encode(images, torch.Generator(device="cuda").manual_seed(62))
        err = float((pipe32.sample(z) - x0).abs().max())
        bounded = steps == STEPS
        say(f"round trip, FFHQ LDM fp32 (TF32 off), {UNPAIRED_SAMPLES} images, {steps} "
            f"steps: max|replay - x0| = {err:.3e}, max|x0| = {float(x0.abs().max()):.3e} "
            + (f"(bound {ROUND_TRIP_BOUND:.0e})" if bounded else "(a reading)"))
        if bounded and not err <= ROUND_TRIP_BOUND:
            fail(f"FFHQ round trip error {err} > {ROUND_TRIP_BOUND}")
    del core32, pipe32
    torch.cuda.empty_cache()
    say_peak(torch, "unpaired")
    return counts


# phase 11: the shipped AFHQ cat -> dog experiment, cut to a smoke run: 100
# of the 850 encode steps on the shipped 1000-step grid, refine 20 of 100
AFHQ_CFG = "experiments/translate_afhqcat256_to_afhqdog256_ddim_eta01.cfg"
AFHQ_CUTS = {("gan", "es_steps"): "100", ("gan", "refine_steps"): "20"}
AFHQ_ADDS = {("raw_data", "eval_num"): "2"}
AFHQ_SAMPLES = 2            # eval_num of AFHQ_CATS cats, one batch
# the cats: committed JPEG fixtures (baseline 4:2:0, quality 75, the AFHQ
# release's format) with Pillow's decode of each beside them
JPEG_DIR = os.path.join("tests", "data_torch", "jpeg")
AFHQ_CAT_JPEGS = ("cat_0", "cat_1", "cat_2")
AFHQ_CATS, AFHQ_DOGS = len(AFHQ_CAT_JPEGS), 4
# checkpoint key of the [gan] section -> weight seed (the cat model, the dog model)
AFHQ_MODELS = {"source_model_path": 0, "target_model_path": 1}
AFHQ_METRICS = ["eval_translate/psnr", "eval_translate/ssim", "eval_translate/l2",
                "eval_translate/fid", "eval_translate/kid", "eval_avr"]
# pool3 features of the fp32 Inception on the card against the same module
# on the CPU, max abs error / max|CPU|: fp32 both ways (TF32 off), but cuDNN's
# convolution algorithms round otherwise than the CPU's over ~100 layers
INCEPTION_REL_BOUND = 1e-3
# the pixel round trip: the replay's states x_t against the encode chain's,
# max abs on [-1, 1] pixels, fp32 UNet (TF32 off)
PIXEL_TRAJECTORY_BOUND = 1e-3


@contextlib.contextmanager
def torch_default_backends(torch):
    """PyTorch's own backend flags inside the block, as a user's CLI run has
    them (cuDNN's convolutions in TF32, matmuls in fp32, cuDNN neither
    deterministic nor benchmarking); the smoke's own after it."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic, cudnn.benchmark)
    cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic, cudnn.benchmark = (
        True, False, False, False)
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic, cudnn.benchmark = saved


def pixel_unet_calls(pipe) -> dict:
    """UNet calls of one batch through the pixel task: the source model's
    encode chain, the target model's replay and its refine chains."""
    return {"source": pipe.es_steps - 1,
            "target": pipe.es_steps + pipe.refine_steps * pipe.refine_iterations}


def pixel_round_trip(torch, pipe, images, generator):
    """Encode, then replay on the same pipeline (no refine) -> (max|replay
    state - encode state| over the x_t both chains give the UNet, t > 0;
    max|image - x0|).  The second is a reading: the replay's last step (t =
    0 -> -1) is the model's x0 prediction from x_0', which misses x0 by
    sqrt(1 - a_0) times the model's eps error there."""
    seen = {}
    model_fn = pipe._model_fn

    def spy(x, t):
        seen.setdefault(int(t[0]), []).append(x.clone())
        return model_fn(x, t)

    pipe._model_fn = spy
    try:
        out = pipe.generate(pipe.encode(images, generator), generator)
    finally:
        del pipe._model_fn
    pairs = [xs for t, xs in seen.items() if t > 0]
    if any(len(xs) != 2 for xs in pairs) or len(seen.get(0, ())) != 1:
        raise ValueError(f"the chains called the UNet at {sorted(seen)} "
                         f"{[len(v) for v in seen.values()]} times")
    traj = max(float((b - a).abs().max()) for a, b in pairs)
    x0 = torch.as_tensor(images, device=out.device) * 2.0 - 1.0
    return traj, float((out - x0).abs().max())


def expected_afhq_sources(n: int):
    """The first ``n`` cats as the CLI should read them: the fixtures'
    committed Pillow decode, resized 512 -> 256 by the port's host path ->
    float32 (n, 256, 256, 3)."""
    import numpy as np

    from cyclediffusion_tpu_torch.data.preprocess.afhqcat256 import INTERPOLATION
    from cyclediffusion_tpu_torch.data.transforms import resize, to_array

    stored = np.load(os.path.join(ROOT, JPEG_DIR, "pillow_decode.npz"))
    return np.stack([to_array(resize(stored[stem], 256, INTERPOLATION))
                     for stem in AFHQ_CAT_JPEGS[:n]])


def write_afhq_images(torch, root):
    """The cats (the committed JPEG fixtures) and synthetic 512 px dog PNGs
    in the stargan-v2 layout under ``root``."""
    import shutil

    import numpy as np

    from cyclediffusion_tpu_torch.data.png import write_png

    d = os.path.join(root, "stargan-v2", "data", "test", "cat")
    os.makedirs(d, exist_ok=True)
    for i, stem in enumerate(AFHQ_CAT_JPEGS):
        shutil.copy(os.path.join(ROOT, JPEG_DIR, f"{stem}.jpg"),
                    os.path.join(d, f"flickr_cat_{i:06d}.jpg"))
    gen = torch.Generator().manual_seed(71)
    d = os.path.join(root, "stargan-v2", "data", "test", "dog")
    os.makedirs(d, exist_ok=True)
    for i in range(AFHQ_DOGS):
        small = torch.rand((1, 3, 16, 16), generator=gen)
        img = torch.nn.functional.interpolate(small, size=(512, 512), mode="bilinear",
                                              align_corners=False)[0].permute(1, 2, 0)
        write_png(os.path.join(d, f"flickr_dog_{i:06d}.png"),
                  (img * 255).round().to(torch.uint8).numpy().astype(np.uint8))


def write_afhq_assets(torch, root, gan):
    """Phase 11, first step: the cat and dog models as seeded full-width
    improved-diffusion checkpoints at the config's paths under ``root``,
    the seeded Inception state dict, the JPEG cats and synthetic PNG dogs
    (:func:`write_afhq_images`) -> ({checkpoint key: the written model},
    Inception path)."""
    from cyclediffusion_tpu_torch.pipelines import zoo
    from cyclediffusion_tpu_torch.tools import pixel_assets

    models = {}
    for key, seed in AFHQ_MODELS.items():
        spec = zoo.PIXEL_ZOO[getattr(gan, key.replace("_path", "_type"))]
        t0 = time.perf_counter()
        with torch.device("cuda"):
            model = zoo.build_pixel_model(spec)
        zoo.init_random_params(model, torch.Generator(device="cuda").manual_seed(seed))
        path = os.path.join(root, getattr(gan, key))
        t1 = time.perf_counter()
        nbytes = pixel_assets.write_pixel_checkpoint(model, path)
        say(f"afhq: {spec.name} {sum(p.numel() for p in model.parameters()):,} params (fp32), "
            f"random init {t1 - t0:.2f} s; {path}: {nbytes:,} bytes written in "
            f"{time.perf_counter() - t1:.2f} s")
        models[key] = model
    inception = os.path.join(root, "pt_inception-2015-12-05.pth")
    say(f"afhq: {inception}: {pixel_assets.write_inception_checkpoint(inception, seed=2):,} "
        f"bytes (seeded pytorch-fid layout)")
    write_afhq_images(torch, root)
    say(f"afhq: {AFHQ_CATS} cat JPEGs ({', '.join(AFHQ_CAT_JPEGS)} of {JPEG_DIR}) and "
        f"{AFHQ_DOGS} synthetic dog PNGs, 512x512, under {os.path.join(root, 'stargan-v2')}")
    return models, inception


def phase_afhq(torch, fa, root):
    """Phase 11: the AFHQ cat -> dog experiment through the CLI on two
    seeded full-width improved-DDPM checkpoints (fp32, loaded bit for bit,
    TF32 convolutions as PyTorch's defaults have it), FID / KID on the
    seeded Inception; the card's Inception against the CPU's; an fp32 pixel
    round trip; the batch-2 UNet call eager and graph-replayed; fails
    unless the path launched none of K1-K4."""
    import copy

    import numpy as np

    from cyclediffusion_tpu_torch import main as cli
    from cyclediffusion_tpu_torch.data.png import read_png
    from cyclediffusion_tpu_torch.evaluation import fid
    from cyclediffusion_tpu_torch.evaluation.utils import to_uint8
    from cyclediffusion_tpu_torch.models.inception import inception_pool3_features
    from cyclediffusion_tpu_torch.pipelines.ddpm_ddim import DDPMDDIMPipeline
    from cyclediffusion_tpu_torch.runtime.config import config_root, get_config
    from cyclediffusion_tpu_torch.tasks.unsupervised_translation import UnsupervisedTranslation
    from cyclediffusion_tpu_torch.tools.pixel_probe import unet_flops
    from cyclediffusion_tpu_torch.tools.step_probe import eager_ms, graph_ms, graph_of

    reset_peak(torch)
    with open(os.path.join(config_root(), AFHQ_CFG)) as f:
        cfg_text = cut_config(f.read(), AFHQ_CUTS, AFHQ_ADDS)
    cfg = os.path.join(root, "afhq.cfg")
    with open(cfg, "w") as f:
        f.write(cfg_text)
    gan = get_config(cfg).gan
    written, inception = write_afhq_assets(torch, root, gan)
    os.environ["CYCLEDIFFUSION_CKPT_ROOT"] = root
    os.environ["CYCLEDIFFUSION_DATA_ROOT"] = root
    os.environ[fid.INCEPTION_CKPT_ENV] = inception
    out_dir = os.path.join(root, "afhq")
    say(f"afhq: {AFHQ_CFG} cut to {AFHQ_CUTS} plus {AFHQ_ADDS}, batch {AFHQ_SAMPLES}")

    # spies: the pipelines the factory loads (load time, UNet calls and
    # batch sizes per pipeline), the task's images
    seen = {"pipes": [], "load_s": [], "batches": set(), "images": []}
    calls = []
    from_ckpt = DDPMDDIMPipeline.from_torch_ckpt
    forward = UnsupervisedTranslation.forward

    def spy_from_ckpt(*a, **k):
        t0 = time.perf_counter()
        pipe = from_ckpt(*a, **k)
        torch.cuda.synchronize()
        seen["load_s"].append(time.perf_counter() - t0)
        model_fn, i = pipe._model_fn, len(calls)
        calls.append(0)

        def counted(x, t):
            calls[i] += 1
            seen["batches"].add(x.shape[0])
            return model_fn(x, t)

        pipe._model_fn = counted
        seen["pipes"].append(pipe)
        return pipe

    def spy_forward(self, *a, **k):
        out = forward(self, *a, **k)
        seen["images"].append((out[0][0], out[0][1]))
        return out

    argv = ["--cfg", cfg, "--output_dir", out_dir, "--seed", "42", "--do_eval",
            "--per_device_eval_batch_size", str(AFHQ_SAMPLES)]
    DDPMDDIMPipeline.from_torch_ckpt = spy_from_ckpt
    UnsupervisedTranslation.forward = spy_forward
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    try:
        with torch_default_backends(torch):
            metrics = cli.main(argv)
            torch.cuda.synchronize()
    finally:
        DDPMDDIMPipeline.from_torch_ckpt = from_ckpt
        UnsupervisedTranslation.forward = forward
    secs = time.perf_counter() - t0
    counts = launched()
    peak = torch.cuda.max_memory_allocated()

    if len(seen["pipes"]) != 2:
        fail(f"afhq: the CLI loaded {len(seen['pipes'])} pipelines, expected 2")
    for (key, ref), pipe, load_s in zip(written.items(), seen["pipes"], seen["load_s"]):
        del pipe._model_fn                              # the spy
        want_sd, got_sd = ref.state_dict(), pipe.model.state_dict()
        differ = [k for k in want_sd if not torch.equal(want_sd[k], got_sd[k])]
        if want_sd.keys() != got_sd.keys() or differ or pipe.dtype != torch.float32:
            fail(f"afhq: the {key} pipeline ({pipe.dtype}) differs from the written "
                 f"model: {differ[:4]}")
        say(f"afhq: {pipe.spec.name} loaded in {load_s:.2f} s ({pipe.dtype}) equals the "
            f"written model bit for bit")
    pipe = seen["pipes"][1]
    want_calls = pixel_unet_calls(pipe)
    got_calls = dict(zip(("source", "target"), calls))
    say(f"afhq: UNet calls {got_calls} (expected {want_calls}) at batch "
        f"{sorted(seen['batches'])}; kernel launches {counts}")
    if got_calls != want_calls or seen["batches"] != {AFHQ_SAMPLES}:
        fail(f"afhq: UNet calls {got_calls} at batch {seen['batches']}, expected "
             f"{want_calls} at {AFHQ_SAMPLES}")
    if any(counts.values()):
        fail(f"afhq: the pixel path launched a kernel: {counts} (its attention has <= 256 "
             f"tokens, which go plain)")

    files = sorted(os.path.relpath(os.path.join(d, f), out_dir)
                   for d, _, fs in os.walk(out_dir) for f in fs)
    want_files = expected_cli_files(AFHQ_SAMPLES, csv=False)
    with open(os.path.join(out_dir, "eval_results.json")) as f:
        results = json.load(f)
    bad = [k for k in AFHQ_METRICS
           if not isinstance(results.get(k), float) or not math.isfinite(results[k])]
    if files != want_files or bad or results.get("eval_samples") != AFHQ_SAMPLES \
            or len(seen["images"]) != 1:
        fail(f"afhq: the CLI wrote {files} (expected {want_files}); non-finite or missing "
             f"{bad} in {results}; {len(seen['images'])} batches")
    if any("_feat" in k for k in results):
        fail(f"afhq: FID/KID fell back from the Inception asset: {sorted(results)}")
    orig, img = seen["images"][0]
    want_src = expected_afhq_sources(AFHQ_SAMPLES)
    if not np.array_equal(orig.float().cpu().numpy(), want_src):
        fail("afhq: the cats the CLI read differ from the JPEG fixtures' Pillow decode, "
             f"resized: max abs {np.abs(orig.float().cpu().numpy() - want_src).max()}")
    say(f"afhq: the {AFHQ_SAMPLES} cats the CLI read from JPEG equal the fixtures' "
        "committed Pillow decode, resized 512 -> 256, bit for bit")
    returned = img.float().cpu().numpy()
    for i in range(AFHQ_SAMPLES):
        png = read_png(os.path.join(out_dir, "temp_gen", f"{i}.png"))
        if png.shape != (256, 256, 3) or not np.array_equal(
                png, to_uint8(np.clip(returned[i], 0, 1))):
            fail(f"afhq: temp_gen/{i}.png is not the returned image {i} in uint8")
    say(f"afhq: {files}; images {tuple(img.shape)}, range [{float(img.min()):.4f}, "
        f"{float(img.max()):.4f}]")
    say(f"afhq: metrics {{{', '.join(f'{k}: {results[k]:.6g}' for k in AFHQ_METRICS)}}}")
    say(f"afhq: eval_runtime {results['eval_runtime']} s, eval_samples_per_second "
        f"{results['eval_samples_per_second']}; the whole CLI call {secs:.2f} s, under "
        f"PyTorch's default flags (fp32 UNet, cuDNN convolutions in TF32); peak device "
        f"memory {peak / 2**30:.2f} GiB")
    if metrics.get("eval_samples") != AFHQ_SAMPLES:
        fail(f"afhq: main() returned {metrics}")

    # the card's Inception against the same module on the CPU
    (model, native, graphed), = fid._INCEPTION_CACHE.values()  # the evaluator's module
    if not native:
        fail("afhq: the Inception asset did not load as a state dict")
    if not graphed.graphs:
        fail("afhq: the evaluator's Inception features replayed no graph")
    # the graphed features at the FID's batch of 32 (the resize to 299 and
    # the tower) against the eager call, and 33 images (a second batch
    # padded to 32: one graph) against the unpadded eager features
    base = img.float()[:1].clamp(0.01, 0.9)
    batch = base + 2e-3 * torch.arange(32, device=base.device).reshape(32, 1, 1, 1)
    owner = types.SimpleNamespace(_graphed=graphed, inception=graphed,
                                  inception_eager=functools.partial(fid._native_features, model))
    graphed_program(torch, "program [Inception pool3, 32 x 256 px -> 299]", owner, "inception",
                    (batch.clamp(0, 1),))
    n_sig = len(graphed.graphs)
    more = torch.cat([batch, batch[:1]]).clamp(0, 1)
    feats = fid.batched_features(graphed, more)
    with torch.no_grad():
        want = torch.cat([fid._native_features(model, more[:32]),
                          fid._native_features(model, more[32:])])
    if len(graphed.graphs) != n_sig or not torch.equal(feats[:32], want[:32]):
        fail("afhq: 33 images did not replay the one batch-32 graph, or differ from eager")
    tail = rel_diff(torch, [feats[32:]], [want[32:]])
    say(f"afhq: 33 images in two batches of 32 (31 padded rows dropped): one graph, the "
        f"first 32 rows equal to eager; the padded batch's real row against the eager "
        f"batch-1 features {tail:.3e} of max (bound {INCEPTION_REL_BOUND:.0e}, the card "
        f"against the CPU's: another batch may take another convolution algorithm)")
    if not tail <= INCEPTION_REL_BOUND:
        fail(f"afhq: the padded batch's features differ from eager by {tail}")
    x = fid.resize_299_bicubic(img.float().clamp(0, 1))
    on_card = inception_pool3_features(model, x).cpu()
    on_cpu = inception_pool3_features(copy.deepcopy(model).cpu(), x.cpu())
    rel = float((on_card - on_cpu).abs().max() / on_cpu.abs().max())
    say(f"afhq: Inception pool3 ({tuple(on_cpu.shape)}, fp32) card vs CPU: max abs err "
        f"{rel:.3e} of max|CPU| {float(on_cpu.abs().max()):.4f} (bound "
        f"{INCEPTION_REL_BOUND:.0e})")
    if not rel <= INCEPTION_REL_BOUND:
        fail(f"afhq: the card's Inception differs from the CPU's by {rel}")

    # fp32 round trip on the cat model: 100 steps of the shipped grid, no refine
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    src = seen["pipes"][0]
    rt = DDPMDDIMPipeline(src.spec, src.model, custom_steps=1000, es_steps=100, eta=0.1,
                          refine_steps=0)
    traj, x0_err = pixel_round_trip(torch, rt, orig,
                                    torch.Generator(device="cuda").manual_seed(72))
    say(f"round trip, AFHQ pixel UNet fp32 (TF32 off), {AFHQ_SAMPLES} images, 100 steps: "
        f"max|replay x_t - encode x_t| = {traj:.3e} (bound {PIXEL_TRAJECTORY_BOUND:.0e}); "
        f"max|image - x0| = {x0_err:.3e} (a reading: the last step predicts x0)")
    if not traj <= PIXEL_TRAJECTORY_BOUND:
        fail(f"afhq: the replay left the encode trajectory by {traj}")

    # the chains cut to 10 steps and refine 4, graphed against eager, under
    # the CLI's flags (TF32 convolutions)
    cut = DDPMDDIMPipeline(src.spec, src.model, custom_steps=1000, es_steps=10, eta=0.1,
                           refine_steps=4)

    def translate():
        g = torch.Generator(device="cuda").manual_seed(74)
        return cut.generate(cut.encode(orig, g), g)

    with torch_default_backends(torch):
        graphed_chain(torch, "graphs [AFHQ pixel encode, replay, refine]", cut,
                      ("_model_fn",), translate, 9 + 10 + 4)
    del cut

    # the batch-2 UNet call, eager and graph-replayed: fp32 (TF32 off), fp32
    # with cuDNN's TF32 convolutions (the CLI's default), bf16
    flops = unet_flops(src.model, AFHQ_SAMPLES)
    gen = torch.Generator(device="cuda").manual_seed(73)
    x = torch.randn((AFHQ_SAMPLES, 256, 256, 3), generator=gen, device="cuda")
    t = torch.full((AFHQ_SAMPLES,), 500, dtype=torch.int64, device="cuda")
    bf16 = copy.deepcopy(src.model).to(torch.bfloat16)
    for name, model, flags, peak_flops in (
            ("fp32", src.model, contextlib.nullcontext, PEAK_FLOPS["fp32"]),
            ("fp32, TF32 convolutions", src.model, functools.partial(torch_default_backends,
                                                                     torch), TF32_FLOPS),
            ("bf16", bf16, contextlib.nullcontext, PEAK_FLOPS["bf16"])):
        step = functools.partial(model, x.to(next(model.parameters()).dtype), t)
        with torch.no_grad(), flags():
            graph, out = graph_of(step)
            graph.replay()
            torch.cuda.synchronize()
            if not torch.equal(out, step()):
                fail(f"afhq: the {name} UNet call's graph replay differs from its eager call")
            bound = 1e3 * flops / peak_flops
            for _ in range(2):
                host, dev = eager_ms(step, 10)
                rep = graph_ms(graph, 10)
                say(f"afhq: AFHQ UNet call at batch {AFHQ_SAMPLES}, {name}: eager host "
                    f"{host:.3f} ms, device span {dev:.3f} ms; graph replay {rep:.3f} ms; "
                    f"{flops / 1e9:.1f} GFLOP, bound {bound:.3f} ms by operations")
        del graph, out, step
    del seen, written, src, rt, bf16
    gc.collect()
    torch.cuda.empty_cache()
    say_peak(torch, "afhq")


# phase 12: CLIP-energy guided sampling at SD v1 512 px (tracked config 5),
# the plain-inversion pipeline on the FFHQ LDM, the tiled first stage
GUIDED_WEIGHT = 0.05
# weight 0 against the plain replay, max abs diff / max|z0|: the same UNet
# calls and steps, the shift 0 * grad exactly 0, so bit for bit is expected
WEIGHT0_REL_BOUND = 1e-6
# The energy's gradient, the guided chains and their graphed twins are held
# bit for bit: CLIP's resize is JAX's weight matrices applied as two fp32
# products, whose backward adds no atomics, and the decoder's convolutions
# run with deterministic cuDNN here
# the energy's gradient along a seeded unit direction against the central
# difference at a step of FD_STEP * |p|, fp32 with TF32 off.  The step
# trades the fp32 energy's rounding (divided by the step) against the clamps
# of the image to [0, 1] (pixels that cross a clamp inside the step bend the
# difference, more of them the longer the step); the steps 10x either side
# are printed beside the gated one
FD_REL_BOUND = 1e-2
FD_STEP = 1e-3
# the same fp32 gradient with the models' GroupNorm through the plain version
# (autograd) instead of the kernels, max abs diff / max: the statistics'
# summation order alone differs.  The energy clamps (img + 1) / 2 to [0, 1],
# whose gradient jumps where a pixel crosses a bound: a decoded pixel within
# ~1e-7 of one crosses it under any change of that order (then the kernels'
# own gradient moves by ~3e-3 of max under a 1e-7 move of the point), so the
# plain run's decode keeps the kernels' side of the clamp at such pixels
PLAIN_GN_GRAD_REL_BOUND = 1e-4
# the FFHQ plain pipeline with K1 against plain attention (fp32, TF32 off),
# x_T and the sampled latent, max abs diff / max|plain|: 50 inversion and 50
# sampling steps each carry K1's ~1e-6 fp32 summation-order difference.  The
# VQ decoder quantises the latent first, and a latent that close to a
# boundary between two codes takes the other one, which changes its patch of
# the image by far more than 1e-3: the codes that differ are bounded as a
# share of the latent's positions, and the images are bounded where all
# codes agree
PLAIN_PIPE_REL_BOUND = 1e-3
CODE_FLIP_BOUND = 1e-3
# the tiled decode with one tile against the untiled one / max|image|: the
# weights cancel in fp32 and the result rounds once to bf16
ONE_TILE_REL_BOUND = 1e-5
TILED_SPLIT = {"ks": (32, 32), "stride": (16, 16)}   # 3 x 3 patches of a 64x64 latent


@contextlib.contextmanager
def plain_group_norm():
    """The models' GroupNorm through the plain version (autograd's
    gradient), not the kernels, inside the block."""
    from cyclediffusion_tpu_torch.models import nn as tnn
    from cyclediffusion_tpu_torch.ops.group_norm import group_norm_reference

    kernel = tnn.group_norm
    tnn.group_norm = group_norm_reference
    try:
        yield
    finally:
        tnn.group_norm = kernel


def fp32_gradient_check(torch, spec, clip) -> dict:
    """The guided energy's gradient with core and scorer in fp32 (TF32 off)
    at the fp32 chain's own first pred_x0 (a point that no bf16 rounding
    moves): its gap to the same gradient with the plain GroupNorm (its
    decode kept on the kernels' side of the energy's clamp), and the
    directional checks at FD_STEP |p| and 10x either side."""
    from cyclediffusion_tpu_torch.samplers.guided import energy_grad
    from cyclediffusion_tpu_torch.tools import guided_probe

    g32 = guided_probe.build(spec, clip, steps=STEPS, device="cuda", dtype=torch.float32)
    x, p32, t = guided_probe.first_step_point(g32)
    efn, core = g32.energy_fn, g32.core
    decode, seen = core.decode_first_stage_eager, []

    def inside(img):
        """Pixels where the energy's clamp passes the gradient."""
        u = (img.detach() + 1.0) / 2.0
        return (u >= 0.0) & (u <= 1.0)

    def recorded(z):
        img = decode(z)
        seen.append(img.detach())
        return img

    def on_the_kernels_side(z):
        # the plain decode, shifted by a constant onto the kernels' decode
        # where the two lie on opposite sides of the clamp
        img, kernel_img = decode(z), seen[0]
        flips = inside(img) != inside(kernel_img)
        seen.append(int(flips.sum()))
        return img + torch.where(flips, kernel_img - img.detach(), 0.0)

    core.decode_first_stage_eager = recorded
    grad32 = energy_grad(efn, x, p32, t)
    core.decode_first_stage_eager = on_the_kernels_side
    try:
        with plain_group_norm():
            grad_plain = energy_grad(efn, x, p32, t)
    finally:
        del core.decode_first_stage_eager
    gen = torch.Generator(device="cuda").manual_seed(81)
    v = torch.randn(p32.shape, generator=gen, device="cuda")
    v = v / v.norm()
    h = FD_STEP * float(p32.norm())
    with torch.no_grad():
        energy = lambda q: efn(x, q, t)         # noqa: E731
        checks = {m: directional_check(energy, grad32, p32, v, m * h) for m in (10, 1, 0.1)}
        e_p = float(energy(p32))
    out = {"energy": e_p, "grad_max": float(grad32.abs().max()), "h": h, "checks": checks,
           "plain_rel": rel_diff(torch, [grad32], [grad_plain]), "clamp_flips": seen[-1]}
    del g32, efn, core, grad32, grad_plain, seen
    gc.collect()
    torch.cuda.empty_cache()
    return out


def guided_launches(spec, attention_route, unet_calls: int) -> dict:
    """K1 and K2 launches of ``unet_calls`` UNet calls on ``spec``: the
    guided chain's only launches (the energy's forward and backward run
    none)."""
    return {k: n * unet_calls for k, n in launches_per_call(spec, attention_route).items()}


def directional_check(energy, grad, p, v, h: float):
    """(<grad, v>, the central difference (E(p + hv) - E(p - hv)) / 2h,
    their gap relative to the larger of the two)."""
    gv = float((grad.double() * v.double()).sum())
    fd = (float(energy(p + h * v)) - float(energy(p - h * v))) / (2.0 * h)
    return gv, fd, abs(gv - fd) / max(abs(gv), abs(fd), 1e-30)


def plain_energy_chains(torch, g, want, run) -> None:
    """The cut guided chain twice with a plain callable as its energy (the
    CLIP energy's own function, behind a new lambda): the first chain wraps
    it and captures its gradient's graph, the second reuses that wrapper and
    only replays; both equal ``want`` (the chain with the ``GraphedEnergy``)
    bit for bit.  ``run(energy)`` runs the chain.  Dropping the callable
    frees the wrapper, its graph and its pool."""
    from cyclediffusion_tpu_torch.samplers.guided import graphed_energy

    fn = g.energy_fn.fn
    plain = lambda x_t, p, t: fn(x_t, p, t)         # noqa: E731
    seen, made = set(), []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        z = run(plain)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        graphs = graphed_energy(plain)._graphed_grad.graphs
        new = [c for k, c in graphs.items() if k not in seen]
        seen |= set(graphs)
        made.append((secs, len(new), sum(c.warm_up_seconds + c.seconds for c in new)))
        del graphs, new
        if not torch.equal(z, want):
            fail(f"guided: the chain with a plain energy callable differs from the "
                 f"GraphedEnergy's by {rel_diff(torch, [z], [want]):.3e} of max|z0|")
    if made[0][1] != 1 or made[1][1] != 0:
        fail(f"guided: a plain energy made {made[0][1]} graph(s) in its first chain and "
             f"{made[1][1]} in its second; expected 1 and 0")
    say(f"guided: a plain energy callable in two 10-step chains: the first {made[0][0]:.3f} s "
        f"with {made[0][1]} capture (warm-up and capture {made[0][2]:.3f} s), the second "
        f"{made[1][0]:.3f} s with {made[1][1]} (its graph replayed); both equal the "
        f"GraphedEnergy chain bit for bit ({card_name()})")
    del plain
    gc.collect()


def phase_guided(torch, fa, attention):
    """Phase 12 (a-c): guided sampling on SD v1, the plain-inversion
    pipeline on the FFHQ LDM, the tiled decode -> the launch counts of one
    guided chain and of the FFHQ pipeline's run with the kernels."""
    from cyclediffusion_tpu_torch.models.clip import CLIPConfig
    from cyclediffusion_tpu_torch.ops.fold import SplitInputParams
    from cyclediffusion_tpu_torch.pipelines.factory import LATENT_MODELS
    from cyclediffusion_tpu_torch.pipelines.latent import LatentCoreSpec, LatentDiffusionCore
    from cyclediffusion_tpu_torch.pipelines.latentdiff_plain import LatentDiffPlainPipeline
    from cyclediffusion_tpu_torch.ops.cfg import cfg_model_fn
    from cyclediffusion_tpu_torch.samplers.guided import energy_grad, energy_guided_decode
    from cyclediffusion_tpu_torch.tools import guided_probe

    cudnn = torch.backends.cudnn
    torch.backends.cuda.matmul.allow_tf32 = cudnn.allow_tf32 = False
    cudnn.deterministic, cudnn.benchmark = True, False
    reset_peak(torch)
    spec, clip = LatentCoreSpec.sd_v1(), CLIPConfig.vit_b_32()
    t0 = time.perf_counter()
    g = guided_probe.build(spec, clip, steps=STEPS, device="cuda")
    torch.cuda.synchronize()
    say(f"guided: SD v1 (seed 0) and a ViT-B/32 scorer "
        f"({sum(p.numel() for p in g.scorer.model.parameters()):,} params, seed 1) in "
        f"bf16, built in {time.perf_counter() - t0:.2f} s; {STEPS} steps, eta "
        f"{guided_probe.ETA}, CFG {guided_probe.CFG_SCALE} at batch 1, weight "
        f"{GUIDED_WEIGHT}")

    # one energy gradient at the first step's pred_x0 (warm-up, then zero
    # kernel launches in its forward and backward), its profile eager and
    # graph-replayed, and the graphed gradient against the eager one
    x, p, t = guided_probe.first_step_point(g)
    energy_grad(g.energy_fn, x, p, t)
    torch.cuda.synchronize()
    reset_launches()
    grad = energy_grad(g.energy_fn, x, p, t)
    torch.cuda.synchronize()
    if any(launched().values()):
        fail(f"guided: the energy's forward and backward launched {launched()}")
    if not torch.isfinite(grad).all():
        fail("guided: non-finite energy gradient")
    flagged = guided_probe.nondeterministic_ops(g)
    say(f"guided: torch.use_deterministic_algorithms(True, warn_only=True) over one eager "
        f"energy gradient flags {len(flagged)} op(s)"
        + "".join(f"\nguided:   {m}" for m in flagged))
    prof = guided_probe.energy_profile(g)
    if not prof["eager_equal"]:
        fail(f"guided: three eager energy gradients at one input differ from a first by up "
             f"to {prof['eager_spread']:.3e} of max")
    top = list(prof["eager_kinds"].items())[:8]
    say(f"guided: energy forward + backward (decode 64x64x4 -> 512x512x3, ViT-B/32) eager: "
        f"host enqueue {prof['eager_host_ms']:.3f} ms, device span "
        f"{prof['eager_device_ms']:.3f} ms per call, {prof['eager_launches']:.0f} launches; "
        f"{prof['gflop']:.1f} GFLOP, {prof['weight_and_io_mb']:.1f} MB of weights and "
        f"inputs: bound {prof['bound_ms']:.3f} ms by {prof['bound_by']}; graph: capture "
        f"{prof['capture_s']:.3f} s, replay {prof['replay_ms']:.3f} ms, graphed call host "
        f"{prof['graphed_host_ms']:.3f} ms, device span {prof['graphed_device_ms']:.3f} ms; "
        f"max|dE/dp| {float(grad.abs().max()):.3e}; four eager gradients at one input "
        f"equal bit for bit ({card_name()})")
    say(f"guided: eager energy by kernel kind (device ms, launches per call): "
        + "; ".join(f"{k} {v['ms']:.3f} ms x{v['launches']:.0f}" for k, v in top))
    graphed_program(torch, "program [guided energy gradient, batch 1, 512 px]", g.energy_fn,
                    "grad", (x, p, t))

    # (a) the chains, plain and guided in turns, counted
    calls = [0]
    model_fn = g.model_fn

    def counted(*a):
        calls[0] += 1
        return model_fn(*a)

    g.model_fn = counted
    reset_peak(torch)
    times, out, counts = {"plain": [], "guided": [], "eager energy": []}, {}, {}
    for name in ("plain", "guided", "eager energy", "eager energy", "guided", "plain"):
        calls[0] = 0
        reset_launches()
        if name == "eager energy":        # the guided chain with the energy eager
            g.energy_fn.grad = g.energy_fn.grad_eager
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        z0 = g.plain() if name == "plain" else g.guided(GUIDED_WEIGHT)
        torch.cuda.synchronize()
        times[name].append(time.perf_counter() - t0)
        g.energy_fn.__dict__.pop("grad", None)
        counts.setdefault(name, (calls[0], launched()))
        out.setdefault(name, []).append(z0)
    chains_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = guided_launches(spec, fa.attention_route, STEPS)
    for name, (n, c) in counts.items():
        if n != STEPS or any(c[k] != want.get(k, 0) for k in c):
            fail(f"guided: the {name} chain made {n} UNet calls and launched {c}; expected "
                 f"{STEPS} and {want}")
    if not torch.isfinite(out["guided"][0]).all():
        fail("guided: non-finite z0")
    # the two chains of each kind, and the graphed energy's against the
    # eager energy's, bit for bit
    z50 = out["guided"] + out["eager energy"]
    if not all(torch.equal(z, z50[0]) for z in z50[1:]):
        rel_e = max(rel_diff(torch, [z], z50[:1]) for z in z50[1:])
        fail(f"guided: the four 50-step guided chains (two with the graphed energy, two with "
             f"the eager) are not equal: up to {rel_e:.3e} of max|z0| apart")
    out = {name: zs[0] for name, zs in out.items()}
    zero = g.guided(0.0)
    rel0 = float((zero - out["plain"]).abs().max() / out["plain"].abs().max())
    if not rel0 <= WEIGHT0_REL_BOUND:
        fail(f"guided: weight 0 differs from the plain replay by {rel0} of max|z0|")
    g.model_fn = model_fn
    plain_s, guided_s, eager_s = (sorted(times[k])[0]
                                  for k in ("plain", "guided", "eager energy"))
    dz0 = float((out["guided"] - out["plain"]).abs().mean())
    say(f"guided: launches per chain {counts['guided'][1]} = {STEPS} UNet calls x "
        f"{launches_per_call(spec, fa.attention_route)}; weight 0 vs plain: {rel0:.3e} of "
        f"max|z0| (bound {WEIGHT0_REL_BOUND:.0e}); the 50-step guided chains, two with the "
        f"graphed energy and two with the eager, equal bit for bit")
    say(f"guided: plain {times['plain']} s/chain, guided {times['guided']} s/chain, guided "
        f"with the eager energy {times['eager energy']} s/chain; best plain {plain_s:.3f} s "
        f"({1e3 * plain_s / STEPS:.2f} ms/step), guided {guided_s:.3f} s "
        f"({1e3 * guided_s / STEPS:.2f} ms/step), eager energy {eager_s:.3f} s "
        f"({1e3 * eager_s / STEPS:.2f} ms/step); guided / plain {guided_s / plain_s:.3f}; "
        f"mean|dz0| {dz0:.4e}; peak device memory of the chains {chains_peak:.2f} GiB "
        f"({card_name()})")

    # the guided chain cut to 10 steps, its UNet calls graphed, against eager
    sched10 = g.core.make_ddim_schedule(10, guided_probe.ETA)

    def guided_cut(weight, energy=None):
        model = cfg_model_fn(g.core.apply_model, g.uncond, g.cond, guided_probe.CFG_SCALE)
        return energy_guided_decode(model, sched10, g.x_T, g.eps[:10], None,
                                    g.energy_fn if energy is None else energy, weight)

    for weight in (0.0, GUIDED_WEIGHT):
        graphed_chain(torch, f"graphs [guided chain, UNet and energy, weight {weight}]",
                      g.core, ("apply_model",), functools.partial(guided_cut, weight), 10,
                      programs=[(g.energy_fn, ("grad",))])
    plain_energy_chains(torch, g, guided_cut(GUIDED_WEIGHT),
                        functools.partial(guided_cut, GUIDED_WEIGHT))

    q = torch.randn((2, 4096, 320), device="cuda", dtype=torch.bfloat16, requires_grad=True)
    with torch.enable_grad():
        try:
            fa.flash_attention_packed(q, q.detach(), q.detach(), 8, 40 ** -0.5)
        except RuntimeError as err:
            say(f"guided: K2 on an input that requires a gradient raises: {err}")
        else:
            fail("guided: K2 took an input that requires a gradient")

    # (c) the tiled decode of the plain chain's z0, and a gradient through it
    core, z = g.core, out["plain"]
    ref = core.decode_first_stage(z)
    batches = []
    decode = core.first_stage.decode

    def spy(h):
        batches.append(h.shape[0])
        return decode(h)

    try:
        core.split_input_params = SplitInputParams(ks=(64, 64), stride=(32, 32))
        one = core.decode_first_stage(z)
        core.split_input_params = SplitInputParams(**TILED_SPLIT)
        core.first_stage.decode = spy
        tiled = core.decode_first_stage_eager(z)
        del core.first_stage.decode
        graphed_program(torch, "program [SD: tiled KL-f8 decode, 9 patches of 32x32x4]",
                        core, "decode_first_stage", (z,))
        tiled_grad = energy_grad(g.energy_fn, x, z, t)
        # the energy reads the tiling: another setting, another graph
        graphed_program(torch, "program [guided energy gradient through the tiled decode]",
                        g.energy_fn, "grad", (x, z, t))
        tiled_ms = cuda_time_ms(lambda: core.decode_first_stage(z), reps=5, warmup=1)
    finally:
        core.split_input_params = None
        core.first_stage.__dict__.pop("decode", None)
    untiled_ms = cuda_time_ms(lambda: core.decode_first_stage(z), reps=5, warmup=1)
    rel1 = float((one - ref).abs().max() / ref.abs().max())
    if not rel1 <= ONE_TILE_REL_BOUND:
        fail(f"tiled decode: one tile differs from the untiled decode by {rel1} of max")
    if batches != [9] or tuple(tiled.shape) != (1, 512, 512, 3) or not torch.isfinite(
            tiled).all():
        fail(f"tiled decode: patch batches {batches}, shape {tuple(tiled.shape)}")
    if not (torch.isfinite(tiled_grad).all() and float(tiled_grad.abs().max()) > 0):
        fail("tiled decode: the energy gradient through it is not finite and non-zero")
    say(f"tiled decode: one tile vs untiled {rel1:.3e} of max (bound "
        f"{ONE_TILE_REL_BOUND:.0e}); {TILED_SPLIT}: 9 patches in one decode call, "
        f"{tuple(tiled.shape)} finite, max|tiled - untiled| "
        f"{float((tiled - ref).abs().max()):.3e}; energy gradient through it max "
        f"{float(tiled_grad.abs().max()):.3e}; decode {tiled_ms:.3f} ms tiled, "
        f"{untiled_ms:.3f} ms untiled")
    del g, core, z, ref, one, tiled, out, zero
    gc.collect()
    torch.cuda.empty_cache()

    # the gradient in fp32 against the plain GroupNorm's and a central difference
    fp32 = fp32_gradient_check(torch, spec, clip)
    checks, rel = fp32["checks"], fp32["checks"][1][2]
    say(f"guided fp32: at the fp32 chain's first pred_x0, E(p) {fp32['energy']:.6e}, "
        f"max|dE/dp| {fp32['grad_max']:.3e}; against the plain GroupNorm's gradient "
        f"{fp32['plain_rel']:.3e} of max (bound {PLAIN_GN_GRAD_REL_BOUND:.0e}; "
        f"{fp32['clamp_flips']} pixel(s) kept on the kernels' side of the clamp); "
        f"<dE/dp, v> {checks[1][0]:.6e}; central difference at h = {fp32['h']:.4g} "
        f"({FD_STEP} |p|): {checks[1][1]:.6e}, relative gap {rel:.3e} (bound "
        f"{FD_REL_BOUND:.0e}); at 10h {checks[10][1]:.6e} ({checks[10][2]:.3e}), at h/10 "
        f"{checks[0.1][1]:.6e} ({checks[0.1][2]:.3e})")
    if not fp32["plain_rel"] <= PLAIN_GN_GRAD_REL_BOUND:
        fail(f"guided: the fp32 energy gradient differs from the plain GroupNorm's by "
             f"{fp32['plain_rel']} of max")
    if not rel <= FD_REL_BOUND:
        fail(f"guided: the energy gradient misses the central difference by {rel}")

    # (b) the plain-inversion pipeline on the FFHQ LDM, K1 against plain
    # attention, fp32
    spec_f = LATENT_MODELS["ffhq256"]()
    core_f = LatentDiffusionCore.random_init(spec_f, UNPAIRED_MODELS["ffhq256"], "cuda",
                                             torch.float32)
    pipe = LatentDiffPlainPipeline(core_f, custom_steps=STEPS)
    gen = torch.Generator(device="cuda").manual_seed(82)
    small = torch.rand((UNPAIRED_SAMPLES, 3, 16, 16), generator=gen, device="cuda")
    images = torch.nn.functional.interpolate(small, size=(256, 256), mode="bilinear",
                                             align_corners=False).permute(0, 2, 3, 1)
    runs, plain_counts = {}, {}
    decode = core_f.decode_first_stage
    for mode in ("kernels", "plain"):
        samples = []
        core_f.decode_first_stage = lambda s: samples.append(s) or decode(s)
        if mode == "plain":       # a graph replays the kernels it captured
            core_f.apply_model = core_f.apply_model_eager
        try:
            with attention(mode):
                reset_launches()
                t0 = time.perf_counter()
                zp = pipe.encode(images)
                img = pipe.generate(zp)
                torch.cuda.synchronize()
                runs[mode] = (zp, samples[0], img, time.perf_counter() - t0)
                plain_counts[mode] = launched()
        finally:
            del core_f.decode_first_stage
            core_f.__dict__.pop("apply_model", None)
    want = {k: n * 2 * STEPS for k, n in launches_per_call(spec_f, fa.attention_route).items()}
    if plain_counts["kernels"] != {**dict.fromkeys(plain_counts["kernels"], 0), **want} or any(
            plain_counts["plain"].values()):
        fail(f"plain pipeline: launches {plain_counts}, expected {want} with the kernels "
             f"and none with plain attention")
    (zk, xk, ik, sk), (zp, xp, ip, sp) = runs["kernels"], runs["plain"]
    rel_z = float((zk - zp).abs().max() / zp.abs().max())
    rel_x = float((xk - xp).abs().max() / xp.abs().max())
    rel_i = float((ik - ip).abs().max() / ip.abs().max())
    codes = [core_f.first_stage.quantize(x / spec_f.scale_factor)[1] for x in (xk, xp)]
    flips = int((codes[0] != codes[1]).sum())
    say(f"plain pipeline (FFHQ LDM fp32, {UNPAIRED_SAMPLES} images, {STEPS} steps, eta 0): "
        f"x_T {tuple(zk.shape)}, image {tuple(ik.shape)}; K1 vs plain attention: x_T "
        f"{rel_z:.3e}, sampled latent {rel_x:.3e} of max (bound {PLAIN_PIPE_REL_BOUND:.0e}); "
        f"{flips} of {codes[0].numel()} VQ codes differ (bound {CODE_FLIP_BOUND:.0e} of "
        f"them), image {rel_i:.3e} of max (bounded where no code differs); launches "
        f"{plain_counts['kernels']}; encode + generate {sk:.3f} s with K1, {sp:.3f} s plain")
    if not (rel_z <= PLAIN_PIPE_REL_BOUND and rel_x <= PLAIN_PIPE_REL_BOUND
            and flips <= CODE_FLIP_BOUND * codes[0].numel()
            and (flips or rel_i <= PLAIN_PIPE_REL_BOUND)):
        fail(f"plain pipeline: K1 disagrees with plain attention: x_T {rel_z}, latent "
             f"{rel_x}, {flips} codes, image {rel_i}")
    if not (torch.isfinite(zk).all() and torch.isfinite(ik).all()):
        fail("plain pipeline: non-finite x_T or image")
    cut = LatentDiffPlainPipeline(core_f, custom_steps=10)

    def invert_sample():
        z = cut.encode(images)
        return z, cut.generate(z)

    graphed_chain(torch, "graphs [plain inversion and sampling, FFHQ LDM fp32]", core_f,
                  ("apply_model",), invert_sample, 20, programs=[(core_f, FIRST_STAGE)])
    del core_f, pipe, runs, cut
    gc.collect()
    torch.cuda.empty_cache()
    say_peak(torch, "guided")
    k1 = counts["guided"][1]
    return {"flash_attention_bhtd": k1["flash_attention_bhtd"]
            + plain_counts["kernels"]["flash_attention_bhtd"],
            "flash_attention_packed": k1["flash_attention_packed"]}


# phase 13: data and metrics
DT_BATCH = 8
DT_CASES = ((512, 256), (256, 512))      # (input size, output size)
DT_METHODS = ("bilinear", "bicubic", "lanczos3", "lanczos5", "nearest")
# preprocess_batch on the card against the CPU, max abs on [0, 1] pixels:
# the same fp32 weight matrices, the products in fp32 both ways (TF32 off),
# summed in another order
DT_BOUND = 1e-5
LPIPS_PAIRS, LPIPS_SIZE = 8, 256
# the random-feature LPIPS on the card against the CPU, max |card - CPU| /
# max|CPU|: fp32 both ways (TF32 off), cuDNN's and the CPU's convolution
# algorithms round otherwise over 13 layers
LPIPS_REL_BOUND = 1e-4
JPEG_REPS = 5

# SD v1's inference spec in the layout of the reference's
# configs/stable-diffusion/v1-inference.yaml
SD_V1_YAML = """\
model:
  base_learning_rate: 1.0e-04
  target: ldm.models.diffusion.ddpm.LatentDiffusion
  params:
    linear_start: 0.00085
    linear_end: 0.0120
    num_timesteps_cond: 1
    log_every_t: 200
    timesteps: 1000
    first_stage_key: "jpg"
    cond_stage_key: "txt"
    image_size: 64
    channels: 4
    cond_stage_trainable: false   # a comment, as the reference has
    conditioning_key: crossattn
    monitor: val/loss_simple_ema
    scale_factor: 0.18215
    use_ema: False

    scheduler_config: # 10000 warmup steps
      target: ldm.lr_scheduler.LambdaLinearScheduler
      params:
        warm_up_steps: [ 10000 ]
        cycle_lengths: [ 10000000000000 ]
        f_start: [ 1.e-6 ]
        f_max: [ 1. ]
        f_min: [ 1. ]

    unet_config:
      target: ldm.modules.diffusionmodules.openaimodel.UNetModel
      params:
        image_size: 32 # unused
        in_channels: 4
        out_channels: 4
        model_channels: 320
        attention_resolutions: [ 4, 2, 1 ]
        num_res_blocks: 2
        channel_mult: [ 1, 2, 4, 4 ]
        num_heads: 8
        use_spatial_transformer: True
        transformer_depth: 1
        context_dim: 768
        use_checkpoint: True
        legacy: False

    first_stage_config:
      target: ldm.models.autoencoder.AutoencoderKL
      params:
        embed_dim: 4
        monitor: val/rec_loss
        ddconfig:
          double_z: true
          z_channels: 4
          resolution: 256
          in_channels: 3
          out_ch: 3
          ch: 128
          ch_mult:
          - 1
          - 2
          - 4
          - 4
          num_res_blocks: 2
          attn_resolutions: []
          dropout: 0.0
        lossconfig:
          target: torch.nn.Identity

    cond_stage_config:
      target: ldm.modules.encoders.modules.FrozenCLIPEmbedder
"""
# a DiffusionCLIP-style AFHQ model file
AFHQ_YML = """\
data:
    dataset: "AFHQ"
    category: "dog"
    image_size: 256
    channels: 3
model:
    type: "simple"
    var_type: fixedsmall
    attn_resolutions: [16, ]
    ema: True
diffusion:
    beta_schedule: linear
    beta_start: 0.0001
    beta_end: 0.02
    num_diffusion_timesteps: 1000
"""


def check_jpeg_fixtures(reps: int = JPEG_REPS):
    """Every committed JPEG fixture decoded on the host -> ({stem: values
    that differ from the stored Pillow decode}, ms of each 512 px decode,
    the Pillow version that made the stored decode)."""
    import numpy as np

    from cyclediffusion_tpu_torch.data.jpeg import read_jpeg

    d = os.path.join(ROOT, JPEG_DIR)
    stored = np.load(os.path.join(d, "pillow_decode.npz"))
    differ, ms = {}, []
    for stem in sorted(f[:-4] for f in os.listdir(d) if f.endswith(".jpg")):
        path = os.path.join(d, f"{stem}.jpg")
        img = read_jpeg(path)
        want = stored[stem]
        differ[stem] = int((img != want).sum()) if img.shape == want.shape else -1
        if img.shape[:2] == (512, 512):
            for _ in range(reps):
                t0 = time.perf_counter()
                read_jpeg(path)
                ms.append(1e3 * (time.perf_counter() - t0))
    return differ, ms, str(stored["pillow_version"])


def dt_batch(torch, size: int, batch: int = DT_BATCH):
    """A seeded batch of uint8 images (B, size, size, 3) on the CPU."""
    gen = torch.Generator().manual_seed(size)
    return torch.randint(0, 256, (batch, size, size, 3), generator=gen, dtype=torch.uint8)


def check_device_transforms(torch, device, cases=DT_CASES, methods=DT_METHODS,
                            batch: int = DT_BATCH) -> dict:
    """``preprocess_batch`` on ``device`` against the CPU -> {(in size, out
    size, method): max abs}."""
    from cyclediffusion_tpu_torch.data.device_transforms import preprocess_batch

    errs = {}
    for size_in, size_out in cases:
        x = dt_batch(torch, size_in, batch)
        for method in methods:
            want = preprocess_batch(x, size_out, method=method)
            got = preprocess_batch(x.to(device), size_out, method=method).cpu()
            if tuple(got.shape) != (batch, size_out, size_out, 3):
                raise ValueError(f"preprocess_batch gave {tuple(got.shape)}")
            errs[(size_in, size_out, method)] = float((got - want).abs().max())
    return errs


def lpips_pairs(torch, pairs: int, size: int):
    """Seeded [-1, 1] images a and noise n, (pairs, size, size, 3), on the CPU."""
    gen = torch.Generator().manual_seed(size + pairs)
    a = torch.rand((pairs, size, size, 3), generator=gen) * 2 - 1
    n = torch.rand((pairs, size, size, 3), generator=gen) * 2 - 1
    return a, n


def check_lpips(torch, device, pairs: int = LPIPS_PAIRS, size: int = LPIPS_SIZE):
    """The seeded random-feature LPIPS on ``device`` against the same
    module on the CPU -> (max |device - CPU| / max|CPU| of d(a, a + 0.1 n),
    d(a, a), d(a, a + 0.01 n), d(a, a + 0.5 n) on the device, the device
    module)."""
    import copy

    from cyclediffusion_tpu_torch.evaluation.lpips import lpips_distance, random_lpips_params

    cpu = random_lpips_params(torch.Generator().manual_seed(0), device="cpu")
    model = copy.deepcopy(cpu).to(device)
    a, n = lpips_pairs(torch, pairs, size)
    with torch.no_grad():
        want = lpips_distance(cpu, a, a + 0.1 * n)
        got = lpips_distance(model, a, a + 0.1 * n).cpu()
        rel = float((got - want).abs().max() / want.abs().max())
        same, small, large = (lpips_distance(model, a, a + k * n).cpu()
                              for k in (0.0, 0.01, 0.5))
    return rel, same, small, large, model


def check_yaml_specs(root: str) -> list:
    """The spec loaders on YAML the phase writes -> the fields that differ
    (none when they pass): SD v1's inference YAML against the ``sd_v1``
    preset (at the file's resolution, the first stage's 256; SD's wrapper
    runs at 512), an AFHQ ``.yml`` against the zoo's ``afhqdog256``."""
    import dataclasses

    from cyclediffusion_tpu_torch.pipelines.latent import LatentCoreSpec
    from cyclediffusion_tpu_torch.pipelines.zoo import PIXEL_ZOO, pixel_spec_from_yml

    bad = []
    path = os.path.join(root, "v1-inference.yaml")
    with open(path, "w") as f:
        f.write(SD_V1_YAML)
    spec = LatentCoreSpec.from_yaml(path, name="sd_v1")
    want = dataclasses.replace(LatentCoreSpec.sd_v1(), resolution=256)
    bad += [f"sd_v1.{f.name}" for f in dataclasses.fields(spec)
            if getattr(spec, f.name) != getattr(want, f.name)]
    path = os.path.join(root, "afhq.yml")
    with open(path, "w") as f:
        f.write(AFHQ_YML)
    spec, want = pixel_spec_from_yml(path, name="afhqdog256"), PIXEL_ZOO["afhqdog256"]
    bad += [f"afhq.{f.name}" for f in dataclasses.fields(spec)
            if getattr(spec, f.name) != getattr(want, f.name)]
    return bad


def phase_data(torch, card: str) -> None:
    """Phase 13: the JPEG decoder on the card's host, the device transforms
    and the random-feature LPIPS on the card against the CPU, the YAML spec
    loaders; their times, beside the card's name and power limit."""
    reset_peak(torch)
    say(f"data: {card}")
    differ, ms, pillow = check_jpeg_fixtures()
    say(f"data: JPEG, {len(differ)} fixtures decoded on the host against Pillow {pillow}'s "
        f"stored decode: differing values {differ}")
    if any(differ.values()):
        fail(f"data: the JPEG decode differs from Pillow's: {differ}")
    ms.sort()
    say(f"data: JPEG decode of a 512x512 4:2:0 image on the host: median {ms[len(ms) // 2]:.1f} "
        f"ms over {len(ms)} decodes (min {ms[0]:.1f}, max {ms[-1]:.1f})")

    from cyclediffusion_tpu_torch.data.device_transforms import preprocess_batch

    errs = check_device_transforms(torch, "cuda")
    worst = max(errs.values())
    say(f"data: preprocess_batch, batch {DT_BATCH}, card vs CPU max abs by (in, out, "
        f"method): {errs} (bound {DT_BOUND:.0e})")
    if not worst <= DT_BOUND:
        fail(f"data: preprocess_batch on the card differs from the CPU by {worst}")
    for size_in, size_out in DT_CASES:
        x = dt_batch(torch, size_in).cuda()
        times = {m: cuda_time_ms(functools.partial(preprocess_batch, x, size_out, m), reps=10)
                 for m in DT_METHODS}
        say(f"data: preprocess_batch {DT_BATCH} x {size_in}px uint8 -> {size_out}px on the "
            f"card, ms per batch: " + ", ".join(f"{m} {t:.3f}" for m, t in times.items()))

    rel, same, small, large, model = check_lpips(torch, "cuda")
    say(f"data: random-feature LPIPS (seeded, fp32, TF32 off; not the published weights), "
        f"{LPIPS_PAIRS} pairs at {LPIPS_SIZE}px: card vs CPU {rel:.3e} of max|CPU| (bound "
        f"{LPIPS_REL_BOUND:.0e}); d(a, a) max {float(same.max()):.3e}; d(a, a + 0.01 n) "
        f"{float(small.mean()):.4g} < d(a, a + 0.5 n) {float(large.mean()):.4g} (means)")
    if not rel <= LPIPS_REL_BOUND:
        fail(f"data: LPIPS on the card differs from the CPU by {rel}")
    if bool((same != 0).any()) or not bool((small < large).all()):
        fail(f"data: LPIPS d(a, a) = {same.tolist()}, small {small.tolist()}, "
             f"large {large.tolist()}")
    from cyclediffusion_tpu_torch.evaluation.lpips import lpips_distance
    a, n = (t.cuda() for t in lpips_pairs(torch, LPIPS_PAIRS, LPIPS_SIZE))
    b = a + 0.1 * n
    with torch.no_grad():
        t = cuda_time_ms(lambda: lpips_distance(model, a, b), reps=10)
    say(f"data: LPIPS on the card, {LPIPS_PAIRS} pairs at {LPIPS_SIZE}px, fp32 (TF32 off): "
        f"{t:.3f} ms per batch")

    with tempfile.TemporaryDirectory(prefix="cd_yaml_") as root:
        bad = check_yaml_specs(root)
    if bad:
        fail(f"data: the YAML spec loaders differ from the presets in {bad}")
    say("data: from_yaml(SD v1 inference YAML) equals LatentCoreSpec.sd_v1() field by field "
        "(at the file's resolution 256); pixel_spec_from_yml(AFHQ .yml) equals the zoo's "
        "afhqdog256")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    say_peak(torch, "data")


# phase 14: the driver across processes and devices.  (a) phase 7's cut SD
# experiment on 3 images at batch 1, so that two processes get ragged shards
PAR_CUTS = {**CLI_CUTS, ("raw_data", "range"): "[4, 7]"}
PAR_SAMPLES = 3
# rank 0's metrics against one process's: JAX's own multi-process bound
# (tests/test_multihost_real.py), 1e-4 + 1e-3 |x|
PAR_ABS, PAR_REL = 1e-4, 1e-3
# (c) tensor parallelism: SD v1's UNet at n_model 2 over the parameters
# JAX's rule picks at this threshold (206 of them)
TP_MIN_SIZE, TP_SHARDED = 512, 206
# (d) the port's optimisers on the card against optax's trajectories
# (tests/data_torch/flax/optax_trajectories.npz, 20 float32 steps): the CPU
# agrees to 2.4e-7; the card's float32 sqrt, pow and reductions may round
# otherwise, and 20 steps may grow that tenfold
OPT_TRAJ_BOUND = 2e-5
# the toy regression of JAX's tests/test_driver_train.py, with its bounds,
# and card vs CPU (float32, another summation order)
TOY_LOSS_BOUND, TOY_W_BOUND, TOY_CARD_CPU_BOUND = 0.05, 0.2, 1e-4
# (b) one Driver.train step through NCCL against the CPU's: the same float32
# operations on 3 weights, so ulps apart
NCCL_STEP_BOUND = 1e-6
SD_UNET_PARAMS = 859_520_964
CHILD_TIMEOUT = 600
FLAX_FIXTURES = os.path.join("tests", "data_torch", "flax")


class ToyRegression:
    """JAX ``tests/test_driver_train.py``'s model: y = w . x, mean squared
    error, ``w`` on ``device``."""

    def __init__(self, torch, device):
        self.trainable_params = {"w": torch.zeros(3, device=device)}

    @staticmethod
    def loss_fn(params, batch, generator):
        return ((batch["x"] @ params["w"] - batch["y"]) ** 2).mean()


def toy_items(n: int = 64):
    import numpy as np

    rng = np.random.RandomState(0)
    w_true = np.array([1.0, -2.0, 0.5], np.float32)
    xs = rng.randn(n, 3).astype(np.float32)
    return [{"x": xs[i], "y": np.float32(xs[i] @ w_true)} for i in range(n)], w_true


def toy_args(out_dir: str, **kw):
    import types

    args = dict(output_dir=out_dir, num_train_epochs=60, learning_rate=0.1,
                per_device_train_batch_size=8, gradient_accumulation_steps=2, logging_steps=0,
                save_steps=0, seed=0, max_grad_norm=1.0, weight_decay=0.0, optim="adamw")
    args.update(kw)
    return types.SimpleNamespace(**args)


def run_children(kind: str, world: int, work: str, extra=()) -> list:
    """This script's ``--child kind`` as ``world`` processes on the card (one
    ``file://`` init under ``work``), each given ``CHILD_TIMEOUT`` seconds ->
    each rank's report.  A failure or a timeout fails the phase."""
    init = "file://" + os.path.join(work, f"{kind}_{world}_init")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--child", kind,
                               str(r), str(world), init, work, *extra],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=CHILD_TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        fail(f"parallel: {kind} x{world} ran past {CHILD_TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            fail(f"parallel: {kind} rank {r} of {world} exited {p.returncode}:\n{out[-4000:]}")
    reports = []
    for r in range(world):
        with open(os.path.join(work, f"{kind}_{world}_{r}.json")) as f:
            reports.append(json.load(f))
    return reports


def child_cli(torch, rank, world, work, extra) -> dict:
    """(a) One process of the CLI on ``cfg`` with the seeded scorer, its
    kernel launches counted from 0 around ``main``."""
    from cyclediffusion_tpu_torch import main as cli
    from cyclediffusion_tpu_torch.ops import flash_attention as fa
    from cyclediffusion_tpu_torch.runtime import context
    from cyclediffusion_tpu_torch.text import CLIPBPETokenizer
    from cyclediffusion_tpu_torch.tools import sd_assets

    cfg, out = extra
    fa.load_kernels()
    context.set_directional_clip(sd_assets.seeded_scorer(
        1, CLIPBPETokenizer(os.environ["CYCLEDIFFUSION_CLIP_BPE"]), "cuda"))
    reset_launches()
    t0 = time.perf_counter()
    metrics = cli.main(["--cfg", cfg, "--output_dir", f"{out}{rank}", "--seed", "42",
                        "--do_eval", "--per_device_eval_batch_size", "1"], device="cuda:0")
    torch.cuda.synchronize()
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "launches": launched(), "seconds": time.perf_counter() - t0}


def child_nccl(torch, rank, world, work, extra) -> dict:
    """(b) A one-rank NCCL group: an all-gather, an all-reduce and one step
    of ``Driver.train`` (its gradient all-reduce counted)."""
    import torch.distributed as dist

    from cyclediffusion_tpu_torch.runtime.driver import Driver

    x = torch.arange(4.0, device="cuda") + 1
    parts = [torch.empty_like(x)]
    dist.all_gather(parts, x)
    y = x.clone()
    dist.all_reduce(y)
    calls = [0]
    all_reduce = dist.all_reduce

    def counted(*a, **k):
        calls[0] += 1
        return all_reduce(*a, **k)

    dist.all_reduce = counted
    items, _ = toy_items(8)
    model = ToyRegression(torch, "cuda")
    driver = Driver(toy_args(os.path.join(work, "nccl_train"), num_train_epochs=1,
                             gradient_accumulation_steps=1), model, train_dataset=items)
    metrics = driver.train()
    dist.all_reduce = all_reduce
    return {"backend": dist.get_backend(), "gathered": parts[0].tolist(), "reduced": y.tolist(),
            "x": x.tolist(), "driver_process": [driver.process_index, driver.process_count],
            "steps": driver.state.global_step, "train_all_reduces": calls[0],
            "w": model.trainable_params["w"].tolist(), "train_loss": metrics["train_loss"]}


def child_tp(torch, rank, world, work, extra) -> dict:
    """(c) SD v1's UNet (bf16, full width, seeded) called whole, then
    sharded at n_model 2 over the ranks and called again."""
    from cyclediffusion_tpu_torch.ops import flash_attention as fa
    from cyclediffusion_tpu_torch.parallel.tp import data_model_mesh, shard_params_tp
    from cyclediffusion_tpu_torch.pipelines.latent import LatentCoreSpec, LatentDiffusionCore

    fa.load_kernels()
    core = LatentDiffusionCore.random_init(LatentCoreSpec.sd_v1(), seed=0, device="cuda",
                                           dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((4, 64, 64, 4), generator=gen, device="cuda")
    t = torch.tensor([981, 981, 500, 500], device="cuda")
    ctx = torch.randn((4, 77, 768), generator=gen, device="cuda")
    call = functools.partial(core.apply_model, x, t, ctx)
    n_whole = sum(p.numel() for p in core.unet.parameters())
    with torch.no_grad():
        eps = call()
        ms_whole = cuda_time_ms(call, reps=5, warmup=1)
        n_sharded = shard_params_tp(data_model_mesh(1, 2, "cuda"), core.unet, TP_MIN_SIZE)
        reset_launches()
        eps_tp = call()
        torch.cuda.synchronize()
        launches = launched()
        ms_tp = cuda_time_ms(call, reps=5, warmup=1)
    return {"n_sharded": n_sharded, "params_whole": n_whole,
            "params_local": sum(p.numel() for p in core.unet.parameters()),
            "rel_err": float((eps_tp - eps).abs().max() / eps.abs().max()),
            "finite": bool(torch.isfinite(eps_tp).all()), "launches": launches,
            "ms_whole": ms_whole, "ms_tp": ms_tp,
            "eps_tp_sum": float(eps_tp.double().sum())}


CHILDREN = {"cli": child_cli, "nccl": child_nccl, "tp": child_tp}


def child_main(argv) -> None:
    """``chip_smoke.py --child <kind> <rank> <world> <init> <work> [...]``:
    one process of phase 14 on ``cuda:0``; joins the group (gloo for
    several ranks on the one card, NCCL for ``nccl``) and writes its report
    as ``<work>/<kind>_<world>_<rank>.json``."""
    kind, rank, world, init, work, extra = (argv[0], int(argv[1]), int(argv[2]), argv[3],
                                           argv[4], argv[5:])
    sys.path.insert(0, ROOT)
    import torch

    from cyclediffusion_tpu_torch.parallel import init_distributed

    if not torch.cuda.is_available():
        fail("the child needs the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    if world > 1 or kind == "nccl":
        init_distributed(init, rank=rank, world_size=world,
                         backend="nccl" if kind == "nccl" else "gloo", timeout_s=CHILD_TIMEOUT)
    report = CHILDREN[kind](torch, rank, world, work, extra)
    report["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    with open(os.path.join(work, f"{kind}_{world}_{rank}.json"), "w") as f:
        json.dump(report, f)
    import torch.distributed as dist

    if dist.is_initialized():
        dist.barrier()          # no rank leaves while another still talks to it
        dist.destroy_process_group()


def check_cli_processes(torch, root, work, card, cli_counts) -> dict:
    """(a) -> the K1/K2 launches of the two processes together."""
    import numpy as np

    from cyclediffusion_tpu_torch.data.png import read_png
    from cyclediffusion_tpu_torch.runtime.config import config_root

    with open(os.path.join(config_root(), CLI_CFG)) as f:
        cfg_text = cut_config(f.read(), PAR_CUTS)
    cfg = os.path.join(root, "parallel_cli.cfg")
    with open(cfg, "w") as f:
        f.write(cfg_text)
    # phase 7's checkpoint and the repository's text-editing images (phases
    # 10 and 11 pointed the data root at their synthetic images)
    os.environ["CYCLEDIFFUSION_CKPT_ROOT"] = root
    os.environ["CYCLEDIFFUSION_DATA_ROOT"] = ROOT
    say(f"parallel: (a) {CLI_CFG} cut to {PAR_CUTS}, {PAR_SAMPLES} images at batch 1, "
        f"one process, then two on cuda:0 over gloo ({card})")
    (one,) = run_children("cli", 1, work, [cfg, os.path.join(work, "one")])
    two = run_children("cli", 2, work, [cfg, os.path.join(work, "two")])
    per_sample = {k: cli_counts[k] // CLI_SAMPLES for k in ROUTE_KERNELS.values()}
    shard = math.ceil(PAR_SAMPLES / 2)
    for label, rep, n in [("one process", one, PAR_SAMPLES)] + [
            (f"rank {r} of 2", rep, shard) for r, rep in enumerate(two)]:
        want = {k: per_sample[k] * n for k in per_sample}
        got = {k: rep["launches"][k] for k in per_sample}
        say(f"parallel: (a) {label}: {n} samples, K1/K2 launches {got} (expected {want}), "
            f"eval_runtime {rep['metrics']['eval_runtime']} s, the whole CLI call "
            f"{rep['seconds']:.2f} s, peak device memory {rep['peak_gib']:.2f} GiB ({card})")
        if got != want:
            fail(f"parallel: (a) {label} launched {got}, expected {want}")
    drop = {"eval_runtime", "eval_samples_per_second", "eval_steps_per_second"}
    want, got = one["metrics"], two[0]["metrics"]
    keys = {k for k in want if k not in drop}
    if keys != {k for k in got if k not in drop}:
        fail(f"parallel: (a) rank 0's metric keys {sorted(got)} differ from {sorted(want)}")
    worst = max(abs(want[k] - got[k]) / (PAR_ABS + PAR_REL * abs(want[k])) for k in keys)
    shown = ", ".join(f"{k}: {got[k]:.6g}" for k in METRIC_KEYS)
    say(f"parallel: (a) rank 0's metrics {{{shown}}}; worst |two - one| / (1e-4 + 1e-3 "
        f"|one|) = {worst:.3g} (bound 1)")
    if not worst <= 1:
        fail(f"parallel: (a) rank 0's metrics {got} differ from one process's {want}")
    for i in range(PAR_SAMPLES):
        a = read_png(os.path.join(work, "one0", "temp_gen", f"{i}.png"))
        b = read_png(os.path.join(work, "two0", "temp_gen", f"{i}.png"))
        if not np.array_equal(a, b):
            fail(f"parallel: (a) gathered temp_gen/{i}.png differs from one process's by "
                 f"{int(np.abs(a.astype(int) - b).max())} levels")
    if os.path.exists(os.path.join(work, "two1", "eval_results.json")):
        fail("parallel: (a) rank 1 wrote eval_results.json")
    say(f"parallel: (a) the {PAR_SAMPLES} gathered temp_gen images equal one process's, bit "
        "for bit; rank 1 wrote no results")
    return {k: sum(rep["launches"][k] for rep in two) for k in ROUTE_KERNELS.values()}


def check_nccl(torch, work, card) -> None:
    """(b)"""
    (rep,) = run_children("nccl", 1, work)
    items, _ = toy_items(8)
    model = ToyRegression(torch, "cpu")
    from cyclediffusion_tpu_torch.runtime.driver import Driver

    Driver(toy_args(os.path.join(work, "nccl_cpu"), num_train_epochs=1,
                    gradient_accumulation_steps=1), model, train_dataset=items).train()
    err = max(abs(a - b) for a, b in zip(rep["w"], model.trainable_params["w"].tolist()))
    say(f"parallel: (b) one-rank {rep['backend']} group: all_gather {rep['gathered']}, "
        f"all_reduce {rep['reduced']} of {rep['x']}; Driver.train as process "
        f"{rep['driver_process']}: {rep['steps']} step, {rep['train_all_reduces']} gradient "
        f"all-reduce(s), w {rep['w']} vs the CPU's step {err:.3g} apart (bound "
        f"{NCCL_STEP_BOUND:.0e}) ({card})")
    if (rep["backend"] != "nccl" or rep["gathered"] != rep["x"] or rep["reduced"] != rep["x"]
            or rep["driver_process"] != [0, 1] or rep["steps"] != 1
            or rep["train_all_reduces"] < 1 or not err <= NCCL_STEP_BOUND):
        fail(f"parallel: (b) NCCL at one rank: {rep}")


def check_tensor_parallel(torch, work, card) -> None:
    """(c)"""
    reps = run_children("tp", 2, work)
    want = {"flash_attention_bhtd": 5, "flash_attention_packed": 5,
            "qout_self_attention_block": 0, "fused_self_attention_block": 0}
    for r, rep in enumerate(reps):
        say(f"parallel: (c) rank {r} of 2: {rep['n_sharded']} parameters sharded "
            f"(expected {TP_SHARDED}), {rep['params_local']:,} of {rep['params_whole']:,} "
            f"weights held; eps off the unsharded call by {rep['rel_err']:.3e} of max|eps| "
            f"(bound {UNET_REL_BOUND:.0e}); launches {rep['launches']}; batch-4 UNet call "
            f"{rep['ms_whole']:.2f} ms whole, {rep['ms_tp']:.2f} ms sharded with gloo "
            f"all-gathers through the host; peak {rep['peak_gib']:.2f} GiB ({card})")
        if (rep["n_sharded"] != TP_SHARDED or not rep["finite"]
                or not rep["rel_err"] <= UNET_REL_BOUND or rep["launches"] != want):
            fail(f"parallel: (c) rank {r}: {rep}")
    if reps[0]["eps_tp_sum"] != reps[1]["eps_tp_sum"]:
        fail("parallel: (c) the ranks' gathered eps differ")


def check_optimisers(torch, work, card) -> None:
    """(d)"""
    import numpy as np

    from cyclediffusion_tpu_torch.models.unet_gd import GDUNet, GDUNetConfig
    from cyclediffusion_tpu_torch.runtime import optim
    from cyclediffusion_tpu_torch.runtime.driver import Driver

    with torch.device("meta"):
        shapes = [tuple(p.shape) for p in GDUNet(GDUNetConfig.sd_v1()).parameters()]
    n = sum(math.prod(s) for s in shapes)
    if n != SD_UNET_PARAMS:
        fail(f"parallel: (d) SD v1's UNet has {n} parameters, expected {SD_UNET_PARAMS}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, moved in (("adamw", 7), ("adafactor", 3)):
        gc.collect()
        torch.cuda.empty_cache()
        reset_peak(torch)
        params = [0.02 * torch.randn(s, generator=gen, device="cuda") for s in shapes]
        for p in params:
            p.grad = torch.randn(p.shape, generator=gen, device="cuda")
        opt = optim.build_optimizer(params, name, optim.constant_schedule(1e-4), 0.01)

        def step():
            optim.clip_by_global_norm_([p.grad for p in params], 1.0)
            opt.step()

        ms = cuda_time_ms(step, reps=3, warmup=1)
        finite = all(bool(torch.isfinite(p).all()) for p in params)
        bound = 1e3 * moved * 4 * n / PEAK_BYTES
        say(f"parallel: (d) {name} + clip_by_global_norm over SD v1's UNet shapes "
            f"({len(shapes)} tensors, {n:,} fp32 parameters): {ms:.2f} ms per step (bound "
            f"{bound:.2f} ms: {moved} x 4 bytes per parameter at {PEAK_BYTES / 1e12} TB/s), "
            f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({card})")
        if not finite:
            fail(f"parallel: (d) {name} made non-finite parameters")
        del params, opt
    gc.collect()
    torch.cuda.empty_cache()

    items, w_true = toy_items()
    ws = {}
    for device in ("cuda", "cpu"):
        model = ToyRegression(torch, device)
        driver = Driver(toy_args(os.path.join(work, f"toy_{device}")), model,
                        train_dataset=items)
        t0 = time.perf_counter()
        m = driver.train()
        ws[device] = model.trainable_params["w"].cpu().numpy()
        say(f"parallel: (d) the toy regression through Driver.train on {device}: "
            f"{driver.state.global_step} steps in "
            f"{time.perf_counter() - t0:.2f} s, train_loss {m['train_loss']:.3g} (bound "
            f"{TOY_LOSS_BOUND}), w {ws[device].tolist()} ({card})")
        if (not m["train_loss"] < TOY_LOSS_BOUND
                or not np.abs(ws[device] - w_true).max() <= TOY_W_BOUND):
            fail(f"parallel: (d) the toy regression on {device} did not fit: {m}")
    err = float(np.abs(ws["cuda"] - ws["cpu"]).max())
    say(f"parallel: (d) toy w, card vs CPU: {err:.3g} (bound {TOY_CARD_CPU_BOUND:.0e})")
    if not err <= TOY_CARD_CPU_BOUND:
        fail(f"parallel: (d) the toy's w on the card is {err} off the CPU's")

    traj = np.load(os.path.join(ROOT, FLAX_FIXTURES, "optax_trajectories.npz"))
    names = sorted(k.split("/")[1] for k in traj.files if k.startswith("adamw/"))
    shapes = {k: traj[f"adamw/{k}"].shape for k in names}
    rng = np.random.default_rng(int(traj["seed"]))
    params0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (3 * rng.standard_normal(s)).astype(np.float32) for k, s in shapes.items()}
             for _ in range(int(traj["steps"]))]
    if not np.array_equal(grads[0]["vector"], traj["grad0_vector"]):
        fail("parallel: (d) numpy drew other gradients than the fixture's")
    lr, warmup, steps = float(traj["lr"]), int(traj["warmup"]), int(traj["steps"])
    for name in ("adamw", "adafactor"):
        params = {k: torch.tensor(v, device="cuda") for k, v in params0.items()}
        opt = optim.build_optimizer(list(params.values()), name,
                                    optim.build_schedule(lr, warmup, steps, "linear"),
                                    float(traj["weight_decay"]))
        for g in grads:
            for k, p in params.items():
                p.grad = torch.tensor(g[k], device="cuda")
            optim.clip_by_global_norm_([p.grad for p in params.values()], float(traj["clip"]))
            opt.step()
        err = max(float(np.abs(params[k].cpu().numpy() - traj[f"{name}/{k}"]).max())
                  for k in names)
        say(f"parallel: (d) {name} on the card, {steps} steps of optax's problem ({names}): "
            f"max |port - optax| {err:.3e} (bound {OPT_TRAJ_BOUND:.0e})")
        if not err <= OPT_TRAJ_BOUND:
            fail(f"parallel: (d) {name} left optax's trajectory by {err}")


def check_msgpack(card) -> None:
    """(e)"""
    import numpy as np
    import torch

    from cyclediffusion_tpu_torch.convert import flax_msgpack

    t0 = time.perf_counter()
    tree = flax_msgpack.read(os.path.join(ROOT, FLAX_FIXTURES, "tree.msgpack"))
    secs = time.perf_counter() - t0
    twin = np.load(os.path.join(ROOT, FLAX_FIXTURES, "tree.npz"))
    leaves = {}

    def walk(t, prefix=""):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                leaves[prefix + k] = v

    walk(tree)
    bad = []
    for key in twin.files:
        leaf = leaves.get(key.removesuffix(".bf16bits"))
        if key.endswith(".bf16bits"):
            leaf = leaf.view(torch.int16).numpy().view(np.uint16) \
                if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16 else None
        arr = np.asarray(leaf)
        if leaf is None or arr.dtype != twin[key].dtype or not np.array_equal(arr, twin[key]):
            bad.append(key)
    if bad or len(leaves) != len(twin.files):
        fail(f"parallel: (e) the Flax fixture differs from its npz twin at {bad} "
             f"({len(leaves)} leaves, {len(twin.files)} in the twin)")
    dtypes = sorted({str(v.dtype) if isinstance(v, torch.Tensor) else str(np.asarray(v).dtype)
                     for v in leaves.values()})
    say(f"parallel: (e) {FLAX_FIXTURES}/tree.msgpack read in {1e3 * secs:.1f} ms: "
        f"{len(leaves)} leaves ({dtypes}) equal to the npz twin bit for bit ({card})")


def phase_parallel(torch, root, card, cli_counts) -> dict:
    """Phase 14 -> the K1/K2 launches of (a)'s two processes."""
    work = os.path.join(root, "parallel")
    os.makedirs(work)
    gc.collect()
    torch.cuda.empty_cache()
    counts = check_cli_processes(torch, root, work, card, cli_counts)
    check_nccl(torch, work, card)
    check_tensor_parallel(torch, work, card)
    check_optimisers(torch, work, card)
    check_msgpack(card)
    return counts


# phase 15: every image file the JAX loader reads, and the JAX driver's
# msgpack checkpoint
IMAGE_DIR = os.path.join("tests", "data_torch", "images")
IMAGE_REPS = 5
# kind -> the 512 px fixture whose host decode is timed
IMAGE_TIMED = {"palette PNG": "p8_512.png", "Paeth RGB PNG": "paeth_rgb_512.png",
               "Adam7 PNG": "adam7_rgb_512.png", "GIF": "gif_512.gif",
               "progressive JPEG": "prog_512.jpg",
               "progressive JPEG cut before its last scan": "prog_512_cut9.jpg",
               "CMYK JPEG": "cmyk_512.jpg"}
# (b): one fixture of each new kind, in the order of the data file
INPUT_FILES = ("p4_trns.png", "rgb16.png", "adam7_rgb8.png", "interlaced.gif",
               "prog_420.jpg", "cmyk.jpg", "prog_512_cut9.jpg")
INPUT_CUTS = {**CLI_CUTS, ("raw_data", "range"): f"[0, {len(INPUT_FILES)}]"}
INPUT_RESOLUTION = 512


def check_image_fixtures(reps: int = IMAGE_REPS):
    """Every committed image fixture through ``load_image`` on the host ->
    ({file: values that differ from Pillow's stored decode, -1 for another
    shape}, {kind: ms of each 512 px decode}, the Pillow version of the
    stored decode)."""
    import numpy as np

    from cyclediffusion_tpu_torch.data.transforms import load_image

    d = os.path.join(ROOT, IMAGE_DIR)
    stored = np.load(os.path.join(d, "pillow_rgb.npz"))
    differ = {}
    for name in sorted(f for f in os.listdir(d) if not f.endswith(".npz")):
        img, want = load_image(os.path.join(d, name)), stored[name]
        differ[name] = int((img != want).sum()) if img.shape == want.shape else -1
    ms = {}
    for kind, name in IMAGE_TIMED.items():
        ms[kind] = []
        for _ in range(reps):
            t0 = time.perf_counter()
            load_image(os.path.join(d, name))
            ms[kind].append(1e3 * (time.perf_counter() - t0))
    return differ, ms, str(stored["pillow_version"])


def smoothing_share(name: str = IMAGE_TIMED["progressive JPEG cut before its last scan"],
                    reps: int = IMAGE_REPS):
    """The host decode of a progressive fixture that stops early, ``reps``
    times, with its block smoothing timed inside -> (ms of each decode, ms
    of the smoothing in each)."""
    from cyclediffusion_tpu_torch.data import jpeg

    smooth, inside = jpeg._smooth_blocks, []

    def timed(*a):
        t0 = time.perf_counter()
        smooth(*a)
        inside[-1] += 1e3 * (time.perf_counter() - t0)

    jpeg._smooth_blocks = timed
    try:
        ms = []
        for _ in range(reps):
            inside.append(0.0)
            t0 = time.perf_counter()
            jpeg.read_jpeg(os.path.join(ROOT, IMAGE_DIR, name))
            ms.append(1e3 * (time.perf_counter() - t0))
    finally:
        jpeg._smooth_blocks = smooth
    return ms, inside


def write_input_root(root: str) -> str:
    """A data root under ``root`` holding :data:`INPUT_FILES` and a
    ``data/translate-text.json`` that names them -> its path."""
    import shutil

    data_root = os.path.join(root, "inputs")
    os.makedirs(os.path.join(data_root, "data", "images"))
    rows = []
    for i, name in enumerate(INPUT_FILES):
        shutil.copy(os.path.join(ROOT, IMAGE_DIR, name),
                    os.path.join(data_root, "data", "images", name))
        rows.append({"encode_text": f"a photo of a cat {i}",
                     "decode_text": f"a watercolour painting of a cat {i}",
                     "img_path": f"./data/images/{name}"})
    with open(os.path.join(data_root, "data", "translate-text.json"), "w") as f:
        json.dump(rows, f, indent=4)
    return data_root


def expected_inputs() -> list:
    """The ``original_image`` of each of :data:`INPUT_FILES`: the SD task's
    preprocess (crop, 512 px bilinear, [0, 1]) of Pillow's stored decode."""
    import numpy as np

    from cyclediffusion_tpu_torch.data.transforms import center_crop_long_edge, resize, to_array

    stored = np.load(os.path.join(ROOT, IMAGE_DIR, "pillow_rgb.npz"))
    return [to_array(resize(center_crop_long_edge(stored[name]), INPUT_RESOLUTION))
            for name in INPUT_FILES]


def checkpoint_round_trip(torch, core, other, out_dir: str):
    """``core`` saved by ``Driver.save_model``, loaded by
    ``Driver.load_model`` into ``other`` -> (the file's bytes, write s,
    read s, the state-dict keys that differ)."""
    import types

    from cyclediffusion_tpu_torch.runtime.driver import Driver

    def driver(c):
        return Driver(types.SimpleNamespace(output_dir=out_dir),
                      types.SimpleNamespace(gan_wrapper=types.SimpleNamespace(core=c)))

    t0 = time.perf_counter()
    driver(core).save_model()
    write_s = time.perf_counter() - t0
    path = os.path.join(out_dir, "model_params.msgpack")
    t0 = time.perf_counter()
    driver(other).load_model(out_dir)
    if other.device.type == "cuda":
        torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    want, got = core.state_dict(), other.state_dict()
    differ = sorted(k for k in want if k not in got or got[k].dtype != want[k].dtype
                    or not torch.equal(got[k], want[k]))
    return os.path.getsize(path), write_s, read_s, differ


def phase_inputs(torch, fa, root, card, num_recovered_eps) -> dict:
    """Phase 15 -> the K1/K2 launches of (b)'s CLI run."""
    import numpy as np

    from cyclediffusion_tpu_torch import main as cli
    from cyclediffusion_tpu_torch.pipelines.latent import LatentCoreSpec, LatentDiffusionCore
    from cyclediffusion_tpu_torch.runtime import context
    from cyclediffusion_tpu_torch.runtime.config import config_root
    from cyclediffusion_tpu_torch.tasks.text_unsupervised_translation import (
        TextUnsupervisedTranslation,
    )
    from cyclediffusion_tpu_torch.text import CLIPBPETokenizer
    from cyclediffusion_tpu_torch.tools import sd_assets

    reset_peak(torch)
    say(f"inputs: {card}")
    # (a)
    differ, ms, pillow = check_image_fixtures()
    jpeg_differ, _, jpeg_pillow = check_jpeg_fixtures(reps=0)
    say(f"inputs: (a) {len(differ)} image fixtures decoded by load_image on the host against "
        f"Pillow {pillow}'s stored convert('RGB'): differing values {differ}; the "
        f"{len(jpeg_differ)} baseline JPEG fixtures against Pillow {jpeg_pillow}'s: "
        f"{jpeg_differ}")
    if any(differ.values()) or any(jpeg_differ.values()):
        fail(f"inputs: (a) a decode differs from Pillow's: {differ} {jpeg_differ}")
    for kind, times in ms.items():
        times.sort()
        say(f"inputs: (a) {kind} ({IMAGE_TIMED[kind]}, 512x512) host decode: median "
            f"{times[len(times) // 2]:.1f} ms over {len(times)} (min {times[0]:.1f}, max "
            f"{times[-1]:.1f}) ({card})")
    decode_ms, smooth_ms = smoothing_share()
    say(f"inputs: (a) the cut progressive file's block smoothing: {sorted(smooth_ms)} ms of "
        f"decodes taking {sorted(decode_ms)} ms (median share "
        f"{sorted(s / d for s, d in zip(smooth_ms, decode_ms))[len(decode_ms) // 2]:.3f}) "
        f"({card})")

    # (b)
    data_root = write_input_root(root)
    with open(os.path.join(config_root(), CLI_CFG)) as f:
        cfg_text = cut_config(f.read(), INPUT_CUTS)
    cfg = os.path.join(root, "inputs.cfg")
    with open(cfg, "w") as f:
        f.write(cfg_text)
    out_dir = os.path.join(root, "inputs_cli")
    os.environ["CYCLEDIFFUSION_CKPT_ROOT"] = root
    os.environ["CYCLEDIFFUSION_DATA_ROOT"] = data_root
    context.reset()
    context.set_directional_clip(sd_assets.seeded_scorer(
        1, CLIPBPETokenizer(os.environ["CYCLEDIFFUSION_CLIP_BPE"]), "cuda"))
    n = len(INPUT_FILES)
    say(f"inputs: (b) {CLI_CFG} cut to {INPUT_CUTS} on {n} images {list(INPUT_FILES)} at "
        "batch 2")
    seen = {"images": {}, "pipe": None}
    forward = TextUnsupervisedTranslation.forward

    def spy_forward(self, sample_id, original_image, encode_text, decode_text):
        for sid, im in zip(np.asarray(sample_id).reshape(-1), original_image):
            seen["images"][int(sid)] = np.array(im, np.float32)
        seen["pipe"] = self.gan_wrapper
        return forward(self, sample_id, original_image, encode_text, decode_text)

    TextUnsupervisedTranslation.forward = spy_forward
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    try:
        metrics = cli.main(["--cfg", cfg, "--output_dir", out_dir, "--seed", "42",
                            "--do_eval", "--per_device_eval_batch_size", "2"])
        torch.cuda.synchronize()
    finally:
        TextUnsupervisedTranslation.forward = forward
    secs = time.perf_counter() - t0
    counts = launched()
    context.reset()
    want_images = expected_inputs()
    if sorted(seen["images"]) != list(range(n)):
        fail(f"inputs: (b) the task model received samples {sorted(seen['images'])}")
    bad = [INPUT_FILES[i] for i in range(n)
           if seen["images"][i].shape != want_images[i].shape
           or not np.array_equal(seen["images"][i], want_images[i])]
    if bad:
        fail(f"inputs: (b) the original_image of {bad} is not the preprocess of Pillow's "
             "decode")
    say(f"inputs: (b) each original_image the task model received ({n}, "
        f"{want_images[0].shape}) equals to_array(resize(center_crop_long_edge(Pillow's "
        "stored decode), 512)) bit for bit")
    pipe = seen["pipe"]
    per_sample = {name: sum(calls * launches_per_call(
        pipe.core.spec, fa.attention_route, reuse=kind == "reuse")[name]
        for kind, calls in expected_calls_by_kind(pipe, num_recovered_eps).items())
        for name in ROUTE_KERNELS.values()}
    want = {k: v * n for k, v in per_sample.items()}
    got = {k: counts[k] for k in want}
    say(f"inputs: (b) K1/K2 launches {got} (expected {want}: {per_sample} per sample)")
    if got != want or counts["qout_self_attention_block"] or counts["fused_self_attention_block"]:
        fail(f"inputs: (b) the CLI launched {counts}, expected {want} and no K3/K4")
    files = sorted(os.path.relpath(os.path.join(d, f), out_dir)
                   for d, _, fs in os.walk(out_dir) for f in fs)
    missing = sorted(set(expected_cli_files(n)) - set(files))
    with open(os.path.join(out_dir, "eval_results.json")) as f:
        results = json.load(f)
    nonfinite = [k for k in METRIC_KEYS
                 if not isinstance(results.get(k), float) or not math.isfinite(results[k])]
    if missing or nonfinite or results.get("eval_samples") != n or \
            metrics.get("eval_samples") != n:
        fail(f"inputs: (b) missing files {missing}, non-finite metrics {nonfinite}: {results}")
    say(f"inputs: (b) the CLI wrote {len(files)} files ({len(expected_cli_files(n))} expected "
        f"present); metrics {{{', '.join(f'{k}: {results[k]:.6g}' for k in METRIC_KEYS)}}}")
    say(f"inputs: (b) eval_runtime {results['eval_runtime']} s, eval_samples_per_second "
        f"{results['eval_samples_per_second']}; the whole CLI call {secs:.2f} s ({card})")

    # (c)
    gc.collect()
    torch.cuda.empty_cache()
    spec = LatentCoreSpec.sd_v1()
    cores = [LatentDiffusionCore.random_init(spec, seed, "cuda", dtype=torch.bfloat16)
             for seed in (0, 1)]
    n_params = sum(v.numel() for v in cores[0].state_dict().values())
    n_unet = sum(p.numel() for p in cores[0].unet.parameters())
    nbytes, write_s, read_s, differ_keys = checkpoint_round_trip(
        torch, cores[0], cores[1], os.path.join(root, "inputs_ckpt"))
    if differ_keys:
        fail(f"inputs: (c) {len(differ_keys)} weights differ after the msgpack round trip: "
             f"{differ_keys[:4]}")
    if n_unet != SD_UNET_PARAMS:
        fail(f"inputs: (c) the SD v1 UNet has {n_unet:,} parameters")
    say(f"inputs: (c) SD v1's seeded bf16 core ({n_params:,} weights, the UNet's "
        f"{n_unet:,}) through Driver.save_model -> model_params.msgpack ({nbytes:,} bytes, "
        f"written in {write_s:.2f} s) -> Driver.load_model into another core ({read_s:.2f} s): "
        f"equal bit for bit ({card})")
    del cores
    gc.collect()
    torch.cuda.empty_cache()
    say_peak(torch, "inputs")
    return counts


def round_trip(torch, core, pipe, images, src) -> float:
    """Phase 5: encode, then replay under the same text and scale 1 with
    deterministic cuDNN -> max|replay - x0| on the latent."""
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    gen = torch.Generator(device="cuda").manual_seed(2)
    vae = torch.randn((images.shape[0], 64, 64, 4), generator=gen, device="cuda")
    x0 = core.encode_first_stage(images * 2.0 - 1.0, vae)
    z = pipe.encode(images, src, gen, vae_noise=vae)[0]
    xT, eps = pipe._unflatten(z, 0)
    c, uc = pipe.get_condition(src), pipe.uncond(images.shape[0])
    replay = pipe._decode_chains(xT[None], eps[None], c, uc, [1.0], None, 0)[0]
    return float((replay - x0).abs().max())


def main() -> None:
    if sys.argv[1:2] == ["--child"]:
        child_main(sys.argv[2:])
        return
    if not os.path.isdir(os.path.join(ROOT, "cyclediffusion_tpu_torch")):
        fail("run from a checkout of the repository: cyclediffusion_tpu_torch/ not found")
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs an NVIDIA GPU")
    card = card_name()
    say(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    say(f"nvidia-smi: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from cyclediffusion_tpu_torch.ops import flash_attention as fa
    from cyclediffusion_tpu_torch.pipelines.latent import (
        LatentCoreSpec,
        LatentDiffusionCore,
    )
    from cyclediffusion_tpu_torch.pipelines.latent_text import StochasticTextPipeline
    from cyclediffusion_tpu_torch.runtime.config import Args
    from cyclediffusion_tpu_torch.samplers import num_recovered_eps
    from cyclediffusion_tpu_torch.tasks.text_unsupervised_translation import (
        TextUnsupervisedTranslation,
    )
    from cyclediffusion_tpu_torch.text import HashTokenizer
    from cyclediffusion_tpu_torch.tools.step_probe import attention

    t0 = time.perf_counter()
    infos = fa.load_kernels()
    for info in infos:
        say(f"build: {info.path.name} {'built' if info.built else 'found'} in "
            f"{info.seconds:.2f} s")
    say(f"build: both libraries loaded in {time.perf_counter() - t0:.2f} s")
    build_report(infos)

    record = phase_kernels(torch, fa)
    gn_record = phase_group_norm(torch)
    slice_counts, k4_counts, gn_launches = phase_slice(torch, fa, attention, HashTokenizer,
                                                       LatentCoreSpec, LatentDiffusionCore,
                                                       StochasticTextPipeline)
    for rec in gn_record:       # the GroupNorm launches of the translate slice
        rec["launches"] = gn_launches
    with tempfile.TemporaryDirectory(prefix="cd_smoke_") as root:
        ref_core = write_assets(torch, root)
        ens_counts = phase_ensemble(torch, fa, Args, TextUnsupervisedTranslation,
                                    num_recovered_eps)
        torch.cuda.empty_cache()
        cli_counts, _ = phase_cli(torch, fa, ref_core, root, num_recovered_eps, CLI_CFG, (80,),
                                  "cli")
        phase_fast(torch, fa, ref_core, StochasticTextPipeline, HashTokenizer,
                   num_recovered_eps)
        phase_cli(torch, fa, ref_core, root, num_recovered_eps, FAST_CLI_CFG, (80,),
                  "fast_cli")
        del ref_core            # the SD cores of phases 4-8 are all freed here
        gc.collect()
        torch.cuda.empty_cache()
        ldm_counts = phase_ldm(torch, fa, root, num_recovered_eps)
        gc.collect()
        torch.cuda.empty_cache()
        unpaired_counts = phase_unpaired(torch, fa, root, num_recovered_eps)
        gc.collect()
        torch.cuda.empty_cache()
        phase_afhq(torch, fa, root)
        gc.collect()
        torch.cuda.empty_cache()
        guided_counts = phase_guided(torch, fa, attention)
        phase_data(torch, card)
        parallel_counts = phase_parallel(torch, root, card, cli_counts)
        input_counts = phase_inputs(torch, fa, root, card, num_recovered_eps)

    # launches on the path that runs each kernel: the translate slice (K1,
    # K2), LDM text2img-large's and FFHQ -> CelebA-HQ's CLI runs (K1), the
    # guided chain (K1, K2) and the FFHQ plain pipeline (K1), the SD CLI in
    # two processes (K1, K2), the SD CLI on the new input kinds (K1, K2),
    # the ensemble (K3), the UNet call in folded mode "1" (K4)
    launches = {"flash_attention_bhtd": slice_counts["flash_attention_bhtd"]
                + ldm_counts["flash_attention_bhtd"]
                + unpaired_counts["flash_attention_bhtd"]
                + guided_counts["flash_attention_bhtd"]
                + parallel_counts["flash_attention_bhtd"]
                + input_counts["flash_attention_bhtd"],
                "flash_attention_packed": slice_counts["flash_attention_packed"]
                + guided_counts["flash_attention_packed"]
                + parallel_counts["flash_attention_packed"]
                + input_counts["flash_attention_packed"],
                "qout_self_attention_block": ens_counts["qout_self_attention_block"],
                "fused_self_attention_block": k4_counts["fused_self_attention_block"]}
    kernels = [{"name": name, "route": "cuda", "source": KERNELS[name][1],
                "replaces": KERNELS[name][2], "launches": launches[name], **record[name]}
               for name in KERNELS]
    print(card)
    print(json.dumps({"kernels": kernels, "group_norm": gn_record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
