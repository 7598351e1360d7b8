"""The edit mix: each request is a batch of (image, source prompt, target
prompt) triplets through ``StochasticTextPipeline.encode`` (the
DPM-Encoder under the source prompt) and ``.generate`` (the replay under
the target prompt), one candidate per image.

Parameters (the mix's file): ``images_per_request``, ``steps``,
``white_box_steps``, ``eta``, ``skip``, ``encoder_scale``,
``decoder_scale``, ``candidate_chunk``.  Every request has the same sizes;
its images, prompts and noises come from ``--seed`` and its index.
"""

from __future__ import annotations

import functools
import math
import random

import torch
import torch.nn.functional as F

from cdbench import compare, counts
from cdbench.reference import sampling
from cdbench.registry import family
from cdbench.weights import derive_seed

STYLES = ("a photo of a", "a painting of a", "a sketch of a", "an oil painting of a",
          "a watercolor of a", "a close-up photo of a")
ADJECTIVES = ("red", "small", "old", "bright", "wooden", "golden", "snowy", "quiet")
SUBJECTS = ("cat", "dog", "horse", "car", "house", "tree", "bird", "boat", "mountain",
            "flower", "chair", "lamp")


def images_per_request(mix: dict) -> int:
    return mix["images_per_request"]


def refine_steps(mix: dict) -> int:
    return mix["steps"] - mix["skip"]


def work_per_request(cfg: dict, mix: dict) -> dict:
    """The units of model work one request needs: UNet rows (the CFG pair
    of each image at each step of both chains), first-stage encodes and
    decodes, text-encoder prompts."""
    b = mix["images_per_request"]
    return {"unet_row": 2 * b * 2 * refine_steps(mix), "encode_image": b,
            "decode_image": b, "prompt": 4 * b}


def make_request(cfg: dict, mix: dict, seed: int, index: int, device) -> dict:
    """Request ``index`` of a run with ``seed`` (index -1: the warm-up)."""
    b, res = mix["images_per_request"], cfg["resolution"]
    lat = counts.latent_size(cfg)
    zc = cfg["arch"]["first_stage"]["embed_dim"]
    rng = random.Random(derive_seed(seed, "prompts", index))
    src, dst = [], []
    for _ in range(b):
        style, adj = rng.choice(STYLES), rng.choice(ADJECTIVES)
        a, c = rng.sample(SUBJECTS, 2)
        src.append(f"{style} {adj} {a}")
        dst.append(f"{style} {adj} {c}")
    gen = torch.Generator(device=device).manual_seed(derive_seed(seed, "request", index))
    low = torch.rand((b, 3, 8, 8), generator=gen, device=device)
    img = F.interpolate(low, size=(res, res), mode="bilinear", align_corners=False)
    img = img + 0.05 * torch.randn((b, 3, res, res), generator=gen, device=device)
    shape = (b, lat, lat, zc)
    return {
        "images": img.clamp(0.0, 1.0).permute(0, 2, 3, 1).contiguous(),
        "source": src, "target": dst,
        "vae_noise": torch.randn(shape, generator=gen, device=device),
        "xT_noise": torch.randn(shape, generator=gen, device=device),
        "posterior_noises": torch.randn((refine_steps(mix),) + shape, generator=gen,
                                        device=device),
    }


class Program:
    """The port's pipeline for the mix, its core's entry points wrapped by
    ``recorder``."""

    def __init__(self, cfg: dict, mix: dict, seed: int, state_dict: dict, device, dtype,
                 recorder):
        from cdbench import program
        from cyclediffusion_tpu_torch.pipelines.latent_text import StochasticTextPipeline

        self.core = program.load_core(cfg, state_dict, device, dtype)
        for attr, layer in (("apply_model", "unet"), ("get_learned_conditioning", "text"),
                            ("encode_first_stage", "first_stage.encode"),
                            ("decode_first_stage", "first_stage.decode")):
            recorder.wrap(self.core, attr, layer)
        self.pipe = StochasticTextPipeline(
            self.core, program.tokenizer(cfg), None, custom_steps=mix["steps"],
            eta=mix["eta"], white_box_steps=mix["white_box_steps"], skip_steps=[mix["skip"]],
            encoder_unconditional_guidance_scales=[mix["encoder_scale"]],
            decoder_unconditional_guidance_scales=[mix["decoder_scale"]], n_trials=1,
            candidate_chunk=mix["candidate_chunk"])

    def run(self, req: dict) -> dict:
        z = self.pipe.encode(req["images"], req["source"], vae_noise=req["vae_noise"],
                             xT_noises=[req["xT_noise"]],
                             posterior_noises=[req["posterior_noises"]])
        images = self.pipe.generate(z, req["target"])
        return {"z": z[0], "images": images[0]}

    def close(self) -> None:
        del self.pipe, self.core


def program_outputs(out: dict, kept: list, mix: dict) -> dict:
    """The compared outputs and states of one request: its result and what
    the wrapped entry points took and returned while it ran (one candidate,
    so one chain of UNet calls per phase, the image rows first in each
    call's [uncond; cond] batch)."""
    b, n = out["images"].shape[0], refine_steps(mix)
    ctx = [o for layer, _, o in kept if layer == "text"]
    unet_in = [a[0][:b] for layer, a, _ in kept if layer == "unet"]
    return {"contexts": dict(zip(("source", "empty_enc", "target", "empty_dec"), ctx)),
            "x0": next(o for layer, _, o in kept if layer == "first_stage.encode"),
            "z": out["z"], "states": torch.stack(unet_in[-n:]),
            "final": next(a[0] for layer, a, _ in kept if layer == "first_stage.decode"),
            "images": out["images"]}


def eps_model(cfg: dict, parts: dict):
    """The configuration's reference eps model over ``parts``:
    ``eps(x, t, cond)`` (its family's ``eps``)."""
    return functools.partial(family(cfg, "reference").eps, cfg, parts)


def _contexts(cfg: dict, parts: dict, req: dict) -> dict:
    """The request's conditionings through its family's ``condition``."""
    ref = family(cfg, "reference")
    dev = req["images"].device
    b = req["images"].shape[0]
    ctx = {"source": ref.condition(cfg, parts, req["source"], dev),
           "empty_enc": ref.condition(cfg, parts, [""] * b, dev),
           "target": ref.condition(cfg, parts, req["target"], dev)}
    ctx["empty_dec"] = ctx["empty_enc"]
    return ctx


def reference_encode(cfg: dict, mix: dict, parts: dict, req: dict):
    """(schedule, contexts, x0, z) of a request through ``parts``."""
    arch = cfg["arch"]
    fs = parts["first_stage"][1]
    ctx = _contexts(cfg, parts, req)
    s = sampling.Schedule(arch["linear_start"], arch["linear_end"], arch["timesteps"],
                          mix["steps"], mix["eta"])
    x0 = fs.encode(req["images"] * 2.0 - 1.0, req["vae_noise"]) * arch["scale_factor"]
    x_T, eps = sampling.dpm_encode(s, eps_model(cfg, parts), x0, ctx["empty_enc"],
                                   ctx["source"], mix["encoder_scale"], mix["skip"],
                                   req["xT_noise"], req["posterior_noises"])
    b = x0.shape[0]
    return s, ctx, x0, torch.cat([x_T[None], eps]).transpose(0, 1).reshape(b, -1)


def split_code(z: torch.Tensor, steps: int):
    """A flat code (B, (n+1)*h*w*c) -> (x_T, eps (n, B, h, w, c))."""
    z = z.reshape(z.shape[0], steps + 1, -1)
    return z[:, 0], z[:, 1:].transpose(0, 1)


@torch.no_grad()
def reference_outputs(cfg: dict, mix: dict, parts: dict, req: dict) -> dict:
    """The request through ``parts`` alone (the control in the program's
    place), in :func:`program_outputs`' form."""
    arch = cfg["arch"]
    model, fs = eps_model(cfg, parts), parts["first_stage"][1]
    s, ctx, x0, z = reference_encode(cfg, mix, parts, req)
    x_T, eps = split_code(z, refine_steps(mix))
    x_T, eps = x_T.reshape(x0.shape), eps.reshape((-1,) + tuple(x0.shape))
    x, states = x_T, []
    for i in range(refine_steps(mix)):
        index = refine_steps(mix) - 1 - i
        states.append(x)
        e = sampling.guided_eps(model, x, int(s.t[index]), ctx["empty_dec"], ctx["target"],
                                mix["decoder_scale"])
        x = sampling.replay_step(s, index, x, e, eps[i])
    images = (fs.decode(x / arch["scale_factor"]) + 1.0) / 2.0
    return {"contexts": ctx, "x0": x0, "z": z, "states": torch.stack(states), "final": x,
            "images": images}


# the numbers compared, each against a limit of its cell
NUMBERS = ("ctx", "x0", "code", "replay", "pixels")


@torch.no_grad()
def readings(cfg: dict, mix: dict, parts: dict, req: dict, outs: dict) -> dict:
    """The float32 reference (``parts``) against ``outs``, each the worst
    relative RMS gap per image (per prompt, and over the conditioning's
    tensors, for the contexts):

    * ``ctx``, ``x0``, ``code``: the text conditionings, the first stage's
      posterior sample and the DPM-Encoder's code (x_T, eps), each the
      reference's own from the request's inputs;
    * ``replay``: every step of the decode chain from ``outs``' own state
      x_t and stored eps: the next state against the reference's step (its
      UNet, the guidance combine and the DDIM replay);
    * ``pixels``: the images against the reference's first-stage decode of
      ``outs``' final latent.
    """
    arch = cfg["arch"]
    model, fs = eps_model(cfg, parts), parts["first_stage"][1]
    s, ctx, x0, z = reference_encode(cfg, mix, parts, req)
    n = refine_steps(mix)
    _, eps = split_code(outs["z"], n)
    eps = eps.reshape((n,) + tuple(x0.shape))
    replay = 0.0 if tuple(outs["states"].shape[:2]) == (n, x0.shape[0]) else math.inf
    for i in range(n if math.isfinite(replay) else 0):
        index = n - 1 - i
        x = outs["states"][i]
        e = sampling.guided_eps(model, x, int(s.t[index]), ctx["empty_dec"], ctx["target"],
                                mix["decoder_scale"])
        nxt = outs["states"][i + 1] if i + 1 < n else outs["final"]
        replay = max(replay, compare.rel_rms(nxt, sampling.replay_step(s, index, x, e, eps[i])))
    images = (fs.decode(outs["final"] / arch["scale_factor"]) + 1.0) / 2.0
    return {
        "ctx": max(compare.worst_rel_rms(outs["contexts"][k], ctx[k]) for k in ctx),
        "x0": compare.rel_rms(outs["x0"], x0),
        "code": compare.rel_rms(outs["z"], z),
        "replay": replay,
        "pixels": compare.rel_rms(outs["images"], images),
    }
