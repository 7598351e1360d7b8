"""The guided mix: each request generates images by
``samplers.guided.energy_guided_decode`` (the CFG eps model against the
empty prompt, each step shifted by the CLIP energy's gradient through the
first stage's decoder and CLIP's image tower) and ``decode_first_stage``.

Parameters (the mix's file): ``images_per_request``, ``steps``, ``eta``,
``cfg_scale``, ``weight``.  The run's prompt comes from ``--seed`` (one
energy, and so one captured gradient, per run); each request's x_T and
eps come from ``--seed`` and its index.
"""

from __future__ import annotations

import random

import torch

from cdbench import compare, counts
from cdbench.drivers.edit import ADJECTIVES, STYLES, SUBJECTS, eps_model
from cdbench.reference import guided as ref_guided
from cdbench.reference import sampling
from cdbench.registry import family
from cdbench.weights import derive_seed

# the parts drawn besides the model family's
EXTRA_PARTS = ("scorer",)


def images_per_request(mix: dict) -> int:
    return mix["images_per_request"]


def work_per_request(cfg: dict, mix: dict) -> dict:
    b, n = mix["images_per_request"], mix["steps"]
    return {"unet_row": 2 * b * n, "energy_grad": b * n, "decode_image": b, "prompt": 2 * b}


def run_prompt(seed: int) -> str:
    rng = random.Random(derive_seed(seed, "prompt"))
    return f"{rng.choice(STYLES)} {rng.choice(ADJECTIVES)} {rng.choice(SUBJECTS)}"


def make_request(cfg: dict, mix: dict, seed: int, index: int, device) -> dict:
    b, n = mix["images_per_request"], counts.latent_size(cfg)
    shape = (b, n, n, cfg["arch"]["first_stage"]["embed_dim"])
    gen = torch.Generator(device=device).manual_seed(derive_seed(seed, "request", index))
    return {"prompts": [run_prompt(seed)] * b,
            "x_T": torch.randn(shape, generator=gen, device=device),
            "eps": torch.randn((mix["steps"],) + shape, generator=gen, device=device)}


def scorer_config(cfg: dict):
    from cyclediffusion_tpu_torch.models.clip import CLIPConfig

    return CLIPConfig(**cfg["arch"]["scorer"])


def scorer_tokenizer(cfg: dict):
    """The port's tokenizer of the scorer's prompts, as the reference's
    ``sampling.hash_tokens`` over the scorer's vocabulary."""
    from cyclediffusion_tpu_torch.text import HashTokenizer

    sc = cfg["arch"]["scorer"]
    return HashTokenizer(sc["vocab_size"], sc["context_length"])


class Program:
    def __init__(self, cfg: dict, mix: dict, seed: int, state_dict: dict, device, dtype,
                 recorder):
        from cdbench import program
        from cyclediffusion_tpu_torch.energy.clean_clip import CLIPScorer
        from cyclediffusion_tpu_torch.energy.clip_energy import clip_energy_fn

        self.mix = mix
        self.core = program.load_core(cfg, state_dict, device, dtype)
        # the port's OpenAI loader reads host arrays
        self.scorer = CLIPScorer.from_openai_state_dict(
            {k[len("scorer."):]: v.float().cpu() for k, v in state_dict.items()
             if k.startswith("scorer.")}, scorer_config(cfg), device, dtype)
        self.tok = program.tokenizer(cfg)
        text = self.scorer.embed_text(scorer_tokenizer(cfg)([run_prompt(seed)]))
        self.energy = clip_energy_fn(self.core, self.scorer, text)
        self.sched = self.core.make_ddim_schedule(mix["steps"], mix["eta"])
        for owner, attr, layer in ((self.core, "apply_model", "unet"),
                                   (self.core, "get_learned_conditioning", "text"),
                                   (self.core, "decode_first_stage", "first_stage.decode"),
                                   (self.energy, "grad", "energy")):
            recorder.wrap(owner, attr, layer)

    def run(self, req: dict) -> dict:
        from cyclediffusion_tpu_torch.ops.cfg import cfg_model_fn
        from cyclediffusion_tpu_torch.samplers import energy_guided_decode

        b = len(req["prompts"])
        cond = self.core.get_learned_conditioning(self.tok(req["prompts"]))
        uncond = self.core.get_learned_conditioning(self.tok([""] * b))
        model_fn = cfg_model_fn(self.core.apply_model, uncond, cond, self.mix["cfg_scale"])
        x = energy_guided_decode(model_fn, self.sched, req["x_T"], req["eps"], None,
                                 self.energy, self.mix["weight"])
        return {"latent": x, "images": (self.core.decode_first_stage(x) + 1.0) / 2.0}

    def close(self) -> None:
        del self.energy, self.scorer, self.core


def program_outputs(out: dict, kept: list, mix: dict) -> dict:
    """The compared outputs and states of one request: the contexts, each
    step's state x_t (the image rows of the UNet's [uncond; cond] batch),
    pred_x0 and energy gradient, the final latent and the images."""
    b = out["images"].shape[0]
    ctx = [o for layer, _, o in kept if layer == "text"]
    energy = [(a, o) for layer, a, o in kept if layer == "energy"]
    return {"contexts": dict(zip(("prompt", "empty"), ctx)),
            "states": torch.stack([a[0][:b] for layer, a, _ in kept if layer == "unet"]),
            "pred_x0": torch.stack([a[1] for a, _ in energy]),
            "grads": torch.stack([o for _, o in energy]),
            "final": out["latent"], "images": out["images"]}


def _setup(cfg: dict, mix: dict, parts: dict, req: dict):
    """(schedule, conditionings, the prompt's CLIP text feature) through
    ``parts``."""
    arch = cfg["arch"]
    ref, scorer = family(cfg, "reference"), parts["scorer"][1]
    dev = req["x_T"].device
    b = len(req["prompts"])
    ctx = {"prompt": ref.condition(cfg, parts, req["prompts"], dev),
           "empty": ref.condition(cfg, parts, [""] * b, dev)}
    sc = arch["scorer"]
    ids = sampling.hash_tokens(req["prompts"][:1], sc["vocab_size"], sc["context_length"])
    text = scorer.embed_text(torch.as_tensor(ids, device=dev))
    s = sampling.Schedule(arch["linear_start"], arch["linear_end"], arch["timesteps"],
                          mix["steps"], mix["eta"])
    return s, ctx, text


def _step(cfg, mix, parts, s, ctx, text, i, x, noise):
    """One guided step from x -> (pred_x0, energy gradient, next state)."""
    fs, scorer = parts["first_stage"][1], parts["scorer"][1]
    index = s.steps - 1 - i
    a = s.a[index]
    e = sampling.guided_eps(eps_model(cfg, parts), x, int(s.t[index]), ctx["empty"],
                            ctx["prompt"], mix["cfg_scale"])
    pred_x0 = (x - torch.sqrt(1.0 - a) * e) / torch.sqrt(a)
    g = ref_guided.clip_energy_grad(fs, scorer, pred_x0, text, cfg["arch"]["scale_factor"])
    e = e + mix["weight"] * (torch.sqrt(a) / torch.sqrt(1.0 - a)) * g
    return pred_x0, g, sampling.replay_step(s, index, x, e, noise)


@torch.no_grad()
def reference_outputs(cfg: dict, mix: dict, parts: dict, req: dict) -> dict:
    """The request through ``parts`` alone, in :func:`program_outputs`' form."""
    fs = parts["first_stage"][1]
    s, ctx, text = _setup(cfg, mix, parts, req)
    x, rows = req["x_T"], []
    for i in range(mix["steps"]):
        pred_x0, g, nxt = _step(cfg, mix, parts, s, ctx, text, i, x, req["eps"][i])
        rows.append((x, pred_x0, g))
        x = nxt
    images = (fs.decode(x / cfg["arch"]["scale_factor"]) + 1.0) / 2.0
    states, preds, grads = (torch.stack(r) for r in zip(*rows))
    return {"contexts": ctx, "states": states, "pred_x0": preds, "grads": grads, "final": x,
            "images": images}


# the numbers compared, each against a limit of its cell
NUMBERS = ("ctx", "grad", "replay", "pixels")


@torch.no_grad()
def readings(cfg: dict, mix: dict, parts: dict, req: dict, outs: dict) -> dict:
    """The float32 reference against ``outs``, each the worst relative RMS
    gap per image: ``ctx`` the text conditionings (over their tensors);
    ``grad`` each step's energy gradient against the reference's at
    ``outs``' own pred_x0; ``replay`` each step from ``outs``' own state
    x_t against the reference's whole step (UNet, guidance, energy
    gradient, DDIM replay with the request's eps); ``pixels`` the images
    against the reference's decode of ``outs``' final latent."""
    fs, scorer = parts["first_stage"][1], parts["scorer"][1]
    sf = cfg["arch"]["scale_factor"]
    s, ctx, text = _setup(cfg, mix, parts, req)
    grad = replay = 0.0
    n = mix["steps"]
    for i in range(n):
        g = ref_guided.clip_energy_grad(fs, scorer, outs["pred_x0"][i], text, sf)
        grad = max(grad, compare.rel_rms(outs["grads"][i], g))
        _, _, nxt = _step(cfg, mix, parts, s, ctx, text, i, outs["states"][i], req["eps"][i])
        got = outs["states"][i + 1] if i + 1 < n else outs["final"]
        replay = max(replay, compare.rel_rms(got, nxt))
    images = (fs.decode(outs["final"] / sf) + 1.0) / 2.0
    return {
        "ctx": max(compare.worst_rel_rms(outs["contexts"][k], ctx[k]) for k in ctx),
        "grad": grad, "replay": replay,
        "pixels": compare.rel_rms(outs["images"], images),
    }
