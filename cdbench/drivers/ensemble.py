"""The ensemble mix: each request is one image's published candidate
ensemble at one skip, ``StochasticTextPipeline.encode`` then ``.forward``:
one DPM-Encoder chain (``n_trials`` 1, one encoder scale), every decoder
scale replayed in chunks of ``candidate_chunk`` candidates (a short last
chunk padded to the chunk's size with copies of its last candidate), each
candidate decoded to pixels and ranked by DirectionalCLIP.

Parameters (the mix's file): ``steps``, ``white_box_steps``, ``eta``,
``skip``, ``encoder_scale``, ``decoder_scales``, ``candidate_chunk``.  One
image a request; ``images_per_min`` counts candidates, each decoded and
scored.  The image, prompts and noises come from ``--seed`` and the
request's index.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from cdbench import compare
from cdbench.drivers import edit
from cdbench.reference import sampling

PARTS = ("unet", "first_stage", "cond", "scorer")


def n_candidates(mix: dict) -> int:
    return len(mix["decoder_scales"])


def images_per_request(mix: dict) -> int:
    return n_candidates(mix)


def work_per_request(cfg: dict, mix: dict) -> dict:
    """Useful work only: padded rows are launched but not counted."""
    n, k = edit.refine_steps(mix), n_candidates(mix)
    return {"unet_row": 2 * n * (1 + k), "encode_image": 1, "decode_image": k,
            "prompt": 4, "clip_image": k + 1, "clip_text": 2}


def real_unet_rows(mix: dict) -> int:
    return work_per_request({}, mix)["unet_row"]


def make_request(cfg: dict, mix: dict, seed: int, index: int, device) -> dict:
    return edit.make_request(cfg, dict(mix, images_per_request=1), seed, index, device)


class Program:
    def __init__(self, cfg: dict, mix: dict, seed: int, state_dict: dict, device, dtype,
                 recorder):
        from cdbench import program
        from cdbench.drivers.guided import scorer_config
        from cyclediffusion_tpu_torch.energy.clean_clip import CLIPScorer, DirectionalCLIP
        from cyclediffusion_tpu_torch.pipelines.latent_text import StochasticTextPipeline

        self.core = program.load_core(cfg, state_dict, device, dtype)
        scorer = CLIPScorer.from_openai_state_dict(
            {k[len("scorer."):]: v.float().cpu() for k, v in state_dict.items()
             if k.startswith("scorer.")}, scorer_config(cfg), device, dtype)
        tok = program.tokenizer(cfg)
        recorder.wrap(scorer, "embed_image", "clip_image")
        recorder.wrap(scorer, "embed_text", "clip_text")
        self.pipe = StochasticTextPipeline(
            self.core, tok, DirectionalCLIP(scorer, tok), custom_steps=mix["steps"],
            eta=mix["eta"], white_box_steps=mix["white_box_steps"], skip_steps=[mix["skip"]],
            encoder_unconditional_guidance_scales=[mix["encoder_scale"]],
            decoder_unconditional_guidance_scales=list(mix["decoder_scales"]), n_trials=1,
            candidate_chunk=mix["candidate_chunk"])
        for owner, attr, layer in ((self.core, "apply_model", "unet"),
                                   (self.core, "get_learned_conditioning", "text"),
                                   (self.core, "encode_first_stage", "first_stage.encode"),
                                   (self.core, "decode_first_stage", "first_stage.decode"),
                                   (self.pipe, "rank", "rank")):
            recorder.wrap(owner, attr, layer,
                          (lambda args, out: len(args[0])) if layer == "rank" else None)

    def run(self, req: dict) -> dict:
        z = self.pipe.encode(req["images"], req["source"], vae_noise=req["vae_noise"],
                             xT_noises=[req["xT_noise"]],
                             posterior_noises=[req["posterior_noises"]])
        best, _ = self.pipe.forward(z, req["images"], req["source"], req["target"])
        return {"z": z[0], "images": best}

    def close(self) -> None:
        del self.pipe, self.core


def program_outputs(out: dict, kept: list, mix: dict) -> dict:
    """The compared outputs and states of one request: the contexts, x0,
    the code, each candidate's decode states (the real rows of each
    launch), final latents and images, the ranking's CLIP embeddings
    (candidates, the original, the source and target prompts), its scores
    and choice, and the image the pipeline returned."""
    n, k = edit.refine_steps(mix), n_candidates(mix)
    ctx = [o for layer, _, o in kept if layer == "text"]
    unet = [a[0] for layer, a, _ in kept if layer == "unet"][n:]
    launches = [unet[i * n:(i + 1) * n] for i in range(len(unet) // n)]
    states = torch.cat([torch.stack([x[:x.shape[0] // 2] for x in launch])
                        for launch in launches], dim=1)[:, :k]
    finals = torch.cat([a[0] for layer, a, _ in kept if layer == "first_stage.decode"])[:k]
    rank_args, (scores, best) = next((a, o) for layer, a, o in kept if layer == "rank")
    # the ranking embeds the source prompt, the target prompt, the
    # original image, then the candidates
    emb = [o for layer, _, o in kept if layer == "clip_image"]
    text = [o for layer, _, o in kept if layer == "clip_text"]
    return {"contexts": dict(zip(("source", "empty_enc", "target", "empty_dec"), ctx)),
            "x0": next(o for layer, _, o in kept if layer == "first_stage.encode"),
            "z": out["z"], "states": states, "final": finals,
            "images": torch.cat(list(rank_args[0])),
            "embeddings": torch.cat([emb[-1], emb[0]] + text[-2:]),
            "scores": scores[0], "best": best[0], "chosen": out["images"][0]}


def _embeddings(cfg: dict, scorer, req: dict, images: torch.Tensor) -> torch.Tensor:
    """CLIP embeddings of the candidates (K, H, W, 3), of the original
    image, of the source and of the target prompt: what DirectionalCLIP's
    scores are made of."""
    block = cfg["arch"]["scorer"]
    ids = torch.as_tensor(sampling.hash_tokens([req["source"][0], req["target"][0]],
                                               block["vocab_size"], block["context_length"]),
                          device=images.device)
    return torch.cat([scorer.embed_image(images), scorer.embed_image(req["images"]),
                      scorer.embed_text(ids)])


def dclip_scores(emb: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """DirectionalCLIP's score of each candidate from :func:`_embeddings`'
    rows, computed in ``dtype``: the cosine between the candidate's
    direction from the original and the target prompt's from the source."""
    emb = emb.to(dtype)
    k = emb.shape[0] - 3
    img = F.normalize(emb[:k] - emb[k:k + 1], dim=-1)
    text = F.normalize(emb[k + 2:] - emb[k + 1:k + 2], dim=-1)
    return (img @ text[0]).float()


def _chains(mix: dict, parts: dict, s, ctx, states_or_x_T, eps, free: bool):
    """Each candidate's decode chain, candidates folded into the batch:
    free-running from x_T (-> states, final) or, given the program's
    states, each step's reference next state (-> list per step)."""
    unet = parts["unet"][1]
    n, k = edit.refine_steps(mix), n_candidates(mix)
    scales = torch.tensor(mix["decoder_scales"], dtype=torch.float32)
    uc, c = ctx["empty_dec"].repeat(k, 1, 1), ctx["target"].repeat(k, 1, 1)
    out, x = [], states_or_x_T
    for i in range(n):
        index = n - 1 - i
        xi = x if free else states_or_x_T[i]
        e = sampling.guided_eps(unet, xi, int(s.t[index]), uc, c, scales.to(xi.device))
        nxt = sampling.replay_step(s, index, xi, e, eps[i])
        out.append(xi if free else nxt)
        x = nxt
    return (torch.stack(out), x) if free else out


@torch.no_grad()
def reference_outputs(cfg: dict, mix: dict, parts: dict, req: dict) -> dict:
    """The request through ``parts`` alone, in :func:`program_outputs`'
    form; the scores in the scorer's own precision (the control's
    bfloat16)."""
    fs, scorer = parts["first_stage"][1], parts["scorer"][1]
    s, ctx, x0, z = edit.reference_encode(cfg, mix, parts, req)
    x_T, eps = edit.split_code(z, edit.refine_steps(mix))
    k = n_candidates(mix)
    x_T = x_T.reshape(x0.shape).repeat(k, 1, 1, 1)
    eps = eps.reshape((-1,) + tuple(x0.shape)).repeat(1, k, 1, 1, 1)
    states, final = _chains(mix, parts, s, ctx, x_T, eps, free=True)
    images = (fs.decode(final / cfg["arch"]["scale_factor"]) + 1.0) / 2.0
    emb = _embeddings(cfg, scorer, req, images)
    scores = dclip_scores(emb, scorer.visual.proj.dtype)
    best = int(torch.argmax(scores))
    return {"contexts": ctx, "x0": x0, "z": z, "states": states, "final": final,
            "images": images, "embeddings": emb, "scores": scores, "best": best,
            "chosen": images[best]}


def wrong_choice(best: int, scores: torch.Tensor, ref: torch.Tensor) -> bool:
    """Whether ``best`` is not the argmax of ``ref`` although it would have
    to be: a choice that maximises ``scores``, each within ``g`` of
    ``ref``, scores at least ``max(ref) - 2 g`` on ``ref``, so where the
    top two of ``ref`` lie further apart than ``2 g`` it is ``ref``'s
    argmax."""
    ref = ref.to(torch.float64)
    gap = float((scores.to(ref) - ref).abs().max())
    top = torch.topk(ref, 2).values
    return float(top[0] - top[1]) > 2.0 * gap and best != int(torch.argmax(ref))


# the numbers compared, each against a limit of its cell
NUMBERS = ("ctx", "x0", "code", "replay", "pixels", "clip", "scores", "choice", "chosen")


@torch.no_grad()
def readings(cfg: dict, mix: dict, parts: dict, req: dict, outs: dict) -> dict:
    """As the edit mix's (``edit.readings``) over every candidate, and the
    ranking's:

    * ``clip``: its CLIP embeddings (the candidates, the original, the
      source and target prompts) against the reference towers' of the same
      images and prompts;
    * ``scores``: its DirectionalCLIP scores against the reference's
      arithmetic, in float32, over its own embeddings;
    * ``choice``: 1 where its chosen candidate is not the argmax of a
      reference's scores although the scores' gap says it must be
      (:func:`wrong_choice`): the reference's over its embeddings, and the
      reference's own from its towers; else 0;
    * ``chosen``: the largest difference between the image it returned
      and its chosen candidate (exact: 0).
    """
    fs, scorer = parts["first_stage"][1], parts["scorer"][1]
    s, ctx, x0, z = edit.reference_encode(cfg, mix, parts, req)
    n, k = edit.refine_steps(mix), n_candidates(mix)
    _, eps = edit.split_code(outs["z"], n)
    eps = eps.reshape((n,) + tuple(x0.shape)).repeat(1, k, 1, 1, 1)
    replay = math.inf          # states of another shape than the request's
    if tuple(outs["states"].shape[:2]) == (n, k) and outs["final"].shape[0] == k:
        nxt = _chains(mix, parts, s, ctx, outs["states"], eps, free=False)
        replay = max(compare.rel_rms(outs["states"][i + 1] if i + 1 < n else outs["final"],
                                     nxt[i]) for i in range(n))
    images = (fs.decode(outs["final"] / cfg["arch"]["scale_factor"]) + 1.0) / 2.0
    ref_emb = _embeddings(cfg, scorer, req, outs["images"])
    own = dclip_scores(outs["embeddings"])
    best = int(outs["best"])
    ok = 0 <= best < outs["images"].shape[0] and outs["scores"].shape == own.shape
    choice = float(not ok or wrong_choice(best, outs["scores"], own)
                   or wrong_choice(best, outs["scores"], dclip_scores(ref_emb)))
    chosen = (float((outs["chosen"].float() - outs["images"][best].float()).abs().max())
              if ok else math.inf)
    return {
        "ctx": max(compare.rel_rms(outs["contexts"][key], ctx[key]) for key in ctx),
        "x0": compare.rel_rms(outs["x0"], x0),
        "code": compare.rel_rms(outs["z"], z),
        "replay": replay,
        "pixels": compare.rel_rms(outs["images"], images),
        "clip": compare.rel_rms(outs["embeddings"], ref_emb),
        "scores": compare.rel_rms(outs["scores"][None], own[None]) if ok else math.inf,
        "choice": choice,
        "chosen": chosen,
    }
