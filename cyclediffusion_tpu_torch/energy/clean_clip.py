"""CLIP and directional-CLIP scoring (counterpart of
``cyclediffusion_tpu.energy.clean_clip``).

``clip = <img, dec_text>`` and ``dclip = <(img - orig)/|.|, (dec - enc)/|.|>``
over unit-normalised ViT-B/32 embeddings of [0, 1] NHWC images and of
tokenised prompts.  The text features of an (encode, decode) prompt pair and
the original image's features are computed once and reused across a whole
candidate ensemble; candidate images are embedded in micro-batches.
"""

from __future__ import annotations

import functools
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from cyclediffusion_tpu_torch.convert.from_jax import flax_to_state_dict, from_openai_state_dict
from cyclediffusion_tpu_torch.models.clip import CLIPConfig, CLIPModel, clip_preprocess
from cyclediffusion_tpu_torch.models.nn import fill_random_, resolve_device
from cyclediffusion_tpu_torch.runtime import graphs, profiling


def normalize(x):
    """x over its L2 norm along the last axis."""
    return x / torch.linalg.norm(x, dim=-1, keepdim=True)


def _embed_image(model: CLIPModel, resolution: int, dtype, images01):
    x = clip_preprocess(images01.to(dtype), resolution)
    return normalize(model.encode_image(x).float())


def _embed_text(model: CLIPModel, ids):
    return normalize(model.encode_text(ids).float())


class CLIPScorer:
    """A frozen :class:`CLIPModel` on one device, in one dtype.  On a CUDA
    device :meth:`embed_image` and :meth:`embed_text` replay CUDA graphs of
    the towers (JAX's jitted ``_embed_image`` and ``_embed_text``), one per
    input shape, in one pool; the ``*_eager`` twins launch eagerly."""

    def __init__(self, config: Optional[CLIPConfig] = None, device="cuda",
                 dtype=torch.float32):
        self.config = config or CLIPConfig.vit_b_32()
        self.device = resolve_device(device)
        self.dtype = dtype
        with self.device:
            self.model = CLIPModel(self.config)
        self.model.to(dtype=dtype).eval().requires_grad_(False)
        pool = graphs.GraphPool()
        self._graphed_image = graphs.GraphedCall(
            functools.partial(_embed_image, self.model, self.config.image_resolution, dtype),
            pool, name="clip.image")
        self._graphed_text = graphs.GraphedCall(functools.partial(_embed_text, self.model),
                                                pool, name="clip.text")

    @classmethod
    def random_init(cls, seed: int = 0, config: Optional[CLIPConfig] = None,
                    device="cuda", dtype=torch.float32) -> "CLIPScorer":
        """Seeded random weights (``models.nn.fill_random_``), drawn on the
        scorer's device."""
        scorer = cls(config, device, dtype)
        fill_random_(scorer.model, torch.Generator(device=scorer.device).manual_seed(seed))
        return scorer

    @classmethod
    def from_jax_params(cls, params: dict, config: Optional[CLIPConfig] = None,
                        device="cuda", dtype=torch.float32) -> "CLIPScorer":
        """Weights from the JAX ``CLIPModel``'s parameter tree (numpy leaves)."""
        scorer = cls(config, device, dtype)
        scorer.model.load_state_dict(flax_to_state_dict(params, scorer.model), strict=True)
        return scorer

    @classmethod
    def from_openai_state_dict(cls, state_dict: Mapping[str, object],
                               config: Optional[CLIPConfig] = None, device="cuda",
                               dtype=torch.float32) -> "CLIPScorer":
        """Weights from OpenAI's CLIP state dict (``ViT-B-32.pt``'s names)."""
        scorer = cls(config, device, dtype)
        scorer.model.load_state_dict(from_openai_state_dict(state_dict, scorer.model),
                                     strict=True)
        return scorer

    @classmethod
    def from_checkpoint(cls, path: str, **kw) -> "CLIPScorer":
        """OpenAI's ``ViT-B-32.pt`` (a TorchScript archive or a plain state
        dict, optionally under ``"state_dict"``)."""
        obj = torch.load(path, map_location="cpu", weights_only=False)
        if isinstance(obj, torch.nn.Module):
            obj = obj.state_dict()
        elif isinstance(obj, dict) and "state_dict" in obj:
            obj = obj["state_dict"]
        return cls.from_openai_state_dict(obj, **kw)

    def embed_image(self, images01) -> torch.Tensor:
        """NHWC [0, 1] images -> unit-norm fp32 embeddings (B, embed_dim)."""
        return self._graphed_image(torch.as_tensor(images01, device=self.device))

    @torch.no_grad()
    def embed_image_eager(self, images01) -> torch.Tensor:
        """:meth:`embed_image` as eager launches, never a graph."""
        return _embed_image(self.model, self.config.image_resolution, self.dtype,
                            torch.as_tensor(images01, device=self.device))

    def embed_images_microbatched(self, images01, micro_batch: int = 64) -> torch.Tensor:
        """:meth:`embed_image` over a large flat batch, ``micro_batch``
        images per tower call.  A shorter last micro-batch is a second
        graph: padding it would embed the real rows at another batch, and
        so possibly round them otherwise."""
        return torch.cat([self.embed_image(images01[i:i + micro_batch])
                          for i in range(0, images01.shape[0], micro_batch)])

    def embed_text(self, token_ids) -> torch.Tensor:
        """(B, T) token ids -> unit-norm fp32 embeddings (B, embed_dim)."""
        return self._graphed_text(self._token_ids(token_ids))

    @torch.no_grad()
    def embed_text_eager(self, token_ids) -> torch.Tensor:
        """:meth:`embed_text` as eager launches, never a graph."""
        return _embed_text(self.model, self._token_ids(token_ids))

    def _token_ids(self, token_ids) -> torch.Tensor:
        # a pageable host copy: the host waits for the device's queue
        with profiling.span("sync.clip.token_ids"):
            return torch.as_tensor(np.asarray(token_ids), dtype=torch.int64,
                                   device=self.device)


class DirectionalCLIP:
    """The reference's ``DirectionalCLIP.__call__`` surface, with text and
    original-image features that can be computed once per prompt pair."""

    def __init__(self, scorer: CLIPScorer, tokenizer):
        self.scorer = scorer
        self.tokenizer = tokenizer

    def text_features(self, texts) -> torch.Tensor:
        return self.scorer.embed_text(self.tokenizer(list(texts)))

    def score_with_features(self, img01, orig_feat, enc_feat, dec_feat
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Candidates (B, H, W, 3) against precomputed embeddings ->
        (clip (B,), dclip (B,))."""
        img_feat = self.scorer.embed_image(img01)
        img_dir = normalize(img_feat - orig_feat)
        text_dir = normalize(dec_feat - enc_feat)
        clip_score = torch.einsum("bz,bz->b", img_feat, dec_feat)
        dclip_score = torch.einsum("bz,bz->b", img_dir, text_dir)
        return clip_score, dclip_score

    def __call__(self, img01, original_img01, encode_text, decode_text):
        """Raw images and prompts -> (clip, dclip)."""
        enc_feat = self.text_features(encode_text)
        dec_feat = self.text_features(decode_text)
        orig_feat = self.scorer.embed_image(original_img01)
        return self.score_with_features(img01, orig_feat, enc_feat, dec_feat)
