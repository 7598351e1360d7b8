"""Text-guided stochastic translation with SD v1 or LDM text2img-large
(counterpart of ``StochasticTextPipeline`` in
``cyclediffusion_tpu.pipelines.latent_text``).

* ``encode(image, encode_text)`` -> z-ensemble ordered ``trial -> enc_scale
  -> skip``, each z flattened with x_T first and then each eps, every entry
  NHWC-flattened.
* ``generate(z_ensemble, decode_text)`` -> each z under each decoder
  guidance scale, as [0, 1] NHWC images, in the same order as the JAX
  pipeline (decoder scale innermost).
* ``forward(z_ensemble, original, encode_text, decode_text)`` -> the
  candidate with the best DirectionalCLIP score per sample, and the winning
  (enc_scale, dec_scale, skip) combos.

Candidates sharing a skip value are folded into the batch axis (``K*B``), at
most ``candidate_chunk`` of them per chain, so one chain of UNet calls
serves them all, with the per-candidate guidance scale a tensor (the
always-dual-batch CFG path, as in JAX).  Chunking caps memory and changes no
result: every candidate's noise is drawn in candidate order before the
chunks are cut.  A skip's tail chunk is padded to the chunk's size with
copies of its last candidate, as JAX pads it, so that every chain of a skip
has one batch and replays one captured graph of the UNet call
(``LatentDiffusionCore.apply_model``); only the real candidates' results are
kept.  The VAE posterior is sampled once per image and shared by all
chains.

``mesh`` (a ``DeviceMesh`` with a ``"data"`` dimension,
``parallel.data_mesh``) splits the candidate axis over its ranks, as JAX's
``mesh`` shards it over devices: each encode and decode launch is rounded
up to the mesh's extent (the last candidate repeated), each rank runs its
contiguous block of the launch and decodes its own rows, and an all-gather
makes x_T, the eps and the decoded images whole on every rank, so the
ranking is the same on each.  Every rank must call with the same sample:
each draws the whole launch's noise from the sample's generator in the
unsplit order and keeps its rows, so the stream does not depend on the
rank.

``fast_key_every > 1`` is the encoder-caching fast mode on both chains
(``samplers.dpm_encode_cached`` / ``ddim_decode_cached`` through
``ops.cfg.cfg_model_fn_pair``): the UNet's encoder half runs at every
``fast_key_every``-th step only.  The noise draws are the exact path's.

``runtime.profiling`` records the entry points as ``pipeline.encode``,
``pipeline.generate``, ``pipeline.forward`` and ``pipeline.rank`` spans (the
ranked candidates as rows), the host's waits on the device as ``sync.*``
spans, and each launch's candidates, padding included and not, as the
``rows.launched`` and ``rows.real`` counters.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from cyclediffusion_tpu_torch.energy.clean_clip import DirectionalCLIP, normalize
from cyclediffusion_tpu_torch.ops.cfg import cfg_model_fn, cfg_model_fn_pair
from cyclediffusion_tpu_torch.parallel.mesh import all_gather_cat, batch_sharding, mesh_extent
from cyclediffusion_tpu_torch.pipelines.latent import LatentDiffusionCore
from cyclediffusion_tpu_torch.runtime import profiling
from cyclediffusion_tpu_torch.samplers import (
    ddim_decode,
    ddim_decode_cached,
    dpm_encode,
    dpm_encode_cached,
    num_recovered_eps,
)

# first-stage decode runs in micro-batches of this many latents: at 512 px
# the decoder's activations are ~0.5 GB per latent
_VAE_BATCH = 8


class StochasticTextPipeline:
    def __init__(
        self,
        core: LatentDiffusionCore,
        tokenizer,
        directional_clip: Optional[DirectionalCLIP] = None,
        *,
        custom_steps: int,
        eta: float,
        white_box_steps: int,
        skip_steps: Sequence[int],
        encoder_unconditional_guidance_scales: Sequence[float],
        decoder_unconditional_guidance_scales: Sequence[float],
        n_trials: int,
        candidate_chunk: Optional[int] = None,
        mesh=None,
        fast_key_every: Optional[int] = None,
    ):
        if eta <= 0:
            raise ValueError("the DPM-Encoder needs eta > 0 (it divides by sigma)")
        if candidate_chunk is not None and candidate_chunk < 1:
            raise ValueError(f"candidate_chunk={candidate_chunk} must be >= 1")
        self.core = core
        self.tokenizer = tokenizer
        self.directional_clip = directional_clip
        # cap on the candidates folded into one chain: the UNet batch is
        # 2 * batch * chunk (the CFG pair)
        self.candidate_chunk = candidate_chunk
        self.white_box_steps = white_box_steps
        self.skip_steps = list(skip_steps)
        self.enc_scales = list(encoder_unconditional_guidance_scales)
        self.dec_scales = list(decoder_unconditional_guidance_scales)
        self.n_trials = n_trials
        self.fast_key_every = fast_key_every
        self.mesh = mesh
        self.sched = core.make_ddim_schedule(custom_steps, eta)
        self.resolution = core.spec.resolution

    # ---- mesh plumbing ---------------------------------------------------- #

    @property
    def _data_extent(self) -> int:
        return 1 if self.mesh is None else mesh_extent(self.mesh, "data")

    def _pad_launch(self, sub: list, chunk: int, c0: int) -> list:
        """A launch's candidates padded by repeating the last one, as JAX pads
        them: a skip's tail chunk (starting at ``c0 > 0``) to the chunk's
        size, so that one captured graph serves every chunk of the skip, and
        every launch up to a multiple of the data extent."""
        want = chunk if len(sub) < chunk and c0 > 0 else len(sub)
        want = -(-want // self._data_extent) * self._data_extent
        profiling.count("rows.launched", want)
        profiling.count("rows.real", len(sub))
        return sub + sub[-1:] * (want - len(sub))

    def _my_rows(self, padded: list) -> list:
        """This rank's contiguous block of a padded launch (all of it off-mesh)."""
        if self.mesh is None:
            return padded
        return padded[batch_sharding(self.mesh, len(padded))]

    def _gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's block of a launch's candidate-leading result, whole."""
        if self.mesh is None:
            return t
        return all_gather_cat(t, self.mesh.get_group("data"))

    # ---- conditioning --------------------------------------------------- #

    def get_condition(self, texts) -> torch.Tensor:
        """c context for texts; uc is the encoding of ""."""
        return self.core.get_learned_conditioning(self.tokenizer(list(texts)))

    def uncond(self, batch: int) -> torch.Tensor:
        return self.get_condition([""] * batch)

    # ---- chains ---------------------------------------------------------- #

    def _latent_shape(self, bsz: int):
        s = self.core.spec
        return (bsz, s.image_size, s.image_size, s.channels)

    @property
    def _fast(self) -> bool:
        return (self.fast_key_every or 0) > 1

    def _guided(self, c_ctx, uc_ctx, scales: Sequence[float], bsz: int):
        """CFG eps model over K candidates folded into the batch axis: one
        ``fn(x, t)``, or in fast mode the ``(key_fn, reuse_fn)`` pair."""
        K = len(scales)
        # a pageable host copy: the host waits for the device's queue
        with profiling.span("sync.scales"):
            scale_f = torch.tensor(scales, dtype=torch.float32, device=self.core.device)
        scale_f = scale_f.repeat_interleave(bsz).reshape(K * bsz, 1, 1, 1)
        uc, c = uc_ctx.repeat(K, 1, 1), c_ctx.repeat(K, 1, 1)
        if self._fast:
            return cfg_model_fn_pair(self.core.apply_model_cached, uc, c, scale_f)
        return cfg_model_fn(self.core.apply_model, uc, c, scale_f)

    def _encode_chains(self, x0, c_ctx, uc_ctx, scales, noises, skip):
        """DPM-Encoder over K candidates at one skip value, candidates folded
        into the batch -> (xT: (K,B,h,w,c), eps: (K,n,B,h,w,c)).  ``noises``
        holds each candidate's (x_T noise (B,...), posterior noises
        (n,B,...))."""
        K, B = len(scales), x0.shape[0]
        n = num_recovered_eps(self.sched.num_steps, self.white_box_steps, skip)
        xT_noise = torch.cat([xn for xn, _ in noises], dim=0)
        post = torch.stack([p for _, p in noises], dim=1).reshape(
            (n, K * B) + tuple(x0.shape[1:]))
        fn = self._guided(c_ctx, uc_ctx, scales, B)
        kw = dict(white_box_steps=self.white_box_steps, skip_steps=skip,
                  xT_noise=xT_noise, posterior_noises=post)
        if self._fast:
            xT, eps = dpm_encode_cached(*fn, self.sched, x0.repeat(K, 1, 1, 1),
                                        key_every=self.fast_key_every, **kw)
        else:
            xT, eps = dpm_encode(fn, self.sched, x0.repeat(K, 1, 1, 1), **kw)
        xT = xT.reshape((K, B) + xT.shape[1:])
        eps = eps.reshape((n, K, B) + eps.shape[2:]).transpose(0, 1)
        return xT, eps

    def _decode_chains(self, xT, eps, c_ctx, uc_ctx, scales, generator, skip):
        """Replay over K candidates at one skip, folded into the batch ->
        latent samples (K, B, h, w, c).  Steps past the stored eps draw
        fresh noise from ``generator``."""
        K, B = xT.shape[0], xT.shape[1]
        n = eps.shape[1]
        xT_f = xT.reshape((K * B,) + xT.shape[2:])
        eps_f = eps.transpose(0, 1).reshape((n, K * B) + eps.shape[3:])
        fn = self._guided(c_ctx, uc_ctx, scales, B)
        if self._fast:
            sample = ddim_decode_cached(*fn, self.sched, xT_f, eps_f, generator,
                                        key_every=self.fast_key_every, skip_steps=skip)
        else:
            sample = ddim_decode(fn, self.sched, xT_f, eps_f, generator, skip_steps=skip)
        return sample.reshape((K, B) + sample.shape[1:])

    # ---- protocol ---------------------------------------------------------- #

    def _combos(self):
        return [(trial, es, sk) for trial in range(self.n_trials)
                for es in self.enc_scales for sk in self.skip_steps]

    def encode(self, image01, encode_text, generator: Optional[torch.Generator] = None,
               *, vae_noise=None, xT_noises=None, posterior_noises=None
               ) -> List[torch.Tensor]:
        """-> z_ensemble (list, order trial -> enc_scale -> skip), each
        ``(B, (n+1)*h*w*c)``.

        The optional pre-drawn noises replace the draws from ``generator``:
        ``vae_noise`` (B,h,w,c) for the first-stage posterior, and per
        candidate ``xT_noises[i]`` (B,h,w,c) and ``posterior_noises[i]``
        (n_i,B,h,w,c) for its DPM-Encoder chain.
        """
        with profiling.span("pipeline.encode"):
            image01 = torch.as_tensor(image01, dtype=torch.float32, device=self.core.device)
            if not image01.shape[1] == image01.shape[2] == self.resolution:
                raise ValueError(f"image {tuple(image01.shape)} is not "
                                 f"{self.resolution}x{self.resolution}")
            bsz = image01.shape[0]
            shape = self._latent_shape(bsz)
            dev = self.core.device

            def draw(s):
                return torch.randn(s, generator=generator, device=dev)

            if vae_noise is None:
                vae_noise = draw(shape)
            x0 = self.core.encode_first_stage((image01 - 0.5) * 2.0,
                                              torch.as_tensor(vae_noise, device=dev))
            c_ctx = self.get_condition(encode_text)
            uc_ctx = self.uncond(bsz)

            combos = self._combos()
            noises = []
            for i, (_, _, sk) in enumerate(combos):
                n = num_recovered_eps(self.sched.num_steps, self.white_box_steps, sk)
                xn = draw(shape) if xT_noises is None else xT_noises[i]
                pn = draw((n,) + shape) if posterior_noises is None else posterior_noises[i]
                noises.append((torch.as_tensor(xn, device=dev),
                               torch.as_tensor(pn, device=dev)))

            results = {}
            for skip in sorted(set(self.skip_steps)):
                idxs = [i for i, (_, _, sk) in enumerate(combos) if sk == skip]
                chunk = self.candidate_chunk or len(idxs)
                for c0 in range(0, len(idxs), chunk):
                    sub = idxs[c0:c0 + chunk]
                    mine = self._my_rows(self._pad_launch(sub, chunk, c0))
                    xT, eps = self._encode_chains(
                        x0, c_ctx, uc_ctx, [combos[i][1] for i in mine],
                        [noises[i] for i in mine], skip)
                    xT, eps = self._gather(xT), self._gather(eps)
                    for j, i in enumerate(sub):
                        results[i] = (xT[j], eps[j])

            z_ensemble = []
            for i in range(len(combos)):
                xT, eps = results[i]
                z = torch.cat([xT[None], eps], dim=0)          # (n+1, B, h, w, c)
                z_ensemble.append(z.transpose(0, 1).reshape(bsz, -1))
            return z_ensemble

    def _unflatten(self, z, skip):
        spec = self.core.spec
        entries = self.white_box_steps - skip if self.white_box_steps != -1 else 1
        z = z.reshape(z.shape[0], entries, spec.image_size, spec.image_size,
                      spec.channels)
        return z[:, 0], z[:, 1:].transpose(0, 1)

    def generate(self, z_ensemble, decode_text, generator: Optional[torch.Generator] = None,
                 *, fresh_noises=None) -> List[torch.Tensor]:
        """Each z x each decoder scale -> [0,1] NHWC image (order preserved).

        Steps past a z's stored eps (``white_box_steps < custom_steps + 1``)
        take fresh noise: ``fresh_noises[i * D + d]`` ``(steps - skip - n, B,
        h, w, c)`` for z ``i`` under decoder scale ``d`` when given, else
        draws from ``generator``, per candidate in candidate order."""
        with profiling.span("pipeline.generate"):
            bsz = z_ensemble[0].shape[0]
            c_ctx = self.get_condition(decode_text)
            uc_ctx = self.uncond(bsz)
            D = len(self.dec_scales)
            imgs: List[Optional[torch.Tensor]] = [None] * (len(z_ensemble) * D)
            for skip in sorted(set(self.skip_steps)):
                work = []  # (xT, eps with its fresh tail, scale, flat position)
                for i in range(len(z_ensemble)):
                    if self.skip_steps[i % len(self.skip_steps)] != skip:
                        continue
                    xT, eps = self._unflatten(z_ensemble[i], skip)
                    fresh = self.sched.num_steps - skip - eps.shape[0]
                    for d, ds in enumerate(self.dec_scales):
                        full = eps
                        if fresh > 0:
                            tail = (torch.randn((fresh,) + tuple(xT.shape),
                                                generator=generator, dtype=xT.dtype,
                                                device=xT.device)
                                    if fresh_noises is None else
                                    torch.as_tensor(fresh_noises[i * D + d], dtype=xT.dtype,
                                                    device=xT.device))
                            full = torch.cat([eps, tail])
                        work.append((xT, full, ds, i * D + d))
                chunk = self.candidate_chunk or len(work)
                for c0 in range(0, len(work), chunk):
                    sub = work[c0:c0 + chunk]
                    mine = self._my_rows(self._pad_launch(sub, chunk, c0))
                    samples = self._decode_chains(
                        torch.stack([w[0] for w in mine]), torch.stack([w[1] for w in mine]),
                        c_ctx, uc_ctx, [w[2] for w in mine], generator, skip)
                    flat = samples.reshape((-1,) + samples.shape[2:])
                    decoded = torch.cat([
                        self.core.decode_first_stage(flat[i:i + _VAE_BATCH])
                        for i in range(0, flat.shape[0], _VAE_BATCH)])
                    decoded = self._gather(
                        decoded.reshape(samples.shape[:2] + decoded.shape[1:]))
                    for j, w in enumerate(sub):
                        imgs[w[3]] = (decoded[j] + 1.0) / 2.0
            return [im for im in imgs if im is not None]

    # ---- ranking ------------------------------------------------------------ #

    def rank(self, img_ensemble: Sequence[torch.Tensor], original_img01, encode_text,
             decode_text):
        """DirectionalCLIP scores of every candidate -> (scores (B, n) fp32,
        best candidate per sample (B,)).  The text features and the
        original's are computed once; candidates are embedded in
        micro-batches."""
        with profiling.span("pipeline.rank", len(img_ensemble) * img_ensemble[0].shape[0]):
            if self.directional_clip is None:
                raise ValueError("ranking needs a DirectionalCLIP scorer (directional_clip)")
            dclip = self.directional_clip
            enc_feat = dclip.text_features(encode_text)
            dec_feat = dclip.text_features(decode_text)
            orig_feat = dclip.scorer.embed_image(original_img01)
            stacked = torch.stack(list(img_ensemble))          # (n, B, H, W, C)
            n, bsz = stacked.shape[:2]
            img_feat = dclip.scorer.embed_images_microbatched(
                stacked.reshape((n * bsz,) + stacked.shape[2:])).reshape(n, bsz, -1)
            img_dir = normalize(img_feat - orig_feat[None])
            text_dir = normalize(dec_feat - enc_feat)
            scores = torch.einsum("nbz,bz->bn", img_dir, text_dir)
            return scores, torch.argmax(scores, dim=1)

    def forward(self, z_ensemble, original_img01, encode_text, decode_text,
                generator: Optional[torch.Generator] = None):
        """Decode every candidate, rank by DirectionalCLIP -> (best image
        (B, H, W, C), per-sample winning (enc_scale, dec_scale, skip))."""
        with profiling.span("pipeline.forward"):
            img_ensemble = self.generate(z_ensemble, decode_text, generator)
            n_expected = (len(self.dec_scales) * len(self.enc_scales)
                          * len(self.skip_steps) * self.n_trials)
            if len(img_ensemble) != n_expected:
                raise ValueError(f"{len(img_ensemble)} candidates, expected {n_expected}")
            original = torch.as_tensor(original_img01, dtype=torch.float32,
                                       device=self.core.device)
            _, best = self.rank(img_ensemble, original, encode_text, decode_text)
            best = best.to(self.core.device)
            img = torch.stack(img_ensemble, dim=1)[
                torch.arange(best.shape[0], device=best.device), best]
            # flat candidate order is trial -> enc_scale -> skip (encode) with the
            # decoder scale innermost (generate's i*D + d), so a trial's inner
            # index is ((e*S) + s)*D + d.  The reference's own report swaps the
            # dec/skip strides (stable_diffusion_stochastic_text_wrapper.py:236-247);
            # these are the JAX package's corrected tuples.
            D, S = len(self.dec_scales), len(self.skip_steps)
            n_inner = D * len(self.enc_scales) * S
            with profiling.span("sync.best"):
                best_ids = best.tolist()
            combos = []
            for bi in (int(j) % n_inner for j in best_ids):
                combos.append((self.enc_scales[bi // (D * S)], self.dec_scales[bi % D],
                               self.skip_steps[(bi // D) % S]))
            return img, combos

    def __call__(self, z_ensemble, original_img01, encode_text, decode_text,
                 generator: Optional[torch.Generator] = None):
        img, combos = self.forward(z_ensemble, original_img01, encode_text,
                                   decode_text, generator)
        print("best scales:", combos)
        return img


def sd_stochastic_text_pipeline(core: LatentDiffusionCore, tokenizer,
                                dclip: Optional[DirectionalCLIP], **kw
                                ) -> StochasticTextPipeline:
    """The pipeline behind the ``SDStochasticText`` gan_type."""
    if core.spec.cond_kind != "clip":
        raise ValueError("SDStochasticText needs a CLIP text-conditioned core")
    return StochasticTextPipeline(core, tokenizer, dclip, **kw)


def latentdiff_stochastic_text_pipeline(core: LatentDiffusionCore, tokenizer,
                                        dclip: Optional[DirectionalCLIP], **kw
                                        ) -> StochasticTextPipeline:
    """The pipeline behind the ``LatentDiffStochasticText`` gan_type."""
    if core.spec.cond_kind != "bert":
        raise ValueError("LatentDiffStochasticText needs an LDM-BERT text-conditioned core")
    return StochasticTextPipeline(core, tokenizer, dclip, **kw)
