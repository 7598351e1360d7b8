"""Text-guided stochastic translation with SD v1 (counterpart of
``StochasticTextPipeline`` in ``cyclediffusion_tpu.pipelines.latent_text``,
without the DirectionalCLIP ranking).

* ``encode(image, encode_text)`` -> z-ensemble ordered ``trial -> enc_scale
  -> skip``, each z flattened with x_T first and then each eps, every entry
  NHWC-flattened.
* ``generate(z_ensemble, decode_text)`` -> each z under each decoder
  guidance scale, as [0, 1] NHWC images, in the same order as the JAX
  pipeline (decoder scale innermost).

Candidates sharing a skip value are folded into the batch axis (``K*B``), so
one chain of UNet calls serves them all, with the per-candidate guidance
scale a tensor (the always-dual-batch CFG path, as in JAX).  The VAE
posterior is sampled once per image and shared by all chains.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from cyclediffusion_tpu_torch.ops.cfg import cfg_model_fn
from cyclediffusion_tpu_torch.pipelines.latent import LatentDiffusionCore
from cyclediffusion_tpu_torch.samplers import ddim_decode, dpm_encode, num_recovered_eps

# first-stage decode runs in micro-batches of this many latents: at 512 px
# the decoder's activations are ~0.5 GB per latent
_VAE_BATCH = 8


class StochasticTextPipeline:
    def __init__(
        self,
        core: LatentDiffusionCore,
        tokenizer,
        *,
        custom_steps: int,
        eta: float,
        white_box_steps: int,
        skip_steps: Sequence[int],
        encoder_unconditional_guidance_scales: Sequence[float],
        decoder_unconditional_guidance_scales: Sequence[float],
        n_trials: int,
    ):
        if eta <= 0:
            raise ValueError("the DPM-Encoder needs eta > 0 (it divides by sigma)")
        self.core = core
        self.tokenizer = tokenizer
        self.white_box_steps = white_box_steps
        self.skip_steps = list(skip_steps)
        self.enc_scales = list(encoder_unconditional_guidance_scales)
        self.dec_scales = list(decoder_unconditional_guidance_scales)
        self.n_trials = n_trials
        self.sched = core.make_ddim_schedule(custom_steps, eta)
        self.resolution = core.spec.resolution

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

    def _guided(self, c_ctx, uc_ctx, scales: Sequence[float], bsz: int):
        """CFG eps model over K candidates folded into the batch axis."""
        K = len(scales)
        scale_f = torch.tensor(scales, dtype=torch.float32, device=self.core.device)
        scale_f = scale_f.repeat_interleave(bsz).reshape(K * bsz, 1, 1, 1)
        return cfg_model_fn(self.core.apply_model, uc_ctx.repeat(K, 1, 1),
                            c_ctx.repeat(K, 1, 1), scale_f)

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
        xT, eps = dpm_encode(
            self._guided(c_ctx, uc_ctx, scales, B), self.sched, x0.repeat(K, 1, 1, 1),
            white_box_steps=self.white_box_steps, skip_steps=skip,
            xT_noise=xT_noise, posterior_noises=post)
        xT = xT.reshape((K, B) + xT.shape[1:])
        eps = eps.reshape((n, K, B) + eps.shape[2:]).transpose(0, 1)
        return xT, eps

    def _decode_chains(self, xT, eps, c_ctx, uc_ctx, scales, generator, skip):
        """Replay over K candidates at one skip, folded into the batch ->
        latent samples (K, B, h, w, c)."""
        K, B = xT.shape[0], xT.shape[1]
        n = eps.shape[1]
        xT_f = xT.reshape((K * B,) + xT.shape[2:])
        eps_f = eps.transpose(0, 1).reshape((n, K * B) + eps.shape[3:])
        sample = ddim_decode(self._guided(c_ctx, uc_ctx, scales, B), self.sched,
                             xT_f, eps_f, generator, skip_steps=skip)
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
            noises.append((torch.as_tensor(xn, device=dev), torch.as_tensor(pn, device=dev)))

        results = {}
        for skip in sorted(set(self.skip_steps)):
            idxs = [i for i, (_, _, sk) in enumerate(combos) if sk == skip]
            xT, eps = self._encode_chains(
                x0, c_ctx, uc_ctx, [combos[i][1] for i in idxs],
                [noises[i] for i in idxs], skip)
            for j, i in enumerate(idxs):
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

    def generate(self, z_ensemble, decode_text,
                 generator: Optional[torch.Generator] = None) -> List[torch.Tensor]:
        """Each z x each decoder scale -> [0,1] NHWC image (order preserved).
        Steps past a z's stored eps draw fresh noise from ``generator``."""
        bsz = z_ensemble[0].shape[0]
        c_ctx = self.get_condition(decode_text)
        uc_ctx = self.uncond(bsz)
        D = len(self.dec_scales)
        imgs: List[Optional[torch.Tensor]] = [None] * (len(z_ensemble) * D)
        for skip in sorted(set(self.skip_steps)):
            work = []  # (xT, eps, scale, flat position)
            for i in range(len(z_ensemble)):
                if self.skip_steps[i % len(self.skip_steps)] != skip:
                    continue
                xT, eps = self._unflatten(z_ensemble[i], skip)
                for d, ds in enumerate(self.dec_scales):
                    work.append((xT, eps, ds, i * D + d))
            if not work:
                continue
            samples = self._decode_chains(
                torch.stack([w[0] for w in work]), torch.stack([w[1] for w in work]),
                c_ctx, uc_ctx, [w[2] for w in work], generator, skip)
            flat = samples.reshape((-1,) + samples.shape[2:])
            decoded = torch.cat([
                self.core.decode_first_stage(flat[i:i + _VAE_BATCH])
                for i in range(0, flat.shape[0], _VAE_BATCH)])
            decoded = decoded.reshape(samples.shape[:2] + decoded.shape[1:])
            for j, w in enumerate(work):
                imgs[w[3]] = (decoded[j] + 1.0) / 2.0
        return [im for im in imgs if im is not None]
