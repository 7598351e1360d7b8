"""The pixel-space DPM-Encoder pipeline, the ``DDPM_DDIM`` gan_type
(counterpart of ``cyclediffusion_tpu.pipelines.ddpm_ddim``).

* ``encode(image01, generator)`` -> ``z`` of ``latent_dim = resolution^2 *
  channels * es_steps`` values per image: x_T, then the ``es_steps - 1``
  recovered eps, each NHWC-flattened, in the JAX pipeline's order.  At the
  shipped ``es_steps`` 850 that is 668 MB per 256 px image in fp32; it stays
  on the pipeline's device.
* ``generate(z, generator)`` -> [-1, 1] NHWC images: the replay and the
  refine (``samplers.pixel``); ``__call__`` maps them to [0, 1].

The UNet runs in the pipeline's ``dtype``, fp32 by default as in JAX: the
eta-DDIM eps recovery divides by c1 (0.1 of the posterior's std at the
shipped eta), which amplifies any error in the model's eps.  Its
convolutions then follow PyTorch's global flags: TF32 on the card by
default (``torch.backends.cudnn.allow_tf32``), which the pipeline leaves
as they are.  The sampler around it is fp32.  Each call builds its chain
anew, so any batch size runs (the task model's batches are ragged); on the
card each batch size is one more captured graph.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
from torch import nn

from cyclediffusion_tpu_torch.convert.from_jax import load_flax_params
from cyclediffusion_tpu_torch.models.nn import resolve_device
from cyclediffusion_tpu_torch.ops import schedule
from cyclediffusion_tpu_torch.pipelines.zoo import (
    PixelModelSpec,
    build_pixel_model,
    init_random_params,
    load_pixel_params,
)
from cyclediffusion_tpu_torch.runtime import graphs
from cyclediffusion_tpu_torch.samplers import pixel_encode, pixel_generate


def _pixel_eps(model, dtype, x, t):
    return model(x.to(dtype), t).float()


class DDPMDDIMPipeline:
    def __init__(self, spec: PixelModelSpec, model: nn.Module, *, sample_type: str = "ddim",
                 custom_steps: int = 1000, es_steps: int = 850, eta: Optional[float] = None,
                 refine_steps: int = 0, refine_iterations: int = 1, t_0: Optional[int] = None,
                 device="cuda", dtype=torch.float32):
        if sample_type == "ddim":
            if eta is None or eta <= 0:
                raise ValueError("eta-DDIM needs eta > 0")
        elif sample_type == "ddpm":
            if eta is not None:
                raise ValueError("DDPM sampling takes no eta")
        else:
            raise ValueError(f"sample_type {sample_type!r}: ddim or ddpm")
        self.spec = spec
        self.device = resolve_device(device)
        self.dtype = dtype
        self.model = model.to(self.device, dtype).eval().requires_grad_(False)
        self._graphed = graphs.GraphedCall(functools.partial(_pixel_eps, self.model, dtype))
        self.sample_type = sample_type
        self.custom_steps = custom_steps
        self.es_steps = es_steps
        self.eta = eta
        self.refine_steps = refine_steps
        self.refine_iterations = refine_iterations
        self.t_0 = t_0 if t_0 is not None else spec.num_diffusion_timesteps - 1
        betas = schedule.get_beta_schedule(
            beta_start=spec.beta_start, beta_end=spec.beta_end,
            num_diffusion_timesteps=spec.num_diffusion_timesteps)
        self.ps = schedule.PixelSchedule.create(betas, var_type=spec.var_type)
        self.seq, self.seq_next = schedule.pixel_timestep_grid(self.t_0, custom_steps,
                                                               es_steps)
        if len(self.seq) != es_steps:
            raise ValueError(f"the grid has {len(self.seq)} steps, es_steps={es_steps}")
        self.resolution = spec.resolution
        self.channels = spec.channels
        self.latent_dim = spec.resolution ** 2 * spec.channels * es_steps

    # ---- constructors -------------------------------------------------- #

    @classmethod
    def random_init(cls, spec: PixelModelSpec, seed: int = 0, device="cuda",
                    dtype=torch.float32, **kw) -> "DDPMDDIMPipeline":
        """Seeded random weights, drawn on the device."""
        device = resolve_device(device)
        with device:
            model = build_pixel_model(spec)
        init_random_params(model, torch.Generator(device=device).manual_seed(seed))
        return cls(spec, model, device=device, dtype=dtype, **kw)

    @classmethod
    def from_jax_params(cls, spec: PixelModelSpec, params: dict, device="cuda",
                        dtype=torch.float32, **kw) -> "DDPMDDIMPipeline":
        """The JAX pipeline's UNet parameter tree (numpy leaves)."""
        model = build_pixel_model(spec)
        load_flax_params(model, params)
        return cls(spec, model, device=device, dtype=dtype, **kw)

    @classmethod
    @torch.no_grad()
    def from_torch_ckpt(cls, spec: PixelModelSpec, path: str, device="cuda",
                        dtype=torch.float32, **kw) -> "DDPMDDIMPipeline":
        """A reference checkpoint (see ``convert.from_torch``); raises on a
        missing file, an unmapped or missing key, or a shape mismatch."""
        device = resolve_device(device)
        with device:
            model = build_pixel_model(spec)
        load_pixel_params(spec, model, path)
        return cls(spec, model, device=device, dtype=dtype, **kw)

    # ---- the chain ------------------------------------------------------ #

    def _model_fn(self, x, t):
        """The UNet call of both chains: replayed as a CUDA graph of
        :meth:`_model_fn_eager` on a CUDA device (``runtime.graphs``), that
        call on the CPU."""
        return self._graphed(x, t)

    @torch.no_grad()
    def _model_fn_eager(self, x, t):
        return _pixel_eps(self.model, self.dtype, x, t)

    def _kw(self):
        return dict(sample_type=self.sample_type, eta=self.eta,
                    learn_sigma=self.spec.learn_sigma)

    def encode(self, image01, generator: Optional[torch.Generator] = None, *,
               xT_noise=None, posterior_noises=None) -> torch.Tensor:
        """[0, 1] NHWC images -> z (B, latent_dim)."""
        image01 = torch.as_tensor(image01, dtype=torch.float32, device=self.device)
        if not image01.shape[1] == image01.shape[2] == self.resolution:
            raise ValueError(f"image {tuple(image01.shape)} is not "
                             f"{self.resolution}x{self.resolution}")
        x0 = (image01 - 0.5) * 2.0
        xT, eps = pixel_encode(self._model_fn, self.ps, self.seq, self.seq_next, x0,
                               generator, xT_noise=xT_noise,
                               posterior_noises=posterior_noises, **self._kw())
        z = torch.empty((x0.shape[0], self.es_steps) + tuple(x0.shape[1:]),
                        dtype=x0.dtype, device=x0.device)
        z[:, 0] = xT
        z[:, 1:] = eps.transpose(0, 1)
        return z.reshape(x0.shape[0], -1)

    def generate(self, z, generator: Optional[torch.Generator] = None,
                 **noises) -> torch.Tensor:
        """z -> [-1, 1] NHWC images (fp32); ``noises`` are
        ``pixel_generate``'s seams."""
        if z.shape[1] != self.latent_dim:
            raise ValueError(f"z of {z.shape[1]} values per image, expected {self.latent_dim}")
        z = z.reshape(z.shape[0], self.es_steps, self.resolution, self.resolution,
                      self.channels)
        return pixel_generate(self._model_fn, self.ps, self.seq, self.seq_next, z[:, 0],
                              z[:, 1:].transpose(0, 1), generator,
                              refine_steps=self.refine_steps,
                              refine_iterations=self.refine_iterations, **noises,
                              **self._kw())

    def __call__(self, z, generator: Optional[torch.Generator] = None,
                 **noises) -> torch.Tensor:
        """z -> [0, 1] NHWC images (fp32, unclamped, as in JAX)."""
        return (self.generate(z, generator, **noises) + 1.0) / 2.0
