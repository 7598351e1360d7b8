"""Noise schedules of both diffusion families (counterpart of
``cyclediffusion_tpu.ops.schedule``).

* Latent DDIM: a base DDPM beta schedule is sub-sampled onto an S-step DDIM
  grid with the reference's ``+1`` timestep offset, and per-index tables
  (alpha_bar, alpha_bar_prev, sigma(eta)) are precomputed.
* Pixel DDPM / eta-DDIM: a linear beta schedule over T steps, walked on an
  explicit ``(t, t_next)`` integer grid (:func:`pixel_timestep_grid`) whose
  ``-1`` sentinel means "alpha_bar_next = 1" (:class:`PixelSchedule`).

Tables are built in float64 NumPy (as the reference's float64
torch.linspace) and stored as float32 CPU tensors: the samplers take 0-d
slices of them as per-step scalars, so the coefficient arithmetic runs in
fp32 on the host, exactly as the JAX scans compute it, and never launches
device work.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def make_beta_schedule(
    schedule: str,
    n_timestep: int,
    linear_start: float = 1e-4,
    linear_end: float = 2e-2,
    cosine_s: float = 8e-3,
) -> np.ndarray:
    """Base DDPM beta schedule (float64 host array)."""
    if schedule == "linear":
        betas = (
            np.linspace(linear_start ** 0.5, linear_end ** 0.5, n_timestep, dtype=np.float64)
            ** 2
        )
    elif schedule == "cosine":
        timesteps = np.arange(n_timestep + 1, dtype=np.float64) / n_timestep + cosine_s
        alphas = np.cos(timesteps / (1 + cosine_s) * np.pi / 2) ** 2
        alphas = alphas / alphas[0]
        betas = 1 - alphas[1:] / alphas[:-1]
        betas = np.clip(betas, 0, 0.999)
    elif schedule == "sqrt_linear":
        betas = np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64)
    elif schedule == "sqrt":
        betas = np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64) ** 0.5
    else:
        raise ValueError(f"schedule '{schedule}' unknown.")
    return betas


def get_beta_schedule(*, beta_start: float, beta_end: float,
                      num_diffusion_timesteps: int) -> np.ndarray:
    """The pixel DDPMs' linear beta schedule (float64 host array)."""
    return np.linspace(beta_start, beta_end, num_diffusion_timesteps, dtype=np.float64)


def make_ddim_timesteps(
    ddim_discr_method: str, num_ddim_timesteps: int, num_ddpm_timesteps: int
) -> np.ndarray:
    """Integer DDIM timestep grid, including the reference's ``+1`` offset
    (load-bearing: it selects the final alpha values)."""
    if ddim_discr_method == "uniform":
        c = num_ddpm_timesteps // num_ddim_timesteps
        ddim_timesteps = np.asarray(list(range(0, num_ddpm_timesteps, c)))
        ddim_timesteps = ddim_timesteps[:num_ddim_timesteps]
    elif ddim_discr_method == "quad":
        ddim_timesteps = (
            np.linspace(0, np.sqrt(num_ddpm_timesteps * 0.8), num_ddim_timesteps) ** 2
        ).astype(int)
    else:
        raise NotImplementedError(
            f'There is no ddim discretization method called "{ddim_discr_method}"'
        )
    return ddim_timesteps + 1


def make_ddim_sampling_parameters(
    alphacums: np.ndarray, ddim_timesteps: np.ndarray, eta: float
):
    """Per-DDIM-index (sigma, alpha_bar, alpha_bar_prev) tables; alphas_prev
    is the table shifted right with ``alphacums[0]`` prepended."""
    alphas = alphacums[ddim_timesteps]
    alphas_prev = np.asarray([alphacums[0]] + alphacums[ddim_timesteps[:-1]].tolist())
    sigmas = eta * np.sqrt((1 - alphas_prev) / (1 - alphas) * (1 - alphas / alphas_prev))
    return sigmas, alphas, alphas_prev


@dataclasses.dataclass(frozen=True)
class DDIMSchedule:
    """Precomputed per-index tables, float32 CPU tensors.  Index ``i``
    corresponds to timestep ``timesteps[i]``; samplers walk
    ``index = total - step - 1`` downward."""

    num_ddpm_timesteps: int
    eta: float
    timesteps: torch.Tensor             # (S,) int64, +1 offset applied
    alphas: torch.Tensor                # (S,) alpha_bar at each DDIM timestep
    alphas_prev: torch.Tensor           # (S,)
    sigmas: torch.Tensor                # (S,) sigma_t(eta)
    sqrt_one_minus_alphas: torch.Tensor  # (S,)
    alphas_cumprod: torch.Tensor        # (T,)
    betas: torch.Tensor                 # (T,)

    @property
    def num_steps(self) -> int:
        return int(self.timesteps.shape[0])

    @staticmethod
    def create(
        betas: np.ndarray,
        num_ddim_timesteps: int,
        eta: float,
        ddim_discretize: str = "uniform",
    ) -> "DDIMSchedule":
        betas = np.asarray(betas, dtype=np.float64)
        num_ddpm_timesteps = int(betas.shape[0])
        alphas_cumprod = np.cumprod(1.0 - betas, axis=0)
        ts = make_ddim_timesteps(ddim_discretize, num_ddim_timesteps, num_ddpm_timesteps)
        sigmas, alphas, alphas_prev = make_ddim_sampling_parameters(alphas_cumprod, ts, eta)

        def f32(x):
            return torch.from_numpy(np.asarray(x, dtype=np.float32))

        return DDIMSchedule(
            num_ddpm_timesteps=num_ddpm_timesteps,
            eta=float(eta),
            timesteps=torch.from_numpy(ts.astype(np.int64)),
            alphas=f32(alphas),
            alphas_prev=f32(alphas_prev),
            sigmas=f32(sigmas),
            sqrt_one_minus_alphas=f32(np.sqrt(1.0 - alphas)),
            alphas_cumprod=f32(alphas_cumprod),
            betas=f32(betas),
        )


def pixel_timestep_grid(t_0: int, custom_steps: int, es_steps: int):
    """``(seq, seq_next)`` int64 grids of the pixel DPM-Encoder:
    ``linspace(0, 1, custom_steps) * t_0`` cast to int (an exact ``range``
    when ``custom_steps`` divides ``t_0 + 1``), cut to ``es_steps``;
    ``seq_next`` is ``seq`` shifted right behind a ``-1`` sentinel.  A grid
    that repeats a timestep (``custom_steps > t_0 + 1``) raises: its
    duplicate step has c1 = 0, and the eta-DDIM eps recovery divides by it."""
    if (t_0 + 1) % custom_steps == 0:
        seq = list(range(0, t_0 + 1, (t_0 + 1) // custom_steps))
    else:
        seq = list(np.linspace(0, 1, custom_steps) * t_0)
    seq = [int(s) for s in seq][:es_steps]
    if len(set(seq)) != len(seq):
        raise ValueError(f"duplicate timesteps in pixel grid (custom_steps={custom_steps} "
                         f"> t_0+1={t_0 + 1}?): eta-DDIM eps recovery would divide by 0")
    seq_next = ([-1] + seq[:-1])[:es_steps]
    return np.asarray(seq, dtype=np.int64), np.asarray(seq_next, dtype=np.int64)


@dataclasses.dataclass(frozen=True)
class PixelSchedule:
    """Tables of the pixel DDPM / eta-DDIM family, float32 CPU tensors,
    indexed by raw timestep.  ``alphas_cumprod_ext`` has alpha_bar(-1) = 1
    in front, so the ``-1`` sentinel is a gather at ``t + 1``
    (:meth:`a_bar`)."""

    betas: torch.Tensor               # (T,)
    alphas_cumprod: torch.Tensor      # (T,)
    alphas_cumprod_ext: torch.Tensor  # (T+1,): [1, alpha_bar_0, ..., alpha_bar_{T-1}]
    logvar: torch.Tensor              # (T,) the fixed log-variance
    num_timesteps: int

    @staticmethod
    def create(betas: np.ndarray, var_type: str = "fixedsmall") -> "PixelSchedule":
        betas = np.asarray(betas, dtype=np.float64)
        alphas_cumprod = np.cumprod(1.0 - betas, axis=0)
        alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])
        posterior_variance = betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
        if var_type == "fixedlarge":
            logvar = np.log(np.append(posterior_variance[1], betas[1:]))
        elif var_type == "fixedsmall":
            logvar = np.log(np.maximum(posterior_variance, 1e-20))
        else:
            raise ValueError(f"var_type {var_type!r}: fixedsmall or fixedlarge")

        def f32(x):
            return torch.from_numpy(np.asarray(x, dtype=np.float32))

        return PixelSchedule(
            betas=f32(betas),
            alphas_cumprod=f32(alphas_cumprod),
            alphas_cumprod_ext=f32(np.concatenate([[1.0], alphas_cumprod])),
            logvar=f32(logvar),
            num_timesteps=int(betas.shape[0]),
        )

    def a_bar(self, t) -> torch.Tensor:
        """alpha_bar(t), with t = -1 giving 1."""
        return self.alphas_cumprod_ext[torch.as_tensor(t) + 1]
