"""One-off measurement: the FFHQ LDM's fp32 DPM-Encoder round trip (encode
with eta 0.1, replay the recovered eps, no refine) in the JAX package and
in the port, at the same weights, images and noise.

    python tests/ffhq_round_trip.py [--width 64] [--vq-ch 32] [--steps 50]
        [--images 3] [--side both|port] [--device cpu|cuda] [--no-mkldnn]

The weights are the port's seeded core (``random_init``, seed 0, on the
CPU) written as a CompVis ``use_ema`` checkpoint (``tools/ldm_assets``) and
loaded by each package's own loader, so that the UNet's output conv is not
zero (JAX's ``random_init`` zeroes it).  Images (smooth, 256 px) and the
chain's noise (x_T and the posterior draws) come from
``np.random.default_rng(seed)`` and go to both packages' ``dpm_encode``.
``--width`` / ``--vq-ch`` set the UNet's ``model_channels`` (published 224)
and the VQ-f4 first stage's ``ch`` (published 128); every other field is
``ldm_ffhq256``'s.  ``--side port`` imports no JAX (the card's machine has
none) and runs the port on ``--device``; ``--no-mkldnn`` runs the port's
CPU convolutions without oneDNN (PyTorch's own kernels), which round
otherwise.  Prints max|replay - x0| on the latent for each side.  Not a
test: it is kept out of tier-1.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
ETA = 0.1


def cut(spec, width: int, vq_ch: int):
    return dataclasses.replace(spec, unet=dataclasses.replace(spec.unet, model_channels=width),
                               first_stage=dataclasses.replace(spec.first_stage, ch=vq_ch))


def inputs(n: int, steps: int, seed: int):
    """Smooth [0, 1] images (n, 256, 256, 3) and the chain's noise: x_T (n,
    64, 64, 3), posterior draws (steps, n, 64, 64, 3)."""
    rng = np.random.default_rng(seed)
    coarse = rng.random((n, 9, 9, 3))
    idx = np.linspace(0, 8, 256)
    lo = np.floor(idx).astype(int).clip(0, 7)
    f = (idx - lo)[None, :, None, None]
    rows = coarse[:, lo] * (1 - f) + coarse[:, lo + 1] * f
    f = (idx - lo)[None, None, :, None]
    images = rows[:, :, lo] * (1 - f) + rows[:, :, lo + 1] * f
    x_t = rng.standard_normal((n, 64, 64, 3))
    post = rng.standard_normal((steps, n, 64, 64, 3))
    return images.astype(np.float32), x_t.astype(np.float32), post.astype(np.float32)


def port_side(spec, ckpt, images, x_t, post, steps, device):
    import torch

    from cyclediffusion_tpu_torch.pipelines.latent import (
        LatentDiffStochasticPipeline,
        LatentDiffusionCore,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    core = LatentDiffusionCore.from_torch_ckpt(spec, ckpt, device=device, use_ema=True)
    pipe = LatentDiffStochasticPipeline(core, custom_steps=steps, eta=ETA,
                                        white_box_steps=steps + 1)
    with torch.no_grad():
        img = torch.as_tensor(images, device=device)
        x0 = core.encode_first_stage((img - 0.5) * 2.0)    # as the pipeline maps it
        z = pipe.encode(img, xT_noise=torch.as_tensor(x_t, device=device),
                        posterior_noises=torch.as_tensor(post, device=device))
        err = float((pipe.sample(z) - x0).abs().max())
    return err, float(x0.abs().max())


def jax_side(spec, ckpt, images, x_t, post, steps):
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    import jax.numpy as jnp

    from cyclediffusion_tpu.pipelines.latent import LatentDiffusionCore
    from cyclediffusion_tpu.samplers import ddim_decode, dpm_encode

    core = LatentDiffusionCore.from_torch_ckpt(spec, ckpt, use_ema=True)
    sched = core.make_ddim_schedule(steps, ETA)

    @jax.jit
    def run(params, image01, xt, pn):
        model_fn = lambda x, t: core.apply_model(x, t, None, params)  # noqa: E731
        x0 = core.encode_first_stage((image01 - 0.5) * 2.0, params=params)
        x_T, eps = dpm_encode(model_fn, sched, x0, jax.random.PRNGKey(0),
                              white_box_steps=steps + 1, xT_noise=xt, posterior_noises=pn)
        replay = ddim_decode(model_fn, sched, x_T, eps, jax.random.PRNGKey(1))
        return jnp.abs(replay - x0).max(), jnp.abs(x0).max()

    err, x0max = run(core.params, jnp.asarray(images), jnp.asarray(x_t), jnp.asarray(post))
    return float(err), float(x0max)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--vq-ch", type=int, default=32)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--images", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--side", choices=("both", "port"), default="both")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--no-mkldnn", action="store_true")
    args = ap.parse_args(argv)

    import torch

    torch.backends.mkldnn.enabled = not args.no_mkldnn

    from cyclediffusion_tpu_torch.pipelines.latent import LatentCoreSpec, LatentDiffusionCore
    from cyclediffusion_tpu_torch.tools.ldm_assets import write_ema_checkpoint

    torch.set_num_threads(min(8, os.cpu_count() or 1))
    spec = cut(LatentCoreSpec.ldm_ffhq256(), args.width, args.vq_ch)
    images, x_t, post = inputs(args.images, args.steps, args.seed)
    print(f"FFHQ LDM round trip, fp32: UNet model_channels {args.width} (published 224), "
          f"VQ ch {args.vq_ch} (128), {args.images} images at 256 px, {args.steps} steps, "
          f"eta {ETA}, seed {args.seed}"
          + (", oneDNN off" if args.no_mkldnn else ""), flush=True)
    with tempfile.TemporaryDirectory(prefix="ffhq_rt_") as root:
        ckpt = os.path.join(root, "model.ckpt")
        core = LatentDiffusionCore.random_init(spec, seed=0, device="cpu")
        write_ema_checkpoint(core, ckpt, raw_seed=2)
        del core
        t0 = time.perf_counter()
        err, x0max = port_side(spec, ckpt, images, x_t, post, args.steps, args.device)
        print(f"port ({args.device}): max|replay - x0| = {err!r}, max|x0| = {x0max!r} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        if args.side == "both":
            from cyclediffusion_tpu.pipelines.latent import LatentCoreSpec as JSpec

            t0 = time.perf_counter()
            jerr, jx0max = jax_side(cut(JSpec.ldm_ffhq256(), args.width, args.vq_ch), ckpt,
                                    images, x_t, post, args.steps)
            print(f"JAX package (cpu): max|replay - x0| = {jerr!r}, max|x0| = {jx0max!r} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
            print(f"port / JAX = {err / jerr!r}")


if __name__ == "__main__":
    main()
