"""CycleDiffusion in PyTorch and CUDA for NVIDIA Hopper (H100).

The port of ``cyclediffusion_tpu`` (the JAX package, which stays the
reference): the SD-v1 text-guided translate path — CLIP text conditioning,
VAE encode, DPM-Encoder, CFG eps-replay, VAE decode — with the two Pallas
flash-attention kernels on that path replaced by hand-written CUDA C++
kernels (``csrc/flash_attention.cu``).

The command line ``python -m cyclediffusion_tpu_torch.main --cfg
experiments/<name>.cfg ...`` runs an experiment end to end: config, data
(``data/``), task model from a CompVis SD v1 checkpoint, the evaluation
driver (``runtime/driver.py``), evaluators and visualizer.

Module paths mirror the JAX package (``ops/``, ``models/``, ``samplers/``,
``pipelines/``, ``data/``, ``evaluation/``, ``runtime/``).  Public functions
keep its layout: images NHWC in [0, 1]; latents and eps stacks NHWC,
time-major ``(n, B, h, w, c)``.  This package imports ``torch`` and never
``jax`` or ``flax`` (nor Pillow, OpenCV or pandas).
"""

__version__ = "0.1.0"
