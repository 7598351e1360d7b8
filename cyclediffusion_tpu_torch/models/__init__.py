"""PyTorch model backbones for the SD-v1 path: the cross-attention UNet, the
KL first-stage VAE and the CLIP text encoder.

Public ``forward``s take the JAX package's NHWC layout; the modules run NCHW
inside (cuDNN's layout).  Parameter names follow the JAX package's Flax names
with ``_<index>`` turned into ``.<index>`` (``input_blocks_3_0`` ->
``input_blocks.3.0``), which is also the reference's state-dict naming; see
``cyclediffusion_tpu_torch.convert.from_jax``.
"""
