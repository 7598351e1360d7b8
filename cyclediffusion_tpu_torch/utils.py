"""Shared constants (counterpart of ``cyclediffusion_tpu.utils``)."""

MAX_SAMPLE_SIZE = 4096  # the reference's model/model_utils.py:1
