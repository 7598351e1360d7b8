"""Schedules, per-step sampler math, classifier-free guidance and the
flash-attention kernels."""
