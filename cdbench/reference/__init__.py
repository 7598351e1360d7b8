"""The benchmark's plain reference: the models and the sampler arithmetic
that the cells reach, written from the published CompVis / Hugging Face
architectures in plain PyTorch (float32, plain attention, TF32 off), under
the published state-dict names.

It imports nothing of the measured program and nothing of JAX; it reads
the weights the benchmark drew and the inputs the benchmark made, never
what the program derived from them.
"""
