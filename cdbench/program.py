"""The measured program's side: a configuration's core, built by the port
through the configuration's model family (``cores/<family>.py``) from the
benchmark's seeded state dict, and the tokenizer its prompts go through.

A family's core module gives ``load_core(cfg, state_dict, device, dtype)``,
a frozen core with the port's entry points (``apply_model``,
``get_learned_conditioning``, ``encode_first_stage``,
``decode_first_stage``, ``make_ddim_schedule``), and ``tokenizer(cfg)``.
"""

from __future__ import annotations

import cyclediffusion_tpu_torch  # noqa: F401  (the program: without it no run gives a result)
from cdbench.registry import family


def load_core(cfg: dict, state_dict: dict, device, dtype):
    """A frozen core holding ``state_dict``'s values (the published names)."""
    return family(cfg, "cores").load_core(cfg, state_dict, device, dtype)


def tokenizer(cfg: dict):
    """The tokenizer of the core's conditioning prompts."""
    return family(cfg, "cores").tokenizer(cfg)
