"""No-op evaluator for source-only tasks (counterpart of
``cyclediffusion_tpu.evaluation.empty``)."""

from __future__ import annotations


class Evaluator:
    def __init__(self, args, meta_args):
        self.args = args
        self.meta_args = meta_args

    def evaluate(self, images, model, weighted_loss, losses, data, split):
        if split not in ("eval", "test"):
            raise ValueError(f"split {split!r}")
        return {}
