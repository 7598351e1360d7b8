"""Meta-evaluator: group per-sample outputs by task name, run each task's
evaluator, namespace its metrics and add the cross-task ``avr`` (counterpart
of ``cyclediffusion_tpu.evaluation.multi_task``)."""

from __future__ import annotations

import numpy as np

from cyclediffusion_tpu_torch.runtime.config import get_config
from cyclediffusion_tpu_torch.runtime.registry import get_evaluator


class Evaluator:
    def __init__(self, meta_args):
        self.meta_args = meta_args

    def evaluate(self, images, model, weighted_loss, losses, dataset, split):
        if split not in ("eval", "test"):
            raise ValueError(f"split {split!r}")
        num_examples = len(dataset)
        if not len(weighted_loss) == num_examples == len(dataset.data):
            raise ValueError(f"{len(weighted_loss)} losses for {num_examples} samples")
        if any(len(v) != num_examples for v in losses.values()):
            raise ValueError("every loss needs one value per sample")
        if isinstance(images, (list, tuple)) and any(
                im is not None and len(im) != num_examples for im in images):
            raise ValueError("every image set needs one image per sample")

        name2eval_kwargs = {}
        for i in range(num_examples):
            name = dataset.data[i]["name"]
            if name not in name2eval_kwargs:
                name2eval_kwargs[name] = {
                    "images": [],
                    "model": model,
                    "weighted_loss": [],
                    "losses": {k: [] for k in losses.keys()},
                    "data": [],
                }
            kw = name2eval_kwargs[name]
            if isinstance(images, (list, tuple)):
                kw["images"].append(tuple(im[i] if im is not None else None for im in images))
            elif images is None:
                kw["images"].append(None)
            else:
                kw["images"].append(images[i])
            kw["weighted_loss"].append(weighted_loss[i])
            for k, v in losses.items():
                kw["losses"][k].append(v[i])
            kw["data"].append(dataset.data[i])

        summary = {}
        for name, eval_kwargs in name2eval_kwargs.items():
            args = get_config(getattr(self.meta_args.arg_paths, name))
            evaluator = get_evaluator(args.evaluation.evaluator_program)(args, self.meta_args)
            for key, metric in evaluator.evaluate(**eval_kwargs, split=split).items():
                summary[f"{name}/{key}"] = metric

        if summary:
            summary["avr"] = float(np.mean([float(v) for v in summary.values()]))
        return summary
