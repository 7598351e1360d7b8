"""The port's command line (counterpart of the repository's ``main.py``):

    python -m cyclediffusion_tpu_torch.main \
        --cfg experiments/translate_text2img256_stable_diffusion_stochastic_1.cfg \
        --output_dir output/sd_1 --seed 42 --do_eval --per_device_eval_batch_size 1

config -> data preprocessing -> task model (through the registry and the
pipeline factory) -> :class:`Driver` -> evaluator and visualizer.  Output
goes under ``--output_dir``: ``eval_results.json``, ``all_results.json``,
``eval_results.csv``, ``temp_gen/*.png`` and ``visualization/*.png``.

The command line runs on the card and raises without one; Python callers
may pass ``main(argv, device="cpu")``.  On N GPUs, one process each:

    torchrun --nproc_per_node N -m cyclediffusion_tpu_torch.main --cfg ...

Under torchrun (``WORLD_SIZE > 1``) each process joins the process group
(``parallel.init_distributed``) and runs on ``cuda:LOCAL_RANK``; the
evaluation split is sharded over the processes and gathered back in
dataset order, and rank 0 alone writes metrics and images; ``main`` leaves
the group it joined when it returns.  A caller that has joined a group
already keeps it and its ``device``.  Launch flags of
the reference (``--local_rank``, ``--ddp_find_unused_parameters``, ...) are
accepted and ignored.  Assets: ``CYCLEDIFFUSION_CKPT_ROOT`` (``ckpts/`` lives under it),
``CYCLEDIFFUSION_CLIP_BPE``, ``CYCLEDIFFUSION_CLIP_CKPT``,
``CYCLEDIFFUSION_DATA_ROOT`` (``data/`` lives under it).
"""

from __future__ import annotations

import argparse
import logging
import os
import random

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)


def parse_training_args(argv=None):
    """The HF-style flags of the reference README; unknown flags are
    accepted with a warning so reference launch scripts keep working."""
    p = argparse.ArgumentParser("cyclediffusion_tpu_torch")
    p.add_argument("--cfg", required=True)
    p.add_argument("--output_dir", default="output/run")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--do_train", action="store_true")
    p.add_argument("--do_eval", action="store_true")
    p.add_argument("--do_predict", action="store_true")
    p.add_argument("--num_train_epochs", type=float, default=0)
    p.add_argument("--per_device_train_batch_size", type=int, default=1)
    p.add_argument("--per_device_eval_batch_size", type=int, default=1)
    p.add_argument("--eval_accumulation_steps", type=int, default=1)
    p.add_argument("--metric_for_best_model", default=None)
    p.add_argument("--greater_is_better", type=lambda s: s != "False", default=True)
    p.add_argument("--save_total_limit", type=int, default=None)
    p.add_argument("--resume_from_checkpoint", default=None)
    p.add_argument("--report_to", default="none")
    p.add_argument("--run_name", default=None)
    p.add_argument("--verbose", action="store_true")
    args, unknown = p.parse_known_args(argv)
    if unknown:
        logger.warning("ignoring unknown flags (reference-compat): %s", unknown)
    return args


def set_seed(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def get_dataset_splits(args):
    """Every task of ``[arg_paths]`` through its raw-data program and
    preprocessor, merged into the multi-task train / dev / test splits."""
    from cyclediffusion_tpu_torch.data import build_raw_datasets, get_multi_task_dataset_splits
    from cyclediffusion_tpu_torch.runtime.config import get_config
    from cyclediffusion_tpu_torch.runtime.registry import get_preprocessor

    cache_root = os.path.join(args.output_dir, "cache")
    name2dataset_splits = {}
    for name, arg_path in args.arg_paths:
        task_args = get_config(arg_path)
        raw_splits = build_raw_datasets(task_args.raw_data.data_program)
        preprocessor = get_preprocessor(task_args.preprocess.preprocess_program)
        name2dataset_splits[name] = preprocessor(task_args, args).preprocess(raw_splits,
                                                                             cache_root)
    return get_multi_task_dataset_splits(meta_args=args,
                                         name2dataset_splits=name2dataset_splits)


def process_device(device) -> torch.device:
    """``device`` checked (a CUDA device must exist); with several processes
    (torchrun's ``WORLD_SIZE > 1``, or a group already joined) the process
    group is joined and an unqualified ``"cuda"`` becomes
    ``cuda:LOCAL_RANK``, the current device."""
    from cyclediffusion_tpu_torch.models.nn import resolve_device
    from cyclediffusion_tpu_torch.parallel import init_distributed

    device = resolve_device(device)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 or dist.is_initialized():
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        if device.type == "cuda":
            torch.cuda.set_device(device)
        init_distributed()
    return device


def main(argv=None, *, device="cuda"):
    from cyclediffusion_tpu_torch.runtime.config import get_config
    from cyclediffusion_tpu_torch.runtime.driver import Driver
    from cyclediffusion_tpu_torch.runtime.registry import (
        get_evaluator,
        get_model,
        get_visualizer,
    )

    joins = not dist.is_initialized()
    device = process_device(device)
    training_args = parse_training_args(argv)
    set_seed(training_args.seed)
    args = get_config(training_args.cfg)
    os.makedirs(training_args.output_dir, exist_ok=True)
    args.output_dir = training_args.output_dir

    dataset_splits = get_dataset_splits(args)
    evaluator = get_evaluator(args.evaluation.evaluator_program)(args)
    visualizer = get_visualizer(args.visualization.visualizer_program)(args)
    model = get_model(args.model.name)(args, base_seed=training_args.seed, device=device)

    driver = Driver(args=training_args, model=model, compute_metrics=evaluator.evaluate,
                    train_dataset=dataset_splits["train"], eval_dataset=dataset_splits["dev"],
                    visualizer=visualizer)
    logger.info("Driver built on %s (process %d/%d).", device, driver.process_index,
                driver.process_count)

    if training_args.resume_from_checkpoint:
        driver.load_model(training_args.resume_from_checkpoint)

    if training_args.do_train:
        metrics = driver.train()
        driver.save_model()
        metrics["train_samples"] = len(dataset_splits["train"])
        driver.log_metrics("train", metrics)
        driver.save_metrics("train", metrics)

    logger.info("*** Evaluate ***")
    metrics = driver.evaluate()
    metrics["eval_samples"] = len(dataset_splits["dev"])
    driver.log_metrics("eval", metrics)
    driver.save_metrics("eval", metrics)

    if training_args.do_predict:
        logger.info("*** Predict ***")
        _, metrics = driver.predict(dataset_splits["test"])
        metrics["predict_samples"] = len(dataset_splits["test"])
        driver.log_metrics("predict", metrics)
        driver.save_metrics("predict", metrics)
    if joins and dist.is_initialized():
        # no rank leaves while another still talks to it (a rank that exits
        # with the group's threads alive aborts)
        dist.barrier()
        dist.destroy_process_group()
    return metrics


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
