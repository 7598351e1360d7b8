"""Evaluation and training driver with the reference Trainer's surface
(counterpart of ``cyclediffusion_tpu.runtime.driver``).

* :class:`EvalLoader`: a contiguous shard per process, then fixed-size
  batches (the last one ragged); array entries are stacked into numpy
  batches, everything else listed.
* :func:`gather_sharded_outputs`: every eval output gathered across
  processes, in dataset order, by an all-gather over the process group's
  gloo side on host arrays (or an injected ``allgather``).
* :class:`Driver`: ``evaluate`` / ``predict`` (the task model's outputs
  come back to numpy float32; rank 0 alone computes metrics, visualises and
  saves), the visualizer, ``log`` with the optional wandb run,
  ``log_metrics`` / ``save_metrics`` with the combined
  ``all_results.json``, checkpoints (``model_params.msgpack`` as the JAX
  driver writes it: each wrapper's weights as the JAX wrapper's Flax tree,
  ``convert.to_jax``, and any ``trainable_params``, in Flax's msgpack;
  the port's earlier ``model_params.pt`` is still read), ``training_args.json``,
  ``trainer_state.json``, the numpy RNG state, ``save_total_limit``
  rotation that keeps the best checkpoint.
* ``train``: the JAX driver's optimiser loop (``runtime.optim``) for a
  model with ``trainable_params`` and ``loss_fn``, the reference
  experiments' no-op otherwise.

One process drives one GPU: the process group (``parallel.init_distributed``)
gives the process's index and count, and there is no further split of a
batch over devices inside a process (JAX's ``_shard_batch``), since a
process's shard of the split is its device's.
"""

from __future__ import annotations

import json
import logging
import math
import os
import re
import shutil
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from cyclediffusion_tpu_torch.convert import flax_msgpack
from cyclediffusion_tpu_torch.convert.from_jax import load_flax_params
from cyclediffusion_tpu_torch.convert.to_jax import module_to_flax
from cyclediffusion_tpu_torch.parallel.mesh import all_gather_cat, process_position
from cyclediffusion_tpu_torch.runtime import optim

logger = logging.getLogger(__name__)

PREFIX_CHECKPOINT_DIR = "checkpoint"
_WRAPPERS = ("gan_wrapper", "source_gan_wrapper", "target_gan_wrapper")


def speed_metrics(split: str, start_time: float, num_samples: int = None,
                  num_steps: int = None) -> Dict[str, float]:
    runtime = time.time() - start_time
    result = {f"{split}_runtime": round(runtime, 4)}
    if runtime == 0:
        return result
    if num_samples is not None:
        result[f"{split}_samples_per_second"] = round(num_samples / runtime, 3)
    if num_steps is not None:
        result[f"{split}_steps_per_second"] = round(num_steps / runtime, 3)
    return result


class EvalLoader:
    """Shard-and-batch an eval dataset: a contiguous shard per process, each
    wrap-padded to ``ceil(n / process_count)`` items when there are several
    processes (uniform gather shapes; the gather truncates the duplicates)."""

    def __init__(self, dataset, batch_size: int, process_index: int = 0,
                 process_count: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        n = len(dataset)
        per = math.ceil(n / process_count)
        self.indices = list(range(process_index * per, min((process_index + 1) * per, n)))
        if process_count > 1 and n > 0:
            while len(self.indices) < per:
                self.indices.append(len(self.indices) % n)

    def __iter__(self):
        for i in range(0, len(self.indices), self.batch_size):
            items = [self.dataset[j] for j in self.indices[i:i + self.batch_size]]
            batch = {}
            for k in items[0].keys():
                vals = [it[k] for it in items]
                batch[k] = np.stack(vals) if isinstance(vals[0], np.ndarray) else vals
            yield batch

    def __len__(self):
        return math.ceil(len(self.indices) / self.batch_size) if self.indices else 0


def _pad_leading(a: np.ndarray, width: int) -> np.ndarray:
    if a.shape[0] >= width:
        return a[:width]
    pad = np.zeros((width - a.shape[0],) + a.shape[1:], a.dtype)
    return np.concatenate([a, pad], axis=0)


def _host_allgather(a: np.ndarray) -> np.ndarray:
    """Every process's ``a`` (equal shapes) stacked in rank order, over the
    process group (host tensors take its gloo side)."""
    return all_gather_cat(torch.from_numpy(np.ascontiguousarray(a))[None]).numpy()


def gather_sharded_outputs(arrays, n: int, process_count: int, allgather=None):
    """Each value's leading axis is this process's contiguous shard: pad to
    ``ceil(n / process_count)``, gather process-major with ``allgather``
    (default: an all-gather over the process group), flatten and truncate
    to ``n``, preserving dataset order.  Several processes without a group
    or an ``allgather`` raise."""
    if process_count <= 1:
        return {k: _pad_leading(np.asarray(v), n) for k, v in arrays.items()}
    if allgather is None:
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(f"gathering over {process_count} processes needs a process "
                               "group (parallel.init_distributed) or an allgather")
        allgather = _host_allgather
    per = math.ceil(n / process_count)
    out = {}
    for k, v in arrays.items():
        g = np.asarray(allgather(_pad_leading(np.asarray(v), per)))
        out[k] = g.reshape((-1,) + g.shape[2:])[:n]
    return out


def to_numpy(x) -> np.ndarray:
    """A task model's output (a tensor on any device, or an array) -> numpy
    float32."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


class TrainerState:
    """The HF TrainerState subset the reference persists."""

    def __init__(self):
        self.epoch = 0.0
        self.global_step = 0
        self.best_metric = None
        self.best_model_checkpoint = None
        self.log_history: List[dict] = []

    def to_dict(self):
        return dict(self.__dict__)

    def save(self, path):
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)

    @classmethod
    def load(cls, path):
        st = cls()
        with open(path) as f:
            st.__dict__.update(json.load(f))
        return st


def _wrapper_module(wrapper):
    """The module that holds a wrapper's weights: a latent pipeline's core,
    a pixel pipeline's UNet."""
    return wrapper.core if hasattr(wrapper, "core") else wrapper.model


def _numpy_tree(tree):
    """A Flax tree read from msgpack with its bfloat16 tensors as float32
    numpy (exact)."""
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return tree.float().numpy() if isinstance(tree, torch.Tensor) else tree


def _to_tensor(leaf, device) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf.to(device)
    return torch.as_tensor(np.array(leaf), device=device)


def _jax_params(module) -> dict:
    """The JAX wrapper's parameter tree of the module that holds the port's
    weights: a latent core's ``{"unet", "first_stage"[, "cond"]}``, else
    the module's own Flax variables."""
    if hasattr(module, "jax_params"):
        return module.jax_params()
    return module_to_flax(module)


def _load_jax_params(module, tree: dict) -> None:
    """A JAX wrapper's saved parameters into the module that holds the port's
    (``_wrapper_module``): a latent core maps its own ``{"unet",
    "first_stage"[, "cond"]}``; any other module is the tree's Flax module."""
    if hasattr(module, "load_jax_params"):
        module.load_jax_params(tree)
    else:
        load_flax_params(module, tree)


def _dump_json(obj, path) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=4, sort_keys=True, default=float)


class Driver:
    """train() / evaluate() / predict() with the reference Trainer surface."""

    def __init__(self, args, model, compute_metrics=None, train_dataset=None,
                 eval_dataset=None, visualizer=None):
        self.args = args
        self.model = model
        self.compute_metrics = compute_metrics
        self.train_dataset = train_dataset
        self.eval_dataset = eval_dataset
        self.visualizer = visualizer
        self.state = TrainerState()
        self.process_index, self.process_count = process_position()
        os.makedirs(args.output_dir, exist_ok=True)

    # ---- logging / metrics ------------------------------------------------ #

    def is_world_process_zero(self) -> bool:
        return self.process_index == 0

    def _wandb(self):
        """The rank-0 wandb module when ``report_to`` names it and it is
        installed, else None (metrics then go to the console and JSON)."""
        if not hasattr(self, "_wandb_run"):
            self._wandb_run = None
            report_to = str(getattr(self.args, "report_to", "none") or "none")
            if self.is_world_process_zero() and "wandb" in report_to:
                try:
                    import wandb
                except ImportError:
                    logger.warning("report_to includes 'wandb' but wandb is not "
                                   "installed; metrics go to console/JSON only.")
                else:
                    if wandb.run is None:
                        wandb.init(
                            project=os.environ.get("WANDB_PROJECT", "cyclediffusion_tpu"),
                            name=os.path.basename(str(getattr(self.args, "cfg", "run"))),
                            config={k: v for k, v in vars(self.args).items()
                                    if isinstance(v, (int, float, str, bool))})
                    self._wandb_run = wandb
        return self._wandb_run

    def log(self, logs: dict) -> None:
        logs["step"] = self.state.global_step
        self.state.log_history.append(logs)
        logger.info("%s", logs)
        wb = self._wandb()
        if wb is not None:
            wb.log(logs, step=self.state.global_step)

    def metrics_format(self, metrics: dict) -> dict:
        out = {}
        for k, v in metrics.items():
            if "_runtime" in k:
                out[k] = f"{v}s"
            elif isinstance(v, float):
                out[k] = round(v, 4)
            else:
                out[k] = v
        return out

    def log_metrics(self, split: str, metrics: dict) -> None:
        if not self.is_world_process_zero():
            return
        print(f"***** {split} metrics *****")
        fmt = self.metrics_format(metrics)
        width = max((len(str(k)) for k in fmt), default=0)
        for key in sorted(fmt.keys()):
            print(f"  {key: <{width}} = {fmt[key]}")

    def save_metrics(self, split: str, metrics: dict, combined: bool = True) -> None:
        if not self.is_world_process_zero():
            return
        _dump_json(metrics, os.path.join(self.args.output_dir, f"{split}_results.json"))
        if combined:
            all_path = os.path.join(self.args.output_dir, "all_results.json")
            all_metrics = {}
            if os.path.exists(all_path):
                with open(all_path) as f:
                    all_metrics = json.load(f)
            all_metrics.update(metrics)
            _dump_json(all_metrics, all_path)

    # ---- checkpointing ---------------------------------------------------- #

    def _sorted_checkpoints(self) -> List[str]:
        out_dir = self.args.output_dir
        paths = []
        for name in os.listdir(out_dir):
            m = re.match(rf"{PREFIX_CHECKPOINT_DIR}-(\d+)$", name)
            full = os.path.join(out_dir, name)
            if m and os.path.isdir(full):
                paths.append((int(m.group(1)), full))
        ordered = [p for _, p in sorted(paths)]
        best = self.state.best_model_checkpoint
        if best and best in ordered:      # never rotate the best one out
            ordered.remove(best)
            ordered.append(best)
        return ordered

    def _rotate_checkpoints(self) -> None:
        limit = getattr(self.args, "save_total_limit", None)
        if not limit or limit <= 0:
            return
        ckpts = self._sorted_checkpoints()
        while len(ckpts) > limit:
            victim = ckpts.pop(0)
            logger.info("Deleting older checkpoint %s", victim)
            shutil.rmtree(victim, ignore_errors=True)

    def _gather_model_params(self) -> dict:
        """The tree the JAX driver saves: each wrapper's JAX parameter tree,
        and the tree being optimised (``trainable_params``), if any."""
        params = {}
        for attr in _WRAPPERS:
            wrapper = getattr(self.model, attr, None)
            if wrapper is not None:
                params[attr] = _jax_params(_wrapper_module(wrapper))
        trainable = getattr(self.model, "trainable_params", None)
        if trainable is not None:
            params["trainable_params"] = trainable
        return params

    def save_model(self, output_dir: Optional[str] = None) -> None:
        """Each wrapper's weights (and any ``trainable_params``) into
        ``model_params.msgpack``, as the JAX driver writes it (streamed, in
        the modules' dtypes), the scalar arguments into
        ``training_args.json``."""
        if not self.is_world_process_zero():
            return
        output_dir = output_dir or self.args.output_dir
        os.makedirs(output_dir, exist_ok=True)
        flax_msgpack.write(os.path.join(output_dir, "model_params.msgpack"),
                           self._gather_model_params())
        with open(os.path.join(output_dir, "training_args.json"), "w") as f:
            json.dump({k: v for k, v in vars(self.args).items()
                       if isinstance(v, (int, float, str, bool, type(None)))}, f, indent=2)

    def load_model(self, checkpoint_dir: str) -> None:
        """``model_params.msgpack`` (written by either driver: each wrapper's
        Flax tree through ``convert.from_jax``), or else an earlier port
        checkpoint's ``model_params.pt``."""
        path = os.path.join(checkpoint_dir, "model_params.msgpack")
        pt = os.path.join(checkpoint_dir, "model_params.pt")
        if not os.path.exists(path) and os.path.exists(pt):
            restored = torch.load(pt, map_location="cpu", weights_only=True)
            for attr, params in restored.items():
                if attr == "trainable_params":
                    self._restore_trainable(params)
                else:
                    _wrapper_module(getattr(self.model, attr)).load_state_dict(params)
            return
        if not os.path.exists(path):
            raise FileNotFoundError(f"{checkpoint_dir} holds neither model_params.msgpack nor "
                                    "model_params.pt")
        for attr, tree in flax_msgpack.read(path).items():
            if attr == "trainable_params":
                self._restore_trainable(tree)
            else:
                _load_jax_params(_wrapper_module(getattr(self.model, attr)),
                                 _numpy_tree(tree))

    def _restore_trainable(self, tree: dict) -> None:
        """Restored ``trainable_params`` as tensors, each on the device of the
        model's own (the CPU for a name it lacks)."""
        old = getattr(self.model, "trainable_params", None) or {}
        self.model.trainable_params = {k: _to_tensor(v, getattr(old.get(k), "device", "cpu"))
                                       for k, v in tree.items()}

    def _save_checkpoint(self, metrics: Optional[dict] = None) -> None:
        ckpt_dir = os.path.join(self.args.output_dir,
                                f"{PREFIX_CHECKPOINT_DIR}-{self.state.global_step}")
        self.save_model(ckpt_dir)
        mkey = getattr(self.args, "metric_for_best_model", None)
        if metrics is not None and mkey:
            mkey = mkey if mkey.startswith("eval_") else f"eval_{mkey}"
            value = metrics.get(mkey)
            greater = getattr(self.args, "greater_is_better", True)
            if value is not None and (self.state.best_metric is None
                                      or (value > self.state.best_metric) == bool(greater)):
                self.state.best_metric = float(value)
                self.state.best_model_checkpoint = ckpt_dir
        if self.is_world_process_zero():
            self.state.save(os.path.join(ckpt_dir, "trainer_state.json"))
            np.save(os.path.join(ckpt_dir, f"rng_state_{self.process_index}.npy"),
                    np.random.get_state()[1])
            self._rotate_checkpoints()

    # ---- evaluation ------------------------------------------------------- #

    def evaluation_loop(self, dataset, description: str, split: str):
        batch_size = getattr(self.args, "per_device_eval_batch_size", 1)
        loader = EvalLoader(dataset, batch_size, self.process_index, self.process_count)
        logger.info("***** Running %s *****", description)
        logger.info("  Num examples = %d", len(dataset))
        logger.info("  Batch size = %d", batch_size)

        originals, translated, losses_acc = [], [], []
        losses_dict: Dict[str, list] = {}
        for batch in loader:
            (orig, img), weighted_loss, losses = self.model.forward(**batch)
            originals.append(to_numpy(orig))
            translated.append(to_numpy(img))
            losses_acc.extend(to_numpy(weighted_loss).tolist())
            for k, v in losses.items():
                losses_dict.setdefault(k, []).extend(to_numpy(v).tolist())

        n = len(dataset)
        gathered = gather_sharded_outputs(
            {
                "orig": np.concatenate(originals) if originals else np.zeros((0,)),
                "trans": np.concatenate(translated) if translated else np.zeros((0,)),
                "weighted_loss": np.asarray(losses_acc, np.float32),
                **{f"loss/{k}": np.asarray(v, np.float32) for k, v in losses_dict.items()},
            },
            n=n, process_count=self.process_count)
        local_orig, local_trans = gathered["orig"], gathered["trans"]
        losses_acc = gathered["weighted_loss"].tolist()
        losses_dict = {k: gathered[f"loss/{k}"].tolist() for k in losses_dict}

        metrics = {}
        if self.compute_metrics is not None and self.is_world_process_zero():
            metrics = self.compute_metrics(images=(local_orig, local_trans), model=self.model,
                                           weighted_loss=losses_acc, losses=losses_dict,
                                           dataset=dataset, split=split)
        metrics = {f"{split}_{k}": v for k, v in metrics.items()}
        return (local_orig, local_trans), metrics

    def evaluate(self, eval_dataset=None):
        dataset = eval_dataset if eval_dataset is not None else self.eval_dataset
        start = time.time()
        images, metrics = self.evaluation_loop(dataset, "Evaluation", "eval")
        metrics.update(speed_metrics("eval", start, num_samples=len(dataset)))
        self.log(dict(metrics))
        if self.visualizer is not None and self.is_world_process_zero():
            self.visualize(images, "eval")
        return metrics

    def predict(self, test_dataset):
        start = time.time()
        images, metrics = self.evaluation_loop(test_dataset, "Prediction", "test")
        metrics.update(speed_metrics("test", start, num_samples=len(test_dataset)))
        self.log(dict(metrics))
        if self.visualizer is not None and self.is_world_process_zero():
            self.visualize(images, "test")
        return images, metrics

    def visualize(self, images, description: str) -> None:
        save_dir = os.path.join(self.args.output_dir, "visualization")
        os.makedirs(save_dir, exist_ok=True)
        self.visualizer.visualize(images=images, model=self.model, description=description,
                                  save_dir=save_dir, step=self.state.global_step)

    # ---- training --------------------------------------------------------- #

    def _build_optimizer(self, params: List[torch.Tensor]):
        """-> (the global-norm clip, the optimiser): AdamW (default) or
        Adafactor on the learning-rate schedule, as the JAX driver builds
        them with optax."""
        a = self.args
        lr = float(getattr(a, "learning_rate", 5e-5))
        schedule = optim.build_schedule(lr, int(getattr(a, "warmup_steps", 0)),
                                        int(getattr(a, "max_steps", 0)),
                                        getattr(a, "lr_scheduler_type", "constant"))
        return (float(getattr(a, "max_grad_norm", 1.0)),
                optim.build_optimizer(params, getattr(a, "optim", "adamw"), schedule,
                                      float(getattr(a, "weight_decay", 0.0))))

    def _allreduce_mean(self, tensors: List[torch.Tensor]) -> None:
        """The mean across processes in place (DDP's gradient averaging, JAX's
        ``process_allgather(g).mean(0)``): an all-reduce on the tensors'
        backend, whenever a group is joined (one rank included)."""
        if not (dist.is_available() and dist.is_initialized()):
            if self.process_count > 1:
                raise RuntimeError(f"{self.process_count} processes and no process group")
            return
        for t in tensors:
            dist.all_reduce(t)
            t.div_(self.process_count)

    def _train_batch(self, items: list, device) -> dict:
        """Items stacked as the JAX driver stacks them; arrays become tensors
        on ``device``."""
        return {k: (torch.as_tensor(np.stack([it[k] for it in items]), device=device)
                    if isinstance(items[0][k], (np.ndarray, np.generic))
                    else [it[k] for it in items])
                for k in items[0]}

    def train(self, resume_from_checkpoint: Optional[str] = None):
        """The JAX driver's training loop for a model with
        ``trainable_params`` (a dict of tensors) and
        ``loss_fn(params, batch, generator) -> loss``: a seeded permutation
        per epoch, the rank-strided shard ``order[rank::count]``, gradients
        summed over ``gradient_accumulation_steps`` micro-batches then
        divided, averaged across processes, clipped by global norm and
        applied; the accumulation resets at each epoch.  ``logging_steps``,
        ``save_steps`` (with ``evaluate`` when ``metric_for_best_model`` is
        set), ``load_best_model_at_end``.  The generator (seeded with
        ``seed``) stands where JAX splits a key per micro-batch.  Without
        trainable parameters, a loss, epochs or data: the reference
        experiments' logged no-op."""
        if resume_from_checkpoint:
            self.load_model(resume_from_checkpoint)
            state_path = os.path.join(resume_from_checkpoint, "trainer_state.json")
            if os.path.exists(state_path):
                self.state = TrainerState.load(state_path)

        epochs = int(getattr(self.args, "num_train_epochs", 0))
        n_train = len(self.train_dataset) if self.train_dataset else 0
        trainable = getattr(self.model, "trainable_params", None)
        loss_fn = getattr(self.model, "loss_fn", None)
        start = time.time()
        if epochs <= 0 or n_train == 0 or trainable is None or loss_fn is None:
            logger.info(
                "No training to do (num_train_epochs=%d, train examples=%d, "
                "trainable=%s) — matching the reference's inference-only usage.",
                epochs, n_train, trainable is not None)
            metrics = speed_metrics("train", start, num_samples=0, num_steps=0)
            self.log(dict(metrics))
            return metrics

        batch_size = int(getattr(self.args, "per_device_train_batch_size", 1))
        accum = int(getattr(self.args, "gradient_accumulation_steps", 1))
        logging_steps = int(getattr(self.args, "logging_steps", 10))
        save_steps = int(getattr(self.args, "save_steps", 0))
        seed = int(getattr(self.args, "seed", 0))

        params = {k: torch.as_tensor(v).detach().clone().requires_grad_(True)
                  for k, v in trainable.items()}
        plist = list(params.values())
        device = plist[0].device
        max_norm, opt = self._build_optimizer(plist)
        rng = np.random.RandomState(seed)
        generator = torch.Generator(device=device).manual_seed(seed)

        def publish():
            self.model.trainable_params = {k: p.detach().clone() for k, p in params.items()}

        steps, loss, shard = 0, None, []
        for epoch in range(epochs):
            # a ragged tail of micro-batches must not leak into the next epoch
            for p in plist:
                p.grad = None
            order = rng.permutation(n_train)
            shard = order[self.process_index::self.process_count]
            for i in range(0, len(shard) - batch_size + 1, batch_size):
                items = [self.train_dataset[int(j)] for j in shard[i:i + batch_size]]
                loss = loss_fn(params, self._train_batch(items, device), generator)
                loss.backward()           # sums the micro-batches' gradients
                if (i // batch_size + 1) % accum:
                    continue
                grads = [p.grad for p in plist]
                with torch.no_grad():
                    for g in grads:
                        g.div_(accum)
                self._allreduce_mean(grads)
                optim.clip_by_global_norm_(grads, max_norm)
                opt.step()
                for p in plist:
                    p.grad = None
                steps += 1
                self.state.global_step = steps
                if logging_steps and steps % logging_steps == 0:
                    self.log({"loss": float(loss.detach()), "epoch": epoch})
                if save_steps and steps % save_steps == 0:
                    publish()
                    metrics = (self.evaluate()
                               if getattr(self.args, "metric_for_best_model", None) else None)
                    self._save_checkpoint(metrics)
            self.state.epoch = float(epoch + 1)

        publish()
        if getattr(self.args, "load_best_model_at_end", False) \
                and self.state.best_model_checkpoint:
            logger.info("Loading best model from %s (score: %s)",
                        self.state.best_model_checkpoint, self.state.best_metric)
            self.load_model(self.state.best_model_checkpoint)
        metrics = speed_metrics("train", start, num_samples=n_train * epochs, num_steps=steps)
        if loss is not None:
            metrics["train_loss"] = float(loss.detach())
        else:
            logger.warning("No optimizer step ran: per-process shard (%d examples) is smaller "
                           "than per_device_train_batch_size=%d.", len(shard), batch_size)
        self.log(dict(metrics))
        return metrics
