"""Multi-task dataset merge: upsampling, dev striding, model_kwargs projection
(counterpart of ``cyclediffusion_tpu.data.preprocess.to_model``).

Temperature upsampling of the train split, ``eval_num`` subsetting of the
dev split by stride, ``split`` / ``name`` tagging, ``MultiTaskDataset``
items projected to their ``model_kwargs``, the ``StrideWrapper`` /
``SplitArgpathWrapper`` helpers, and the test split falling back to dev.
A ``[raw_data]`` section without ``upsample_temp`` or ``eval_num`` (the SD
experiments have no ``eval_num``) means no upsampling and no striding.
"""

from __future__ import annotations

import math
from copy import deepcopy
from random import shuffle
from typing import Dict

import numpy as np


def upsample(data, weight):
    n_data = len(data)
    if weight < 1:
        raise ValueError(f"upsample weight {weight} < 1")
    integral = list(range(n_data)) * int(math.floor(weight))
    residual = list(range(n_data))
    shuffle(residual)
    residual = residual[: int(n_data * (weight - int(math.floor(weight))))]
    return [deepcopy(data[idx]) for idx in integral + residual]


class MultiTaskWrapper:
    def __init__(self, name2dataset, meta_args, split: str):
        name2data = {
            name: [dataset[idx] for idx in range(len(dataset))]
            for name, dataset in name2dataset.items()
        }

        temp = getattr(meta_args.raw_data, "upsample_temp", None)
        if temp and temp != 1 and split == "train":
            name2size = {name: len(d) for name, d in name2data.items()}
            sum_tau_size = sum(np.exp(np.log(size) / temp) for size in name2size.values())
            sum_size = sum(name2size.values())
            name2upsample = {
                name: np.exp(np.log(size) / temp) / sum_tau_size * sum_size / size
                for name, size in name2size.items()
            }
            largest, _ = max(name2size.items(), key=lambda x: x[1])
            norm = name2upsample[largest]
            for name in name2upsample:
                name2upsample[name] /= norm
            for name in sorted(name2data.keys()):
                name2data[name] = upsample(name2data[name], name2upsample[name])

        for name, data in name2data.items():
            for item in data:
                item["split"] = split
                item["name"] = name

        eval_num = getattr(meta_args.raw_data, "eval_num", None)
        if split == "dev" and eval_num:
            for name in name2data.keys():
                full = name2data[name]
                if eval_num < len(full):
                    stride = 1.0 * len(full) / eval_num
                    name2data[name] = [full[int(idx * stride)] for idx in range(eval_num)]

        self.dataset = []
        for name in sorted(name2data.keys()):
            self.dataset.extend(name2data[name])

    def __getitem__(self, index):
        return self.dataset[index]

    def __len__(self):
        return len(self.dataset)


class StrideWrapper:
    def __init__(self, dataset, stride: int):
        self.dataset = dataset
        self.index2old_index = [idx * stride for idx in range(len(dataset) // stride)]

    def __getitem__(self, index):
        return self.dataset[self.index2old_index[index]]

    def __len__(self):
        return len(self.index2old_index)


class SplitArgpathWrapper:
    def __init__(self, dataset, split: str, name: str):
        self.dataset = dataset
        self.split = split
        self.name = name

    def __getitem__(self, index):
        item = self.dataset[index]
        item["split"] = self.split
        item["name"] = self.name
        return item

    def __len__(self):
        return len(self.dataset)


class MultiTaskDataset:
    def __init__(self, meta_args, name2dataset: Dict[str, object], split: str):
        self.meta_args = meta_args
        self.data = MultiTaskWrapper(name2dataset=name2dataset, meta_args=meta_args,
                                     split=split)

    def __getitem__(self, index):
        data = self.data[index]
        return {k: data[k] for k in data["model_kwargs"]}

    def __len__(self):
        return len(self.data)


def get_multi_task_dataset_splits(meta_args, name2dataset_splits):
    name2train, name2dev, name2test = {}, {}, {}
    for name, splits in name2dataset_splits.items():
        name2train[name] = splits["train"]
        name2dev[name] = splits["dev"]
        name2test[name] = splits.get("test", splits["dev"])
    return {
        "train": MultiTaskDataset(meta_args, name2train, split="train"),
        "dev": MultiTaskDataset(meta_args, name2dev, split="dev"),
        "test": MultiTaskDataset(meta_args, name2test, split="test"),
    }
