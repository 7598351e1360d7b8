"""Shared dataset scaffolding for the per-task preprocessors (counterpart of
``cyclediffusion_tpu.data.preprocess.common``)."""

from __future__ import annotations

import os
from typing import Callable, Dict, List

import numpy as np

from cyclediffusion_tpu_torch.data.transforms import data_root


class EmptyTrainDataset:
    """Train splits are empty for zero-shot tasks."""

    def __getitem__(self, index):
        raise NotImplementedError()

    def __len__(self):
        return 0


class ListDataset:
    def __init__(self, items: List[dict], getter: Callable[[dict], dict]):
        self.items = items
        self.getter = getter

    def __getitem__(self, index):
        return self.getter(dict(self.items[index]))

    def __len__(self):
        return len(self.items)


class PreprocessorBase:
    """``preprocess(raw_datasets, cache_root) -> {'train', 'dev'}``."""

    def __init__(self, args, meta_args):
        self.args = args
        self.meta_args = meta_args

    def build_dev(self):
        raise NotImplementedError

    def preprocess(self, raw_datasets, cache_root: str) -> Dict[str, object]:
        if len(raw_datasets) != 3:
            raise ValueError(f"expected train/validation/test raw splits, got {list(raw_datasets)}")
        return {"train": EmptyTrainDataset(), "dev": self.build_dev()}


def sample_id(idx: int) -> np.ndarray:
    return np.asarray(idx, dtype=np.int64)


def resolve_path(path: str) -> str:
    if os.path.isabs(path):
        return path
    return os.path.join(data_root(), path.lstrip("./"))
