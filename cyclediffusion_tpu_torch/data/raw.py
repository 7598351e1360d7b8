"""Raw-data stub: 1000 ids for each of three splits (counterpart of
``cyclediffusion_tpu.data.raw``; the reference's ``raw_data/empty.py``).
The preprocessors attach the real data."""

from __future__ import annotations

_N = 1000


def build_raw_datasets(data_program: str = "empty"):
    if data_program not in ("empty", "empty.py", "raw_data/empty.py"):
        raise ValueError(f"unknown raw data program: {data_program}")
    return {split: [{"id": n} for n in range(_N)] for split in ("train", "validation", "test")}
