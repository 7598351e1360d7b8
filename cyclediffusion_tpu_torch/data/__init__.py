"""Data pipeline: raw id builder, per-task preprocessors, multi-task merge
(counterpart of ``cyclediffusion_tpu.data``).

Images are float32 HWC numpy in [0, 1]; datasets are plain
``__getitem__`` / ``__len__`` objects.  Data paths resolve against
``CYCLEDIFFUSION_DATA_ROOT`` (default: the working directory).
"""

from cyclediffusion_tpu_torch.data.preprocess.to_model import (  # noqa: F401
    get_multi_task_dataset_splits,
)
from cyclediffusion_tpu_torch.data.raw import build_raw_datasets  # noqa: F401
