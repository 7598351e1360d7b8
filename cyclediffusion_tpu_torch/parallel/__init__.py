"""Multi-process and multi-device parallelism (counterpart of
``cyclediffusion_tpu.parallel``).

JAX runs one controller: one process drives a mesh over its local devices,
arrays carry a ``NamedSharding`` and GSPMD inserts the collectives.  PyTorch's
idiom is one process per GPU, so the port maps:

* the ``data`` mesh -> the ranks of a ``torch.distributed`` process group,
  one GPU each (``cuda:LOCAL_RANK``), as a 1-D ``DeviceMesh`` named
  ``"data"`` (:func:`data_mesh`);
* ``NamedSharding(P("data"))`` -> "this rank's contiguous block of rows"
  (:func:`batch_sharding`, :func:`shard_batch`);
* replicated arrays -> a broadcast from rank 0 (:func:`replicate`);
* GSPMD's inserted all-gathers -> explicit collectives
  (:func:`all_gather_cat`, and the tensor-parallel layers of
  :mod:`.tp`, whose outputs are all-gathered along their feature axis).

:func:`init_distributed` joins the group from torchrun's environment or a
``file://`` init method; it raises rather than run as one process when the
group cannot be formed.
"""

from cyclediffusion_tpu_torch.parallel.mesh import (  # noqa: F401
    all_gather_cat,
    batch_sharding,
    data_mesh,
    init_distributed,
    pad_to_multiple,
    process_position,
    replicate,
    shard_batch,
    shard_rows,
)
