"""Tensor-parallel parameter sharding over a ``model`` mesh dimension
(counterpart of ``cyclediffusion_tpu.parallel.tp``).

Rule (the JAX package's, on the Flax tree): a parameter of two or more
dimensions whose *last Flax axis* is at least ``min_size`` and divisible by
the ``model`` extent is sharded on that axis; everything else is
replicated.  The Flax axis is found through the layout that
``convert.from_jax`` maps: a ``Dense`` kernel ``(in, out)`` and a ``Conv``
kernel ``(H, W, in, out)`` are a torch weight's dim 0 (output features),
an ``Embed`` table ``(num, dim)`` keeps its features on dim 1, and a raw
parameter keeps its last axis.

:func:`shard_params_tp` keeps each picked layer's block of output features
(its bias with it) and all-gathers the layer's output along the feature
axis over the ``model`` group, so the rest of the model sees whole
tensors, as GSPMD's inserted all-gathers make them whole in JAX.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch import nn

from cyclediffusion_tpu_torch.models.nn import GDAttentionBlock
from cyclediffusion_tpu_torch.models.transformer import CrossAttention
from cyclediffusion_tpu_torch.parallel.mesh import (
    _default_device_type,
    all_gather_cat,
    mesh_extent,
)

# layers whose weight is a Flax kernel (output features on torch dim 0) and
# whose output carries its features on this axis
_KERNEL_LAYERS = {nn.Linear: -1, nn.Conv1d: 1, nn.Conv2d: 1}


def _kernel_out_dim(module: nn.Module) -> Optional[int]:
    """The output's feature axis of a kernel layer (subclasses included:
    ``models.nn.Conv2d``), or None for any other module."""
    return next((dim for cls, dim in _KERNEL_LAYERS.items() if isinstance(module, cls)),
                None)


def data_model_mesh(n_data: int, n_model: int, device_type: Optional[str] = None):
    """2-D ``DeviceMesh`` over ``("data", "model")``, the group's ranks in
    row-major order (rank ``d * n_model + m``)."""
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs a process group: call init_distributed first")
    if n_data * n_model != dist.get_world_size():
        raise ValueError(f"a {n_data} x {n_model} mesh needs {n_data * n_model} ranks, the "
                         f"group has {dist.get_world_size()}")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type or _default_device_type(), (n_data, n_model),
                            mesh_dim_names=("data", "model"))


def _flax_axis(module: nn.Module, pname: str, p: torch.Tensor):
    """(the torch dim holding the Flax leaf's last axis, the Flax leaf's
    number of dimensions)."""
    if pname == "weight" and _kernel_out_dim(module) is not None:
        return 0, max(p.ndim, 2)      # a Dense kernel may be a 1x1 conv here
    if pname == "weight" and isinstance(module, nn.Embedding):
        return 1, 2
    return p.ndim - 1, p.ndim


def tp_param_specs(module: nn.Module, n_model: int, min_size: int = 512
                   ) -> Dict[str, Optional[int]]:
    """Parameter name -> the torch dim sharded over ``model``, or None
    (replicated), by the JAX package's rule."""
    specs = {}
    for mname, mod in module.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            dim, flax_ndim = _flax_axis(mod, pname, p)
            size = p.shape[dim] if p.ndim else 0
            picked = flax_ndim >= 2 and size >= min_size and size % n_model == 0
            specs[(f"{mname}." if mname else "") + pname] = dim if picked else None
    return specs


def _direct_weight_readers(module: nn.Module):
    """Layers whose weights a parent reads without calling them, so that a
    gathered output cannot stand in: ``GDAttentionBlock``'s ``qkv`` and
    ``proj_out``, and a folded ``CrossAttention``'s projections."""
    for mod in module.modules():
        if isinstance(mod, GDAttentionBlock):
            yield from (mod.qkv, mod.proj_out)
        elif isinstance(mod, CrossAttention) and mod.folded_attn is not None:
            yield from (mod.to_q, mod.to_k, mod.to_v, mod.to_out[0])


@torch.no_grad()
def shard_params_tp(mesh, module: nn.Module, min_size: int = 512) -> int:
    """Shard ``module`` in place over the mesh's ``model`` dimension by
    :func:`tp_param_specs` -> the number of parameters sharded (biases not
    counted); :func:`is_sharded` then reads True.  Raises for a picked
    parameter that no layer here can shard (a raw parameter, a grouped
    convolution, a weight its parent reads directly)."""
    n_model, rank = mesh_extent(mesh, "model"), mesh.get_local_rank("model")
    group = mesh.get_group("model")
    specs = tp_param_specs(module, n_model, min_size)
    readers = {id(m) for m in _direct_weight_readers(module)}
    sharded = 0
    for mname, mod in module.named_modules():
        prefix = f"{mname}." if mname else ""
        picked = [n for n, _ in mod.named_parameters(recurse=False)
                  if specs[prefix + n] is not None]
        if not picked:
            continue
        where = prefix + picked[0]
        if picked != ["weight"] or id(mod) in readers or getattr(mod, "groups", 1) != 1:
            raise NotImplementedError(f"no tensor-parallel layer for {where} "
                                      f"({type(mod).__name__})")
        out_dim = _kernel_out_dim(mod)
        if out_dim is not None:
            size = mod.weight.shape[0] // n_model
            block = slice(rank * size, (rank + 1) * size)
            mod.weight = nn.Parameter(mod.weight[block].clone(), requires_grad=False)
            if mod.bias is not None:
                mod.bias = nn.Parameter(mod.bias[block].clone(), requires_grad=False)
        elif isinstance(mod, nn.Embedding):
            out_dim = -1
            size = mod.weight.shape[1] // n_model
            mod.weight = nn.Parameter(mod.weight[:, rank * size:(rank + 1) * size].clone(),
                                      requires_grad=False)
        else:
            raise NotImplementedError(f"no tensor-parallel layer for {where} "
                                      f"({type(mod).__name__})")
        mod.register_forward_hook(
            lambda _m, _inputs, out, dim=out_dim: all_gather_cat(out, group, dim))
        sharded += 1
    module._tp_sharded = sharded > 0
    return sharded


def is_sharded(module: nn.Module) -> bool:
    """Whether :func:`shard_params_tp` sharded a layer of ``module``: its
    all-gathers then run in the forward, through the host under gloo, and no
    CUDA graph can hold them."""
    return getattr(module, "_tp_sharded", False)
