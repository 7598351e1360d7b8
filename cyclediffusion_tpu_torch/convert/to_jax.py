"""The port's modules -> the Flax parameter trees the JAX package's modules
hold: the inverse of ``from_jax.flax_to_state_dict``, for the JAX driver's
``model_params.msgpack``.

Names.  ``from_jax.module_name`` turns every digit token of a Flax name
into a dotted index, so a dotted port name does not say where the Flax
module boundaries were: ``input_blocks.3.0.in_layers.2`` is
``input_blocks_3_0 / in_layers_2``, but ``up.0.block.1`` is the single
Flax module ``up_0_block_1``.  The boundaries come from the port's module
tree instead: a port module is a Flax module unless it only groups others
(:data:`GROUPS`: the containers, the autoencoder's resolution levels and
mid block, and the plain ``nn.Module`` holders of the CompVis DDPM UNet),
and a group's children take its name joined with ``_``.
Leaves.  ``Linear.weight (out, in)`` -> ``kernel (in, out)``; a 1x1
``Conv2d`` or 1-tap ``Conv1d`` weight -> a Dense ``kernel (in, out)`` (the
JAX models hold every such layer as Dense); any other ``Conv2d`` weight
OIHW -> HWIO; a norm's ``weight`` -> ``scale``; ``Embedding.weight`` ->
``embedding``, and the VQ codebook -> the raw parameter
``quantize/embedding``; biases and raw parameters as they are.
A leaf keeps the module's dtype: numpy for float32, a ``torch.bfloat16``
tensor for bfloat16 (``flax_msgpack`` writes its bits).
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import torch
from torch import nn

from cyclediffusion_tpu_torch.convert.from_jax import _PATH_NAMES
from cyclediffusion_tpu_torch.models import autoencoder
from cyclediffusion_tpu_torch.models.nn import GroupNorm

# port modules that group others and are no Flax module
GROUPS = (nn.ModuleList, nn.Sequential, nn.ModuleDict, autoencoder._Level, autoencoder._Mid)
_NORMS = (GroupNorm, nn.GroupNorm, nn.LayerNorm)
# port names whose Flax path is not the rule's
_PORT_PATHS = {name: path for path, name in _PATH_NAMES.items()}


def _is_group(module: nn.Module) -> bool:
    return isinstance(module, GROUPS) or type(module) is nn.Module


def _leaves(module: nn.Module, scope: Tuple[str, ...] = (), pending: Tuple[str, ...] = (),
            prefix: str = "") -> Iterator[Tuple[Tuple[str, ...], str, nn.Module, str]]:
    """(Flax path of the leaf, port state-dict name, owning module, its
    attribute) for every entry of ``module.state_dict()``."""
    for attr, value in list(module._parameters.items()) + [
            (k, v) for k, v in module._buffers.items()
            if k not in module._non_persistent_buffers_set]:
        if value is not None:
            yield scope + (_leaf_name(module, attr),), prefix + attr, module, attr
    for name, child in module.named_children():
        names = pending + (name,)
        if _is_group(child):
            yield from _leaves(child, scope, names, prefix + name + ".")
        else:
            yield from _leaves(child, scope + ("_".join(names),), (), prefix + name + ".")


def _leaf_name(module: nn.Module, attr: str) -> str:
    if attr != "weight":
        return attr
    if isinstance(module, (nn.Linear, nn.Conv1d, nn.Conv2d)):
        return "kernel"
    if isinstance(module, _NORMS):
        return "scale"
    if isinstance(module, nn.Embedding):
        return "embedding"
    return attr


def _flax_leaf(module: nn.Module, attr: str) -> torch.Tensor:
    """The parameter ``attr`` of ``module`` in its Flax layout (a view;
    any device, the meta device too)."""
    w = getattr(module, attr).detach()
    if attr != "weight":
        return w
    if isinstance(module, nn.Linear):
        return w.t()
    if isinstance(module, nn.Conv1d):
        if w.shape[2] != 1:
            raise ValueError(f"a {w.shape[2]}-tap Conv1d has no Flax counterpart here")
        return w[:, :, 0].t()
    if isinstance(module, nn.Conv2d):
        return w[:, :, 0, 0].t() if tuple(w.shape[2:]) == (1, 1) else w.permute(2, 3, 1, 0)
    return w


def _named_leaves(module: nn.Module):
    """(Flax path, port name, the leaf in Flax's layout) of every entry of
    ``module.state_dict()``."""
    seen = set()
    for path, name, owner, attr in _leaves(module):
        path = _PORT_PATHS.get(name, path)
        if path in seen:
            raise ValueError(f"two port parameters map to the Flax leaf {'/'.join(path)}")
        seen.add(path)
        yield path, name, _flax_leaf(owner, attr)


def flax_layout(module: nn.Module) -> Dict[Tuple[str, ...], Tuple[int, ...]]:
    """The Flax path of each of ``module``'s weights -> its Flax shape (a
    module on the meta device gives its full-width layout for free)."""
    return {path: tuple(leaf.shape) for path, _, leaf in _named_leaves(module)}


def module_to_flax(module: nn.Module) -> dict:
    """``module``'s weights as the Flax variables ``{"params": tree}`` of
    the JAX module it ports, on the host in the module's dtype."""
    tree: dict = {}
    for path, _, leaf in _named_leaves(module):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        leaf = leaf.cpu().contiguous()
        node[path[-1]] = leaf if leaf.dtype == torch.bfloat16 else leaf.numpy()
    return {"params": tree}
