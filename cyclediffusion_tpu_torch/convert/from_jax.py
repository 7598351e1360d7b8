"""The JAX package's Flax parameter trees (numpy leaves) -> the port's state
dicts.

Names: every ``_<index>`` path component of a Flax name becomes ``.<index>``
(``input_blocks_3_0`` / ``in_layers_2`` -> ``input_blocks.3.0.in_layers.2``,
``to_out_0`` -> ``to_out.0``); the VAE mid block keeps the reference's
``mid.block_1`` / ``mid.attn_1`` / ``mid.block_2``.
Leaves: Dense ``kernel (in, out)`` -> ``weight (out, in)``, or
``(out, in, 1, 1)`` where the port's module is a 1x1 conv; Conv ``kernel``
HWIO -> OIHW; norm ``scale`` -> ``weight``; ``Embed.embedding`` ->
``weight``; ``bias`` and raw parameters (``position_embedding``) as they are.
The ``_Kernel`` / ``_KernelBias`` holders are ordinary ``{kernel[, bias]}``
dicts, so they land on ``Linear(bias=False)`` / ``Linear``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

_MID_NAMES = {"mid_block_1": "mid.block_1", "mid_attn_1": "mid.attn_1",
              "mid_block_2": "mid.block_2"}


def module_name(flax_name: str) -> str:
    """One Flax path component -> its dotted port path: an all-digit
    ``_``-separated token is split off with dots (``up_0_block_1`` ->
    ``up.0.block.1``)."""
    if flax_name in _MID_NAMES:
        return _MID_NAMES[flax_name]
    toks = flax_name.split("_")
    out = toks[0]
    for prev, tok in zip(toks, toks[1:]):
        out += ("." if tok.isdigit() or prev.isdigit() else "_") + tok
    return out


def _flatten(tree: dict, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _convert_leaf(leaf: str, value: np.ndarray, target_shape) -> np.ndarray:
    if leaf == "kernel" and value.ndim == 4:
        return np.transpose(value, (3, 2, 0, 1))          # HWIO -> OIHW
    if leaf == "kernel" and value.ndim == 2:
        out = value.T
        return out.reshape(target_shape) if len(target_shape) == 4 else out
    return value


_LEAF_NAMES = {"kernel": "weight", "scale": "weight", "embedding": "weight"}


def flax_to_state_dict(tree: dict, module: nn.Module) -> Dict[str, torch.Tensor]:
    """Convert a Flax tree (optionally wrapped in ``{"params": ...}``) into a
    complete state dict for ``module``.  Raises if any Flax leaf has no
    target, any target parameter is left unset, or a shape disagrees."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    targets = module.state_dict()
    out, unmapped, bad = {}, [], []
    for path, value in _flatten(tree):
        leaf = path[-1]
        name = ".".join([module_name(p) for p in path[:-1]]
                        + [_LEAF_NAMES.get(leaf, leaf)])
        if name not in targets:
            unmapped.append("/".join(path))
            continue
        arr = _convert_leaf(leaf, np.asarray(value), tuple(targets[name].shape))
        if tuple(arr.shape) != tuple(targets[name].shape):
            bad.append(f"{name}: {arr.shape} vs {tuple(targets[name].shape)}")
            continue
        out[name] = torch.from_numpy(np.array(arr, dtype=np.float32))
    missing = sorted(set(targets) - set(out) - set(bad))
    if unmapped or missing or bad:
        raise ValueError(
            f"conversion mismatch for {type(module).__name__}: "
            f"unmapped Flax leaves {unmapped[:8]} ({len(unmapped)}), "
            f"unset parameters {missing[:8]} ({len(missing)}), "
            f"shape mismatches {bad[:8]} ({len(bad)})")
    return out


@torch.no_grad()
def load_flax_params(module: nn.Module, tree: dict) -> None:
    """Load a Flax tree into ``module`` in place (cast to its dtype/device)."""
    module.load_state_dict(flax_to_state_dict(tree, module), strict=True)
