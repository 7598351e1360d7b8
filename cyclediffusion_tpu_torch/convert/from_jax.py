"""The JAX package's Flax parameter trees (numpy leaves) -> the port's state
dicts.

Names: every ``_<index>`` path component of a Flax name becomes ``.<index>``
(``input_blocks_3_0`` / ``in_layers_2`` -> ``input_blocks.3.0.in_layers.2``,
``to_out_0`` -> ``to_out.0``); the VAE mid block keeps the reference's
``mid.block_1`` / ``mid.attn_1`` / ``mid.block_2``.
Leaves: Dense ``kernel (in, out)`` -> ``weight (out, in)``, or
``(out, in, 1, 1)`` / ``(out, in, 1)`` where the port's module is a 1x1
conv (the VAE's, VQ's ``quant_conv``) or a 1-tap Conv1d (``GDAttentionBlock``'s
``qkv`` and ``proj_out``); Conv ``kernel`` HWIO -> OIHW; norm ``scale`` ->
``weight``; ``Embed.embedding`` -> ``weight``, and the VQ codebook
(``quantize/embedding``, a raw parameter) -> ``quantize.embedding.weight``;
``bias`` and raw parameters (``position_embedding``) as they are.
The ``_Kernel`` / ``_KernelBias`` holders are ordinary ``{kernel[, bias]}``
dicts, so they land on ``Linear(bias=False)`` / ``Linear``.

The CLIP scorer's tree goes the same way: ``conv1`` HWIO -> OIHW without a
bias; ``class_embedding``, ``positional_embedding``, ``proj`` and
``text_projection`` as raw parameters; ``in_proj`` as one
``Linear(w, 3w)``; ``ln_1`` / ``ln_2`` keep their names.
:func:`from_openai_state_dict` maps OpenAI's own ``ViT-B-32.pt`` names onto
the same modules.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

# Flax names whose numbered tail is part of the module's name, not an index
_KEPT_NAMES = {"mid_block_1": "mid.block_1", "mid_attn_1": "mid.attn_1",
               "mid_block_2": "mid.block_2", "ln_1": "ln_1", "ln_2": "ln_2"}


def module_name(flax_name: str) -> str:
    """One Flax path component -> its dotted port path: an all-digit
    ``_``-separated token is split off with dots (``up_0_block_1`` ->
    ``up.0.block.1``)."""
    if flax_name in _KEPT_NAMES:
        return _KEPT_NAMES[flax_name]
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
        return out.reshape(target_shape) if len(target_shape) > 2 else out
    return value


_LEAF_NAMES = {"kernel": "weight", "scale": "weight", "embedding": "weight"}
# whole Flax paths whose port name is not the rule's
_PATH_NAMES = {("quantize", "embedding"): "quantize.embedding.weight"}


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
        name = _PATH_NAMES.get(tuple(path)) or ".".join(
            [module_name(p) for p in path[:-1]] + [_LEAF_NAMES.get(leaf, leaf)])
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


# OpenAI CLIP state-dict names -> the port's CLIPModel names
_OPENAI_RENAMES = (
    (r"^(visual\.)transformer\.resblocks\.(\d+)\.", r"\1resblocks.\2."),
    (r"^transformer\.resblocks\.(\d+)\.", r"text.resblocks.\1."),
    (r"^(token_embedding|positional_embedding|text_projection|ln_final)\b", r"text.\1"),
    (r"\.attn\.in_proj_(weight|bias)$", r".in_proj.\1"),
    (r"\.attn\.out_proj\.", r".out_proj."),
    (r"\.mlp\.(c_fc|c_proj)\.", r".\1."),
)


def from_openai_state_dict(state_dict: Mapping[str, object],
                           module: nn.Module) -> Dict[str, torch.Tensor]:
    """OpenAI's CLIP state dict (``ViT-B-32.pt``'s names, torch tensors or
    numpy arrays) -> a complete state dict for the port's ``CLIPModel``.
    ``logit_scale`` is dropped: scoring uses cosine similarity only.  Raises
    on an unmapped key, an unset parameter or a shape mismatch."""
    targets = module.state_dict()
    out, unmapped, bad = {}, [], []
    for key, value in state_dict.items():
        if key == "logit_scale":
            continue
        name = key
        for pat, rep in _OPENAI_RENAMES:
            name = re.sub(pat, rep, name)
        if name not in targets:
            unmapped.append(key)
            continue
        arr = torch.as_tensor(np.asarray(value, dtype=np.float32))
        if tuple(arr.shape) != tuple(targets[name].shape):
            bad.append(f"{name}: {tuple(arr.shape)} vs {tuple(targets[name].shape)}")
            continue
        out[name] = arr
    missing = sorted(set(targets) - set(out) - {b.split(":")[0] for b in bad})
    if unmapped or missing or bad:
        raise ValueError(
            f"OpenAI CLIP conversion mismatch: unmapped keys {unmapped[:8]} "
            f"({len(unmapped)}), unset parameters {missing[:8]} ({len(missing)}), "
            f"shape mismatches {bad[:8]} ({len(bad)})")
    return out
