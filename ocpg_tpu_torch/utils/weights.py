"""Carry the JAX model's weights into the port.

``load_jax_params(model, variables)`` takes the JAX model's
``{"params": ..., "frozen": ...}`` tree as nested dicts of numpy arrays (a
caller gets it with ``jax.tree_util.tree_map(np.asarray, variables)``; this
module imports no JAX) and copies it into the port's modules, whose names
follow the flax tree:

* Dense ``kernel (in, out)`` -> Linear ``weight (out, in)``;
* Conv ``kernel (H, W, I, O)`` -> Conv2d ``weight (O, I, H, W)``;
* LayerNorm / GroupNorm ``scale`` -> ``weight``; Embed ``embedding`` -> ``weight``;
* the ``frozen`` collection -> the FrozenBatchNorm buffers;
* every other leaf (``query_embed``, ``level_embed``, the Swin blocks'
  ``relative_position_bias_table``) as it is.

It is strict: a port tensor left unset, a JAX leaf left unused or a shape
mismatch raises, naming the key.  One exception: a tree from an eval-mode
init lacks the two train-only modules (``ls_feat_viz``, ``ls_text_proj``);
those stay at their init, and ``load_jax_params`` returns their keys.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), np.asarray(v)


def _port_key(path: Tuple[str, ...], arr: np.ndarray) -> Tuple[str, np.ndarray]:
    *mods, leaf = path
    if leaf == "kernel":
        if arr.ndim == 2:
            arr = arr.T
        elif arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        else:
            raise ValueError(f"{'/'.join(path)}: kernel of rank {arr.ndim}")
        leaf = "weight"
    elif leaf in ("scale", "embedding"):
        leaf = "weight"
    return ".".join(mods + [leaf]), arr


def jax_to_state_dict(variables: Mapping) -> Dict[str, np.ndarray]:
    """The port's state_dict keys and arrays for a JAX variables tree."""
    out: Dict[str, np.ndarray] = {}
    for collection in ("params", "frozen"):
        for path, arr in _flatten(variables.get(collection, {})):
            key, arr = _port_key(path, arr)
            if key in out:
                raise KeyError(f"two JAX leaves map onto {key}")
            out[key] = np.ascontiguousarray(arr)
    unknown = set(variables) - {"params", "frozen"}
    if unknown:
        raise KeyError(f"unknown JAX collections {sorted(unknown)}")
    return out


# modules that only a train-mode init of the JAX model creates
TRAIN_ONLY = ("ls_feat_viz.", "ls_text_proj.")


def load_jax_params(model: nn.Module, variables: Mapping) -> List[str]:
    """Copy ``variables`` into ``model``; returns the train-only keys the
    tree lacked (left at their init), else an empty list."""
    arrays = jax_to_state_dict(variables)
    target = model.state_dict()
    absent = set(target) - set(arrays)
    train_only = sorted(k for k in target if k.startswith(TRAIN_ONLY))
    left = train_only if set(train_only) <= absent else []
    missing = sorted(absent - set(left))
    unused = sorted(set(arrays) - set(target))
    if missing:
        raise KeyError(f"port tensors with no JAX leaf: {missing[:10]}"
                       f"{' ...' if len(missing) > 10 else ''}")
    if unused:
        raise KeyError(f"JAX leaves the port does not use: {unused[:10]}"
                       f"{' ...' if len(unused) > 10 else ''}")
    loaded = {k: t for k, t in target.items() if k not in left}
    for key, tensor in loaded.items():
        arr = arrays[key]
        if tuple(arr.shape) != tuple(tensor.shape):
            raise ValueError(f"{key}: JAX shape {tuple(arr.shape)} != port shape "
                             f"{tuple(tensor.shape)}")
    with torch.no_grad():
        for key, tensor in loaded.items():
            tensor.copy_(torch.from_numpy(arrays[key]))
    return left
