"""Checkpoints of the train state: counterpart of ``ocpg_tpu/engine/checkpoint.py``.

The JAX package saves its ``TrainState`` pytree with orbax; the port saves
torch state dicts.  A train state is a mapping of names to objects with
``state_dict()`` / ``load_state_dict()``: the model, the ``TrainOptimizer``
(moments, applied-step count, LR boundaries) and the ``TrainStep`` (step
counter, dropout generator).  ``restore`` returns the saved state dicts
by name, which the caller loads into fresh objects; with those three the
next step is the one the saved run would have taken.

``save`` returns before the file is written, as orbax's does: it copies
every tensor to the host first (the next ``optimizer.step()`` updates the
parameters and moments in place), then writes in a background thread to a
temporary name and renames it with ``os.replace``, so a reader never sees
a partial file.  One write is in flight per manager; ``save``,
``restore``, ``latest_step`` and ``wait`` wait for the previous one, and a
new manager (or ``load_params``) on a directory waits for the write of the
last manager made on it in this process.  After each write only the
newest ``max_to_keep`` checkpoints stay.

``restore_params_into`` is the finetune merge (``strict=False`` without
the class heads); ``load_params`` takes the model's weights of the newest
checkpoint for inference; ``load_pretrained_torch`` loads a reference
PyTorch checkpoint (``--pretrained_weights``, a ``--checkpoint`` file).
"""

from __future__ import annotations

import os
import re
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Mapping, Optional, Sequence

import torch
import torch.nn as nn

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")

# directory -> the last manager made on it in this process
_MANAGERS: Dict[str, "CheckpointManager"] = {}


def _barrier_directory(directory: str) -> None:
    prev = _MANAGERS.get(directory)
    if prev is not None:
        prev.wait()


def _steps(directory: str) -> Sequence[int]:
    """The steps saved in ``directory``, oldest first."""
    return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(directory)) if m)


def _path(directory: str, step: int) -> str:
    return os.path.join(directory, f"ckpt_{step}.pt")


def _load(directory: str, step: int) -> Dict[str, Any]:
    return torch.load(_path(directory, step), map_location="cpu", weights_only=True)


def _to_host(x: Any) -> Any:
    """A copy of a state dict's tree with every tensor copied to the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, Mapping):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    return x


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        _barrier_directory(self.directory)
        os.makedirs(self.directory, exist_ok=True)
        self._executor = ThreadPoolExecutor(max_workers=1)
        self._pending: Optional[Future] = None
        _MANAGERS[self.directory] = self

    def save(self, step: int, state: Mapping[str, Any]) -> None:
        """Snapshot ``state`` (name -> object with ``state_dict()``) to the
        host and write it in the background as step ``step``."""
        self.wait()
        snapshot = {name: _to_host(obj.state_dict()) for name, obj in state.items()}
        self._pending = self._executor.submit(self._write, step, snapshot)

    def _write(self, step: int, snapshot: Dict[str, Any]) -> None:
        path = _path(self.directory, step)
        tmp = f"{path}.tmp"
        torch.save(snapshot, tmp)
        os.replace(tmp, path)
        for old in _steps(self.directory)[:-self.max_to_keep]:
            os.remove(_path(self.directory, old))

    def wait(self) -> None:
        """Block until the write in flight has finished; raise its error."""
        pending, self._pending = self._pending, None
        if pending is not None:
            pending.result()

    def restore(self, step: Optional[int] = None) -> Dict[str, Any]:
        """The saved state dicts by name (tensors on the CPU) of ``step``,
        the newest when None."""
        self.wait()
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return _load(self.directory, step)

    def latest_step(self) -> Optional[int]:
        self.wait()
        steps = _steps(self.directory)
        return steps[-1] if steps else None


def restore_params_into(target: Mapping[str, torch.Tensor], source: Mapping[str, torch.Tensor],
                        drop_prefixes: Sequence[str] = ("class_embed",)) -> Dict[str, torch.Tensor]:
    """The strict=False merge of two state dicts: the source's entry where
    the target has the key at the same shape (cast to the target's type),
    the target's where a key is missing from the source, differs in shape,
    or has a dotted component starting with one of ``drop_prefixes`` (the
    class heads, for finetuning)."""
    out = {}
    for key, tgt in target.items():
        src = source.get(key)
        dropped = any(part.startswith(d) for part in key.split(".") for d in drop_prefixes)
        if dropped or src is None or tuple(src.shape) != tuple(tgt.shape):
            out[key] = tgt
        else:
            out[key] = src.to(dtype=tgt.dtype, device=tgt.device)
    return out


def load_params(checkpoint_dir: str, model: nn.Module) -> nn.Module:
    """Load the model weights of the newest train-state checkpoint in
    ``checkpoint_dir`` into ``model`` (every entry of its state dict that
    the checkpoint has at the same shape), for inference; returns the model."""
    directory = os.path.abspath(checkpoint_dir)
    _barrier_directory(directory)
    steps = _steps(directory) if os.path.isdir(directory) else []
    if not steps:
        raise FileNotFoundError(f"no checkpoint in {checkpoint_dir}")
    saved = _load(directory, steps[-1])
    model.load_state_dict(restore_params_into(model.state_dict(), saved["model"],
                                              drop_prefixes=()))
    return model


def load_pretrained_torch(model: nn.Module, path: str, cfg,
                          drop_class_heads: bool = True) -> List[str]:
    """Load a reference PyTorch checkpoint into ``model`` (the
    ``--pretrained_weights`` loader, and a ``--checkpoint`` file).

    ``path`` holds a raw reference OCPG state dict (flat dotted keys,
    converted by ``utils/torch_weights.convert_ocpg`` for ``cfg``'s
    backbone and layer counts) or an already converted tree: a bare params
    tree or ``{"params": ..., "frozen": ...}``.  The tree's tensors, the
    FrozenBN statistics included, are merged as ``restore_params_into``
    merges (a tensor the checkpoint lacks or holds at another shape keeps
    the model's value); with ``drop_class_heads`` (finetuning) the class
    heads keep theirs too.  Returns the keys of the model's state dict that
    were taken from the checkpoint.
    """
    from ..utils.torch_weights import convert_ocpg, load_torch_file
    from ..utils.weights import jax_to_state_dict

    src = load_torch_file(path)
    if any(isinstance(k, str) and "." in k for k in src):
        params, frozen = convert_ocpg(
            src, enc_layers=cfg.enc_layers, dec_layers=cfg.dec_layers,
            num_feature_levels=cfg.num_feature_levels, backbone=cfg.backbone,
            text_layers=cfg.text_layers, with_box_refine=cfg.with_box_refine)
        tree = {"params": params, "frozen": frozen}
    else:
        tree = {"params": src.get("params", src), "frozen": src.get("frozen", {})}
    source = {k: torch.as_tensor(v) for k, v in jax_to_state_dict(tree).items()}
    drop = ("class_embed",) if drop_class_heads else ()
    target = model.state_dict()
    merged = restore_params_into(target, source, drop_prefixes=drop)
    model.load_state_dict(merged)
    return sorted(k for k in target if merged[k] is not target[k])


def load_checkpoint(model: nn.Module, path: str, cfg) -> nn.Module:
    """A ``--checkpoint``: a reference ``.pth`` file (class heads kept, for
    inference) or a port ``checkpoints/`` directory; returns the model."""
    if os.path.isfile(path):
        load_pretrained_torch(model, path, cfg, drop_class_heads=False)
    else:
        load_params(path, model)
    return model
