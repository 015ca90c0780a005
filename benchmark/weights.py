"""The weights of a run, drawn from its seed on the device.

One ``normal_`` call over a single float32 buffer on the card, from a
``torch.Generator`` seeded with the run's seed, then each tensor of the
model's ``state_dict`` is a view of that buffer scaled by its rule:

* Linear and Conv2d weights: N(0, 1/fan_in), fan_in = inputs x receptive
  field (lecun normal); the MSDA offset and attention-weight heads and the
  last layer of each box-refinement MLP start at zero, as in the recipe;
* biases: zero, but the MSDA offsets (the sampling grid), the class heads
  (prior 0.01), the first box head's size logits (-2) and the Swin patch
  embedding's (N(0, 1/fan_in): a zero bias makes every padding token the
  zero vector, whose LayerNorm backward overflows);
* embeddings N(0, 1/dim); query and level embeddings N(0, 1); the Swin
  relative-position tables N(0, 0.02^2) clipped at +-0.04;
* norms (LayerNorm, GroupNorm, the frozen BatchNorms): ones and zeros.

The benchmark hands the same tensors to the program and to the reference,
which match by name: the reference is a copy of the program's modules.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn as nn

from .reference.deformable_transformer import offset_bias
from .reference.ocpg import OCPG
from .reference.step import build_reference, config_of

_ZERO_WEIGHTS = ("sampling_offsets", "attention_weights")


def _rules(model: nn.Module) -> Dict[str, tuple]:
    """state_dict name -> (kind, arg): "normal" (std), "const" (value),
    "array" (values), "clipped" (std, bound)."""
    rules: Dict[str, tuple] = {}
    for mname, mod in model.named_modules():
        pre = f"{mname}." if mname else ""
        leaf = mname.rsplit(".", 1)[-1]
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
            fan_in = mod.weight[0].numel()
            std = 1.0 / math.sqrt(fan_in)
            zero_w = leaf in _ZERO_WEIGHTS or (leaf == "layers_2" and ".bbox_embed_" in f".{mname}")
            rules[pre + "weight"] = ("const", 0.0) if zero_w else ("normal", std)
            if mod.bias is not None:
                n = mod.bias.numel()
                if leaf == "sampling_offsets":
                    parent = model.get_submodule(mname.rsplit(".", 1)[0])
                    grid = offset_bias(parent.m, parent.l, parent.p)
                    rules[pre + "bias"] = ("array", grid.reshape(-1))
                elif leaf.startswith("class_embed_"):
                    rules[pre + "bias"] = ("const", -math.log((1 - 0.01) / 0.01))
                elif leaf == "patch_embed":
                    rules[pre + "bias"] = ("normal", std)
                elif leaf == "layers_2" and mname.endswith("bbox_embed_0.layers_2"):
                    rules[pre + "bias"] = ("array", np.array([0.0, 0.0] + [-2.0] * (n - 2),
                                                             np.float32))
                else:
                    rules[pre + "bias"] = ("const", 0.0)
        elif isinstance(mod, nn.Embedding):
            rules[pre + "weight"] = ("normal", 1.0 / math.sqrt(mod.embedding_dim))
        elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
            rules[pre + "weight"] = ("const", 1.0)
            rules[pre + "bias"] = ("const", 0.0)
        elif type(mod).__name__ == "FrozenBatchNorm":
            for name, v in (("weight", 1.0), ("bias", 0.0), ("running_mean", 0.0),
                            ("running_var", 1.0)):
                rules[pre + name] = ("const", v)
        for pname, _ in mod.named_parameters(recurse=False):
            key = pre + pname
            if key in rules:
                continue
            if pname == "relative_position_bias_table":
                rules[key] = ("clipped", 0.02, 0.04)
            elif pname in ("query_embed", "level_embed"):
                rules[key] = ("normal", 1.0)
    return rules


@torch.no_grad()
def draw_weights(model: nn.Module, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every floating entry of ``model.state_dict()`` (a model of the same
    names and shapes; the meta device will do) drawn from ``seed`` on
    ``device`` as the module docstring says.  Integer buffers are left out."""
    rules = _rules(model)
    entries = [(k, v) for k, v in model.state_dict().items() if v.is_floating_point()]
    missing = [k for k, _ in entries if k not in rules]
    if missing:
        raise KeyError(f"no weight rule for {missing[:5]}")
    total = sum(v.numel() for _, v in entries)
    g = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.empty(total, dtype=torch.float32, device=device).normal_(generator=g)
    out: Dict[str, torch.Tensor] = {}
    offset = 0
    for k, v in entries:
        t = flat[offset:offset + v.numel()].view(v.shape)
        offset += v.numel()
        rule = rules[k]
        if rule[0] == "normal":
            t.mul_(rule[1])
        elif rule[0] == "clipped":
            t.mul_(rule[1]).clamp_(-rule[2], rule[2])
        elif rule[0] == "const":
            t.fill_(rule[1])
        else:
            t.copy_(torch.from_numpy(rule[1]).view(v.shape))
        out[k] = t
    return out


def load_weights(model: nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copy ``weights`` into ``model``; every floating entry must be there."""
    state = model.state_dict()
    want = {k for k, v in state.items() if v.is_floating_point()}
    if want != set(weights):
        raise KeyError(f"weights differ from the model's: {sorted(want ^ set(weights))[:5]}")
    with torch.no_grad():
        for k, t in weights.items():
            state[k].copy_(t)


def draw_for(fields: Mapping, seed: int, device) -> Dict[str, torch.Tensor]:
    """``draw_weights`` over the reference model of a configuration's fields
    (built on the meta device: names and shapes only)."""
    with torch.device("meta"):
        model = OCPG(config_of(fields))
    return draw_weights(model, seed, device)


def reference_model(fields: Mapping, seed: int, device,
                    compute_dtype: str = "float32") -> nn.Module:
    """The reference model of ``fields`` with the run's weights."""
    ref = build_reference(fields, device, compute_dtype)
    load_weights(ref, draw_for(fields, seed, device))
    return ref
