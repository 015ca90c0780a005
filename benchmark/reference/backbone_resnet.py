"""ResNet-50/101 with frozen BatchNorm: counterpart of
``ocpg_tpu/models/backbone_resnet.py``.  Takes NCHW frames and returns the
four stage outputs (strides 4, 8, 16, 32; channels 256 ... 2048), NCHW.
Blocks are named ``layer{stage}_{block}`` as in the JAX tree."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import FrozenBatchNorm


class Bottleneck(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int = 1, dilation: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 1, bias=False)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=dilation,
                               dilation=dilation, bias=False)
        self.bn2 = FrozenBatchNorm(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = FrozenBatchNorm(planes * 4)
        self.downsample = downsample
        if downsample:
            self.downsample_conv = nn.Conv2d(cin, planes * 4, 1, stride=stride, bias=False)
            self.downsample_bn = FrozenBatchNorm(planes * 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = self.downsample_bn(self.downsample_conv(x)) if self.downsample else x
        return F.relu(out + identity)


class ResNet(nn.Module):
    num_channels: Tuple[int, ...] = (256, 512, 1024, 2048)

    def __init__(self, layers: Sequence[int], dilation: bool = False):
        super().__init__()
        self.layers = tuple(layers)
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        cin, dil = 64, 1
        for stage, (blocks, planes) in enumerate(zip(self.layers, (64, 128, 256, 512))):
            stride = 1 if stage == 0 else 2
            if stage == 3 and dilation:
                dil *= stride
                stride = 1
            for b in range(blocks):
                setattr(self, f"layer{stage + 1}_{b}",
                        Bottleneck(cin, planes, stride if b == 0 else 1, dil,
                                   downsample=(b == 0)))
                cin = planes * 4

    def forward(self, x: torch.Tensor,
                num_frames: Optional[int] = None) -> Tuple[torch.Tensor, ...]:
        """Frames are independent: ``num_frames`` is not read."""
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        outs = []
        for stage, blocks in enumerate(self.layers):
            for b in range(blocks):
                x = getattr(self, f"layer{stage + 1}_{b}")(x)
            outs.append(x)
        return tuple(outs)


_LAYERS = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3)}


def build_resnet(arch: str, dilation: bool) -> ResNet:
    return ResNet(_LAYERS[arch], dilation)


def _from_config(cfg) -> ResNet:
    return build_resnet(cfg.backbone, cfg.dilation)


BACKBONES = dict.fromkeys(_LAYERS, _from_config)
