"""ResNet trunk for the pose regressors, as an eval-ready ``nn.Module``.

The PyTorch counterpart of :mod:`geomapnet_tpu.models.resnet`: the
torchvision ResNet topology (BasicBlock for 18/34, Bottleneck for 50) ending
at the global-average-pooled feature vector. Submodule names follow the Flax
module (``conv1``, ``bn1``, ``layer1_0.downsample_conv`` ...), so a Flax
variable path maps onto a ``state_dict`` key one to one
(:mod:`geomapnet_tpu_torch.models.flax_import`).

The public boundary keeps the JAX layout: the trunk takes NHWC images
``(N, H, W, 3)``. ``x.permute(0, 3, 1, 2)`` of an NHWC-contiguous tensor is a
``channels_last`` NCHW tensor, so entering the convolutions costs no copy.
BatchNorm is ``nn.BatchNorm2d`` with eps 1e-5; the Flax max-pool pads with
-inf, as ``nn.MaxPool2d(3, 2, 1)`` does.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

__all__ = ["ResNet", "BasicBlock", "Bottleneck", "resnet18", "resnet34",
           "resnet50"]


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=1e-5)


class BasicBlock(nn.Module):
    """Two 3x3 convs with a residual connection (torchvision BasicBlock)."""

    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(cin, filters, 3, stride)
        self.bn1 = _bn(filters)
        self.conv2 = _conv(filters, filters, 3)
        self.bn2 = _bn(filters)
        self.relu = nn.ReLU(inplace=True)
        if stride != 1 or cin != filters:
            self.downsample_conv = _conv(cin, filters, 1, stride)
            self.downsample_bn = _bn(filters)
        else:
            self.downsample_conv = self.downsample_bn = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if self.downsample_conv is not None:
            identity = self.downsample_bn(self.downsample_conv(x))
        return self.relu(y + identity)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck with 4x expansion (torchvision
    Bottleneck; stride lives on the 3x3 as in torchvision's v1.5 graph)."""

    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int = 1):
        super().__init__()
        out_ch = filters * 4
        self.conv1 = _conv(cin, filters, 1)
        self.bn1 = _bn(filters)
        self.conv2 = _conv(filters, filters, 3, stride)
        self.bn2 = _bn(filters)
        self.conv3 = _conv(filters, out_ch, 1)
        self.bn3 = _bn(out_ch)
        self.relu = nn.ReLU(inplace=True)
        if stride != 1 or cin != out_ch:
            self.downsample_conv = _conv(cin, out_ch, 1, stride)
            self.downsample_bn = _bn(out_ch)
        else:
            self.downsample_conv = self.downsample_bn = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if self.downsample_conv is not None:
            identity = self.downsample_bn(self.downsample_conv(x))
        return self.relu(y + identity)


class ResNet(nn.Module):
    """ResNet trunk ending at the pooled feature vector.

    :param stage_sizes: blocks per stage, e.g. (3, 4, 6, 3) for ResNet-34
    :param block_cls: :class:`BasicBlock` (18/34) or :class:`Bottleneck` (50)
    """

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 block_cls: type = BasicBlock):
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = _bn(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        cin = 64
        for stage, n_blocks in enumerate(self.stage_sizes):
            filters = 64 * (2 ** stage)
            for block in range(n_blocks):
                stride = 2 if (stage > 0 and block == 0) else 1
                self.add_module(f"layer{stage + 1}_{block}",
                                block_cls(cin, filters, stride))
                cin = filters * block_cls.expansion
        self.out_features = cin

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) images -> (N, out_features) pooled features."""
        x = x.permute(0, 3, 1, 2)
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        for stage, n_blocks in enumerate(self.stage_sizes):
            for block in range(n_blocks):
                x = getattr(self, f"layer{stage + 1}_{block}")(x)
        return x.mean(dim=(2, 3))


def resnet18() -> ResNet:
    """ResNet-18 trunk (lighter option for ablations/tests)."""
    return ResNet(stage_sizes=(2, 2, 2, 2))


def resnet34() -> ResNet:
    """ResNet-34 trunk: the reference's feature extractor."""
    return ResNet(stage_sizes=(3, 4, 6, 3))


def resnet50() -> ResNet:
    """ResNet-50 trunk (2048-d features)."""
    return ResNet(stage_sizes=(3, 4, 6, 3), block_cls=Bottleneck)
