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

``dtype`` is the compute dtype, placed as Flax places it (not as
``torch.autocast`` would): parameters stay float32 and each conv casts its
input and kernel to ``dtype``; BatchNorm reads float32 and writes float32,
so the residual add, its relu, the stem's relu and max-pool and the global
mean run in float32; the stem's output and each block's conv inputs are
cast back to ``dtype``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["ResNet", "BasicBlock", "Bottleneck", "Conv2d", "BatchNorm2d",
           "resnet18", "resnet34", "resnet50"]


class Conv2d(nn.Conv2d):
    """Bias-free ``nn.Conv2d`` that casts its input and float32 kernel to
    ``compute_dtype`` at use, as Flax's ``nn.Conv(dtype=...)`` does; the
    output is in ``compute_dtype``."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(cin, cout, k, stride=stride, padding=k // 2,
                         bias=False)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.conv2d(x.to(dt), self.weight.to(dt), None, self.stride,
                        self.padding)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (eps 1e-5) that reads and writes float32 whatever
    its input's dtype, as the Flax trunk's ``BatchNorm(dtype=float32)``."""

    def __init__(self, c: int):
        super().__init__(c, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float())


class BasicBlock(nn.Module):
    """Two 3x3 convs with a residual connection (torchvision BasicBlock)."""

    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv2d(cin, filters, 3, stride, dtype)
        self.bn1 = BatchNorm2d(filters)
        self.conv2 = Conv2d(filters, filters, 3, 1, dtype)
        self.bn2 = BatchNorm2d(filters)
        self.relu = nn.ReLU(inplace=True)
        if stride != 1 or cin != filters:
            self.downsample_conv = Conv2d(cin, filters, 1, stride, dtype)
            self.downsample_bn = BatchNorm2d(filters)
        else:
            self.downsample_conv = self.downsample_bn = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if self.downsample_conv is not None:
            identity = self.downsample_bn(self.downsample_conv(x))
        return self.relu(y + identity.float())


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck with 4x expansion (torchvision
    Bottleneck; stride lives on the 3x3 as in torchvision's v1.5 graph)."""

    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        out_ch = filters * 4
        self.conv1 = Conv2d(cin, filters, 1, 1, dtype)
        self.bn1 = BatchNorm2d(filters)
        self.conv2 = Conv2d(filters, filters, 3, stride, dtype)
        self.bn2 = BatchNorm2d(filters)
        self.conv3 = Conv2d(filters, out_ch, 1, 1, dtype)
        self.bn3 = BatchNorm2d(out_ch)
        self.relu = nn.ReLU(inplace=True)
        if stride != 1 or cin != out_ch:
            self.downsample_conv = Conv2d(cin, out_ch, 1, stride, dtype)
            self.downsample_bn = BatchNorm2d(out_ch)
        else:
            self.downsample_conv = self.downsample_bn = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if self.downsample_conv is not None:
            identity = self.downsample_bn(self.downsample_conv(x))
        return self.relu(y + identity.float())


class ResNet(nn.Module):
    """ResNet trunk ending at the pooled feature vector.

    :param stage_sizes: blocks per stage, e.g. (3, 4, 6, 3) for ResNet-34
    :param block_cls: :class:`BasicBlock` (18/34) or :class:`Bottleneck` (50)
    :param dtype: compute dtype (float32, or bfloat16 at Flax's placement)
    """

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 block_cls: type = BasicBlock,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.dtype = dtype
        self.conv1 = Conv2d(3, 64, 7, 2, dtype)
        self.bn1 = BatchNorm2d(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        cin = 64
        for stage, n_blocks in enumerate(self.stage_sizes):
            filters = 64 * (2 ** stage)
            for block in range(n_blocks):
                stride = 2 if (stage > 0 and block == 0) else 1
                self.add_module(f"layer{stage + 1}_{block}",
                                block_cls(cin, filters, stride, dtype))
                cin = filters * block_cls.expansion
        self.out_features = cin

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) images -> (N, out_features) pooled features."""
        x = self.bn1(self.conv1(x.permute(0, 3, 1, 2)))
        x = self.maxpool(self.relu(x)).to(self.dtype)
        for stage, n_blocks in enumerate(self.stage_sizes):
            for block in range(n_blocks):
                x = getattr(self, f"layer{stage + 1}_{block}")(x)
        return x.mean(dim=(2, 3))


def resnet18(dtype: torch.dtype = torch.float32) -> ResNet:
    """ResNet-18 trunk (lighter option for ablations/tests)."""
    return ResNet(stage_sizes=(2, 2, 2, 2), dtype=dtype)


def resnet34(dtype: torch.dtype = torch.float32) -> ResNet:
    """ResNet-34 trunk: the reference's feature extractor."""
    return ResNet(stage_sizes=(3, 4, 6, 3), dtype=dtype)


def resnet50(dtype: torch.dtype = torch.float32) -> ResNet:
    """ResNet-50 trunk (2048-d features)."""
    return ResNet(stage_sizes=(3, 4, 6, 3), block_cls=Bottleneck,
                  dtype=dtype)
