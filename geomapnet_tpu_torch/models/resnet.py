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

Trainable as the Flax trunk: conv kernels start from ``kaiming_normal``
(fan_in, gain sqrt(2), a plain normal), BatchNorm from scale 1 and bias 0.
In train mode BatchNorm normalizes with the biased batch variance and moves
its running variance toward the unbiased one at momentum 0.1, which is the
Flax module's ``momentum=0.9`` (:class:`geomapnet_tpu.models.resnet.
BatchNorm`).

``bn_bf16_bwd=True`` gives every train-mode BatchNorm the bfloat16 backward
of :func:`geomapnet_tpu.models.resnet.bn_train_norm_bf16bwd`
(:class:`BatchNormBf16Backward`): the same forward and running statistics,
the backward's elementwise math in bfloat16. Inside
:func:`recomputing_batch_norm` (the recompute of ``remat``) a train-mode
BatchNorm normalizes with its batch statistics and leaves its running
statistics and batch count as the first forward left them.

Data-parallel training (:func:`geomapnet_tpu_torch.parallel.shard_step`)
sets each BatchNorm's group (:func:`sync_batch_norm`): a train-mode
BatchNorm then normalizes with the mean and variance of the GLOBAL
(micro)batch, the rows of every rank, as the JAX package's SPMD BatchNorm
does (:class:`SyncBatchNorm`: one all-reduce of the per-channel sums in
the forward, one of the two gradient sums in the backward). Without a
group nothing changes.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["ResNet", "BasicBlock", "Bottleneck", "Conv2d", "BatchNorm2d",
           "BatchNormBf16Backward", "SyncBatchNorm", "sync_batch_norm",
           "recomputing_batch_norm",
           "kaiming_normal_", "resnet18", "resnet34", "resnet50"]

# set while remat recomputes a forward: BatchNorm then moves no statistic
_RECOMPUTING = contextvars.ContextVar("recomputing_batch_norm",
                                      default=False)


@contextlib.contextmanager
def recomputing_batch_norm():
    """Train-mode BatchNorm inside this context normalizes with the batch
    statistics, as the first forward did, and leaves the running
    statistics and ``num_batches_tracked`` alone: a recompute must not move
    them a second time."""
    token = _RECOMPUTING.set(True)
    try:
        yield
    finally:
        _RECOMPUTING.reset(token)


def kaiming_normal_(weight: torch.Tensor) -> torch.Tensor:
    """Flax's ``variance_scaling(2.0, "fan_in", "normal")``: a plain normal
    of standard deviation sqrt(2 / fan_in), fan_in = every dimension of the
    torch weight but the first (output) one."""
    return nn.init.kaiming_normal_(weight, mode="fan_in",
                                   nonlinearity="relu")


class Conv2d(nn.Conv2d):
    """Bias-free ``nn.Conv2d`` that casts its input and float32 kernel to
    ``compute_dtype`` at use, as Flax's ``nn.Conv(dtype=...)`` does; the
    output is in ``compute_dtype``. The kernel starts from
    :func:`kaiming_normal_`."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(cin, cout, k, stride=stride, padding=k // 2,
                         bias=False)
        self.compute_dtype = compute_dtype

    def reset_parameters(self) -> None:
        kaiming_normal_(self.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.conv2d(x.to(dt), self.weight.to(dt), None, self.stride,
                        self.padding)


class BatchNormBf16Backward(torch.autograd.Function):
    """Train-mode BatchNorm whose backward does its elementwise math in
    bfloat16: the port of :func:`geomapnet_tpu.models.resnet.
    bn_train_norm_bf16bwd`.

    The forward is the call ``F.batch_norm`` makes (``_batch_norm_impl_
    index``, the same kernel with the same arguments), so the output, the
    running statistics' update and the saved batch mean and inverse std
    are those of the default BatchNorm bit for bit. The backward keeps the
    normalized input in bfloat16 and computes, as JAX's ``_bn_bf16bwd_bwd``
    does, ``dx = coef * (g - mean(g) - xhat * mean(g xhat))`` with ``g``,
    ``xhat`` and every elementwise product in bfloat16, the two per-channel
    sums accumulated in float32 and ``coef = scale * invstd`` formed in
    float32; the scale and bias gradients are those float32 sums.

    ``apply(x, weight, bias, running_mean, running_var, momentum, eps)``.
    """

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, momentum,
                eps):
        y, mean, invstd, _, _ = torch.ops.aten._batch_norm_impl_index(
            x, weight, bias, running_mean, running_var, True, momentum, eps,
            torch.backends.cudnn.enabled)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        xhat = ((x - mean.view(shape)) * invstd.view(shape)).to(
            torch.bfloat16)
        ctx.save_for_backward(xhat, weight, invstd)
        ctx.x_dtype = x.dtype
        return y

    @staticmethod
    def backward(ctx, g):
        xhat, weight, invstd = ctx.saved_tensors
        shape = (1, -1) + (1,) * (g.dim() - 2)
        dims = (0,) + tuple(range(2, g.dim()))
        n = g.numel() // g.shape[1]
        gb = g.to(torch.bfloat16)
        sum_g = torch.sum(gb, dims, dtype=torch.float32)
        sum_gx = torch.sum(gb * xhat, dims, dtype=torch.float32)
        bf = torch.bfloat16
        coef = (weight.float() * invstd).to(bf).view(shape)
        dx = coef * (gb - (sum_g / n).to(bf).view(shape)
                     - xhat * (sum_gx / n).to(bf).view(shape))
        return (dx.to(ctx.x_dtype), sum_gx.to(weight.dtype),
                sum_g.to(weight.dtype), None, None, None, None)


class SyncBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm over a data-parallel group's global batch.

    The forward all-reduces the local per-channel (sum, sum of squares) in
    one float32 buffer and normalizes with the global statistics in the
    JAX package's one-pass form (``mean = E[x]``, ``var = E[x^2] -
    E[x]^2``, biased; :class:`geomapnet_tpu.models.resnet.BatchNorm`),
    then moves the running statistics toward the global mean and the
    unbiased global variance. The backward all-reduces the two gradient
    sums and returns ``dx = w invstd (g - sum(g)/n - xhat sum(g xhat)/n)``
    over the global ``n`` (the gradient of every rank's loss with respect
    to this rank's rows), and the LOCAL sums as the scale and bias
    gradients, which the step's gradient all-reduce then averages. With
    ``bf16_backward`` the backward's elementwise math is
    :class:`BatchNormBf16Backward`'s. Every rank holds the same number of
    rows; every rank must run the same layers in the same order (a
    recompute under ``remat`` runs the collective again).

    ``apply(x, weight, bias, running_mean, running_var, momentum, eps,
    mesh, bf16_backward)``.
    """

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, momentum,
                eps, mesh, bf16_backward):
        dims = (0,) + tuple(range(2, x.dim()))
        shape = (1, -1) + (1,) * (x.dim() - 2)
        c = x.shape[1]
        n = x.numel() // c * mesh.world_size
        stats = mesh.all_reduce_(torch.cat([x.sum(dims), (x * x).sum(dims)]))
        mean = stats[:c] / n
        var = stats[c:] / n - mean * mean
        invstd = torch.rsqrt(var + eps)
        xhat = (x - mean.view(shape)) * invstd.view(shape)
        y = xhat * weight.view(shape) + bias.view(shape)
        with torch.no_grad():
            running_mean.mul_(1.0 - momentum).add_(mean, alpha=momentum)
            running_var.mul_(1.0 - momentum).add_(
                var * (n / max(n - 1, 1)), alpha=momentum)
        if bf16_backward:
            xhat = xhat.to(torch.bfloat16)
        ctx.save_for_backward(xhat, weight, invstd)
        ctx.mesh, ctx.n, ctx.bf16 = mesh, n, bf16_backward
        ctx.x_dtype = x.dtype
        return y

    @staticmethod
    def backward(ctx, g):
        xhat, weight, invstd = ctx.saved_tensors
        n, c = ctx.n, g.shape[1]
        shape = (1, -1) + (1,) * (g.dim() - 2)
        dims = (0,) + tuple(range(2, g.dim()))
        if ctx.bf16:
            g = g.to(torch.bfloat16)
        sum_g = torch.sum(g, dims, dtype=torch.float32)
        sum_gx = torch.sum(g * xhat, dims, dtype=torch.float32)
        tot = ctx.mesh.all_reduce_(torch.cat([sum_g, sum_gx]))
        dt = g.dtype
        coef = (weight.float() * invstd).to(dt).view(shape)
        dx = coef * (g - (tot[:c] / n).to(dt).view(shape)
                     - xhat * (tot[c:] / n).to(dt).view(shape))
        return (dx.to(ctx.x_dtype), sum_gx.to(weight.dtype),
                sum_g.to(weight.dtype), None, None, None, None, None, None)


def sync_batch_norm(model: nn.Module, mesh) -> nn.Module:
    """Give every :class:`BatchNorm2d` of ``model`` the data-parallel group
    ``mesh`` (a :class:`geomapnet_tpu_torch.parallel.DataParallel`; None
    turns the sync off): in train mode they normalize over the group's
    global batch (:class:`SyncBatchNorm`). Returns ``model``."""
    for m in model.modules():
        if isinstance(m, BatchNorm2d):
            m.sync_mesh = mesh
    return model


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (eps 1e-5, momentum 0.1) that reads and writes
    float32 whatever its input's dtype, as the Flax trunk's
    ``BatchNorm(dtype=float32, momentum=0.9)``. With ``bf16_backward`` its
    train-mode backward is :class:`BatchNormBf16Backward`'s; with a
    ``sync_mesh`` (:func:`sync_batch_norm`) train mode normalizes over the
    group's global batch."""

    def __init__(self, c: int, bf16_backward: bool = False):
        super().__init__(c, eps=1e-5, momentum=0.1)
        self.bf16_backward = bf16_backward
        self.sync_mesh = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if not self.training and self.running_mean.requires_grad:
            # statistics that require grad (a functional call on packed
            # pipeline weights): F.batch_norm refuses them, so normalize as
            # Flax's eval BatchNorm does, differentiably
            shape = (1, -1) + (1,) * (x.dim() - 2)
            mul = torch.rsqrt(self.running_var + self.eps) * self.weight
            return ((x - self.running_mean.view(shape)) * mul.view(shape)
                    + self.bias.view(shape))
        frozen = _RECOMPUTING.get()
        mesh = self.sync_mesh if self.training else None
        if not self.training or not (frozen or self.bf16_backward
                                     or mesh is not None):
            return super().forward(x)
        rm, rv = self.running_mean, self.running_var
        if frozen:
            # throwaway statistics: the recompute saves for the backward
            # the tensors the first forward saved, and moves nothing
            rm, rv = rm.clone(), rv.clone()
        else:
            self.num_batches_tracked.add_(1)
        if mesh is not None:
            return SyncBatchNorm.apply(x, self.weight, self.bias, rm, rv,
                                       self.momentum, self.eps, mesh,
                                       self.bf16_backward)
        if self.bf16_backward:
            return BatchNormBf16Backward.apply(x, self.weight, self.bias, rm,
                                               rv, self.momentum, self.eps)
        return F.batch_norm(x, rm, rv, self.weight, self.bias, True,
                            self.momentum, self.eps)


class BasicBlock(nn.Module):
    """Two 3x3 convs with a residual connection (torchvision BasicBlock)."""

    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32,
                 bn_bf16_bwd: bool = False):
        super().__init__()
        self.conv1 = Conv2d(cin, filters, 3, stride, dtype)
        self.bn1 = BatchNorm2d(filters, bn_bf16_bwd)
        self.conv2 = Conv2d(filters, filters, 3, 1, dtype)
        self.bn2 = BatchNorm2d(filters, bn_bf16_bwd)
        self.relu = nn.ReLU(inplace=True)
        if stride != 1 or cin != filters:
            self.downsample_conv = Conv2d(cin, filters, 1, stride, dtype)
            self.downsample_bn = BatchNorm2d(filters, bn_bf16_bwd)
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
                 dtype: torch.dtype = torch.float32,
                 bn_bf16_bwd: bool = False):
        super().__init__()
        out_ch = filters * 4
        self.conv1 = Conv2d(cin, filters, 1, 1, dtype)
        self.bn1 = BatchNorm2d(filters, bn_bf16_bwd)
        self.conv2 = Conv2d(filters, filters, 3, stride, dtype)
        self.bn2 = BatchNorm2d(filters, bn_bf16_bwd)
        self.conv3 = Conv2d(filters, out_ch, 1, 1, dtype)
        self.bn3 = BatchNorm2d(out_ch, bn_bf16_bwd)
        self.relu = nn.ReLU(inplace=True)
        if stride != 1 or cin != out_ch:
            self.downsample_conv = Conv2d(cin, out_ch, 1, stride, dtype)
            self.downsample_bn = BatchNorm2d(out_ch, bn_bf16_bwd)
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
    :param bn_bf16_bwd: every BatchNorm with the bfloat16 backward
    """

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 block_cls: type = BasicBlock,
                 dtype: torch.dtype = torch.float32,
                 bn_bf16_bwd: bool = False):
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.dtype = dtype
        self.conv1 = Conv2d(3, 64, 7, 2, dtype)
        self.bn1 = BatchNorm2d(64, bn_bf16_bwd)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        cin = 64
        for stage, n_blocks in enumerate(self.stage_sizes):
            filters = 64 * (2 ** stage)
            for block in range(n_blocks):
                stride = 2 if (stage > 0 and block == 0) else 1
                self.add_module(f"layer{stage + 1}_{block}",
                                block_cls(cin, filters, stride, dtype,
                                          bn_bf16_bwd))
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


def resnet18(dtype: torch.dtype = torch.float32,
             bn_bf16_bwd: bool = False) -> ResNet:
    """ResNet-18 trunk (lighter option for ablations/tests)."""
    return ResNet(stage_sizes=(2, 2, 2, 2), dtype=dtype,
                  bn_bf16_bwd=bn_bf16_bwd)


def resnet34(dtype: torch.dtype = torch.float32,
             bn_bf16_bwd: bool = False) -> ResNet:
    """ResNet-34 trunk: the reference's feature extractor."""
    return ResNet(stage_sizes=(3, 4, 6, 3), dtype=dtype,
                  bn_bf16_bwd=bn_bf16_bwd)


def resnet50(dtype: torch.dtype = torch.float32,
             bn_bf16_bwd: bool = False) -> ResNet:
    """ResNet-50 trunk (2048-d features)."""
    return ResNet(stage_sizes=(3, 4, 6, 3), block_cls=Bottleneck,
                  dtype=dtype, bn_bf16_bwd=bn_bf16_bwd)
