"""Plain float32 MapNet: a ResNet trunk and the PoseNet heads, written from
the architecture's description (He et al. 2016, torchvision's BasicBlock
topology; Kendall et al. 2015 / Brahmbhatt et al. 2018 for the heads).

Parameters are one flat dict of tensors keyed by module path
(``feature_extractor.layer2_0.conv1.weight``, ``fc_feat.bias`` ...), the
naming the benchmark's weight generator uses. Convolutions are NCHW,
``torch.nn.functional`` only, float32. Nothing here imports the measured
program.

The same walk serves the control of the int8 cells: ``quant`` (a
:class:`FakeQuant`) folds each BatchNorm into its conv, rounds every conv
kernel per output channel and every conv input per tensor to ``bits``
signed levels, and does the same for ``fc_feat``; everything else stays
float32.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

__all__ = ["param_specs", "FakeQuant", "forward", "trunk", "head",
           "normalize_rgb", "BN_EPS"]

BN_EPS = 1e-5


def _blocks(stage_sizes):
    """(name, in channels, filters, stride) of every basic block."""
    cin = 64
    for s, n in enumerate(stage_sizes):
        f = 64 * 2 ** s
        for b in range(n):
            yield f"layer{s + 1}_{b}", cin, f, 2 if (s > 0 and b == 0) else 1
            cin = f


def param_specs(stage_sizes=(3, 4, 6, 3), feat_dim=2048) -> list:
    """(name, shape, kind) of every tensor of a ResNet-trunk PoseNet, kind
    one of conv, bn_weight, bn_bias, bn_mean, bn_var, bn_count, fc_weight,
    fc_bias."""
    out = []

    def conv(name, o, i, k):
        out.append((f"feature_extractor.{name}.weight", (o, i, k, k),
                    "conv"))

    def bn(name, c):
        for leaf, kind in (("weight", "bn_weight"), ("bias", "bn_bias"),
                           ("running_mean", "bn_mean"),
                           ("running_var", "bn_var"),
                           ("num_batches_tracked", "bn_count")):
            out.append((f"feature_extractor.{name}.{leaf}",
                        () if kind == "bn_count" else (c,), kind))

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    cin = 64
    for name, cin, f, stride in _blocks(stage_sizes):
        conv(f"{name}.conv1", f, cin, 3)
        bn(f"{name}.bn1", f)
        conv(f"{name}.conv2", f, f, 3)
        bn(f"{name}.bn2", f)
        if stride != 1 or cin != f:
            conv(f"{name}.downsample_conv", f, cin, 1)
            bn(f"{name}.downsample_bn", f)
    width = 64 * 2 ** (len(stage_sizes) - 1)
    for name, o, i in (("fc_feat", feat_dim, width), ("fc_xyz", 3, feat_dim),
                       ("fc_wpqr", 3, feat_dim)):
        out.append((f"{name}.weight", (o, i), "fc_weight"))
        out.append((f"{name}.bias", (o,), "fc_bias"))
    return out


@dataclasses.dataclass
class FakeQuant:
    """Round to ``bits`` signed levels: kernels per output channel at their
    absmax, activations per tensor at ``scales[site]`` (filled by a
    calibration pass: ``observe`` records each site's input absmax)."""

    bits: int
    scales: dict = dataclasses.field(default_factory=dict)
    observe: bool = False

    @property
    def levels(self) -> float:
        return float(2 ** (self.bits - 1) - 1)

    def kernel(self, w: torch.Tensor) -> torch.Tensor:
        dims = tuple(range(1, w.dim()))
        s = w.abs().amax(dim=dims, keepdim=True).clamp_min(1e-12) / self.levels
        return torch.round(w / s).clamp(-self.levels, self.levels) * s

    def act(self, site: str, x: torch.Tensor) -> torch.Tensor:
        if self.observe:
            m = x.abs().amax()
            self.scales[site] = torch.maximum(self.scales[site], m) \
                if site in self.scales else m
            return x
        s = self.scales[site].clamp_min(1e-12) / self.levels
        return torch.round(x / s).clamp(-self.levels, self.levels) * s


def _conv_bn(p, x, conv, bn, stride, pad, train, quant, stats,
             momentum=0.1):
    """conv (no bias) then BatchNorm: batch statistics in ``train`` (the
    running statistics in ``stats`` move at ``momentum``), else the running
    ones; with ``quant`` the BatchNorm is folded into the conv first."""
    w = p[f"{conv}.weight"]
    g, b = p[f"{bn}.weight"], p[f"{bn}.bias"]
    rm, rv = stats[f"{bn}.running_mean"], stats[f"{bn}.running_var"]
    if quant is not None:
        inv = g / torch.sqrt(rv + BN_EPS)
        wf = quant.kernel(w * inv.view(-1, 1, 1, 1))
        return F.conv2d(quant.act(conv, x), wf, b - rm * inv, stride, pad)
    y = F.conv2d(x, w, None, stride, pad)
    return F.batch_norm(y, rm, rv, g, b, train, momentum, BN_EPS)


def trunk(p: dict, x: torch.Tensor, stage_sizes, train: bool = False,
          quant: FakeQuant | None = None, stats: dict | None = None,
          momentum: float = 0.1) -> torch.Tensor:
    """(N, 3, H, W) float32 -> (N, C) pooled features. ``stats``: the
    BatchNorm running statistics (default: ``p``'s own tensors, which a
    train-mode call then moves at ``momentum``)."""
    stats = p if stats is None else stats
    fe = "feature_extractor"
    kw = dict(train=train, quant=quant, stats=stats, momentum=momentum)
    x = torch.relu(_conv_bn(p, x, f"{fe}.conv1", f"{fe}.bn1", 2, 3, **kw))
    x = F.max_pool2d(x, 3, 2, 1)
    for name, cin, f, stride in _blocks(stage_sizes):
        n = f"{fe}.{name}"
        y = torch.relu(_conv_bn(p, x, f"{n}.conv1", f"{n}.bn1", stride, 1,
                                **kw))
        y = _conv_bn(p, y, f"{n}.conv2", f"{n}.bn2", 1, 1, **kw)
        if stride != 1 or cin != f:
            x = _conv_bn(p, x, f"{n}.downsample_conv", f"{n}.downsample_bn",
                         stride, 0, **kw)
        x = torch.relu(y + x)
    return x.mean(dim=(2, 3))


def head(p: dict, feats: torch.Tensor, keep_mask: torch.Tensor | None = None,
         droprate: float = 0.5, quant: FakeQuant | None = None
         ) -> torch.Tensor:
    """(N, C) features -> (N, 6) [xyz, log q]: fc_feat, relu, dropout (the
    kept features scaled by 1 / (1 - droprate)), then the two heads."""
    w = p["fc_feat.weight"]
    if quant is not None:
        feats, w = quant.act("fc_feat", feats), quant.kernel(w)
    h = torch.relu(F.linear(feats, w, p["fc_feat.bias"]))
    if keep_mask is not None:
        h = torch.where(keep_mask, h / (1.0 - droprate), torch.zeros_like(h))
    return torch.cat([F.linear(h, p["fc_xyz.weight"], p["fc_xyz.bias"]),
                      F.linear(h, p["fc_wpqr.weight"], p["fc_wpqr.bias"])],
                     dim=-1)


def forward(p: dict, x: torch.Tensor, stage_sizes, train: bool = False,
            keep_mask: torch.Tensor | None = None, droprate: float = 0.5,
            quant: FakeQuant | None = None, stats: dict | None = None
            ) -> torch.Tensor:
    """(N, 3, H, W) normalized images -> (N, 6) poses."""
    return head(p, trunk(p, x, stage_sizes, train, quant, stats), keep_mask,
                droprate, quant)


def normalize_rgb(images: torch.Tensor, mean, std) -> torch.Tensor:
    """(N, H, W, 3) uint8 -> (N, 3, H, W) float32 ``(x / 255 - mean) /
    std``."""
    x = images.permute(0, 3, 1, 2).float() / 255.0
    m = torch.tensor(mean, dtype=torch.float32, device=x.device)
    s = torch.tensor(std, dtype=torch.float32, device=x.device)
    return (x - m.view(1, 3, 1, 1)) / s.view(1, 3, 1, 1)
