"""BN folding + int8 post-training quantization for PoseNet/MapNet inference.

The PyTorch counterpart of :mod:`geomapnet_tpu.models.quant`, with the same
function names. Two inference trees share one trunk walk:

- **folded float** (:func:`fold_posenet_variables`): inference BatchNorm
  folded into each conv's kernel and a bias (``--fold_bn``); the convs run
  as ``F.conv2d`` in the compute dtype, as the port's float ResNet does;
- **int8 PTQ** (:func:`quantize_posenet_variables`): symmetric
  per-output-channel int8 weights with BN folded into the dequant multiplier
  ``m``; the int32 accumulator is rescaled once (``acc * (m * x_scale) +
  b``) and shifted by ``b``.

Activation scales are dynamic (``max|x| / 127`` per batch) or static
(:func:`calibrate_activation_scales`). With static scales on every site of a
basic-block trunk, the fused dataflow (:func:`_trunk_forward_fused`) keeps
every activation int8 between convs: each conv's epilogue dequantizes,
relus, adds the shortcut and requantizes to the next site's scale.

Tree preparation is numpy, copied from the JAX module (its lines 61-195,
283-293, 446-452 and 526-584): the trees equal the JAX package's bit for
bit. The forwards run on :class:`QuantizedPoseNet`, an ``nn.Module`` that
holds a prepared tree's tensors as buffers on the device. Every int8 conv,
fused or not, runs through the hand-written CUDA kernel K1, each site
through its own :class:`geomapnet_tpu_torch.ops.cuda_quant.PreparedConv`
(launch arguments prepared once), and the fused stem's
int8 max-pool through K2
(:func:`geomapnet_tpu_torch.ops.cuda_quant.int8_maxpool3x3s2`); on CPU
tensors both take their plain versions. While the module is traced for
export (:mod:`geomapnet_tpu_torch.serving`), K1 and K2 are called through
their ``torch.library`` operators instead
(:mod:`geomapnet_tpu_torch.ops.library`). The int8 ``fc_feat`` head's int32
product runs on ``torch._int_mm``.

Rounding follows what XLA compiles the JAX source to on the CPU: the
dequant ``acc * ms + b`` is one FMA; a dynamic scale ``max(|x|, 1e-12) /
127.0`` is a multiply by float32(1/127); a division by a scale passed as an
argument is a true division.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import library
from ..ops.cuda_quant import (
    PreparedConv,
    fma_f32,
    int8_maxpool3x3s2,
    pack_conv_weight,
)

__all__ = [
    "quantize_posenet_variables",
    "fold_posenet_variables",
    "calibrate_activation_scales",
    "QuantizedPoseNet",
    "posenet_apply_int8",
    "mapnet_apply_int8",
    "posenet_apply_folded",
    "mapnet_apply_folded",
    "convert_stem_s2d",
    "quantize_input_int8",
    "space_to_depth_input",
]

_BN_EPS = 1e-5  # matches models/resnet.py
# XLA compiles the JAX module's ``/ 127.0`` of a dynamic scale to a multiply
# by float32(1/127); a multiply by a Python float is exact in PyTorch
_INV127 = float(np.float32(1.0 / 127.0))
_PAD1 = ((1, 1), (1, 1))
_PAD0 = ((0, 0), (0, 0))


# ---------------------------------------------------------------- trees (numpy)


def _bn_affine(bn_params: Mapping, bn_stats: Mapping):
    """Inference BN as a per-channel affine: returns (a, b) with BN(z)=a*z+b."""
    a = np.asarray(bn_params["scale"], np.float32) / np.sqrt(
        np.asarray(bn_stats["var"], np.float32) + _BN_EPS
    )
    b = np.asarray(bn_params["bias"], np.float32) - np.asarray(
        bn_stats["mean"], np.float32
    ) * a
    return a, b


def _fold_conv_bn(kernel: np.ndarray, bn_params: Mapping, bn_stats: Mapping,
                  ) -> dict:
    """Quantize one conv kernel with its BatchNorm folded in.

    kernel: (H, W, I, O) float; BN affine a*z + b computed from
    scale/bias/mean/var. Returns {qkernel int8, m (O,) f32, b (O,) f32} with
    ``conv_int32 * (m * x_scale) + b`` reproducing BN(conv(x)).
    """
    kernel = np.asarray(kernel, np.float32)
    a, b = _bn_affine(bn_params, bn_stats)

    w_absmax = np.max(np.abs(kernel), axis=(0, 1, 2))  # per out channel
    w_scale = np.maximum(w_absmax, 1e-12) / 127.0
    qkernel = np.clip(np.round(kernel / w_scale), -127, 127).astype(np.int8)
    return {
        "qkernel": qkernel,
        "m": (a * w_scale).astype(np.float32),
        "b": b.astype(np.float32),
    }


def _fold_conv_bn_float(kernel: np.ndarray, bn_params: Mapping,
                        bn_stats: Mapping) -> dict:
    """Fold BN into the conv weights WITHOUT quantizing (serving float path).

    Returns {kernel (H,W,I,O) f32 scaled per out channel, b (O,) f32} with
    ``conv(x, kernel) + b`` reproducing BN(conv(x)) exactly (in f32).
    """
    kernel = np.asarray(kernel, np.float32)
    a, b = _bn_affine(bn_params, bn_stats)
    return {"kernel": (kernel * a).astype(np.float32),
            "b": b.astype(np.float32)}


def _walk_block(params: Mapping, stats: Mapping, fold) -> dict:
    out = {
        "conv1": fold(params["conv1"]["kernel"], params["bn1"], stats["bn1"]),
        "conv2": fold(params["conv2"]["kernel"], params["bn2"], stats["bn2"]),
    }
    if "conv3" in params:  # Bottleneck (resnet50-family)
        out["conv3"] = fold(params["conv3"]["kernel"], params["bn3"],
                            stats["bn3"])
    if "downsample_conv" in params:
        out["downsample"] = fold(
            params["downsample_conv"]["kernel"], params["downsample_bn"],
            stats["downsample_bn"],
        )
    return out


def _np_tree(tree: Mapping) -> dict:
    """Nested dict with every leaf as a numpy array (the JAX module's
    ``jax.tree.map(np.asarray, ...)``)."""
    return {k: _np_tree(v) if isinstance(v, Mapping) else np.asarray(v)
            for k, v in tree.items()}


def _copy_containers(tree: Mapping) -> dict:
    """New dicts all the way down, leaves shared."""
    return {k: _copy_containers(v) if isinstance(v, Mapping) else v
            for k, v in tree.items()}


def _prepare_tree(variables: Mapping, stage_sizes, fold,
                  quantize_heads: bool = False) -> dict:
    params, stats = variables["params"], variables["batch_stats"]
    if "posenet" in params:  # MapNet nesting
        params, stats = params["posenet"], stats["posenet"]
    fe_p, fe_s = params["feature_extractor"], stats["feature_extractor"]

    trunk: dict[str, Any] = {
        "conv1": fold(fe_p["conv1"]["kernel"], fe_p["bn1"], fe_s["bn1"]),
    }
    for stage, n_blocks in enumerate(stage_sizes):
        for block in range(n_blocks):
            name = f"layer{stage + 1}_{block}"
            trunk[name] = _walk_block(fe_p[name], fe_s[name], fold)

    heads = {k: _np_tree(params[k]) for k in ("fc_feat", "fc_xyz", "fc_wpqr")}
    if quantize_heads:
        # the 512->2048 fc_feat matmul is the only head worth int8; the
        # 3-wide pose heads are noise. Per-output-channel symmetric weights.
        w = np.asarray(heads["fc_feat"]["kernel"], np.float32)  # (I, O)
        w_scale = np.maximum(np.max(np.abs(w), axis=0), 1e-12) / 127.0
        heads["fc_feat"] = {
            "qkernel": np.clip(np.round(w / w_scale), -127, 127
                               ).astype(np.int8),
            "m": w_scale.astype(np.float32),
            "b": np.asarray(heads["fc_feat"]["bias"], np.float32),
        }
    return {"trunk": trunk, "heads": heads}


def _stage_sizes(trunk: Mapping) -> tuple:
    """Recover (n_blocks per stage) from the trunk's ``layer{s}_{b}`` keys."""
    counts: dict[int, int] = {}
    for k in trunk:
        if k.startswith("layer"):
            s, b = k[5:].split("_")
            counts[int(s)] = max(counts.get(int(s), 0), int(b) + 1)
    return tuple(counts[s] for s in sorted(counts))


def quantize_posenet_variables(variables: Mapping, stage_sizes=(3, 4, 6, 3),
                               quantize_heads: bool = False) -> dict:
    """PoseNet variables -> int8 inference tree.

    Accepts the ``{"params", "batch_stats"}`` tree of a PoseNet (or the
    ``posenet``-nested MapNet equivalent), e.g. from
    :func:`geomapnet_tpu_torch.models.flax_import.load_npz` or
    :func:`~geomapnet_tpu_torch.models.flax_import.state_dict_to_variables`.
    Pose heads stay float; ``quantize_heads`` also runs the fc_feat matmul
    in int8.
    """
    return _prepare_tree(variables, stage_sizes, _fold_conv_bn,
                         quantize_heads=quantize_heads)


def fold_posenet_variables(variables: Mapping, stage_sizes=(3, 4, 6, 3)
                           ) -> dict:
    """PoseNet variables -> BN-folded FLOAT inference tree (no quant)."""
    return _prepare_tree(variables, stage_sizes, _fold_conv_bn_float)


def _iter_sites(qtree: Mapping):
    """Yield conv-site dicts in exactly ``_trunk_forward``'s visit order."""
    trunk = qtree["trunk"]
    yield trunk["conv1"]
    for stage, n_blocks in enumerate(_stage_sizes(trunk)):
        for block in range(n_blocks):
            blk = trunk[f"layer{stage + 1}_{block}"]
            for key in ("conv1", "conv2", "conv3", "downsample"):
                if key in blk:
                    yield blk[key]


def _is_fusable(qtree: Mapping) -> bool:
    """Fused dataflow needs static scales everywhere and basic blocks only."""
    sites = list(_iter_sites(qtree))
    return all("qkernel" in s and "x_scale" in s for s in sites) and not any(
        "conv3" in qtree["trunk"][k] for k in qtree["trunk"]
        if k.startswith("layer")
    )


def _stem_kernel_s2d(k7: np.ndarray) -> np.ndarray:
    """Rearrange a (7,7,C,O) stride-2 stem kernel for the S2D dataflow.

    The stride-2 7x7 conv ``y[i,j] = sum_{a,b} x[2i+a-3, 2j+b-3] k[a,b]``
    regroups exactly over 2x2 input blocks: with ``x2[p,q,(dh,dw)] =
    x[2p+dh, 2q+dw]`` each tap ``a`` lands in block ``p = i + m - 2`` with
    ``a = 2m - 1 + dh``, so the whole stem is a STRIDE-1 4x4 conv over x2
    with padding (2, 1). (m=0, dh=0) falls outside the 7-tap support and
    stays zero.
    """
    kh, kw, c, o = k7.shape
    if (kh, kw) != (7, 7):
        raise ValueError(f"S2D stem rearrange expects a 7x7 kernel, "
                         f"got {(kh, kw)}")
    k4 = np.zeros((4, 4, 4 * c, o), k7.dtype)
    for m in range(4):
        for dh in range(2):
            a = 2 * m - 1 + dh
            if not 0 <= a < 7:
                continue
            for n_ in range(4):
                for dw in range(2):
                    b = 2 * n_ - 1 + dw
                    if not 0 <= b < 7:
                        continue
                    blk = (dh * 2 + dw) * c
                    k4[m, n_, blk:blk + c, :] = k7[a, b]
    return k4


def convert_stem_s2d(qtree: Mapping) -> dict:
    """Rewrite an int8 tree's stem site for the space-to-depth dataflow.

    Returns a new tree (leaves shared except conv1's qkernel) whose stem is
    the stride-1 4x4 conv over 2x2-space-to-depth input: bit-exact on the
    int8 path (integer accumulation is associative). The fused forward
    dispatches on the kernel's shape; non-fused paths reject S2D trees.
    """
    c1 = qtree["trunk"]["conv1"]
    if "qkernel" not in c1:
        raise ValueError("convert_stem_s2d needs an int8 tree (--quantize)")
    if c1["qkernel"].shape[:2] == (4, 4):
        return dict(qtree)  # already converted
    new_c1 = dict(c1)
    new_c1["qkernel"] = _stem_kernel_s2d(np.asarray(c1["qkernel"]))
    out = dict(qtree)
    out["trunk"] = dict(qtree["trunk"])
    out["trunk"]["conv1"] = new_c1
    return out


def _stem_is_s2d(qtree: Mapping) -> bool:
    c1 = qtree["trunk"]["conv1"]
    return "qkernel" in c1 and c1["qkernel"].shape[:2] == (4, 4)


# ------------------------------------------------------ the tree on the device


def _f32(v) -> torch.Tensor:
    return torch.tensor(np.asarray(v, np.float32))


class _Site(nn.Module):
    """One conv site: packed int8 kernel, ``m``, ``b`` and an optional static
    ``x_scale``; or, folded float, an OIHW ``kernel`` and ``b``. An int8
    site runs K1 through :meth:`conv`."""

    def __init__(self, q: Mapping):
        super().__init__()
        self.int8 = "qkernel" in q
        if self.int8:
            qk = np.asarray(q["qkernel"])
            self.ksize = tuple(qk.shape[:2])
            self.cin = qk.shape[2]
            self.register_buffer("w", pack_conv_weight(qk))
            self.register_buffer("m", _f32(q["m"]))
            self.register_buffer(
                "x_scale", _f32(q["x_scale"]) if "x_scale" in q else None)
        else:
            k = np.asarray(q["kernel"], np.float32)
            self.ksize = tuple(k.shape[:2])
            self.cin = k.shape[2]
            self.register_buffer("kernel", torch.from_numpy(
                np.ascontiguousarray(k.transpose(3, 2, 0, 1))))
        self.register_buffer("b", _f32(q["b"]))
        self._k1: PreparedConv | None = None

    def conv(self, x: torch.Tensor, s_in, **kw) -> torch.Tensor:
        """K1 on this site's weights (keywords as
        :func:`~geomapnet_tpu_torch.ops.cuda_quant.int8_conv`'s, less
        ``ksize``). The launch arguments are prepared at the first call and
        again after ``.to()`` moves the buffers; while traced for export,
        the call goes through K1's operator."""
        if library.tracing():
            return library.int8_conv(x, self.w, self.m, self.b, s_in,
                                     ksize=self.ksize, **kw)
        k1 = self._k1
        if k1 is None or k1.w is not self.w or k1.m is not self.m \
                or k1.b is not self.b:
            k1 = self._k1 = PreparedConv(self.w, self.m, self.b, self.ksize)
        return k1(x, s_in, **kw)


class _Dense(nn.Module):
    """A head: float (I, O) ``kernel`` and ``bias``, or the int8 fc_feat's
    (I, O) ``qkernel``, ``m``, ``b`` and optional static ``x_scale``."""

    def __init__(self, p: Mapping):
        super().__init__()
        self.int8 = "qkernel" in p
        if self.int8:
            # stored (O, I) and used transposed: the column-major (I, O)
            # operand that cuBLASLt's int8 product takes on every version
            self.register_buffer("qkernel_t", torch.from_numpy(
                np.ascontiguousarray(np.asarray(p["qkernel"]).T)))
            self.register_buffer("m", _f32(p["m"]))
            self.register_buffer("b", _f32(p["b"]))
            self.register_buffer(
                "x_scale", _f32(p["x_scale"]) if "x_scale" in p else None)
        else:
            self.register_buffer("kernel", _f32(p["kernel"]))
            self.register_buffer("bias", _f32(p["bias"]))


class QuantizedPoseNet(nn.Module):
    """A prepared int8 or folded tree as an ``nn.Module`` of buffers, laid
    out as the tree: ``trunk["conv1"]``, ``trunk["layer1_0"]["conv2"]``,
    ``heads["fc_feat"]`` ...; ``.to(device)`` moves it.

    ``forward(images)`` is :func:`posenet_apply_int8` at the module's
    ``dtype`` and ``fused`` setting: (N, H, W, 3) float (or, fused,
    prequantized int8) images -> (N, 6) float32 poses.
    """

    def __init__(self, qtree: Mapping, dtype: torch.dtype = torch.bfloat16,
                 fused: bool = False):
        super().__init__()
        tr = qtree["trunk"]
        self.stage_sizes = _stage_sizes(tr)
        self.trunk = nn.ModuleDict({"conv1": _Site(tr["conv1"])})
        for k, blk in tr.items():
            if k.startswith("layer"):
                self.trunk[k] = nn.ModuleDict(
                    {s: _Site(q) for s, q in blk.items()})
        self.heads = nn.ModuleDict(
            {k: _Dense(p) for k, p in qtree["heads"].items()})
        self.fusable = _is_fusable(qtree)
        self.stem_s2d = _stem_is_s2d(qtree)
        self.dtype = dtype
        self.fused = fused
        if fused and not self.fusable:
            raise ValueError(
                "fused requant needs calibrated static scales on every "
                "site and a basic-block (resnet18/34) trunk")

    def blocks(self) -> list:
        return [self.trunk[f"layer{s + 1}_{b}"]
                for s, n in enumerate(self.stage_sizes) for b in range(n)]

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return posenet_apply_int8(self, images, self.dtype, self.fused)

    def features(self, images: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) images -> (N, F) trunk features (:meth:`head`'s
        input); ``forward`` is ``head(features(images))``."""
        return _trunk_features(self, images, self.dtype, self.fused)

    def head(self, feats: torch.Tensor) -> torch.Tensor:
        """(N, F) trunk features -> (N, 6) float32 poses."""
        return _apply_heads(self, feats, self.dtype)


# ------------------------------------------------------------------ forwards


def _q8(x: torch.Tensor, x_scale: torch.Tensor) -> torch.Tensor:
    """Symmetric per-tensor quantize to int8; a true division by the scale
    tensor (on the card, dividing by a Python float would multiply by its
    reciprocal)."""
    return torch.clamp(torch.round(x / x_scale), -127, 127).to(torch.int8)


def _dynamic_scale(x: torch.Tensor) -> torch.Tensor:
    """``max(max|x|, 1e-12) / 127`` as XLA compiles it (times f32(1/127))."""
    return torch.clamp_min(x.abs().amax().to(torch.float32), 1e-12) * _INV127


def _nhwc_conv(x, kernel, stride, pad):
    """Float NHWC conv through cuDNN (channels_last), symmetric padding."""
    y = F.conv2d(x.permute(0, 3, 1, 2), kernel, stride=tuple(stride),
                 padding=pad[0][0])
    return y.permute(0, 2, 3, 1)


def _conv_site(x: torch.Tensor, q: _Site, stride, padding,
               dtype=torch.bfloat16, observe: list | None = None
               ) -> torch.Tensor:
    """One conv site: int8 (dynamic or static scale) or folded float.

    ``observe`` (calibration mode): append this site's input absmax, in the
    order :func:`_iter_sites` walks the tree.
    """
    if observe is not None:
        observe.append(x.to(torch.float32).abs().amax())
    if not q.int8:  # folded float path
        y = _nhwc_conv(x.to(dtype), q.kernel.to(dtype), stride, padding)
        return y + q.b.to(dtype)
    x_scale = q.x_scale if q.x_scale is not None else _dynamic_scale(x)
    qx = _q8(x.to(torch.float32), x_scale).contiguous()
    return q.conv(qx, x_scale, stride=tuple(stride), pad=padding, mode="deq",
                  out_dtype=dtype)


def _basic_block(x, q, stride, dtype, observe):
    y = _conv_site(x, q["conv1"], stride, _PAD1, dtype, observe)
    y = torch.relu(y)
    y = _conv_site(y, q["conv2"], (1, 1), _PAD1, dtype, observe)
    identity = (
        _conv_site(x, q["downsample"], stride, _PAD0, dtype, observe)
        if "downsample" in q else x
    )
    return torch.relu(y + identity)


def _bottleneck_block(x, q, stride, dtype, observe):
    y = _conv_site(x, q["conv1"], (1, 1), _PAD0, dtype, observe)
    y = torch.relu(y)
    y = _conv_site(y, q["conv2"], stride, _PAD1, dtype, observe)
    y = torch.relu(y)
    y = _conv_site(y, q["conv3"], (1, 1), _PAD0, dtype, observe)
    identity = (
        _conv_site(x, q["downsample"], stride, _PAD0, dtype, observe)
        if "downsample" in q else x
    )
    return torch.relu(y + identity)


def _strides(stage_sizes) -> list:
    # stages after the first open with a stride-2 block (resnet50's
    # layer1_0 has a stride-1 projection, so the downsample does not say)
    return [(2, 2) if (stage > 0 and block == 0) else (1, 1)
            for stage, n in enumerate(stage_sizes) for block in range(n)]


def _trunk_forward(qnet: QuantizedPoseNet, x: torch.Tensor,
                   dtype=torch.bfloat16, observe: list | None = None
                   ) -> torch.Tensor:
    x = _conv_site(x, qnet.trunk["conv1"], (2, 2), ((3, 3), (3, 3)), dtype,
                   observe)
    x = torch.relu(x)
    # -inf padding, as lax.reduce_window's init in the JAX module
    x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
    for q, stride in zip(qnet.blocks(), _strides(qnet.stage_sizes)):
        run = _bottleneck_block if "conv3" in q else _basic_block
        x = run(x, q, stride, dtype, observe)
    return x.to(torch.float32).mean(dim=(1, 2)).to(dtype)


def calibrate_activation_scales(qtree: Mapping, batches,
                                dtype=torch.bfloat16,
                                device: torch.device | None = None) -> dict:
    """Bake static activation scales into an int8 tree.

    Runs the dynamic-scale int8 forward over ``batches`` — an iterable of
    (N, H, W, 3) or (N, T, H, W, 3) preprocessed image tensors (or arrays) —
    on ``device`` (default: each batch's own), observing each conv input's
    absmax, and returns a new tree whose sites carry ``x_scale =
    max_batches(absmax) / 127``. A dynamic scale couples batchmates, so the
    scales equal the JAX package's only for the same batches.
    """
    if _stem_is_s2d(qtree):
        raise ValueError("calibrate before convert_stem_s2d: the observer "
                         "walk runs the canonical 7x7-stem trunk")
    head_q = "qkernel" in qtree["heads"]["fc_feat"]
    qnet = None
    mx = None
    with torch.inference_mode():
        for batch in batches:
            x = torch.as_tensor(batch)
            if device is not None:
                x = x.to(device)
            if qnet is None:
                qnet = QuantizedPoseNet(qtree, dtype).to(x.device)
            if x.dim() == 5:
                x = x.reshape(-1, *x.shape[2:])
            obs: list = []
            feat = _trunk_forward(qnet, x.to(dtype), dtype, observe=obs)
            if head_q:
                obs.append(feat.to(torch.float32).abs().amax())
            m = torch.stack(obs)
            mx = m if mx is None else torch.maximum(mx, m)
    if mx is None:
        raise ValueError("calibration requires at least one batch")
    mx = mx.to("cpu").numpy().astype(np.float32)

    out = _copy_containers(qtree)
    sites = list(_iter_sites(out))
    if head_q:
        sites.append(out["heads"]["fc_feat"])
    if len(sites) != len(mx):
        raise AssertionError(
            f"site walk ({len(sites)}) and observation ({len(mx)}) diverged")
    for site, absmax in zip(sites, mx):
        site["x_scale"] = np.float32(max(float(absmax), 1e-12) / 127.0)
    return out


def _fused_basic_block(qx: torch.Tensor, s_in: torch.Tensor, q, stride,
                       s_out: torch.Tensor | None) -> torch.Tensor:
    """Basic block with int8 dataflow: int8 in (scale ``s_in``), int8 out
    (scale ``s_out``), or float32 out when ``s_out`` is None (last block).
    Two or three K1 launches: conv1 (relu + requant to conv2's scale), the
    downsample (float32 dequant) when there is one, conv2 (dequant, add the
    shortcut, relu, requant)."""
    c1, c2 = q["conv1"], q["conv2"]
    stride = tuple(stride)
    q1 = c1.conv(qx, s_in, stride=stride, pad=_PAD1, mode="relu_q",
                 s_out=c2.x_scale)
    if "downsample" in q:
        idn = q["downsample"].conv(qx, s_in, stride=stride, pad=_PAD0,
                                   mode="deq", out_dtype=torch.float32)
        return c2.conv(q1, c2.x_scale, stride=(1, 1), pad=_PAD1,
                       mode="residual", residual=idn, s_out=s_out)
    return c2.conv(q1, c2.x_scale, stride=(1, 1), pad=_PAD1, mode="residual",
                   residual=qx, res_scale=s_in, s_out=s_out)


def _trunk_forward_fused(qnet: QuantizedPoseNet, x: torch.Tensor,
                         dtype=torch.bfloat16) -> torch.Tensor:
    """Static-scale int8 trunk with fused requantization (int8 dataflow):
    1 + 2 per block + 1 per downsample K1 launches and one K2 launch."""
    blocks = qnet.blocks()
    c1 = qnet.trunk["conv1"]
    s_in = c1.x_scale
    # int8 input passes through untouched: the caller pre-quantized at the
    # stem's static scale (quantize_input_int8, the prequantized row cache)
    qx = x if x.dtype == torch.int8 else _q8(x.to(torch.float32), s_in)
    s1 = blocks[0]["conv1"].x_scale
    if c1.ksize == (4, 4):  # S2D stem (convert_stem_s2d)
        if qx.shape[-1] * 4 == c1.cin:
            # not yet rearranged (a prequantized S2D cache ships 4C-channel
            # frames and skips this)
            qx = space_to_depth_input(qx)
        qy = c1.conv(qx.contiguous(), s_in, stride=(1, 1),
                     pad=((2, 1), (2, 1)), mode="relu_q", s_out=s1)
    else:
        qy = c1.conv(qx.contiguous(), s_in, stride=(2, 2),
                     pad=((3, 3), (3, 3)), mode="relu_q", s_out=s1)
    qy = (library.int8_maxpool3x3s2(qy) if library.tracing()
          else int8_maxpool3x3s2(qy))
    for i, (q, stride) in enumerate(zip(blocks,
                                        _strides(qnet.stage_sizes))):
        s_out = (blocks[i + 1]["conv1"].x_scale
                 if i + 1 < len(blocks) else None)
        qy = _fused_basic_block(qy, q["conv1"].x_scale, q, stride, s_out)
    return qy.mean(dim=(1, 2)).to(dtype)


def _int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32 through ``torch._int_mm``;
    the CUDA path wants more than 16 rows, so fewer are zero-padded (K and
    N must be multiples of 8 there). A graph traced for export pads every
    batch by 17 rows: its row count is symbolic, and it may run on either
    device."""
    rows = a.shape[0]
    if library.tracing():
        a = torch.cat([a, a.new_zeros((17, a.shape[1]))])
    elif a.device.type == "cuda" and rows <= 16:
        a = torch.cat([a, a.new_zeros((32 - rows, a.shape[1]))])
    return torch._int_mm(a.contiguous(), b)[:rows]


def _apply_heads(qnet: QuantizedPoseNet, feat: torch.Tensor, dtype
                 ) -> torch.Tensor:
    heads = qnet.heads

    def dense(h, p):
        return h @ p.kernel.to(dtype) + p.bias.to(dtype)

    fc_feat = heads["fc_feat"]
    if fc_feat.int8:
        # a static scale keeps each row's output independent of its
        # batchmates; a dynamic one couples them
        x_scale = (fc_feat.x_scale if fc_feat.x_scale is not None
                   else _dynamic_scale(feat))
        qh = _q8(feat.to(torch.float32), x_scale)
        acc = _int_mm(qh, fc_feat.qkernel_t.t())
        h = fma_f32(acc.to(torch.float32), fc_feat.m * x_scale, fc_feat.b)
        h = h.to(dtype)
    else:
        h = dense(feat, fc_feat)
    h = torch.relu(h)
    xyz = dense(h, heads["fc_xyz"]).to(torch.float32)
    wpqr = dense(h, heads["fc_wpqr"]).to(torch.float32)
    return torch.cat([xyz, wpqr], dim=-1)


def quantize_input_int8(qnet: QuantizedPoseNet, images: torch.Tensor
                        ) -> torch.Tensor:
    """Pre-quantize preprocessed images to the stem conv's static scale: the
    fused trunk's int8 stem input, a per-frame function that a device cache
    can store (:func:`geomapnet_tpu_torch.data.device_cache.quantize_rows`).
    """
    c1 = qnet.trunk["conv1"]
    if not c1.int8 or c1.x_scale is None:
        raise ValueError("quantize_input_int8 needs an int8 trunk with a "
                         "calibrated static stem scale (--calibrate N)")
    return _q8(images.to(torch.float32), c1.x_scale)


def space_to_depth_input(x: torch.Tensor) -> torch.Tensor:
    """2x2 space-to-depth: (N, H, W, C) -> (N, ceil(H/2), ceil(W/2), 4C).

    Odd spatial dims are zero-padded high first (zero is the conv padding
    value in both the float and the symmetric-int8 domain). Channel order is
    ``(dh*2 + dw)*C + c`` — the layout :func:`_stem_kernel_s2d` targets.
    """
    n, h, w, c = x.shape
    if h % 2 or w % 2:
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        h, w = h + h % 2, w + w % 2
    x = x.reshape(n, h // 2, 2, w // 2, 2, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h // 2, w // 2, 4 * c)


def posenet_apply_int8(qnet: QuantizedPoseNet, images: torch.Tensor,
                       dtype=torch.bfloat16, fused: bool = False
                       ) -> torch.Tensor:
    """(N, H, W, 3) -> (N, 6) poses via the int8 (or folded) trunk and the
    heads.

    ``fused=True`` (static-calibrated basic-block trees only) runs the
    int8-dataflow trunk (:func:`_trunk_forward_fused`). Raises if the tree
    isn't fusable, on int8 input without ``fused``, and on an S2D tree
    without ``fused``.
    """
    return _apply_heads(qnet, _trunk_features(qnet, images, dtype, fused),
                        dtype)


def _trunk_features(qnet: QuantizedPoseNet, images: torch.Tensor, dtype,
                    fused: bool) -> torch.Tensor:
    """(N, H, W, 3) -> (N, F): :func:`posenet_apply_int8`'s trunk."""
    if fused:
        if not qnet.fusable:
            raise ValueError(
                "fused requant needs calibrated static scales on every "
                "site and a basic-block (resnet18/34) trunk")
        return _trunk_forward_fused(qnet, images, dtype)
    if images.dtype == torch.int8:
        raise ValueError("prequantized int8 input "
                         "(quantize_input_int8) needs fused=True")
    if qnet.stem_s2d:
        raise ValueError("space-to-depth stem trees (convert_stem_s2d) "
                         "run fused only; pass fused=True")
    return _trunk_forward(qnet, images.to(dtype), dtype)


def mapnet_apply_int8(qnet: QuantizedPoseNet, images: torch.Tensor,
                      dtype=torch.bfloat16, fused: bool = False
                      ) -> torch.Tensor:
    """(N, T, H, W, 3) -> (N, T, 6): shared-weight PoseNet per frame."""
    n, t = images.shape[:2]
    flat = images.reshape(n * t, *images.shape[2:])
    out = posenet_apply_int8(qnet, flat, dtype, fused=fused)
    return out.reshape(n, t, 6)


# The folded-float tree runs through the identical walk; these aliases keep
# call sites honest about which tree they hold.
posenet_apply_folded = posenet_apply_int8
mapnet_apply_folded = mapnet_apply_int8
