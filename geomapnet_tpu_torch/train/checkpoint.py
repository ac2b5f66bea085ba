"""Checkpoints: ``torch.save`` of the whole training state, and weight
loading from the port's checkpoints, upstream ``.pth.tar`` files,
torchvision trunks and Flax ``.npz`` files.

The PyTorch counterpart of :mod:`geomapnet_tpu.train.checkpoint` (whose
orbax directories are not read here). A checkpoint is
``logdir/epoch_{epoch:03d}.pth.tar`` in upstream's layout
(common/train.py:161-204): ``{epoch, model_state_dict, optim_state_dict,
criterion_state_dict}``, plus ``step`` (the optimizer's update count), with
the port's own parameter names. MapNet's names are PoseNet's under a
``posenet.`` prefix; :func:`adapt_state_dict` re-nests a state dict across
that boundary as the JAX package's ``adapt_model_params`` does for its
trees (:90-107).
"""

from __future__ import annotations

import os
import re
from pathlib import Path

import torch
from torch import nn

from ..models.flax_import import state_dict_to_variables, \
    variables_to_state_dict
from ..models.torch_import import convert_state_dict, load_npz, \
    merge_variables
from .optim import Optimizer

__all__ = [
    "save_checkpoint",
    "restore_checkpoint",
    "latest_checkpoint",
    "adapt_state_dict",
    "load_model_params",
    "load_weights",
]

_PREFIX = "posenet."


def save_checkpoint(logdir: str | Path, epoch: int, model: nn.Module,
                    criterion: nn.Module, optimizer: Optimizer) -> Path:
    """Write ``logdir/epoch_{epoch:03d}.pth.tar`` (through a temporary file
    and a rename, so a reader never sees half a checkpoint)."""
    path = Path(logdir) / f"epoch_{epoch:03d}.pth.tar"
    tmp = path.with_name(path.name + ".tmp")
    torch.save({
        "epoch": int(epoch),
        "step": optimizer.count,
        "model_state_dict": model.state_dict(),
        "optim_state_dict": optimizer.state_dict(),
        "criterion_state_dict": criterion.state_dict(),
    }, tmp)
    os.replace(tmp, path)
    return path


def latest_checkpoint(logdir: str | Path) -> Path | None:
    """Most recent ``epoch_*.pth.tar`` checkpoint in a logdir, or None."""
    paths = sorted(
        Path(logdir).glob("epoch_*.pth.tar"),
        key=lambda p: int(re.sub(r"\D", "", p.name.split(".")[0]) or -1),
    )
    return paths[-1] if paths else None


def _read(path: str | Path) -> dict:
    return torch.load(path, map_location="cpu", weights_only=False)


def restore_checkpoint(path: str | Path, model: nn.Module,
                       criterion: nn.Module, optimizer: Optimizer) -> int:
    """Restore the full state (weights, BatchNorm statistics, loss weights,
    optimizer moments and update count) in place; returns the epoch."""
    ckpt = _read(path)
    model.load_state_dict(adapt_state_dict(ckpt["model_state_dict"], model))
    criterion.load_state_dict(ckpt["criterion_state_dict"])
    optimizer.load_state_dict(ckpt["optim_state_dict"])
    return int(ckpt["epoch"])


def adapt_state_dict(state: dict, model: nn.Module) -> dict:
    """Re-nest a PoseNet / MapNet state dict for ``model``: add or strip the
    ``posenet.`` prefix when the key sets differ by exactly that wrapper,
    return the dict as it is when they already match, raise otherwise."""
    keys = set(model.state_dict())
    have = set(state)
    if have == keys:
        return state
    if keys == {_PREFIX + k for k in have}:
        return {_PREFIX + k: v for k, v in state.items()}
    if have == {_PREFIX + k for k in keys}:
        return {k[len(_PREFIX):]: v for k, v in state.items()}
    raise KeyError(f"cannot reconcile state dicts: {sorted(have)[:4]}... vs "
                   f"{sorted(keys)[:4]}...")


def load_model_params(path: str | Path, model: nn.Module) -> None:
    """Load only the weights and BatchNorm statistics of a port checkpoint
    into ``model`` (PoseNet <-> MapNet re-nested); the optimizer, the loss
    weights and the epoch stay fresh (fine-tuning, upstream
    scripts/train.py:41-42)."""
    model.load_state_dict(adapt_state_dict(_read(path)["model_state_dict"],
                                           model))


def _is_port_layout(state: dict) -> bool:
    """The port's parameter names (``fc_feat``, ``layer1_0``) rather than
    upstream's or torchvision's (``fc``, ``layer1.0``)."""
    return any(k.startswith(("fc_feat.", "feature_extractor.layer1_0.",
                             _PREFIX + "fc_feat."))
               for k in state)


def load_weights(path: str | Path, model: nn.Module) -> str:
    """Load weights into ``model`` (a PoseNet, or a MapNet's PoseNet) from:

    - a port checkpoint ``epoch_*.pth.tar`` (or a bare port state dict);
    - an upstream PoseNet/MapNet ``.pth.tar`` or a torchvision trunk state
      dict, converted and merged (a trunk-only import leaves the heads as
      they are);
    - a Flax ``.npz`` (``geomapnet_tpu.models.save_npz``), merged the same
      way.

    Returns which of the three it was ("port", "torch" or "npz").
    """
    posenet = getattr(model, "posenet", model)
    if Path(path).suffix == ".npz":
        imported, kind = load_npz(str(path)), "npz"
    else:
        ckpt = _read(path)
        state = ckpt.get("model_state_dict", ckpt) \
            if isinstance(ckpt, dict) else ckpt
        if _is_port_layout(state):
            posenet.load_state_dict(adapt_state_dict(state, posenet))
            return "port"
        imported, kind = convert_state_dict(state), "torch"
    current = state_dict_to_variables(posenet.state_dict())
    merged = merge_variables(current, imported)
    posenet.load_state_dict(variables_to_state_dict(merged))
    return kind
