"""Import torch checkpoints (torchvision ResNet / upstream MapNet) and
Flax ``.npz`` weights into the port's modules.

Copies of :mod:`geomapnet_tpu.models.torch_import`'s numpy functions (that
package cannot be imported without jax); tests/test_torch_import_isolation.py
pins each copy to its original:

- :func:`convert_state_dict` maps a torch state-dict (torchvision
  ``resnet34().state_dict()``, or an upstream ``epoch_xxx.pth.tar``
  ``model_state_dict``) onto PoseNet-rooted Flax ``{"params",
  "batch_stats"}`` trees, handling the ``mapnet.`` / ``feature_extractor.``
  prefixes, the OIHW -> HWIO conv transposition and BatchNorm naming;
- :func:`load_torch_checkpoint` reads a ``.pth``/``.pth.tar`` file and
  converts it;
- :func:`save_npz` / :func:`load_npz` store variables as a flat npz;
- :func:`merge_variables` overlays imported leaves on a model's variables and
  tolerates missing ones (a trunk-only import leaves the heads at their
  init, the reference's pretrained-trunk + fresh-heads setup).

From there :func:`geomapnet_tpu_torch.models.flax_import.
variables_to_state_dict` gives the port's ``state_dict``
(:func:`geomapnet_tpu_torch.train.checkpoint.load_weights` does both).
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch

__all__ = [
    "convert_state_dict",
    "load_torch_checkpoint",
    "merge_variables",
    "save_npz",
    "load_npz",
]

_BN_MAP = {
    "weight": ("params", "scale"),
    "bias": ("params", "bias"),
    "running_mean": ("batch_stats", "mean"),
    "running_var": ("batch_stats", "var"),
}


def _strip_prefixes(key: str) -> str | None:
    """Normalize checkpoint key prefixes to the bare torchvision layout."""
    key = re.sub(r"^(module\.)?(mapnet\.)?", "", key)
    key = re.sub(r"^(posenet\.)?", "", key)
    key = re.sub(r"^feature_extractor\.", "", key)
    if key.endswith("num_batches_tracked"):
        return None
    return key


def _flax_path(key: str) -> tuple[tuple[str, ...], tuple[str, ...]] | None:
    """Map a normalized torch key to (collection-relative path, leaf kind).

    Returns ``(path, (collection, leaf_name))`` or None for ignorable keys.
    ``path`` is relative to the PoseNet module root, with the trunk under
    ``feature_extractor``.
    """
    parts = key.split(".")

    # head layers live at the PoseNet root
    if parts[0] in ("fc_xyz", "fc_wpqr"):
        mod, leaf = parts[0], parts[1]
        return (mod,), ("params", "kernel" if leaf == "weight" else "bias")

    trunk = ("feature_extractor",)

    if parts[0] == "fc":  # the reference's replaced trunk fc -> our fc_feat
        leaf = parts[1]
        return ("fc_feat",), ("params", "kernel" if leaf == "weight" else "bias")

    if parts[0] == "conv1":
        return trunk + ("conv1",), ("params", "kernel")
    if parts[0] == "bn1":
        return trunk + ("bn1",), _BN_MAP[parts[1]]

    m = re.match(r"layer(\d+)", parts[0])
    if m:
        block = f"layer{m.group(1)}_{parts[1]}"
        sub = parts[2]
        if sub == "downsample":
            which = "downsample_conv" if parts[3] == "0" else "downsample_bn"
            leaf = parts[4]
            if which == "downsample_conv":
                return trunk + (block, which), ("params", "kernel")
            return trunk + (block, which), _BN_MAP[leaf]
        if sub.startswith("conv"):
            return trunk + (block, sub), ("params", "kernel")
        if sub.startswith("bn"):
            return trunk + (block, sub), _BN_MAP[parts[3]]

    return None  # unknown key (e.g. torchvision's original 1000-way fc)


def convert_state_dict(
    state_dict: Mapping[str, Any], strict: bool = False
) -> dict[str, dict]:
    """Torch state-dict -> ``{"params": ..., "batch_stats": ...}`` pytrees.

    :param state_dict: torch name -> tensor/ndarray mapping
    :param strict: raise on unmapped keys instead of skipping them
    """
    # A raw torchvision trunk dict (resnet34().state_dict()) carries the
    # original 1000-way ImageNet ``fc`` and none of PoseNet's structure; the
    # reference discards that layer by replacing it
    # (upstream models/posenet.py:46). A reference PoseNet/MapNet
    # checkpoint instead has pose heads and a ``feature_extractor.``-scoped
    # trunk whose ``fc`` IS the feat layer and must be kept.
    normalized = [_strip_prefixes(k) for k in state_dict]
    is_raw_trunk = not any(
        n and (n.startswith(("fc_xyz", "fc_wpqr")))
        for n in normalized
    ) and not any("feature_extractor." in k for k in state_dict)

    out: dict[str, dict] = {"params": {}, "batch_stats": {}}
    for key, value in state_dict.items():
        norm = _strip_prefixes(key)
        if norm is None:
            continue
        if is_raw_trunk and norm.startswith("fc."):
            continue
        mapped = _flax_path(norm)
        if mapped is None:
            # torchvision's original ImageNet fc does not exist in PoseNet;
            # the reference also discards it by replacing the layer
            # (upstream models/posenet.py:46)
            if strict and not norm.startswith("fc."):
                raise KeyError(f"unmapped torch key: {key}")
            continue
        path, (collection, leaf) = mapped

        arr = np.asarray(getattr(value, "numpy", lambda: value)())
        if leaf == "kernel":
            if arr.ndim == 4:  # conv OIHW -> HWIO
                arr = arr.transpose(2, 3, 1, 0)
            elif arr.ndim == 2:  # linear (O, I) -> (I, O)
                arr = arr.T

        node = out[collection]
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return out


def load_torch_checkpoint(path: str) -> dict[str, dict]:
    """Read a ``.pth``/``.pth.tar`` file and convert it.

    Accepts either a bare state-dict or the reference's checkpoint dict with a
    ``model_state_dict`` entry (upstream common/train.py:198-204).
    """
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "model_state_dict" in ckpt:
        ckpt = ckpt["model_state_dict"]
    return convert_state_dict(ckpt)


def _flatten(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    flat = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(v, Mapping):
            flat.update(_flatten(v, name))
        else:
            flat[name] = np.asarray(v)
    return flat


def _unflatten(flat: Mapping[str, np.ndarray]) -> dict:
    tree: dict = {}
    for key, value in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def save_npz(path: str, variables: Mapping[str, Any]) -> None:
    """Persist converted variables as a flat npz (torch-free runtime load)."""
    np.savez(path, **_flatten(dict(variables)))


def load_npz(path: str) -> dict:
    """Load variables persisted by :func:`save_npz`."""
    with np.load(path) as data:
        return _unflatten({k: data[k] for k in data.files})


def merge_variables(variables: Mapping, imported: Mapping) -> dict:
    """Overlay imported leaves onto a model's init variables.

    Missing leaves keep their initialized values; shape mismatches raise.
    Returns a new (nested dict) variables tree.
    """

    def merge(dst: Mapping, src: Mapping, path: str = "") -> dict:
        out = dict(dst)
        for k, v in src.items():
            here = f"{path}/{k}" if path else k
            if k not in out:
                raise KeyError(f"imported key not in model: {here}")
            if isinstance(v, Mapping):
                out[k] = merge(out[k], v, here)
            else:
                cur = np.asarray(out[k])
                arr = np.asarray(v)
                if cur.shape != arr.shape:
                    raise ValueError(
                        f"shape mismatch at {here}: model {cur.shape} vs "
                        f"import {arr.shape}"
                    )
                out[k] = arr.astype(cur.dtype)
        return out

    return merge(variables, imported)
