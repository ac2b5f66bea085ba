"""Flax variables -> PoseNet ``state_dict``: the weight bridge into the port.

The inverse direction of :mod:`geomapnet_tpu.models.torch_import`. It takes
the PoseNet-rooted ``{"params": ..., "batch_stats": ...}`` tree of numpy
arrays that the JAX package's ``save_npz`` writes (``/``-flattened keys) and
returns the ``state_dict`` of :class:`geomapnet_tpu_torch.models.posenet.
PoseNet`, whose submodules carry the Flax names:

- conv ``kernel`` HWIO -> ``weight`` OIHW; Dense ``kernel`` (I, O) ->
  ``weight`` (O, I); ``bias`` -> ``bias``;
- BatchNorm ``scale`` / ``bias`` / ``mean`` / ``var`` -> ``weight`` /
  ``bias`` / ``running_mean`` / ``running_var`` (plus a zero
  ``num_batches_tracked``, which inference never reads).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

__all__ = ["variables_to_state_dict", "state_dict_to_variables", "load_npz"]

_STATS = {"mean": "running_mean", "var": "running_var"}


def _leaves(tree: Mapping, prefix: tuple = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def variables_to_state_dict(variables: Mapping) -> dict[str, torch.Tensor]:
    """PoseNet-rooted Flax variables -> the port's PoseNet ``state_dict``."""
    sd: dict[str, torch.Tensor] = {}
    for path, arr in _leaves(variables["params"]):
        mod, leaf = ".".join(path[:-1]), path[-1]
        if leaf == "kernel":
            if arr.ndim == 4:      # conv HWIO -> OIHW
                arr = arr.transpose(3, 2, 0, 1)
            elif arr.ndim == 2:    # dense (I, O) -> (O, I)
                arr = arr.T
            else:
                raise ValueError(f"unexpected kernel rank at {path}")
            name = "weight"
        elif leaf == "scale":
            name = "weight"
        elif leaf == "bias":
            name = "bias"
        else:
            raise KeyError(f"unknown Flax parameter {'/'.join(path)}")
        sd[f"{mod}.{name}"] = torch.from_numpy(
            np.ascontiguousarray(arr, dtype=np.float32))
    for path, arr in _leaves(variables.get("batch_stats", {})):
        mod, leaf = ".".join(path[:-1]), path[-1]
        if leaf not in _STATS:
            raise KeyError(f"unknown Flax batch statistic {'/'.join(path)}")
        sd[f"{mod}.{_STATS[leaf]}"] = torch.from_numpy(
            np.ascontiguousarray(arr, dtype=np.float32))
        sd.setdefault(f"{mod}.num_batches_tracked",
                      torch.zeros((), dtype=torch.int64))
    return sd


_FROM_STATS = {v: k for k, v in _STATS.items()}


def state_dict_to_variables(sd: Mapping[str, torch.Tensor]) -> dict:
    """The inverse of :func:`variables_to_state_dict`: a PoseNet
    ``state_dict`` -> PoseNet-rooted ``{"params", "batch_stats"}`` numpy
    tree in the Flax layout, the input of the serving trees
    (:func:`geomapnet_tpu_torch.models.quant.quantize_posenet_variables`).
    Transposes only, so every value is carried exactly."""
    out: dict = {"params": {}, "batch_stats": {}}
    for key, t in sd.items():
        *mod, leaf = key.split(".")
        if leaf == "num_batches_tracked":
            continue
        arr = t.detach().to("cpu", torch.float32).numpy()
        if leaf in _FROM_STATS:
            coll, name = "batch_stats", _FROM_STATS[leaf]
        elif leaf == "weight" and arr.ndim == 4:   # conv OIHW -> HWIO
            coll, name, arr = "params", "kernel", arr.transpose(2, 3, 1, 0)
        elif leaf == "weight" and arr.ndim == 2:   # dense (O, I) -> (I, O)
            coll, name, arr = "params", "kernel", arr.T
        elif leaf == "weight":                     # BatchNorm
            coll, name = "params", "scale"
        elif leaf == "bias":
            coll, name = "params", "bias"
        else:
            raise KeyError(f"unknown state_dict entry {key}")
        node = out[coll]
        for p in mod:
            node = node.setdefault(p, {})
        node[name] = np.ascontiguousarray(arr)
    return out


def load_npz(path: str) -> dict:
    """Load variables written by ``geomapnet_tpu.models.save_npz`` (keys
    flattened with ``/``) back into a nested dict of numpy arrays."""
    tree: dict = {}
    with np.load(path) as data:
        for key in data.files:
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = data[key]
    return tree
