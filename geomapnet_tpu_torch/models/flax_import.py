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

A VidLoc-rooted tree (:class:`geomapnet_tpu_torch.models.vidloc.VidLoc`)
carries the same trunk, a ``fc_pose`` Dense and the two
``OptimizedLSTMCell``s ``lstm_fwd`` / ``lstm_bwd``; those become the
``lstm`` ``nn.LSTM``'s layer-0 tensors, gates stacked ``[i, f, g, o]``:
``weight_ih_l0`` rows from the ``i{g}`` kernels, ``weight_hh_l0`` rows from
the ``h{g}`` kernels, ``bias_ih_l0`` from the ``h{g}`` biases and a zero
``bias_hh_l0`` (``lstm_bwd``: the same tensors with the ``_reverse``
suffix). The way back is :func:`~geomapnet_tpu_torch.models.torch_import.
convert_lstm_weights`, which adds the two biases, so a Flax -> torch ->
Flax round trip is exact.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .torch_import import convert_lstm_weights

__all__ = ["variables_to_state_dict", "state_dict_to_variables",
           "state_dict_tensors", "load_npz"]

_STATS = {"mean": "running_mean", "var": "running_var"}
# VidLoc's LSTM cells and the suffix of their nn.LSTM direction
_LSTM_CELLS = {"lstm_fwd": "", "lstm_bwd": "_reverse"}
_GATES = ("i", "f", "g", "o")


def _lstm_tensors(cell: Mapping, sfx: str) -> dict[str, np.ndarray]:
    """An ``OptimizedLSTMCell``'s params -> one direction of ``nn.LSTM``'s
    layer 0 (the inverse of :func:`convert_lstm_weights`)."""
    def stack(side, leaf):
        return np.concatenate([
            np.asarray(cell[f"{side}{g}"][leaf]).T if leaf == "kernel"
            else np.asarray(cell[f"{side}{g}"][leaf]) for g in _GATES])

    bias = stack("h", "bias")
    return {f"lstm.weight_ih_l0{sfx}": stack("i", "kernel"),
            f"lstm.weight_hh_l0{sfx}": stack("h", "kernel"),
            f"lstm.bias_ih_l0{sfx}": bias,
            f"lstm.bias_hh_l0{sfx}": np.zeros_like(bias)}


def _leaves(tree: Mapping, prefix: tuple = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def variables_to_state_dict(variables: Mapping) -> dict[str, torch.Tensor]:
    """PoseNet- or VidLoc-rooted Flax variables -> the port's PoseNet or
    VidLoc ``state_dict``."""
    sd: dict[str, torch.Tensor] = {}
    params = dict(variables["params"])
    for cell, sfx in _LSTM_CELLS.items():
        if cell in params:
            for key, arr in _lstm_tensors(params.pop(cell), sfx).items():
                sd[key] = torch.from_numpy(np.array(arr, dtype=np.float32))
    for path, arr in _leaves(params):
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
            np.array(arr, dtype=np.float32))
    for path, arr in _leaves(variables.get("batch_stats", {})):
        mod, leaf = ".".join(path[:-1]), path[-1]
        if leaf not in _STATS:
            raise KeyError(f"unknown Flax batch statistic {'/'.join(path)}")
        sd[f"{mod}.{_STATS[leaf]}"] = torch.from_numpy(
            np.array(arr, dtype=np.float32))
        sd.setdefault(f"{mod}.num_batches_tracked",
                      torch.zeros((), dtype=torch.int64))
    return sd


_FROM_STATS = {v: k for k, v in _STATS.items()}


def _flax_leaf(key: str, t: torch.Tensor):
    """One PoseNet ``state_dict`` entry -> (collection, module path, Flax
    name, a float32 tensor in the Flax layout): a conv's OIHW weight as an
    HWIO view and a dense (O, I) weight as an (I, O) view, on the entry's
    own device (a float32 entry is not copied)."""
    *mod, leaf = key.split(".")
    t = t.detach().to(torch.float32)
    if leaf in _FROM_STATS:
        return "batch_stats", mod, _FROM_STATS[leaf], t
    if leaf == "weight" and t.dim() == 4:     # conv OIHW -> HWIO
        return "params", mod, "kernel", t.permute(2, 3, 1, 0)
    if leaf == "weight" and t.dim() == 2:     # dense (O, I) -> (I, O)
        return "params", mod, "kernel", t.t()
    if leaf == "weight":                      # BatchNorm
        return "params", mod, "scale", t
    if leaf == "bias":
        return "params", mod, "bias", t
    raise KeyError(f"unknown state_dict entry {key}")


def _put(tree: dict, coll: str, mod: list, name: str, leaf) -> None:
    node = tree[coll]
    for p in mod:
        node = node.setdefault(p, {})
    node[name] = leaf


def state_dict_to_variables(sd: Mapping[str, torch.Tensor]) -> dict:
    """The inverse of :func:`variables_to_state_dict`: a PoseNet
    ``state_dict`` -> PoseNet-rooted ``{"params", "batch_stats"}`` numpy
    tree in the Flax layout (:func:`state_dict_tensors` copied to the
    host). Transposes only, so every value is carried exactly. VidLoc's
    ``lstm`` tensors become its two cells through
    :func:`convert_lstm_weights`."""
    out: dict = {"params": {}, "batch_stats": {}}
    lstm = {}
    for key, t in sd.items():
        *mod, leaf = key.split(".")
        if leaf == "num_batches_tracked":
            continue
        if mod == ["lstm"]:
            lstm[leaf] = t.detach().to("cpu", torch.float32).numpy()
            continue
        coll, mod, name, t = _flax_leaf(key, t)
        _put(out, coll, mod, name, np.ascontiguousarray(t.cpu().numpy()))
    for cell, sfx in _LSTM_CELLS.items():
        if f"weight_ih_l0{sfx}" in lstm:
            out["params"][cell] = {
                gate: {k: np.ascontiguousarray(v) for k, v in leaves.items()}
                for gate, leaves in convert_lstm_weights(
                    lstm, reverse=bool(sfx)).items()}
    return out


def state_dict_tensors(sd: Mapping[str, torch.Tensor]) -> dict:
    """A PoseNet ``state_dict`` -> the tree of :func:`state_dict_to_variables`
    with float32 tensor leaves where the entries are: views of the model's
    own tensors in the Flax layout (a bf16 entry is cast where it is), no
    copy to the host. The serving trees
    (:func:`geomapnet_tpu_torch.models.quant.quantize_posenet_variables`)
    are then prepared on the model's device."""
    out: dict = {"params": {}, "batch_stats": {}}
    for key, t in sd.items():
        if not key.endswith(".num_batches_tracked"):
            _put(out, *_flax_leaf(key, t))
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
