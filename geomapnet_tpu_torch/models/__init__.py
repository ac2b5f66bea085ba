"""PoseNet / MapNet / VidLoc with ResNet trunks as torch modules, and the
Flax weight bridge."""

from .posenet import MapNet, PoseNet, nan_grad_guard, posenet_head_apply
from .resnet import ResNet, resnet18, resnet34, resnet50
from .torch_import import (
    convert_lstm_weights,
    convert_state_dict,
    load_npz,
    load_torch_checkpoint,
    merge_variables,
    save_npz,
)
from .vidloc import VidLoc

__all__ = [
    "MapNet", "PoseNet", "nan_grad_guard", "posenet_head_apply",
    "ResNet", "resnet18", "resnet34", "resnet50",
    "convert_lstm_weights", "convert_state_dict", "load_npz",
    "load_torch_checkpoint", "merge_variables", "save_npz",
    "VidLoc",
]
