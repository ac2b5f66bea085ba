"""PoseNet / MapNet with ResNet trunks as torch modules, and the Flax
weight bridge."""
