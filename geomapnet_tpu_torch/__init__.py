"""geomapnet_tpu_torch: the PyTorch / CUDA (H100) port of geomapnet_tpu.

The JAX package :mod:`geomapnet_tpu` is the reference this package is held
against; module paths mirror it (``ops/image.py`` <-> ``ops/image.py`` and
so on). This package imports torch and numpy and never jax, flax, optax or
orbax.

Ported so far: the MapNet / PoseNet (ResNet-18/34/50) evaluation, float32
or bf16, of 7Scenes and the synthetic scene (loader path, or the whole scene
in a device frame cache with the frame-dedup epoch) and of raw RobotCar
Bayer mosaics through the hand-written CUDA demosaic kernel
(:mod:`geomapnet_tpu_torch.ops.cuda_image`); the int8 and BN-folded
serving trunks on the hand-written int8 conv and max-pool kernels
(:mod:`geomapnet_tpu_torch.ops.cuda_quant`); MapNet+PGO
(:mod:`geomapnet_tpu_torch.pgo`, with the torch quaternion / SE(3) / VO ops
of :mod:`geomapnet_tpu_torch.geometry`) and eval-time dropout: ``python -m
geomapnet_tpu_torch.cli.eval ...``; training (``python -m
geomapnet_tpu_torch.cli.train ...``), and both data-parallel over several
cards under ``torchrun`` (:mod:`geomapnet_tpu_torch.parallel`).

Importing the package loads no submodule; import what you use.
"""

__version__ = "0.1.0"
