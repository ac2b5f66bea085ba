"""Tensor-parallel head and spatially partitioned eval over a 2-D grid.

The PyTorch counterpart of :mod:`geomapnet_tpu.parallel.tensor`. There, the
shardings are attached to the parameters and GSPMD inserts the
collectives; here one process drives one rank of a ``("data", "model")``
:class:`~geomapnet_tpu_torch.parallel.mesh.Grid` and the collectives are
written out:

- **Tensor parallelism (Megatron) for the PoseNet head MLP.**
  ``fc_feat`` is column-parallel (this rank holds a block of its output
  features, weight and bias alike), the heads ``fc_xyz`` / ``fc_wpqr``
  are row-parallel (a block of their input features; biases replicated).
  The column layer's input passes Megatron's *f* (identity forward,
  all-reduce over ``model`` backward, :func:`copy_to_group`), the row
  layers' partial products pass *g* (all-reduce over ``model`` forward,
  identity backward, :func:`reduce_from_group`) before the bias. The relu
  and the dropout run on the column block: its keep-mask is this rank's
  columns of the full-width hashed mask. :func:`shard_step_tp` makes a
  :class:`~geomapnet_tpu_torch.train.state.TrainStep` run so: batches
  shard over ``data`` only, BatchNorm syncs and gradients average over
  ``data`` only, and the global-norm clip sums the head blocks' squared
  norms over ``model`` (the replicated parameters counted once, as optax
  does on the logical arrays). Every collective is a static-buffer
  all-reduce, so the step stays capturable in a CUDA graph.
- **Spatial partitioning of the eval forward.** Image height is split in
  bands over ``model`` (batch over ``data``). Every conv and the stem's
  max-pool computes the band of ITS output rows (a contiguous split of
  that output's height, possibly uneven or empty: 32 rows over 4 bands are
  half a row a band by layer 3) and first fetches exactly the input rows
  those output rows read from the ranks that hold them, point to point
  (:meth:`~geomapnet_tpu_torch.parallel.mesh.DataParallel.exchange`). Zero
  padding (-inf for the max-pool) applies only past the image's edges.
  The global average pool sums the bands with one all-reduce. Forward
  only, as JAX's eval is.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from .mesh import DataParallel, Grid, shard_step

__all__ = [
    "head_tp_spec",
    "tp_state_shardings",
    "shard_head_",
    "gather_head",
    "shard_step_tp",
    "copy_to_group",
    "reduce_from_group",
    "spatial_image_sharding",
    "make_spatial_eval_step",
]

# Megatron column/row layout of the PoseNet head MLP, keyed by the trailing
# (module, param) names: (tensor rank, sharded dim of the torch tensor).
# nn.Linear stores its weight (out, in): column-parallel splits dim 0, row-
# parallel dim 1 (JAX's kernels are (in, out): P(None, 'model') and
# P('model', None)). The rank check lets the rule skip anything else.
_HEAD_RULES: dict[tuple[str, str], tuple[int, int]] = {
    ("fc_feat", "weight"): (2, 0),   # column-parallel
    ("fc_feat", "bias"): (1, 0),
    ("fc_xyz", "weight"): (2, 1),    # row-parallel
    ("fc_wpqr", "weight"): (2, 1),
}


def head_tp_spec(name: str, tensor: torch.Tensor) -> int | None:
    """The dim of ``tensor`` (a parameter named ``name`` in a state dict)
    that head tensor parallelism splits over ``model``, or None when it
    stays replicated. Only the trailing ``module.param`` names matter, so
    the rule applies to any model holding a PoseNet head."""
    names = tuple(name.split("."))
    rule = _HEAD_RULES.get(names[-2:]) if len(names) >= 2 else None
    if rule is not None and tensor.dim() == rule[0]:
        return rule[1]
    return None


def tp_state_shardings(model: nn.Module, grid: Grid,
                       rule: Callable = head_tp_spec) -> dict:
    """``{parameter name: sharded dim or None}`` of ``model`` under head
    tensor parallelism on ``grid``. Checks that every sharded dim divides
    over the ``model`` axis first."""
    mp = grid.shape["model"]
    out = {}
    for name, p in model.named_parameters():
        dim = rule(name, p)
        if dim is not None and p.shape[dim] % mp:
            names = name.replace(".", "/")
            raise ValueError(
                f"tensor-parallel dim {dim} of {names} has size "
                f"{p.shape[dim]}, not divisible by the {mp}-device "
                f"'model' mesh axis (feat_dim must be a multiple of "
                f"the model-parallel degree {mp})"
            )
        out[name] = dim
    return out


class _CopyToGroup(torch.autograd.Function):
    """Megatron's *f*: identity forward, sum over the group backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce_(g.clone(
            memory_format=torch.contiguous_format)), None


class _ReduceFromGroup(torch.autograd.Function):
    """Megatron's *g*: sum over the group forward, identity backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.all_reduce_(x.clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_group(x: torch.Tensor, mesh: DataParallel) -> torch.Tensor:
    """``x`` unchanged; its gradient is summed over ``mesh``'s ranks. For a
    value every rank holds whose consumers each see a part of the work
    (a column-parallel layer's input)."""
    return _CopyToGroup.apply(x, mesh)


def reduce_from_group(x: torch.Tensor, mesh: DataParallel) -> torch.Tensor:
    """``x`` summed over ``mesh``'s ranks; the gradient passes unchanged
    (every rank holds the same cotangent of the sum). Unlike
    ``torch.distributed.nn.functional.all_reduce``, whose backward sums
    the cotangents again and so multiplies every replicated gradient by
    the group's size."""
    return _ReduceFromGroup.apply(x, mesh)


class _ParallelLinear(nn.Module):
    """A head ``Linear``'s block on this rank: ``column`` (its input through
    :func:`copy_to_group`) or ``row`` (its partial product through
    :func:`reduce_from_group`, then the replicated bias). Holds the
    original parameters under their names, so the state dict's keys stay
    the model's."""

    def __init__(self, linear: nn.Linear, kind: str, mesh: DataParallel):
        super().__init__()
        self.weight, self.bias = linear.weight, linear.bias
        self.compute_dtype = getattr(linear, "compute_dtype", torch.float32)
        self.kind, self.mesh = kind, mesh
        self.out_features, self.in_features = self.weight.shape

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if self.kind == "column":
            x = copy_to_group(x, self.mesh)
            return F.linear(x.to(dt), self.weight.to(dt)) + self.bias.to(dt)
        y = reduce_from_group(F.linear(x.to(dt), self.weight.to(dt)),
                              self.mesh)
        return y + self.bias.to(dt)


def _block(t: torch.Tensor, dim: int, parts: int, i: int) -> torch.Tensor:
    n = t.shape[dim] // parts
    return t.narrow(dim, i * n, n).clone()


def shard_head_(model: nn.Module, grid: Grid, optimizer=None,
                rule: Callable = head_tp_spec) -> dict:
    """Slice ``model``'s head in place to this rank's blocks over
    ``grid``'s ``model`` axis (and the optimizer's per-parameter state,
    where it already exists) and route the head's layers through the
    Megatron collectives. The parameters stay the same objects, so an
    optimizer built before keeps stepping them; its clip then sums the
    blocks' squared norms over ``model``. Returns the sharded dims
    (:func:`tp_state_shardings`)."""
    dims = tp_state_shardings(model, grid, rule)
    mp, m = grid.shape["model"], grid.index("model")
    mesh = grid["model"]
    sharded = []
    for name, p in model.named_parameters():
        dim = dims[name]
        if dim is None:
            continue
        full = tuple(p.shape)
        with torch.no_grad():
            p.data = _block(p.data, dim, mp, m)
        sharded.append(p)
        if optimizer is not None:
            state = optimizer.optimizer.state.get(p, {})
            for k, v in state.items():
                if torch.is_tensor(v) and tuple(v.shape) == full:
                    state[k] = _block(v, dim, mp, m)
    for parent in list(model.modules()):
        for child_name, child in list(parent.named_children()):
            if not isinstance(child, nn.Linear):
                continue
            kinds = {rule(f"{child_name}.{n}", p)
                     for n, p in child.named_parameters(recurse=False)
                     if n == "weight"}
            kind = {0: "column", 1: "row"}.get(kinds.pop())
            if kind is not None:
                setattr(parent, child_name,
                        _ParallelLinear(child, kind, mesh))
    if optimizer is not None:
        optimizer.shard_clip(sharded, mesh)
    return dims


def gather_head(model: nn.Module, grid: Grid,
                rule: Callable = head_tp_spec, state: dict | None = None
                ) -> dict:
    """``model``'s state dict with every head block all-gathered over
    ``grid``'s ``model`` axis: the logical (upstream-layout) parameters,
    on every rank, which a one-card model loads. ``state``: another dict
    under the state dict's names to gather instead (the parameters'
    gradients)."""
    mesh = grid["model"]
    out = {}
    state = model.state_dict() if state is None else state
    for name, t in state.items():
        dim = rule(name, t) if t.is_floating_point() else None
        if dim is not None and mesh.world_size > 1:
            moved = t.movedim(dim, 0).contiguous()
            t = mesh.all_gather(moved).movedim(0, dim).contiguous()
        out[name] = t
    return out


def shard_step_tp(step, grid: Grid, rule: Callable = head_tp_spec):
    """Make a :class:`~geomapnet_tpu_torch.train.state.TrainStep` run over
    ``grid`` (axes ``data`` and ``model``): the head sliced to this rank's
    blocks (:func:`shard_head_`), every rank of a ``model`` sub-group fed
    the same rows (its ``data`` rank's share of the global batch),
    BatchNorm synced and gradients averaged over ``data`` only
    (:func:`~geomapnet_tpu_torch.parallel.mesh.shard_step` on the ``data``
    sub-group), the dropout keep-mask this rank's columns of the
    full-width hashed mask. Returns ``step``."""
    shard_head_(step.model, grid, step.optimizer, rule)
    shard_step(step, grid["data"])
    mp, m = grid.shape["model"], grid.index("model")
    local = step.feat_dim // mp
    step.mask_columns = (m * local, step.feat_dim)
    step.feat_dim = local
    return step


# --------------------------------------------------------------- spatial

def _band(n: int, parts: int, i: int) -> tuple[int, int]:
    """Rows ``[lo, hi)`` of band ``i`` when ``n`` rows split into ``parts``
    contiguous bands (uneven, possibly empty, in order)."""
    return i * n // parts, (i + 1) * n // parts


class SpatialSharding(NamedTuple):
    """Batch over ``data``, image height over ``model``: ``spec`` names
    each dim's axis (JAX's ``PartitionSpec``)."""

    grid: Grid
    spec: tuple
    h_dim: int

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of a global batch ``x``: its rows over
        ``data`` and its height band over ``model``."""
        d = self.grid["data"]
        if x.shape[0] % d.world_size:
            raise ValueError(
                f"batch dim {x.shape[0]} is not divisible by the "
                f"{d.world_size}-rank 'data' group")
        n = x.shape[0] // d.world_size
        lo, hi = _band(x.shape[self.h_dim], self.grid.shape["model"],
                      self.grid.index("model"))
        return x[d.rank * n:(d.rank + 1) * n].narrow(self.h_dim, lo,
                                                      hi - lo)


def spatial_image_sharding(grid: Grid, ndim: int = 5,
                           h_dim: int = 2) -> SpatialSharding:
    """The layout of a spatially partitioned batch on ``grid``: for
    ``(N, T, H, W, C)`` tuples (``ndim=5, h_dim=2``) or ``(N, H, W, C)``
    frames (``ndim=4, h_dim=1``), batch over ``data`` and image height in
    bands over ``model``."""
    spec = [None] * ndim
    spec[0] = "data"
    spec[h_dim] = "model"
    return SpatialSharding(grid, tuple(spec), h_dim)


class _Bands:
    """The height bands of one activation over the ``model`` sub-group."""

    def __init__(self, mesh: DataParallel, height: int):
        self.mesh, self.height = mesh, height
        self.parts, self.me = mesh.world_size, mesh.rank

    def of(self, q: int) -> tuple[int, int]:
        return _band(self.height, self.parts, q)


def _fetch(x: torch.Tensor, bands: _Bands, need: Callable, fill: float
           ) -> torch.Tensor:
    """Input rows ``need(me)`` (``[a, b)``, which may pass the image's
    edges) of the activation whose band ``x`` (N, C, rows, W) this rank
    holds: every rank sends each peer the rows of its band that the peer
    needs, and rows past the edges are ``fill``."""
    h, parts, me = bands.height, bands.parts, bands.me

    def inside(q):
        a, b = need(q)
        return max(a, 0), min(b, h)

    def overlap(owner, reader):
        lo, hi = bands.of(owner)
        a, b = inside(reader)
        return max(lo, a), min(hi, b)

    row = x.shape[0] * x.shape[1] * x.shape[3]
    sends, recvs, numel = {}, {}, 0
    for q in range(parts):
        for r in range(parts):
            lo, hi = overlap(q, r)
            if q == r or hi <= lo:
                continue
            numel = max(numel, (hi - lo) * row)
            if q == me:
                own = bands.of(me)[0]
                sends[r] = x[:, :, lo - own:hi - own].contiguous()
            elif r == me:
                recvs[q] = x.new_empty(
                    (x.shape[0], x.shape[1], hi - lo, x.shape[3]))
    bands.mesh.exchange(sends, recvs, numel, x.dtype)
    a, b = need(me)
    if b <= a:
        return x[:, :, :0]
    pieces = []
    if a < 0:
        pieces.append(x.new_full((x.shape[0], x.shape[1], -a, x.shape[3]),
                                 fill))
    for q in range(parts):
        lo, hi = overlap(q, me)
        if hi <= lo:
            continue
        if q == me:
            own = bands.of(me)[0]
            pieces.append(x[:, :, lo - own:hi - own])
        else:
            pieces.append(recvs[q])
    if b > h:
        pieces.append(x.new_full((x.shape[0], x.shape[1], b - h, x.shape[3]),
                                 fill))
    return torch.cat(pieces, dim=2)


def _banded(op: Callable, x: torch.Tensor, bands: _Bands, k: int, s: int,
            p: int, cout: int, fill: float = 0.0) -> tuple:
    """``op(slab)`` (an op of kernel ``k``, stride ``s``, height padding
    ``p`` applied as rows of ``fill``; ``op`` pads the width itself) on
    this rank's band of its output; returns (output band, output bands)."""
    h_out = (bands.height + 2 * p - k) // s + 1
    out = _Bands(bands.mesh, h_out)

    def need(q):
        lo, hi = out.of(q)
        if hi <= lo:
            return 0, 0
        return lo * s - p, (hi - 1) * s - p + k

    slab = _fetch(x, bands, need, fill)
    lo, hi = out.of(out.me)
    if hi <= lo:
        w_out = (x.shape[3] + 2 * p - k) // s + 1
        return x.new_zeros((x.shape[0], cout, 0, w_out)), out
    return op(slab), out


def _conv(conv: nn.Conv2d, x: torch.Tensor, bands: _Bands) -> tuple:
    k, s, p = conv.kernel_size[0], conv.stride[0], conv.padding[0]
    dt = getattr(conv, "compute_dtype", torch.float32)

    def op(slab):
        return F.conv2d(slab.to(dt), conv.weight.to(dt), None, conv.stride,
                        (0, conv.padding[1]))

    return _banded(op, x, bands, k, s, p, conv.out_channels)


def _bn(bn: nn.Module, x: torch.Tensor) -> torch.Tensor:
    return bn(x) if x.numel() else x.float()


def _block_forward(block: nn.Module, x: torch.Tensor, bands: _Bands):
    y, yb = _conv(block.conv1, x, bands)
    y = torch.relu(_bn(block.bn1, y))
    y, yb = _conv(block.conv2, y, yb)
    y = _bn(block.bn2, y)
    if hasattr(block, "conv3"):                 # Bottleneck
        y = torch.relu(y)
        y, yb = _conv(block.conv3, y, yb)
        y = _bn(block.bn3, y)
    identity = x
    if block.downsample_conv is not None:
        identity, _ = _conv(block.downsample_conv, x, bands)
        identity = _bn(block.downsample_bn, identity)
    return torch.relu(y + identity.float()), yb


def _spatial_features(trunk: nn.Module, x: torch.Tensor, height: int,
                      mesh: DataParallel) -> torch.Tensor:
    """The trunk's pooled features (N, F) of the images whose height band
    ``x`` (N, rows, W, 3) this rank holds (``height`` rows in all, banded
    over ``mesh``); the same on every rank of ``mesh``."""
    bands = _Bands(mesh, height)
    y, yb = _conv(trunk.conv1, x.permute(0, 3, 1, 2), bands)
    y = torch.relu(_bn(trunk.bn1, y))
    y, yb = _banded(lambda slab: F.max_pool2d(slab, 3, 2, (0, 1)), y, yb,
                    3, 2, 1, y.shape[1], fill=float("-inf"))
    y = y.to(trunk.dtype)
    for stage, n_blocks in enumerate(trunk.stage_sizes):
        for b in range(n_blocks):
            y, yb = _block_forward(getattr(trunk, f"layer{stage + 1}_{b}"),
                                   y, yb)
    sums = mesh.all_reduce_(y.float().sum(dim=(2, 3)))
    return sums / (yb.height * y.shape[3])


def make_spatial_eval_step(model: nn.Module,
                           sharding: SpatialSharding) -> Callable:
    """``eval_step(images) -> (loss, outputs)``: the eval forward of
    ``model`` (a PoseNet, or a MapNet on ``(N, T, H, W, C)`` tuples) with
    this rank's block of the global batch ``images`` (``sharding``'s
    layout) computed spatially partitioned; ``outputs`` are the poses of
    the whole global batch on every rank, the loss a zero (JAX's eval step
    without a criterion). Forward only."""
    grid = sharding.grid
    posenet = getattr(model, "posenet", model)

    def eval_step(images: torch.Tensor):
        model.eval()
        with torch.no_grad():
            height = images.shape[sharding.h_dim]
            block = sharding.shard(images).to(grid.device)
            lead = tuple(block.shape[:sharding.h_dim])
            frames = block.reshape((math.prod(lead),)
                                   + tuple(block.shape[sharding.h_dim:]))
            feats = _spatial_features(posenet.feature_extractor, frames,
                                      height, grid["model"])
            poses = posenet.head(feats).reshape(lead + (-1,))
            out = grid["data"].all_gather(poses)
        return torch.zeros((), device=out.device), out

    return eval_step
