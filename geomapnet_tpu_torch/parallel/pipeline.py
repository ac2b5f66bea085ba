"""GPipe pipeline parallelism over a ``stage`` axis of a grid.

The PyTorch counterpart of :mod:`geomapnet_tpu.parallel.pipeline`. JAX runs
one ``shard_map`` program on every device, picks the stage with
``lax.switch`` and moves activations with ``ppermute``; here each rank of
the ``stage`` sub-group runs its own stage function:

- the model is split into S stage functions, one per rank of the
  ``stage`` sub-group of a :class:`~geomapnet_tpu_torch.parallel.mesh.
  Grid`;
- the GPipe schedule runs ``M + S - 1`` ticks: at tick ``t`` stage ``s``
  runs microbatch ``t - s`` (a rank skips the ticks outside its range, the
  bubble, instead of computing on garbage as SPMD must);
- activations hop to the right neighbour in a fixed-size float32 transport
  buffer (the largest stage boundary), point to point
  (``batch_isend_irecv``) through :meth:`~geomapnet_tpu_torch.parallel.
  mesh.DataParallel.exchange`, which takes an all-gather on the card
  where the group's backend is gloo (gloo sends host memory only);
- the last stage's outputs reach every rank by a sum over ``stage`` of the
  others' zero buffers (JAX's ``psum``), Megatron's *g*
  (:func:`~geomapnet_tpu_torch.parallel.tensor.reduce_from_group`), whose
  backward passes the cotangent unchanged.

Weight memory shards over the stages: each stage's parameters flatten into
one float32 row of an ``(S, max_size)`` buffer (:func:`pack_stage_params`,
in JAX's flatten order: dict keys sorted), and :func:`shard_stage_params`
leaves each rank only its own row, a leaf tensor that an optimizer steps.

The schedule is differentiable with respect to the packed row, the
per-stage ``stage_params`` and the input: :class:`_GPipe` is one
``autograd.Function`` whose forward runs the ticks (keeping each tick's
graph) and whose backward runs them in reverse, each rank back-propagating
its ticks and sending each input's cotangent to its left neighbour (the
inverse permutation). The schedule fixes the order of every hop on every
rank, so no rank waits on a send that autograd's engine has not reached
yet. With ``data_axis`` (dp x pp) every data rank pipelines its rows of
each microbatch; the outputs are all-gathered over ``data`` (the
cotangent's own rows going back) and the weights' gradients summed over it
(Megatron's *f* on the weights), so every rank holds the full batch's
gradient, as the JAX package's ``psum`` over ``data`` gives it.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import torch
import torch.nn.functional as F

from .mesh import DataParallel, Grid
from .tensor import copy_to_group, reduce_from_group

__all__ = [
    "pipeline_apply",
    "stage_shapes",
    "pack_stage_params",
    "unpack_stage_params",
    "shard_stage_params",
    "StageParamsMeta",
]


class StageParamsMeta(NamedTuple):
    """Static metadata to unflatten one packed-buffer row per stage."""

    treedefs: tuple     # per stage: the pytree's structure
    leaf_specs: tuple   # per stage: ((shape, dtype), ...) in flatten order
    sizes: tuple        # per stage: flat float32 element count
    max_size: int


def _flatten(tree) -> tuple[list, object]:
    """(leaves, structure) of a pytree of dicts, lists and tuples, in JAX's
    order (dict keys sorted; None is an empty subtree)."""
    leaves = []

    def walk(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return ("dict", tuple((k, walk(t[k])) for k in sorted(t)))
        if isinstance(t, (list, tuple)):
            return (type(t).__name__, tuple(walk(v) for v in t))
        leaves.append(t)
        return "leaf"

    return leaves, walk(tree)


def _unflatten(treedef, leaves: Sequence):
    it = iter(leaves)

    def build(d):
        if d is None:
            return None
        if d == "leaf":
            return next(it)
        kind, items = d
        if kind == "dict":
            return {k: build(v) for k, v in items}
        seq = [build(v) for v in items]
        return tuple(seq) if kind == "tuple" else seq

    return build(treedef)


def pack_stage_params(stage_params: Sequence
                      ) -> tuple[torch.Tensor, StageParamsMeta]:
    """Flatten per-stage pytrees into an (S, max_size) float32 buffer and
    its metadata. Rows are zero-padded to the largest stage; the round trip
    is exact for float32 and bfloat16 leaves, and the packing is made of
    differentiable ops."""
    treedefs, leaf_specs, sizes, flats = [], [], [], []
    device = None
    for p in stage_params:
        leaves, treedef = _flatten(p)
        leaves = [torch.as_tensor(leaf) for leaf in leaves]
        if leaves and device is None:
            device = leaves[0].device
        treedefs.append(treedef)
        leaf_specs.append(tuple((tuple(leaf.shape), leaf.dtype)
                                for leaf in leaves))
        flats.append(torch.cat([leaf.reshape(-1).to(torch.float32)
                                for leaf in leaves]) if leaves else None)
        sizes.append(sum(leaf.numel() for leaf in leaves))
    max_size = max(1, max(sizes))
    rows = [F.pad(f, (0, max_size - f.numel())) if f is not None
            else torch.zeros(max_size, device=device) for f in flats]
    return torch.stack(rows), StageParamsMeta(
        tuple(treedefs), tuple(leaf_specs), tuple(sizes), max_size)


def _unpack_row(row: torch.Tensor, meta: StageParamsMeta, i: int):
    """Stage ``i``'s pytree from its (max_size,) buffer row."""
    leaves, off = [], 0
    for shape, dtype in meta.leaf_specs[i]:
        n = 1
        for d in shape:
            n *= d
        leaves.append(row[off:off + n].reshape(shape).to(dtype))
        off += n
    return _unflatten(meta.treedefs[i], leaves)


def unpack_stage_params(buf: torch.Tensor, meta: StageParamsMeta) -> list:
    """Inverse of :func:`pack_stage_params` (checkpointing, inspection)."""
    return [_unpack_row(buf[i], meta, i) for i in range(len(meta.sizes))]


def shard_stage_params(stage_params: Sequence, mesh: Grid,
                       axis: str = "stage"
                       ) -> tuple[torch.Tensor, StageParamsMeta]:
    """Pack the per-stage parameters (every rank passes all of them) and
    keep this rank's stage row only: a (1, max_size) float32 leaf on the
    grid's device that requires grad, and the metadata. Each rank holds
    ``max_size * 4`` bytes of weights instead of ``sum(sizes) * 4``; train
    on the row (its gradient and the optimizer's state have its shape),
    unpack for checkpointing."""
    buf, meta = pack_stage_params(stage_params)
    s = mesh.index(axis)
    row = buf[s:s + 1].detach().to(mesh.device).clone()
    return row.requires_grad_(True), meta


def stage_shapes(stage_fns: Sequence[Callable], x_struct: torch.Tensor
                 ) -> list:
    """The chain's per-stage (input, output) structures, as meta tensors
    (shape and dtype), from a run of the stages on fake tensors (no
    computation). ``x_struct``: a tensor whose shape, dtype and device
    stand for the first stage's input; its values are not read."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    specs = []
    with torch.no_grad(), FakeTensorMode(allow_non_fake_inputs=True):
        cur = torch.empty(tuple(x_struct.shape), dtype=x_struct.dtype,
                          device=x_struct.device)
        for fn in stage_fns:
            out = fn(cur)
            specs.append(((tuple(cur.shape), cur.dtype),
                          (tuple(out.shape), out.dtype)))
            cur = out
    return [tuple(torch.empty(s, dtype=d, device="meta") for s, d in pair)
            for pair in specs]


def _flat(a: torch.Tensor, n: int) -> torch.Tensor:
    v = a.reshape(-1).to(torch.float32)
    return F.pad(v, (0, n - v.numel()))


def _unflat(buf: torch.Tensor, struct: torch.Tensor) -> torch.Tensor:
    return buf[:struct.numel()].reshape(struct.shape).to(struct.dtype)


class _Schedule(NamedTuple):
    fn: Callable          # this rank's stage: fn(params, a) or fn(a)
    params: Callable      # leaves -> this stage's params (or None)
    mesh: DataParallel    # the stage sub-group
    n_micro: int
    in_struct: torch.Tensor    # this stage's input
    own_struct: torch.Tensor   # this stage's output
    out_struct: torch.Tensor   # the last stage's output
    buf_elems: int
    sum_over: tuple       # groups over which the leaves' gradients sum


class _GPipe(torch.autograd.Function):
    """The GPipe schedule on this rank: ``apply(schedule, xm, *leaves) ->
    outputs`` ((M, rows, ...): the last stage's outputs, zeros on the other
    stages). The backward runs the ticks in reverse (see the module
    docstring)."""

    @staticmethod
    def forward(ctx, sch: _Schedule, xm: torch.Tensor, *leaves):
        s, last = sch.mesh.rank, sch.mesh.world_size - 1
        grad = any(ctx.needs_input_grad[1:])
        if grad:
            leaves = tuple(t.detach().requires_grad_(t.requires_grad)
                           for t in leaves)
        ticks = {}
        outputs = torch.zeros((sch.n_micro,) + tuple(sch.out_struct.shape),
                              dtype=sch.out_struct.dtype, device=xm.device)
        recv = None
        for t in range(sch.n_micro + last):
            m = t - s
            active = 0 <= m < sch.n_micro
            out_flat = None
            if active:
                a = xm[m] if s == 0 else _unflat(recv, sch.in_struct)
                if grad:
                    a = a.detach().requires_grad_(
                        a.is_floating_point()
                        and (s > 0 or ctx.needs_input_grad[1]))
                    with torch.enable_grad():
                        y = sch.fn(sch.params(leaves), a)
                    ticks[t] = (a, y)
                else:
                    y = sch.fn(sch.params(leaves), a)
                out_flat = _flat(y.detach(), sch.buf_elems)
                if s == last:
                    outputs[m] = y.detach()
            sends = {s + 1: out_flat} if active and s < last else {}
            recvs = ({s - 1: xm.new_empty(sch.buf_elems,
                                          dtype=torch.float32)}
                     if s > 0 and 0 <= t + 1 - s < sch.n_micro else {})
            sch.mesh.exchange(sends, recvs, sch.buf_elems)
            recv = recvs.get(s - 1)
        ctx.sch, ctx.ticks, ctx.leaves = sch, ticks, leaves
        ctx.xm_shape = xm.shape
        return outputs

    @staticmethod
    def backward(ctx, g_out):
        sch, ticks, leaves = ctx.sch, ctx.ticks, ctx.leaves
        s, last = sch.mesh.rank, sch.mesh.world_size - 1
        gx = (g_out.new_zeros(ctx.xm_shape) if ctx.needs_input_grad[1]
              else None)
        g_next = None
        for t in reversed(range(sch.n_micro + last)):
            m = t - s
            active = 0 <= m < sch.n_micro
            g_a = None
            if active:
                a, y = ticks.pop(t)
                gy = (g_out[m] if s == last
                      else _unflat(g_next, sch.own_struct))
                if y.requires_grad:
                    torch.autograd.backward(y, gy.to(y.dtype))
                g_a = a.grad
                if s == 0 and gx is not None and g_a is not None:
                    gx[m] = g_a
            sends = ({s - 1: (_flat(g_a, sch.buf_elems) if g_a is not None
                              else g_out.new_zeros(sch.buf_elems,
                                                   dtype=torch.float32))}
                     if active and s > 0 else {})
            recvs = ({s + 1: g_out.new_empty(sch.buf_elems,
                                             dtype=torch.float32)}
                     if s < last and 0 <= t - 1 - s < sch.n_micro else {})
            sch.mesh.exchange(sends, recvs, sch.buf_elems)
            g_next = recvs.get(s + 1)
        grads = [None if not leaf.requires_grad
                 else leaf.grad if leaf.grad is not None
                 else torch.zeros_like(leaf) for leaf in leaves]
        live = [g for g in grads if g is not None]
        if live and sch.sum_over:
            # one float32 bucket, summed over each group in a fixed order
            flat = torch.cat([g.reshape(-1).float() for g in live])
            for group in sch.sum_over:
                group.all_reduce_(flat)
            off = 0
            for g in live:
                g.copy_(flat[off:off + g.numel()].view(g.shape))
                off += g.numel()
        return (None, gx, *grads)


class _GatherRows(torch.autograd.Function):
    """The data ranks' microbatch rows (dim 1) concatenated in rank order;
    the backward keeps this rank's rows of the cotangent."""

    @staticmethod
    def forward(ctx, out, mesh):
        ctx.mesh, ctx.rows = mesh, out.shape[1]
        moved = out.movedim(1, 0).contiguous()
        return mesh.all_gather(moved).movedim(0, 1).contiguous()

    @staticmethod
    def backward(ctx, g):
        r = ctx.mesh.rank * ctx.rows
        return g[:, r:r + ctx.rows].contiguous(), None


def pipeline_apply(
    stage_fns: Sequence[Callable],
    mesh: Grid,
    x: torch.Tensor,
    n_microbatches: int,
    axis: str = "stage",
    stage_params: Sequence | None = None,
    packed_params: torch.Tensor | None = None,
    params_meta: StageParamsMeta | None = None,
    data_axis: str | None = None,
) -> torch.Tensor:
    """Apply ``stage_fns[0] -> ... -> stage_fns[-1]`` pipelined over the
    ``axis`` sub-group of ``mesh``; every rank passes the same arguments.

    :param stage_fns: one function per rank of ``axis``, each mapping one
        activation tensor to the next; ``fn(params_i, a)`` with
        ``stage_params`` or ``packed_params``, else ``fn(a)`` (weights
        closed over: forward only)
    :param x: the full batch for stage 0, on every rank; its leading dim
        must divide into ``n_microbatches``
    :param stage_params: per-stage parameter pytrees, on every rank
    :param packed_params: this rank's stage row of the packed buffer
        (:func:`shard_stage_params`), or the whole ``(S, max_size)``
        buffer; requires ``params_meta``
    :param data_axis: a second axis of ``mesh`` for dp x pp: each data rank
        pipelines its rows of every microbatch
    :returns: the last stage's output for the full batch, on every rank,
        equal to the sequential composition up to the float32 transport
    """
    n_stages = mesh.shape[axis]
    if len(stage_fns) != n_stages:
        raise ValueError(
            f"{len(stage_fns)} stage functions for a {n_stages}-device "
            f"'{axis}' mesh axis"
        )
    if packed_params is not None and params_meta is None:
        raise ValueError("packed_params requires params_meta")
    if packed_params is not None and stage_params is not None:
        raise ValueError("pass stage_params OR packed_params, not both")
    n_micro = n_microbatches
    if x.shape[0] % n_micro:
        raise ValueError(
            f"batch {x.shape[0]} is not divisible into {n_micro} microbatches"
        )
    micro = x.shape[0] // n_micro
    if data_axis is not None and micro % mesh.shape[data_axis]:
        raise ValueError(
            f"microbatch rows {micro} not divisible by data axis "
            f"'{data_axis}' size {mesh.shape[data_axis]}"
        )
    if stage_params is not None and len(stage_params) != len(stage_fns):
        raise ValueError(
            f"{len(stage_params)} stage_params for {len(stage_fns)} stages"
        )

    device = mesh.device
    stages = mesh[axis]
    s = mesh.index(axis)
    data = mesh[data_axis] if data_axis is not None else None
    rows = micro // (data.world_size if data is not None else 1)

    if packed_params is not None:
        zero = torch.zeros(params_meta.max_size, device=device)
        bind = [lambda a, i=i: stage_fns[i](
            _unpack_row(zero, params_meta, i), a) for i in range(n_stages)]
    elif stage_params is not None:
        bind = [lambda a, i=i: stage_fns[i](stage_params[i], a)
                for i in range(n_stages)]
    else:
        bind = list(stage_fns)
    shapes = stage_shapes(bind, torch.empty(
        (rows,) + tuple(x.shape[1:]), dtype=x.dtype, device=device))
    buf_elems = max(t.numel() for pair in shapes for t in pair)

    # the differentiable inputs, whose gradients the schedule sums over the
    # ranks that share them (Megatron's f): every rank ends with the whole
    # gradient
    if packed_params is not None:
        w = packed_params.to(device)
        own_row = w.shape[0] == 1      # else the whole buffer: take row s
        leaves = (w,)
        sum_over = ([] if own_row else [stages]) + [data]

        def params(lv):
            return _unpack_row(lv[0][0 if own_row else s], params_meta, s)
    elif stage_params is not None:
        leaves, treedefs, offsets = [], [], [0]
        for p in stage_params:
            lv, td = _flatten(p)
            leaves += [torch.as_tensor(t).to(device) for t in lv]
            treedefs.append(td)
            offsets.append(len(leaves))
        leaves = tuple(leaves)
        sum_over = [stages, data]

        def params(lv):
            return _unflatten(treedefs[s], lv[offsets[s]:offsets[s + 1]])
    else:
        leaves, sum_over = (), []

        def params(lv):
            return None

    xm = x.to(device).reshape((n_micro, micro) + tuple(x.shape[1:]))
    if xm.requires_grad:
        xm = copy_to_group(xm, stages)
        if data is not None:
            xm = copy_to_group(xm, data)
    if data is not None:
        xm = xm[:, data.rank * rows:(data.rank + 1) * rows]

    fn = stage_fns[s]
    sch = _Schedule(
        fn if (packed_params is not None or stage_params is not None)
        else (lambda p, a: fn(a)),
        params, stages, n_micro, shapes[s][0], shapes[s][1], shapes[-1][1],
        buf_elems,
        tuple(g for g in sum_over if g is not None))
    out = _GPipe.apply(sch, xm, *leaves)
    out = reduce_from_group(out, stages)
    if data is not None:
        out = _GatherRows.apply(out, data)
    return out.reshape((n_micro * micro,) + tuple(out.shape[2:]))
