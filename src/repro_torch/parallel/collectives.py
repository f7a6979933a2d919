"""Collectives over a mesh's axes that autograd differentiates, and their
counter (the port's counterpart of the collectives the JAX package's
``shard_map``s and XLA's partitioner issue).

A sharded step (``models.model.MeshCtx``) runs every block on each rank's
local tensors and calls these where the layout needs an exchange. Each
takes a :class:`Group` (one or more mesh axes, data outer) or ``None``,
which stands for a group of one rank: then nothing is exchanged and the
tensor is returned as it is, so a 1 x 1 mesh computes exactly what one
device computes.

The functions are ``torch.autograd.Function``s over
``torch.distributed._functional_collectives``, whose backward is the
adjoint of the forward when the step's objective is the sum of every
rank's local objective (``steps.loss_and_grads``): an all-reduce's is an
all-reduce, an all-gather's a reduce-scatter, and :func:`grad_all_reduce`
(the identity) sums a replicated tensor's gradient over the ranks that
share it. ``CommDebugMode`` sees the functional collectives, in the forward
and in the backward; :class:`CollectiveCounter` also adds each one's bytes
to a :class:`~repro_torch.parallel.roofline.CollectiveStats`, by the ring
formulas the dry run and ``parse_collectives`` use.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor.debug import CommDebugMode

from repro_torch.parallel.roofline import CollectiveStats


@dataclass(frozen=True)
class Group:
    """A process group over ``axes`` of a mesh: ``size`` ranks, this rank
    the ``index``-th (data outer)."""

    axes: tuple
    pg: Any
    size: int
    index: int


def _wait(t: torch.Tensor) -> torch.Tensor:
    return t.wait() if isinstance(t, funcol.AsyncCollectiveTensor) else t


def _all_reduce(x, group: Group, op: str = "sum"):
    return _wait(funcol.all_reduce(x.contiguous(), op, group.pg))


def _all_gather(x, group: Group, dim: int):
    return _wait(funcol.all_gather_tensor(x.contiguous(), dim, group.pg))


def _reduce_scatter(x, group: Group, dim: int):
    return _wait(funcol.reduce_scatter_tensor(x.contiguous(), "sum", dim, group.pg))


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group, ctx.dim), None, None


class _GradAllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def all_reduce(x: torch.Tensor, group: Optional[Group]) -> torch.Tensor:
    """The sum of ``x`` over the group's ranks, on each of them."""
    return x if group is None else _AllReduce.apply(x, group)


def all_reduce_max(x: torch.Tensor, group: Optional[Group]) -> torch.Tensor:
    """The elementwise maximum over the group (no gradient: for the
    stabilising shifts of a log-sum-exp, whose gradient is zero)."""
    return x if group is None else _all_reduce(x.detach(), group, "max")


def all_gather(x: torch.Tensor, group: Optional[Group], dim: int) -> torch.Tensor:
    """The group's blocks of ``x`` concatenated along ``dim``, in rank
    order (data outer)."""
    return x if group is None else _AllGather.apply(x, group, dim)


def grad_all_reduce(x: torch.Tensor, group: Optional[Group]) -> torch.Tensor:
    """``x`` itself, whose gradient is summed over the group: a tensor
    replicated over the group's ranks, each of which uses it on its own
    share of the work."""
    return x if group is None else _GradAllReduce.apply(x, group)


def full_tensor(x) -> torch.Tensor:
    """The whole tensor of a DTensor on every rank: its local block
    all-gathered over each mesh dim that splits it, the inner dims first
    (so a dim split over several axes comes back in order)."""
    local, mesh = x.to_local(), x.device_mesh
    for i in reversed(range(mesh.ndim)):
        p = x.placements[i]
        if p.is_shard() and mesh.size(i) > 1:
            local = _wait(funcol.all_gather_tensor(local.contiguous(), p.dim, mesh.get_group(i)))
    return local


# functional collective op name -> the kind parse_collectives names
_KINDS = {"all_reduce": "all-reduce", "all_gather_into_tensor": "all-gather",
          "reduce_scatter_tensor": "reduce-scatter", "all_to_all_single": "all-to-all"}


class CollectiveCounter(CommDebugMode):
    """``CommDebugMode`` (``get_comm_counts()``: the collectives by op)
    that also adds each collective's result bytes and group size to
    ``stats``, a :class:`CollectiveStats`: the bytes a device sends, by the
    ring formulas of ``parallel.roofline``."""

    def __init__(self):
        super().__init__()
        self.stats = CollectiveStats()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        kind = _KINDS.get(getattr(func, "_overloadpacket", func).__name__.split(".")[-1])
        if kind is not None:
            group = dist.distributed_c10d._resolve_process_group(args[-1])
            res = out if kind != "all-reduce" else args[0]
            self.stats.add(kind, res.numel() * res.element_size(), group.size())
        return out
