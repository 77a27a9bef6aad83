"""Collectives of the port's meshes, with their gradients.

The JAX package annotates placements and lets GSPMD insert the collectives
(``sct_gan_tpu/parallel/mesh.py``); under ``shard_map`` it writes
``lax.all_gather`` and lets JAX transpose it. The port runs one process per
card (SPMD), so each collective is explicit, and the ones on a
differentiated path are ``torch.autograd.Function``s:

  * ``copy_to``      — identity forward, all-reduce backward: the input of a
    column-parallel layer (Megatron's ``f``);
  * ``reduce_from``  — all-reduce forward, identity backward: the output of
    a row-parallel layer or a vocab-parallel lookup (Megatron's ``g``);
  * ``gather_seq``   — all-gather along dim 0, backward a reduce-scatter:
    context parallelism's K/V, gathered in the (S, B, d) layout so that the
    attention reads the result through strides without a copy;
  * ``gather_rows``  — all-gather along dim 0, backward this rank's slice of
    the gradient: outputs that every data-parallel rank feeds to the same
    replicated loss (each rank's gradient is then its share of the global
    one, and the parameter gradients sum over the ranks).

An ``Axis`` names one mesh dimension as this rank sees it: its process group
(``None`` on a mesh of one), this rank's index and the size. Every
collective of a size-1 axis is the identity and runs nothing.

Gloo (the CPU backend, also two ranks sharing one card) gathers into a list
and reduce-scatters as an all-reduce and a slice; NCCL gathers and
reduce-scatters into one tensor.

``stats`` counts the collectives run. With
``stats.timed`` set, each collective is also bracketed by device
synchronisations and its wall time added to ``stats.seconds``: the
collective share of a run, at the price of those synchronisations.
"""
from __future__ import annotations

import time
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist


class Axis(NamedTuple):
    """One mesh dimension as this rank sees it."""

    group: Optional[object]   # torch.distributed ProcessGroup, or None
    rank: int
    size: int


SINGLE = Axis(None, 0, 1)


class _Stats:
    def __init__(self):
        self.timed = False
        self.reset()

    def reset(self) -> None:
        self.calls, self.seconds = 0, 0.0


stats = _Stats()


def _sync(t: torch.Tensor) -> None:
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def _run(fn, t: torch.Tensor):
    """Run one collective on ``t``, counting it in ``stats``."""
    stats.calls += 1
    if not stats.timed:
        return fn()
    _sync(t)
    t0 = time.perf_counter()
    out = fn()
    _sync(t)
    stats.seconds += time.perf_counter() - t0
    return out


def _gloo(axis: Axis) -> bool:
    return dist.get_backend(axis.group) == "gloo"


def all_reduce_(t: torch.Tensor, axis: Optional[Axis],
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced over ``axis`` in place (nothing on a size-1 axis)."""
    if axis is not None and axis.size > 1:
        _run(lambda: dist.all_reduce(t, op=op, group=axis.group), t)
    return t


def all_gather(t: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """The ranks' ``t`` concatenated along dim 0, in rank order."""
    if axis is None or axis.size == 1:
        return t
    t = t.contiguous()
    if _gloo(axis):
        parts = [torch.empty_like(t) for _ in range(axis.size)]
        _run(lambda: dist.all_gather(parts, t, group=axis.group), t)
        return torch.cat(parts)
    out = t.new_empty((axis.size * t.shape[0], *t.shape[1:]))
    _run(lambda: dist.all_gather_into_tensor(out, t, group=axis.group), t)
    return out


def reduce_scatter(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The sum over the ranks of ``t``, this rank's dim-0 chunk of it."""
    if axis.size == 1:
        return t
    t = t.contiguous()
    n = t.shape[0] // axis.size
    if _gloo(axis):
        _run(lambda: dist.all_reduce(t, group=axis.group), t)
        return t[axis.rank * n:(axis.rank + 1) * n]
    out = t.new_empty((n, *t.shape[1:]))
    _run(lambda: dist.reduce_scatter_tensor(out, t, group=axis.group), t)
    return out


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.axis), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return all_reduce_(x.contiguous().clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return all_gather(x, axis)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.axis), None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis, ctx.n = axis, x.shape[0]
        return all_gather(x, axis)

    @staticmethod
    def backward(ctx, g):
        r, n = ctx.axis.rank, ctx.n
        return g[r * n:(r + 1) * n], None


def copy_to(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    if axis is None or axis.size == 1:
        return x
    return _CopyTo.apply(x, axis)


def reduce_from(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    if axis is None or axis.size == 1:
        return x
    return _ReduceFrom.apply(x, axis)


def gather_seq(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    if axis is None or axis.size == 1:
        return x
    return _GatherSeq.apply(x, axis)


def gather_rows(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    if axis is None or axis.size == 1:
        return x
    return _GatherRows.apply(x, axis)
