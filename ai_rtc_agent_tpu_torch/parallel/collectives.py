"""Differentiable collectives over one process group.

JAX's ``lax.ppermute``, ``all_to_all``, ``all_gather`` and ``psum`` carry
transpose rules, so ``jax.grad`` through a ``shard_map`` body is right by
construction.  Here each collective is a ``torch.autograd.Function`` whose
backward is that transpose:

* :func:`ppermute` sends along a ring shift; its backward sends the
  gradient back along the inverse shift.
* :func:`all_to_all` splits one axis over the group and concatenates what it
  receives along another; its backward swaps the two axes.
* Megatron's conjugate pairs, for a tensor that is either replicated over
  the group or sharded along one axis:

  =============  ============================  =======================
  function       forward                       backward
  =============  ============================  =======================
  :func:`shard`   replicated -> this rank's     all-gather
                  slice
  :func:`gather`  sharded -> all-gathered,      this rank's slice
                  replicated
  :func:`reduce`  partial sums -> all-reduced,  identity
                  replicated
  :func:`copy_to` identity (a replicated input  all-reduce
                  consumed by a sharded op)
  =============  ============================  =======================

``torch.distributed.nn.functional.all_reduce`` all-reduces the gradient
too, which multiplies it by the group size when the consumer is
replicated: :func:`reduce` is the form whose backward is right here.

``group=None`` means a size-1 axis: every function is then the identity
and does no collective.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _rank(group) -> int:
    return dist.get_rank(group)


def _size(group) -> int:
    return dist.get_world_size(group)


def _all_gather(x, dim, group):
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def _slice(x, dim, group):
    n = _size(group)
    if x.shape[dim] % n:
        raise ValueError(f"axis {dim} of {tuple(x.shape)} does not split over {n} ranks")
    return x.chunk(n, dim=dim)[_rank(group)].contiguous()


def _all_reduce(x, group):
    y = x.contiguous().clone()
    dist.all_reduce(y, group=group)
    return y


class _Shard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _slice(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.dim, ctx.group), None, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def shard(x, dim: int, group):
    """This rank's slice of replicated ``x`` along ``dim``."""
    return x if group is None else _Shard.apply(x, dim % x.ndim, group)


def gather(x, dim: int, group):
    """The shards of ``x`` along ``dim``, all-gathered in rank order."""
    return x if group is None else _Gather.apply(x, dim % x.ndim, group)


def reduce(x, group):
    """The sum of ``x`` over the group (partial products made whole)."""
    return x if group is None else _Reduce.apply(x, group)


def copy_to(x, group):
    """``x`` as it is; its gradient is summed over the group."""
    return x if group is None else _CopyTo.apply(x, group)


def _permute(xs, shift, group):
    n, r = _size(group), _rank(group)
    dst = dist.get_global_rank(group, (r + shift) % n)
    src = dist.get_global_rank(group, (r - shift) % n)
    xs = [x.contiguous() for x in xs]
    outs = [torch.empty_like(x) for x in xs]
    ops = []
    for x, out in zip(xs, outs):
        ops.append(dist.P2POp(dist.isend, x, dst, group))
        ops.append(dist.P2POp(dist.irecv, out, src, group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return outs


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shift, group, *xs):
        ctx.shift, ctx.group = shift, group
        return tuple(_permute(xs, shift, group))

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, *_permute(gs, -ctx.shift, ctx.group))


def ppermute(xs, group, shift: int = 1):
    """Rank r's tensors go to rank r+shift of the group (mod its size); every
    tensor of ``xs`` rides one batch of sends and receives."""
    xs = tuple(xs)
    if group is None or _size(group) == 1:
        return xs
    return _PPermute.apply(shift, group, *xs)


def _all_to_all(x, split_dim, concat_dim, group):
    n = _size(group)
    if x.shape[split_dim] % n:
        raise ValueError(f"axis {split_dim} of {tuple(x.shape)} does not split over {n} ranks")
    send = torch.stack(x.chunk(n, dim=split_dim)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, group):
        ctx.dims, ctx.group = (split_dim, concat_dim), group
        return _all_to_all(x, split_dim, concat_dim, group)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return _all_to_all(g, concat_dim, split_dim, ctx.group), None, None, None


def all_to_all(x, split_dim: int, concat_dim: int, group):
    """Chunk j of ``x`` along ``split_dim`` goes to rank j; the chunks received
    are concatenated along ``concat_dim`` in rank order (``lax.all_to_all``
    with ``tiled=True``)."""
    if group is None:
        return x
    return _AllToAll.apply(x, split_dim % x.ndim, concat_dim % x.ndim, group)
