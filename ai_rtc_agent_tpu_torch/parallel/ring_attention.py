"""Ring and Ulysses attention: sequence parallelism over the mesh's ``sp``
axis (counterpart of ai_rtc_agent_tpu/parallel/ring_attention.py).

Every function takes this rank's token shard, q/k/v [B, L/n, H, D] (the
batch is already the rank's dp slice), computes in f32 and returns its
shard of the output in q's dtype.  They are built from the differentiable
collectives of parallel/collectives.py, so autograd gives their backward as
``jax.grad`` does through the JAX ``shard_map`` bodies.

* :func:`ring_attention`: streaming softmax; the K/V shards go round the
  group by :func:`~.collectives.ppermute` while each rank accumulates its
  queries' output with a running max and denominator (no send at n = 1).
* :func:`ulysses_attention`: all_to_all tokens -> heads, full attention on
  a head slice, heads -> tokens back; needs H % n == 0.
* :func:`sp_cross_attention`: queries sharded, the short text context
  replicated: no collective forward; backward sums the context's gradient
  over the group (each rank's queries saw all of it).

The per-block products stay ``torch.einsum``: the JAX package computes them
outside any Pallas kernel too.
"""

from __future__ import annotations

import math

import torch

from . import collectives as C


def _dense(q, k, v):
    """softmax(Q K^T / sqrt(D)) V in f32, cast to q's dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w, v.float()).to(q.dtype)


def ring_attention(q, k, v, mesh, axis: str = "sp", batch_axis=None):
    """q, k, v: this rank's [B, L/n, H, D] shards of the tokens over ``axis``.
    ``batch_axis`` is the JAX signature's; the batch is already this rank's
    dp slice."""
    group = mesh.group(axis)
    n = mesh.size(axis)
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf = q.float()
    b, lq, h, d = q.shape
    o = torch.zeros((b, lq, h, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, lq), -math.inf, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, lq), dtype=torch.float32, device=q.device)
    k_blk, v_blk = k, v
    for i in range(n):
        logits = torch.einsum("bqhd,bkhd->bhqk", qf, k_blk.float()) * scale
        # the running max only keeps exp() in range: the output does not
        # depend on it, so it carries no gradient
        m_new = torch.maximum(m, logits.detach().amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        o = o * corr.transpose(1, 2)[..., None] + torch.einsum("bhqk,bkhd->bqhd", p,
                                                               v_blk.float())
        m = m_new
        if i < n - 1:
            k_blk, v_blk = C.ppermute((k_blk, v_blk), group)
    return (o / l.transpose(1, 2)[..., None]).to(q.dtype)


def ulysses_attention(q, k, v, mesh, axis: str = "sp", batch_axis=None):
    """q, k, v: this rank's [B, L/n, H, D] token shards; needs H % n == 0."""
    group = mesh.group(axis)
    n = mesh.size(axis)
    if q.shape[2] % n:
        raise ValueError(f"ulysses_attention needs heads % {axis} == 0 (H={q.shape[2]}, "
                         f"{axis}={n})")
    # [B, L/n, H, D] -> [B, L, H/n, D]
    qg, kg, vg = (C.all_to_all(t, 2, 1, group) for t in (q, k, v))
    return C.all_to_all(_dense(qg, kg, vg), 1, 2, group)


def sp_cross_attention(q, k, v, mesh, axis: str = "sp", batch_axis=None):
    """q: this rank's [B, Lq/n, H, D] shard; k, v: [B, Lk, H, D] replicated."""
    group = mesh.group(axis)
    return _dense(q, C.copy_to(k, group), C.copy_to(v, group))


def dense_reference(q, k, v):
    """Plain attention over whole tensors, for the tests."""
    return _dense(q, k, v)
