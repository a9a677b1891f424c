"""Foundational layers as plain functions over param dicts of tensors.

Counterpart of ai_rtc_agent_tpu/models/layers.py.  A "module" is a pair
``init_*(gen, ...) -> params`` / ``apply(params, x, ...) -> y``; params are
nested dicts (and lists) of tensors with the JAX tree's names.

* Activations are NHWC and attention is [B, L, H, D], as in the JAX
  package, so the parity tests compare like with like.
* Conv weights are OIHW (``bridge.params_from_jax`` turns HWIO into OIHW);
  a conv runs on the NHWC tensor's NCHW view, which is channels_last in
  memory, so no transpose is copied.
* Linear kernels keep the JAX [in, out] layout and apply as ``x @ w``.
* A w8 kernel (models/quant.py: ``kernel_q`` int8 + a per-output-channel
  ``scale``) is dequantized in the primitive, in the activation dtype, as
  the JAX ``_kernel`` does: the int8 tensor stays int8 in device memory and
  the dequant runs inside the step (a captured step carries it).
* A style adapter's factors (``lora_down``/``lora_up`` beside a linear's
  kernel, adapters/bank.py) add their low-rank residual, per row in the
  session step.
* Compute follows the activation dtype; normalization statistics are f32.
* Under the trainer's tensor parallelism (parallel/trainer.py) a linear's or
  a conv's dict carries ``"tp"``: its kernel is this rank's shard, and the
  primitive runs Megatron's simple form (:func:`_tensor_parallel`).
* ``attn_impl="ring"``/``"ulysses"`` route attention over the sequence-
  parallel group that :func:`sp_attention_group` activates.
"""

from __future__ import annotations

import math
from contextlib import contextmanager

import torch
import torch.nn.functional as F

from ..ops.kernels import attention as kattn
from ..ops.kernels import norm as knorm
from ..parallel import collectives as C
from ..parallel import ring_attention as RA
from . import quant as Q

# --------------------------------------------------------------------------
# initializers (fan-in normal, like the JAX init; a meta device gives shapes
# only, which is how the tests check the full-size architecture)
# --------------------------------------------------------------------------


def _normal(gen, shape, std, device):
    device = torch.device(device)
    if device.type == "meta":
        return torch.empty(shape, device=device)
    return torch.randn(shape, generator=gen, device=device) * std


def init_linear(gen, in_dim, out_dim, bias=True, scale=1.0, device="cpu"):
    p = {"kernel": _normal(gen, (in_dim, out_dim), scale / math.sqrt(max(in_dim, 1)), device)}
    if bias:
        p["bias"] = torch.zeros(out_dim, device=device)
    return p


def init_conv(gen, in_ch, out_ch, k=3, bias=True, scale=1.0, device="cpu"):
    std = scale / math.sqrt(max(in_ch * k * k, 1))
    p = {"kernel": _normal(gen, (out_ch, in_ch, k, k), std, device)}
    if bias:
        p["bias"] = torch.zeros(out_ch, device=device)
    return p


def init_norm(ch, device="cpu"):
    return {"scale": torch.ones(ch, device=device), "bias": torch.zeros(ch, device=device)}


# --------------------------------------------------------------------------
# primitives
# --------------------------------------------------------------------------


def _kernel(p, dtype):
    """The dense kernel, or a w8 kernel dequantized in ``dtype``."""
    if "kernel_q" in p:
        return Q.dequantize(p, dtype)
    return p["kernel"].to(dtype)


def _affine(x, kernel, bias):
    y = x @ kernel.to(x.dtype)
    return y if bias is None else y + bias.to(x.dtype)


def _tensor_parallel(p, x, product):
    """Megatron's simple form for a dict whose kernel is sharded over tp
    (``p["tp"]`` = (kind, group), set by parallel/trainer.py); ``product(x,
    bias)`` runs the local shard.  A column-sharded kernel computes its
    shard of the output and gathers it whole; its input enters through
    ``copy_to``, whose backward sums the input's gradient over the group.  A
    row-sharded kernel takes its slice of the input's channels; the partial
    products are summed over the group, then the bias is added once.
    Activations between two layers stay replicated."""
    kind, group = p["tp"]
    bias = p.get("bias")
    if kind == "column":
        return C.gather(product(C.copy_to(x, group), bias), -1, group)
    y = C.reduce(product(C.shard(x, -1, group), None), group)
    return y if bias is None else y + bias.to(y.dtype)


def linear(p, x):
    if "tp" in p:
        return _tensor_parallel(p, x, lambda z, b: _affine(z, p["kernel"], b))
    y = x @ _kernel(p, x.dtype)
    if "lora_down" in p:
        # a per-session style adapter (adapters/bank.py grafts the factors
        # beside the kernel): the low-rank residual after the dense or w8
        # product and before the bias, as the JAX linear adds it
        y = y + lora_residual(p["lora_down"], p["lora_up"], x)
    if "bias" in p:
        y = y + p["bias"].to(x.dtype)
    return y


def lora_residual(down, up, x):
    """``(x @ down.T) @ up.T`` in ``x``'s dtype.  The factors are shared,
    ``down`` [R, in] and ``up`` [out, R], or per row, [N, R, in] and
    [N, out, R] against ``x`` [N, ..., in] (each row of the session step
    its own session's), as two batched products over ``x`` viewed as
    [N, T, in].  The association is the JAX one, so a zero factor adds
    exactly 0.0."""
    down = down.to(x.dtype)
    up = up.to(x.dtype)
    if down.ndim == 2:
        return (x @ down.T) @ up.T
    n = down.shape[0]
    if x.shape[0] != n:
        raise ValueError(f"per-row factors for {n} rows against an input of {x.shape[0]} rows")
    xs = x.reshape(n, -1, x.shape[-1])
    r = torch.bmm(torch.bmm(xs, down.transpose(1, 2)), up.transpose(1, 2))
    return r.reshape(*x.shape[:-1], up.shape[1])


def conv2d(p, x, stride: int = 1, padding="SAME"):
    """NHWC conv with an OIHW kernel.  ``"SAME"`` at stride 1 pads k//2 (1
    for 3x3, 0 for 1x1); an int pads symmetrically, as torch convs do —
    the stride-2 call sites pass 1, matching the JAX package."""
    w = _kernel(p, x.dtype)
    if padding == "SAME":
        if stride != 1:
            raise ValueError("SAME padding is only defined here at stride 1")
        padding = w.shape[-1] // 2

    def product(z, bias):
        bias = None if bias is None else bias.to(z.dtype)
        return F.conv2d(z.permute(0, 3, 1, 2), w, bias, stride=stride,
                        padding=padding).permute(0, 2, 3, 1)

    if "tp" in p:
        return _tensor_parallel(p, x, product)
    return product(x, p.get("bias"))


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def group_norm(p, x, groups: int = 32, eps: float = 1e-5, act=None):
    """GroupNorm over NHWC, f32 statistics; ``groups`` shrinks until it
    divides the channel count; ``act="silu"`` fuses :func:`silu` after it.
    The fused kernel (ops/kernels/norm.py; its plain version on a CPU
    tensor), unless the call needs a gradient, which the kernel does not
    give: then the plain version, so the trainer's steps are unchanged."""
    if act not in (None, "silu"):
        raise ValueError(f"group_norm: act {act!r} is neither None nor 'silu'")
    fn = silu if act else None
    if _needs_grad(x, p["scale"], p["bias"]):
        return knorm.group_norm_plain(x, p["scale"], p["bias"], groups, eps, fn)
    return knorm.group_norm(x, p["scale"], p["bias"], groups, eps, fn)


def layer_norm(p, x, eps: float = 1e-5):
    """LayerNorm over the last axis, f32 statistics: the fused kernel, or
    its plain version as :func:`group_norm` says."""
    if _needs_grad(x, p["scale"], p["bias"]):
        return knorm.layer_norm_plain(x, p["scale"], p["bias"], eps)
    return knorm.layer_norm(x, p["scale"], p["bias"], eps)


def silu(x):
    return x * torch.sigmoid(x)


def gelu(x):
    return F.gelu(x, approximate="none")


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


ACTIVATIONS = {"silu": silu, "gelu": gelu, "quick_gelu": quick_gelu}


def timestep_embedding(timesteps, dim: int, max_period: int = 10000, dtype=torch.float32):
    """[B] -> [B, dim] sinusoidal embedding, ``[cos | sin]``."""
    half = dim // 2
    t = torch.as_tensor(timesteps).float()
    freqs = torch.exp(
        -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / half
    )
    args = t[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb.to(dtype)


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------

ATTN_IMPLS = ("plain", "kernel", "ring", "ulysses")

# The sequence-parallel group for attn_impl="ring"/"ulysses": the trainer
# activates a mesh around its step, and every attention call inside routes
# its token axis over the mesh's sp axis.
_SP_CTX: list = []  # stack of (mesh, axis, batch_axis)


@contextmanager
def sp_attention_group(mesh, axis: str = "sp", batch_axis: str | None = None):
    """Activate sequence-parallel attention for the model applies inside
    (the JAX ``sp_attention_mesh``).  ``batch_axis`` keeps the JAX
    signature: each rank already holds only its dp slice of the batch."""
    _SP_CTX.append((mesh, axis, batch_axis))
    try:
        yield
    finally:
        _SP_CTX.pop()


def current_sp_group():
    return _SP_CTX[-1] if _SP_CTX else (None, "sp", None)


def init_attention(gen, query_dim, context_dim, heads, head_dim, device="cpu"):
    context_dim = context_dim or query_dim
    inner = heads * head_dim
    return {
        "to_q": init_linear(gen, query_dim, inner, bias=False, device=device),
        "to_k": init_linear(gen, context_dim, inner, bias=False, device=device),
        "to_v": init_linear(gen, context_dim, inner, bias=False, device=device),
        "to_out": init_linear(gen, inner, query_dim, device=device),
    }


def attention(p, x, context=None, heads: int = 8, attn_impl: str = "kernel"):
    """Multi-head attention. x: [B, Lq, C], context: [B, Lk, Cc] or None.

    ``attn_impl``: "kernel" — the flash-attention kernel
    (ops/kernels/attention.py; its plain version on a CPU tensor);
    "plain" — dense einsum softmax (:func:`sdpa_plain`); "ring" /
    "ulysses" — sequence-parallel over the active
    :func:`sp_attention_group` (:func:`_sdpa_sp`)."""
    is_self = context is None
    context = x if context is None else context
    q = linear(p["to_q"], x)
    k = linear(p["to_k"], context)
    v = linear(p["to_v"], context)
    b, lq, inner = q.shape
    hd = inner // heads
    q = q.reshape(b, lq, heads, hd)
    k = k.reshape(b, context.shape[1], heads, hd)
    v = v.reshape(b, context.shape[1], heads, hd)
    if attn_impl == "kernel":
        o = kattn.flash_attention(q, k, v)
    elif attn_impl == "plain":
        o = sdpa_plain(q, k, v)
    elif attn_impl in ("ring", "ulysses"):
        o = _sdpa_sp(q, k, v, is_self, attn_impl)
    else:
        raise ValueError(f"attn_impl {attn_impl!r} not in {ATTN_IMPLS}")
    return linear(p["to_out"], o.reshape(b, lq, inner))


def _sdpa_sp(q, k, v, is_self: bool, kind: str):
    """Sequence-parallel dispatch (the JAX ``_sdpa_sp``). The local case (no
    group is active, the axis has one rank, or the query tokens do not split
    over it) computes attention whole on this rank: through the serving
    route, the flash-attention kernel (its plain version on a CPU tensor),
    unless the call needs a gradient, which the kernel does not give: then
    the plain route, as the JAX local case takes XLA's, so the trainer's
    steps are unchanged. Otherwise this rank takes its token shard of the
    replicated q (and k/v for self-attention), runs ring or Ulysses
    attention (Ulysses needs heads % n == 0, else ring) or, for
    cross-attention, its queries against the whole short context, and the
    output shards are gathered whole. The activations outside attention stay
    replicated over sp: the JAX trainer shards the latents' height instead;
    the function is the same."""
    mesh, axis, batch_axis = current_sp_group()
    n = mesh.size(axis) if mesh is not None else 1
    lq, heads = q.shape[1], q.shape[2]
    if n == 1 or lq % n:
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
            return sdpa_plain(q, k, v)
        return kattn.flash_attention(q, k, v)
    group = mesh.group(axis)
    qs = C.shard(q, 1, group)
    if not is_self:
        o = RA.sp_cross_attention(qs, k, v, mesh, axis, batch_axis)
    else:
        ks, vs = C.shard(k, 1, group), C.shard(v, 1, group)
        if kind == "ulysses" and heads % n == 0:
            o = RA.ulysses_attention(qs, ks, vs, mesh, axis, batch_axis)
        else:
            o = RA.ring_attention(qs, ks, vs, mesh, axis, batch_axis)
    return C.gather(o, 1, group)


def sdpa_plain(q, k, v, mask=None):
    """[B,L,H,D] attention: logits in q's dtype, f32 softmax, weights cast
    back to q's dtype (the JAX ``_sdpa_xla``)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if mask is not None:
        logits = logits + mask
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


def causal_mask(length: int, device="cpu"):
    """[1,1,L,L] f32 additive causal mask (-1e9 above the diagonal)."""
    m = torch.tril(torch.ones(length, length, dtype=torch.bool, device=device))
    return torch.where(m, 0.0, -1e9)[None, None]


# --------------------------------------------------------------------------
# feed-forward (GEGLU)
# --------------------------------------------------------------------------


def init_geglu_ff(gen, dim, mult=4, device="cpu"):
    return {
        "proj": init_linear(gen, dim, dim * mult * 2, device=device),
        "out": init_linear(gen, dim * mult, dim, device=device),
    }


def geglu_ff(p, x):
    a, g = linear(p["proj"], x).chunk(2, dim=-1)
    return linear(p["out"], a * gelu(g))
