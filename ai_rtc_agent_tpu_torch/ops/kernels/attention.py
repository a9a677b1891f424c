"""Flash attention: the CUDA C++ kernel for Hopper and its plain version.

Replaces ai_rtc_agent_tpu/ops/pallas/attention.py (``flash_attention``,
Pallas body ``_attn_kernel``, dense oracle ``_xla_attention``).  The kernel
source is ``csrc/flash_attention.cu``; its header says what bounds it on the
card (tensor-core throughput at the UNet's self-attention shapes, launch and
latency for the 77-token cross-attention and the small levels) and how the
design answers it: TMA loads straight from [B, L, H, D] into a ring of K/V
tiles fed by a producer warpgroup through mbarriers, wgmma with the scores,
probabilities and output kept in registers, f32 running max and
denominator.  Built with nvcc (sm_90a) into ``build/`` at first use, bound
with ctypes.  The TMA descriptors are encoded in C inside the launch
function, so the wrapper's Python work per call is what a plain launch
needs.

Unlike the TPU kernel, a ragged Lk is masked inside the kernel (no dense
fallback) and a ragged Lq or D arrives as TMA's zero fill and is not stored
(no padding copy).  A head dim off a multiple of 8 (the tiny families'
4), which TMA's 16-byte strides cannot describe, is zero-padded up to the
next one in a copy, with the scale kept at 1/sqrt(D): the zero columns add
nothing to Q K^T and give zero output columns, which are cut off.  The
kernel computes in bf16 (f32 running max and denominator), so on the card
it takes bf16 only: f32 inputs raise rather than lose precision silently;
an f32 configuration uses ``attn_impl="plain"``.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from . import build, refuse_grad

SOURCE = "flash_attention.cu"
MAX_HEAD_DIM = 160

launches = 0  # kernel launches since the last reset (plain int)

_lib = None


def load():
    """Compile (first use) and bind the kernel library."""
    global _lib
    if _lib is None:
        lib = build.load_library(SOURCE)
        fn = lib.flash_attention_forward
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        for name in ("flash_attention_key_tile", "flash_attention_registers"):
            getattr(lib, name).argtypes = [ctypes.c_int, ctypes.c_int]
            getattr(lib, name).restype = ctypes.c_int
        _lib = lib
    return _lib


def key_tile(d: int, lq: int) -> int:
    """Key rows per tile of the kernel instantiation that serves head dim
    ``d`` at ``lq`` query rows (from the built library; 0 if none takes it)."""
    return load().flash_attention_key_tile(d, lq)


def registers(d: int, lq: int) -> int:
    """Registers per thread that instantiation is launched with on the
    current device; negative if its register plan cannot run there."""
    return load().flash_attention_registers(d, lq)


def attention_plain(q, k, v):
    """Dense f32 softmax(Q K^T / sqrt(D)) V, cast to q's dtype — the plain
    version of the kernel (counterpart of ``_xla_attention``)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w, v.float()).to(q.dtype)


def flash_attention(q, k, v, mask=None):
    """q: [B, Lq, H, D], k/v: [B, Lk, H, D] -> [B, Lq, H, D] in q's dtype.

    A CPU tensor takes :func:`attention_plain`; a CUDA tensor (bf16, head
    dim up to 160, 16-byte aligned; a head dim off a multiple of 8 is
    zero-padded to one) launches the kernel or raises.  The kernel picks
    its instantiation from D and Lq (see :func:`key_tile`; the .cu header
    lists them).  ``mask`` is unsupported
    (diffusion attention is unmasked) and raises, as on the TPU.  A call
    that would need a gradient raises on every device
    (:func:`~ai_rtc_agent_tpu_torch.ops.kernels.refuse_grad`)."""
    global launches
    refuse_grad("flash_attention", q, k, v)
    if mask is not None:
        raise NotImplementedError("flash_attention is non-causal/unmasked")
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.ndim != 4 or k.shape != v.shape or k.ndim != 4:
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}")
    b, lq, h, d = q.shape
    if k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"q{tuple(q.shape)} and k{tuple(k.shape)} disagree")
    if not q.dtype == k.dtype == v.dtype == torch.bfloat16:
        raise TypeError(
            f"flash_attention on the card takes bf16, got {q.dtype}/{k.dtype}/{v.dtype} "
            '(it computes in bf16; use attn_impl="plain" for f32)'
        )
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d}: the kernel takes up to {MAX_HEAD_DIM}")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("q, k and v must share a device")
    pad = -d % 8
    if pad:
        q, k, v = (F.pad(t, (0, pad)) for t in (q, k, v))
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention needs 16-byte aligned q/k/v")
    lib = load()
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.flash_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            b, lq, k.shape[1], h, d + pad, 1.0 / math.sqrt(d),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention launch failed: {msg} ({err})")
    launches += 1
    return o[..., :d] if pad else o
