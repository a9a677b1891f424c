"""GroupNorm (+SiLU) and LayerNorm: the CUDA C++ kernels for Hopper and
their plain versions.

Replaces no Pallas kernel: the JAX package runs both norms as plain XLA
(ai_rtc_agent_tpu/models/layers.py ``group_norm``, ``layer_norm``), which
XLA fuses on the TPU.  Written as PyTorch ops, as the plain versions here
are, a norm is an f32 copy, a ``var_mean``, four broadcast f32 passes and a
cast, and the SiLU after a GroupNorm two more passes.  The kernel source is
``csrc/fused_norm.cu``; its header says what bounds it on the card (bytes:
GroupNorm 6 B an element in bf16, LayerNorm 4 B) and how the design keeps
to that bound: each norm is one pass over the activation (GroupNorm two
launches, statistics then apply; LayerNorm one), f32 statistics, affine and
SiLU, one rounding to the activation's type, 16-byte loads and stores where
C % 8 == 0 and the pointers are aligned and a scalar path otherwise.  The
parameters are in the activation's type, as ``cast_params`` stores them.
Built with nvcc (sm_90a) into ``build/`` at first use, bound with ctypes.

The kernels are deterministic (no float atomics) and allocate nothing: the
wrapper allocates the output and GroupNorm's small f32 scratch with
``torch.empty`` and launches on the current stream, so a call captures into
a CUDA graph.  ``launches`` counts kernel launches: 2 a GroupNorm, 1 a
LayerNorm.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from . import build, refuse_grad

SOURCE = "fused_norm.cu"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # the kernel's dtype code
MAX_CHANNELS = 4096  # GroupNorm; the .cu's MAX_CHANNELS (its statistics' shared memory)
MAX_ROW = 2048  # LayerNorm; the .cu's MAX_ROW (a row held in one warp's registers)

launches = 0  # kernel launches since the last reset (plain int)

_lib = None


def load():
    """Compile (first use) and bind the kernel library."""
    global _lib
    if _lib is None:
        lib = build.load_library(SOURCE)
        lib.group_norm_forward.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [
            ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int,
                                                       ctypes.c_void_p]
        lib.group_norm_forward.restype = ctypes.c_int
        lib.group_norm_tiles.argtypes = [ctypes.c_int, ctypes.c_longlong, ctypes.c_int]
        lib.group_norm_tiles.restype = ctypes.c_int
        lib.layer_norm_forward.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        lib.layer_norm_forward.restype = ctypes.c_int
        lib.fused_norm_error_string.argtypes = [ctypes.c_int]
        lib.fused_norm_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(err: int, what: str):
    if err:
        msg = load().fused_norm_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({err})")


def num_groups(c: int, groups: int) -> int:
    """``groups``, shrunk until it divides the channel count ``c``."""
    g = min(groups, c)
    while c % g:
        g -= 1
    return g


# ---------------------------------------------------------------------------
# plain versions (a CPU tensor, and any call that needs a gradient)
# ---------------------------------------------------------------------------


def group_norm_plain(x, scale, bias, groups: int = 32, eps: float = 1e-5, silu=None):
    """GroupNorm over NHWC, f32 statistics; ``groups`` shrinks until it
    divides the channel count; ``silu``: None, or the caller's SiLU
    (models/layers.py ``silu``), applied to the result in x's dtype."""
    n, h, w, c = x.shape
    g = num_groups(c, groups)
    xf = x.float().reshape(n, h * w, g, c // g)
    var, mean = torch.var_mean(xf, dim=(1, 3), keepdim=True, correction=0)
    xf = ((xf - mean) * torch.rsqrt(var + eps)).reshape(n, h, w, c)
    y = (xf * scale + bias).to(x.dtype)
    return silu(y) if silu is not None else y


def layer_norm_plain(x, scale, bias, eps: float = 1e-5):
    xf = x.float()
    var, mean = torch.var_mean(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------


@lru_cache(maxsize=256)
def _tiles(device_index: int, n: int, rows: int, c: int) -> int:
    """The kernel's tiles a sample's rows are cut into (its scratch's T)."""
    with torch.cuda.device(device_index):
        t = load().group_norm_tiles(n, rows, c)
    if t <= 0:
        _check(-t, "group_norm_tiles")
    return t


def _operands(name, x, scale, bias, c):
    """x, scale and bias contiguous, after the checks the kernels need."""
    if x.dtype not in DTYPES:
        raise TypeError(f"{name} on the card takes bf16 or f32 activations, got {x.dtype}")
    for pname, t in (("scale", scale), ("bias", bias)):
        if not isinstance(t, torch.Tensor) or t.shape != (c,):
            raise ValueError(f"{name}: {pname} must be a [{c}] tensor")
        if t.device != x.device:
            raise ValueError(f"{name}: {pname} on {t.device}, x on {x.device}")
        if t.dtype != x.dtype:
            raise TypeError(f"{name}: {pname} is {t.dtype}; the kernel reads x's {x.dtype}")
    if x.numel() == 0:
        raise ValueError(f"{name}: empty x {tuple(x.shape)}")
    return x.contiguous(), scale.contiguous(), bias.contiguous()


def group_norm(x, scale, bias, groups: int = 32, eps: float = 1e-5, silu=None):
    """x: [N, H, W, C] -> the same shape and dtype, GroupNorm over ``groups``
    groups (shrunk until they divide C), then SiLU where ``silu`` is given
    (the caller's SiLU, models/layers.py ``silu``).

    A CPU tensor takes :func:`group_norm_plain`, which applies ``silu`` to
    the result rounded to x's dtype; a CUDA tensor (bf16 or f32, C up to
    MAX_CHANNELS, scale/bias [C] in x's dtype) launches the two kernels or
    raises, the kernel computing SiLU itself in f32 before the one rounding.
    A call that would need a gradient raises on every device
    (:func:`~ai_rtc_agent_tpu_torch.ops.kernels.refuse_grad`)."""
    global launches
    refuse_grad("group_norm", x, scale, bias)
    if x.device.type == "cpu":
        return group_norm_plain(x, scale, bias, groups, eps, silu)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm: unsupported device {x.device}")
    if x.ndim != 4:
        raise ValueError(f"group_norm takes NHWC, got {tuple(x.shape)}")
    n, h, w, c = x.shape
    if c > MAX_CHANNELS:
        raise ValueError(f"group_norm: {c} channels, the kernel takes up to {MAX_CHANNELS}")
    x, scale, bias = _operands("group_norm", x, scale, bias, c)
    g = num_groups(c, groups)
    rows = h * w
    t = _tiles(x.device.index, n, rows, c)
    lib = load()
    y = torch.empty_like(x)
    part = torch.empty(n * t * g * 4, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.group_norm_forward(
            x.data_ptr(), y.data_ptr(), scale.data_ptr(), bias.data_ptr(), part.data_ptr(),
            DTYPES[x.dtype], n, rows, c, g, t, eps, int(silu is not None),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _check(err, "group_norm")
    launches += 2
    return y


def layer_norm(x, scale, bias, eps: float = 1e-5):
    """x: [..., C] -> the same shape and dtype, LayerNorm over the last axis.

    A CPU tensor takes :func:`layer_norm_plain`; a CUDA tensor (bf16 or f32,
    C up to MAX_ROW, scale/bias [C] in x's dtype) launches the kernel or
    raises.  A call that would need a gradient raises on every device."""
    global launches
    refuse_grad("layer_norm", x, scale, bias)
    if x.device.type == "cpu":
        return layer_norm_plain(x, scale, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm: unsupported device {x.device}")
    c = x.shape[-1]
    if c > MAX_ROW:
        raise ValueError(f"layer_norm: rows of {c}, the kernel takes up to {MAX_ROW}")
    x, scale, bias = _operands("layer_norm", x, scale, bias, c)
    lib = load()
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.layer_norm_forward(
            x.data_ptr(), y.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            DTYPES[x.dtype], x.numel() // c, c, eps,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _check(err, "layer_norm")
    launches += 1
    return y
