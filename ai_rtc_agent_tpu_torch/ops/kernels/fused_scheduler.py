"""The fused stream-step epilogue: the CUDA C++ kernel for Hopper and its
plain version.

Replaces ai_rtc_agent_tpu/ops/pallas/fused_scheduler.py
(``fused_stream_epilogue``, Pallas body ``_kernel``).  Per batch row b, with
scalars alpha, sigma, c_skip, c_out, next_alpha, next_sigma and (g, delta):

    eps    = g*eps_c - (g-1)*delta*stock     (cfg self/initialize; else eps_c)
    x0     = (x - sigma*eps) / alpha
    den    = c_skip*x + c_out*x0
    adv    = next_alpha*den + next_sigma*noise
    stock' = (eps_c + beta*stock)/(1+beta),  beta = sigma/max(alpha, 1e-6)
             (cfg self; otherwise the stock is returned unchanged)

The kernel source is ``csrc/fused_stream_epilogue.cu``; its header says what
bounds it on the card (the launch: ~96 KB on the main path) and how the
design answers it (one launch, 16-byte vector loads, coefficients read by
pointer from the device).  Built with nvcc (sm_90a) into ``build/`` at
first use, bound with ctypes.

Beyond the JAX function's arguments, keywords let one launch carry the whole
post-UNet chain of the port's step, with no glue around it:

* ``turbo``: the turbo step, pred_x0 == the blend with c_skip=0, c_out=1
  (``coeffs.c_skip``/``c_out`` are not read).
* ``noise_shift``: entry b renoises with row b+shift of ``noise``; entries
  past its last row get 0 (the JAX step's concatenation of
  ``noise[shift:]`` and zeros).
* ``advanced_out``: [R, ...] tensor that receives the advanced rows b < R
  in place and is returned in place of ``advanced``.
* ``stock_out``: receives the new stock in place (cfg self; it may be
  ``stock`` itself).  With cfg none/initialize the stock does not change,
  ``stock_out`` is not written and ``stock`` is returned.

The wrapper does no host sync, so a launch can be captured in a CUDA graph.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

SOURCE = "fused_stream_epilogue.cu"
CFG_TYPES = ("none", "initialize", "self")  # index = the kernel's cfg code
DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # the kernel's dtype code

launches = 0  # kernel launches since the last reset (plain int)

_lib = None


def load():
    """Compile (first use) and bind the kernel library."""
    global _lib
    if _lib is None:
        lib = build.load_library(SOURCE)
        fn = lib.fused_stream_epilogue
        fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 4 + [ctypes.c_longlong] + [
            ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.fused_stream_epilogue_empty.argtypes = [ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
        lib.fused_stream_epilogue_empty.restype = ctypes.c_int
        lib.fused_stream_epilogue_error_string.argtypes = [ctypes.c_int]
        lib.fused_stream_epilogue_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(err: int, what: str):
    if err:
        msg = load().fused_stream_epilogue_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({err})")


def launch_empty(rows: int, n: int, device=None):
    """Launch an empty kernel on the epilogue's grid for ``rows`` rows of
    ``n`` elements: the launch floor the kernel is timed against."""
    stream = torch.cuda.current_stream(device).cuda_stream
    _check(load().fused_stream_epilogue_empty(rows, n, stream), "empty kernel")


def epilogue_plain(x_t, eps_c, stock, noise, coeffs, guidance, delta, cfg_type="self", *,
                   turbo=False, noise_shift=0, advanced_out=None, stock_out=None):
    """The kernel's math as composed PyTorch ops (f32, cast to x's dtype),
    with the same keywords as :func:`fused_stream_epilogue`."""
    if cfg_type not in CFG_TYPES:
        raise ValueError(f"fused epilogue: unsupported cfg_type {cfg_type!r}")
    f32 = lambda a: torch.as_tensor(a, device=x_t.device).to(torch.float32)
    col = lambda a: f32(a).reshape((-1,) + (1,) * (x_t.ndim - 1))
    alpha, sigma = col(coeffs.alpha), col(coeffs.sigma)
    g, d = f32(guidance), f32(delta)
    x = x_t.float()
    e = eps_c.float()
    s = stock.float()
    eps = g * e - (g - 1.0) * d * s if cfg_type != "none" else e
    x0 = (x - sigma * eps) / alpha
    den = x0 if turbo else col(coeffs.c_skip) * x + col(coeffs.c_out) * x0
    nz = torch.zeros_like(x)
    k = max(0, min(noise.shape[0] - noise_shift, x.shape[0]))
    nz[:k] = noise[noise_shift:noise_shift + k].float()
    adv = (col(coeffs.next_alpha) * den + col(coeffs.next_sigma) * nz).to(x_t.dtype)
    if advanced_out is not None:
        adv = advanced_out.copy_(adv[: advanced_out.shape[0]])
    new_stock = stock
    if cfg_type == "self":
        beta = sigma / torch.clamp(alpha, min=1e-6)
        new_stock = ((e + beta * s) / (1.0 + beta)).to(x_t.dtype)
        if stock_out is not None:
            new_stock = stock_out.copy_(new_stock)
    return den.to(x_t.dtype), adv, new_stock


def _f32_ptr(name, v, numel, device):
    """The device pointer of an f32 coefficient tensor of ``numel`` entries."""
    if not (isinstance(v, torch.Tensor) and v.dtype == torch.float32 and v.device == device
            and v.numel() == numel and v.is_contiguous()):
        raise TypeError(f"{name}: needs a contiguous f32 tensor of {numel} on {device}")
    return v.data_ptr()


def fused_stream_epilogue(x_t, eps_c, stock, noise, coeffs, guidance, delta, cfg_type="self", *,
                          turbo=False, noise_shift=0, advanced_out=None, stock_out=None):
    """x_t/eps_c/stock/noise: [B, h, w, c] -> (denoised, advanced, stock').

    ``coeffs``: ops.lcm.StepCoeffs with [B] vectors; keywords as the module
    docstring says.  A CPU tensor takes :func:`epilogue_plain`; a CUDA tensor
    launches the kernel or raises: every tensor must share x's shape (the
    ring buffer: its row shape), device and dtype (bf16 or f32), the outputs
    must be contiguous, and the coefficient vectors, guidance and delta must
    be f32 tensors on that device."""
    global launches
    device = x_t.device
    if device.type == "cpu":
        return epilogue_plain(x_t, eps_c, stock, noise, coeffs, guidance, delta, cfg_type,
                              turbo=turbo, noise_shift=noise_shift, advanced_out=advanced_out,
                              stock_out=stock_out)
    if device.type != "cuda":
        raise ValueError(f"fused_stream_epilogue: unsupported device {device}")
    if cfg_type not in CFG_TYPES:
        raise ValueError(f"fused epilogue: unsupported cfg_type {cfg_type!r}")
    dtype, shape = x_t.dtype, x_t.shape
    if dtype not in DTYPES:
        raise TypeError(f"fused_stream_epilogue takes bf16 or f32, got {dtype}")
    is_self = cfg_type == "self"
    if not is_self:
        stock_out = None  # the stock does not change
    for name, t in (("eps_c", eps_c), ("stock", stock), ("noise", noise),
                    ("advanced_out", advanced_out), ("stock_out", stock_out)):
        if t is None:
            continue
        if t.dtype != dtype or t.device != device:
            raise TypeError(f"{name} {t.dtype}@{t.device} vs x {dtype}@{device}: mixed dtypes or devices")
        if t.shape != shape and (t is not advanced_out or t.shape[1:] != shape[1:]):
            raise ValueError(f"{name} {tuple(t.shape)} vs x {tuple(shape)}")
    B = shape[0]
    if x_t.numel() == 0:
        raise ValueError(f"empty x {tuple(shape)}")
    if advanced_out is not None and advanced_out.shape[0] > B:
        raise ValueError(f"advanced_out has {advanced_out.shape[0]} rows, more than {B}")
    if any(t is not None and not t.is_contiguous() for t in (advanced_out, stock_out)):
        raise ValueError("advanced_out/stock_out must be contiguous")
    if noise_shift < 0:
        raise ValueError(f"noise_shift {noise_shift} < 0")
    alpha, sigma, next_alpha, next_sigma = (
        _f32_ptr(name, getattr(coeffs, name), B, device)
        for name in ("alpha", "sigma", "next_alpha", "next_sigma"))
    c_skip = 0 if turbo else _f32_ptr("c_skip", coeffs.c_skip, B, device)
    c_out = 0 if turbo else _f32_ptr("c_out", coeffs.c_out, B, device)
    g, d = _f32_ptr("guidance", guidance, 1, device), _f32_ptr("delta", delta, 1, device)
    x, e, s, nz = (t.contiguous() for t in (x_t, eps_c, stock, noise))
    den = torch.empty_like(x)
    adv = torch.empty_like(x) if advanced_out is None else advanced_out
    new_stock = (torch.empty_like(x) if stock_out is None else stock_out) if is_self else stock
    lib = load()
    with torch.cuda.device(device):
        err = lib.fused_stream_epilogue(
            x.data_ptr(), e.data_ptr(), s.data_ptr(), nz.data_ptr(), den.data_ptr(),
            adv.data_ptr(), new_stock.data_ptr() if is_self else 0,
            alpha, sigma, c_skip, c_out, next_alpha, next_sigma, g, d,
            DTYPES[dtype], CFG_TYPES.index(cfg_type), int(turbo), B, x.numel() // B,
            B, noise_shift, adv.shape[0], torch.cuda.current_stream(device).cuda_stream,
        )
    _check(err, "fused_stream_epilogue")
    launches += 1
    return den, adv, new_stock
